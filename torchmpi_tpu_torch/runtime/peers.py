"""Ranks spread over several processes on one host: the transport.

The JAX package runs multi-controller: ``start(coordinator_address=...)``
makes every process's devices ranks of one global communicator, and the
Pallas rings K3 and K7 reach the other processes' devices by remote DMA
(the reference's own p2p/cudaIPC ring between the processes of a host,
SURVEY.md section 2.1). Here a process holds some of the virtual ranks,
all on its one device, and passes and gets the rows of its own ranks only.
Two planes carry what crosses processes:

- :class:`ControlPlane`: a ``torch.distributed`` gloo group that meets
  at ``<coordinator>`` (the launcher's or ``start()``'s address; process
  0 serves the store there for its life). It
  gives the barrier, the object gather that exchanges slab handles, the
  scalar collectives, the vendor path's row gather
  (:func:`gather_rows_host`) and the staged allreduce's host hop.
- :class:`Lane`: one communicator's exchange between its processes. Each
  process owns one slab of two slots: on CUDA one ``cudaMalloc`` exported
  by IPC handle (``csrc/peer.cpp``; the caching allocator's blocks share
  allocations, and a handle names a whole one), on the CPU (only when the
  caller asked for ``device='cpu'``) a POSIX shared-memory file. Every
  peer maps every slab once; the handles travel once a slab, and a slab
  grows by a new exchange.

The protocol of call k (slot ``s = k % 2``) never makes a kernel wait on
another process's flag (without MPS, kernels of processes on one card only
time-slice):

1. before writing slot s, wait on the host until every peer has posted the
   read of call k-2, then make the stream wait on that peer's read event;
2. copy the process's rows into its slot s on the stream, record its
   interprocess write event, then post the host sequence number k+1 (the
   post follows the record: ``cudaStreamWaitEvent`` waits on the record
   last *issued* when it is called);
3. wait on the host for every peer's post k+1, then make the stream wait
   on each peer's write event;
4. read the slots (the cross-process K3 in any of its three modes, K4 in
   either of its two, K5, K6, K7, a copy into a full rank-stacked tensor,
   or the copies of :meth:`Lane.move` and :meth:`Lane.alltoall`), record
   the read event, post the read k+1.

A host wait polls the peer's counter in shared memory; a peer whose
process is gone raises :class:`PeerError` at once, and one that does not
answer raises after ``deadlock_timeout_seconds`` (600 s while it is 0).
Every process of a lane must be on one host (the rest is ROADMAP A13's
rest, part 8).

A communicator may span some of the processes only (a ``Communicator``
built by the processes that hold its ranks, as a JAX one over a subset of
the devices). Its lane's setup and slab-growth exchanges, its barrier and
its staged partials then meet among that set only
(:meth:`ControlPlane.all_gather_object`, ``barrier`` and
``all_gather_bytes`` with ``procs``): keys under the control plane's
``TCPStore``, which process 0 serves for the job's life, scoped to the set
and numbered by an epoch of that set, as the JAX package scopes its
staged exchange's tags (``torchmpi_tpu/schedule/lower.py:494-516``). A
gloo group over a subset would have to be made by every process of the
job, which a process outside the set never reaches; the store needs
nobody else. So a process outside the set is never waited for, and two
sets that overlap keep their own order.

Since a lane call waits on the host, an async collective cannot run it on
the caller's thread. The control plane's :class:`IssueThread` runs them,
one FIFO a process (the counterpart of the reference's collective offload
thread): ``run_async`` enqueues the call and returns at once. Every
process must post its calls in one order, so everything else that crosses
processes (a sync collective, the scalar collectives, a barrier) first
drains the FIFO (:meth:`ControlPlane.drain`) and then runs on the
caller's thread: the calls keep program order, and gloo never sees two
threads' ops interleaved differently in two processes.
"""

from __future__ import annotations

import collections
import contextlib
import os
import pickle
import secrets
import socket
import threading
import time
from concurrent.futures import Future
from datetime import timedelta
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import constants

_WAIT_DEFAULT_S = 600.0
_WRITE, _READ = 0, 1
_SLOT_ALIGN = 1 << 20  # slot sizes grow in MiB, so every slot and row start aligns


class PeerError(RuntimeError):
    """A peer process died, or did not answer within the wait bound."""


def wait_bound() -> float:
    """Seconds a host wait on a peer lasts before it raises:
    ``deadlock_timeout_seconds``, or 600 while that is 0."""
    t = float(constants.get("deadlock_timeout_seconds"))
    return t if t > 0 else _WAIT_DEFAULT_S


def rest(what: str, part: int) -> NotImplementedError:
    """The error of an operation not yet carried across processes, naming
    the ``part`` of ROADMAP A13's rest that carries it."""
    return NotImplementedError(f"{what} across processes is ROADMAP A13's rest, part {part}")


def _shm_path(name: str) -> str:
    return f"/dev/shm/{name}"


def _shm(name: str, nbytes: int, create: bool) -> torch.Tensor:
    """A uint8 tensor over the POSIX shared-memory file ``name``, made
    (``create``) or mapped."""
    if create:
        fd = os.open(_shm_path(name), os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, nbytes)
        finally:
            os.close(fd)
    return torch.from_file(_shm_path(name), shared=True, size=nbytes, dtype=torch.uint8)


def _unlink(name: str) -> None:
    try:
        os.unlink(_shm_path(name))
    except FileNotFoundError:
        pass


def _alive(pid: int) -> bool:
    """True while process ``pid`` runs (a zombie counts as gone)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except (OSError, IndexError):
        return True


# the coordinator's store, one a process for its life: process 0 serves it
# at the coordinator's address and every start() meets under a prefix of
# its own, so a process that starts again while another is still tearing
# its group down never meets the old group's keys
_stores: dict = {}
# the bytes of one store value in an exchange among some of the processes:
# the TCPStore's server refuses a message over 8 MiB (and drops the
# connection), so a larger payload travels as pieces of this size
STORE_PIECE_BYTES = 4 << 20


def _store(coordinator: str, count: int, index: int):
    """``(store, generation)`` of this process's next ``start()`` at
    ``coordinator``."""
    import torch.distributed as dist

    key = (coordinator, count, index)
    ent = _stores.get(key)
    if ent is None:
        host, _, port = coordinator.rpartition(":")
        store = dist.TCPStore(host or "localhost", int(port), count, is_master=index == 0,
                              timeout=timedelta(seconds=wait_bound()))
        ent = _stores[key] = [store, 0]
    ent[1] += 1
    return ent[0], ent[1]


class IssueThread:
    """One FIFO of cross-process work and the daemon thread that runs it,
    started at the first :meth:`submit`. A call's error is set on its
    future, and every later call fails with a :class:`PeerError` naming
    it: once a call has left the lanes' protocol midway, the processes are
    out of step, and no later call may run as if they were not."""

    def __init__(self):
        self._cv = threading.Condition()
        self._items: collections.deque = collections.deque()
        self._pending = 0
        self._thread: Optional[threading.Thread] = None
        self.failed: Optional[BaseException] = None

    def submit(self, fn: Callable) -> Future:
        """Enqueue ``fn``; its future holds what it returns or raises."""
        fut: Future = Future()
        with self._cv:
            if self.failed is not None:
                fut.set_exception(self._failure())
                return fut
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="tm-xproc-issue",
                                                daemon=True)
                self._thread.start()
            self._items.append((fn, fut))
            self._pending += 1
            self._cv.notify_all()
        return fut

    def _failure(self) -> PeerError:
        return PeerError(f"an earlier cross-process call failed: {self.failed!r}")

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._items:
                    self._cv.wait()
                fn, fut = self._items.popleft()
            try:
                if fn is None:
                    return
                if self.failed is not None:
                    fut.set_exception(self._failure())
                    continue
                try:
                    fut.set_result(fn())
                except BaseException as e:  # raised from wait(); an exit stops the thread too
                    with self._cv:
                        self.failed = e
                    fut.set_exception(e)
                    if not isinstance(e, Exception):
                        with self._cv:
                            for _, rest in self._items:
                                if rest is not None:
                                    rest.set_exception(self._failure())
                            self._pending -= len(self._items)
                            self._items.clear()
                        raise
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def drain(self) -> None:
        """Wait until every call submitted so far has run (a no-op on the
        thread itself). Raises :class:`PeerError` once a call has failed."""
        if self._pending and threading.current_thread() is not self._thread:
            with self._cv:
                while self._pending and self.failed is None:
                    self._cv.wait()
        if self.failed is not None:
            raise self._failure()

    def close(self) -> None:
        """Stop the thread once the FIFO is empty."""
        with self._cv:
            thread = self._thread
            if thread is None:
                return
            if thread.is_alive():
                self._items.append((None, None))
                self._pending += 1
                self._cv.notify_all()
        thread.join()
        self._thread = None


class ControlPlane:
    """The processes' gloo group, met at the coordinator's store, made by
    ``start()`` and torn down by ``stop()``. ``index`` is this
    process, ``count`` the processes; ``pids`` and ``hosts`` name each."""

    def __init__(self, coordinator: str, num_processes: int, process_id: int):
        import torch.distributed as dist

        self._dist = dist
        self.issue = IssueThread()
        self.index, self.count = int(process_id), int(num_processes)
        self._own = not dist.is_initialized()
        self.group = None
        if self._own:
            store, gen = _store(coordinator, self.count, self.index)
            dist.init_process_group(
                "gloo", store=dist.PrefixStore(f"tm-start-{gen}", store), world_size=self.count,
                rank=self.index, timeout=timedelta(seconds=wait_bound()))
        else:
            store = dist.distributed_c10d._get_default_store()
            if dist.get_world_size() != self.count or dist.get_rank() != self.index:
                raise RuntimeError(
                    f"torch.distributed is initialised as rank {dist.get_rank()} of "
                    f"{dist.get_world_size()}, not process {self.index} of {self.count}")
            if dist.get_backend() != "gloo":
                self.group = dist.new_group(backend="gloo")
        info = self.all_gather_object((socket.gethostname(), os.getpid(), secrets.token_hex(4)))
        self.hosts = [h for h, _, _ in info]
        self.pids = [pid for _, pid, _ in info]
        # process 0's token names this job's shared-memory files and its
        # keys of the exchanges among some of the processes
        self.job = info[0][2]
        self._sets = dist.PrefixStore(f"tm-sets-{self.job}", store)
        self._epochs: dict = {}
        self._pieces: dict = {}
        self.lanes: List["Lane"] = []
        self._lane_ids: dict = {}

    def drain(self) -> None:
        """Run every async call enqueued so far before the caller's next
        cross-process step (see the module's last paragraph)."""
        self.issue.drain()

    def _collective(self, fn: Callable):
        """``fn()``, a gloo collective, after the FIFO drains; gloo's error
        becomes a :class:`PeerError` when a peer process is gone."""
        self.drain()
        try:
            return fn()
        except RuntimeError as e:
            gone = [q for q, pid in enumerate(getattr(self, "pids", ()))
                    if q != self.index and not _alive(pid)]
            if gone:
                raise PeerError(f"process {gone[0]} (pid {self.pids[gone[0]]}) died during a "
                                f"collective of process {self.index}: {e}") from e
            raise

    def _some(self, procs) -> Optional[List[int]]:
        """``procs`` as a sorted list of process indices that holds this
        process, or None when it is every process. Every process meets
        over the gloo group, which carries the bulk payloads several times
        faster than the store's one server thread: 4 processes gathering
        config 5's staged partial (100480 f32 each) took 9.2 ms through
        gloo and 16.1 through the store, the vendor path's rows (2 x 2^23
        f32 each) 324 and 2,206 ms (``chip_exchange_probe.py`` on the
        H100 machine's host, PERF.md)."""
        if procs is None:
            return None
        procs = sorted({int(q) for q in procs})
        if self.index not in procs or any(not 0 <= q < self.count for q in procs):
            raise ValueError(f"process {self.index} cannot meet the processes {procs} of "
                             f"{self.count}")
        return None if len(procs) == self.count else procs

    def _exchange(self, procs: List[int], payload: bytes) -> List[bytes]:
        """Every process of ``procs``'s ``payload`` in process order, met
        under the store's keys of this set and its next epoch (see the
        module). A payload travels as pieces of at most
        :data:`STORE_PIECE_BYTES`; its head (the piece count and the first
        piece) is posted last, so a member that reads it finds every
        piece. Each process deletes its keys of the set's previous
        exchange: every member has read them once all have posted this
        one."""
        self.drain()
        name = ",".join(map(str, procs))
        epoch = self._epochs.get(name, 0) + 1
        self._epochs[name] = epoch
        keys = [f"{name}/{epoch}/{q}" for q in procs]
        own = keys[procs.index(self.index)]
        pieces = [payload[i:i + STORE_PIECE_BYTES]
                  for i in range(0, len(payload), STORE_PIECE_BYTES)] or [b""]
        for i, piece in enumerate(pieces[1:], 1):
            self._sets.set(f"{own}/{i}", piece)
        self._sets.set(own, len(pieces).to_bytes(4, "little") + pieces[0])
        t0 = time.monotonic()
        while True:
            try:
                self._sets.wait(keys, timedelta(seconds=0.2))
                break
            except RuntimeError:
                gone = [q for q in procs if q != self.index and not _alive(self.pids[q])]
                if gone:
                    raise PeerError(f"process {gone[0]} (pid {self.pids[gone[0]]}) died during "
                                    f"an exchange of processes {procs}") from None
                if time.monotonic() - t0 > wait_bound():
                    raise PeerError(f"processes {procs} did not all post exchange {epoch} within "
                                    f"{wait_bound():.0f} s (deadlock_timeout_seconds)") from None
        out = []
        for q, k in zip(procs, keys):
            if q == self.index:
                out.append(payload)
                continue
            head = self._sets.get(k)
            count = int.from_bytes(head[:4], "little")
            out.append(b"".join([head[4:]] + [self._sets.get(f"{k}/{i}")
                                              for i in range(1, count)]))
        if epoch > 1:
            last = f"{name}/{epoch - 1}/{self.index}"
            for i in range(1, self._pieces[name]):
                self._sets.delete_key(f"{last}/{i}")
            self._sets.delete_key(last)
        self._pieces[name] = len(pieces)
        return out

    def all_gather_object(self, obj, procs=None) -> list:
        """Every process's ``obj`` in process order: of every process over
        the gloo group, or of the processes ``procs`` (a set that holds
        this one) over the store."""
        some = self._some(procs)
        if some is not None:
            return [pickle.loads(b) for b in self._exchange(some, pickle.dumps(obj))]
        out = [None] * self.count
        self._collective(lambda: self._dist.all_gather_object(out, obj, group=self.group))
        return out

    def barrier(self, procs=None) -> None:
        """Meet every process, or the processes ``procs``."""
        some = self._some(procs)
        if some is not None:
            self._exchange(some, b"")
            return
        self._collective(lambda: self._dist.barrier(group=self.group))

    def all_gather_bytes(self, t: torch.Tensor, procs=None) -> List[torch.Tensor]:
        """Every process's (or every process of ``procs``'s) CPU uint8
        tensor of ``t``'s shape (the same in every process), in process
        order."""
        some = self._some(procs)
        if some is not None:
            raw = t.contiguous().numpy().tobytes()
            return [torch.frombuffer(bytearray(b), dtype=torch.uint8).reshape(t.shape)
                    for b in self._exchange(some, raw)]
        bufs = [torch.empty_like(t) for _ in range(self.count)]
        self._collective(lambda: self._dist.all_gather(bufs, t.contiguous(), group=self.group))
        return bufs

    def lane(self, comm) -> "Lane":
        """``comm``'s lane, made (collectively, among its processes) at its
        first use. Lanes are numbered per process set, so every member
        names a lane alike."""
        lane = comm.__dict__.get("_peer_lane")
        if lane is None:
            members = tuple(sorted(set(comm.processes)))
            n = self._lane_ids[members] = self._lane_ids.get(members, 0) + 1
            name = f"{'-'.join(map(str, members))}n{n}"
            lane = comm.__dict__["_peer_lane"] = Lane(self, comm, name)
            self.lanes.append(lane)
        return lane

    def close(self) -> None:
        """Stop the issue thread, unmap the peers' slabs, wait for every
        process, free this process's slabs, destroy the group (``stop()``'s
        last steps). Once a call has failed, the processes are out of
        step: the thread and the lanes go without waiting for the peers
        (:meth:`abandon`) and the failure is raised."""
        try:
            self.drain()
        except BaseException:
            self.issue.close()
            self.abandon()
            raise
        self.issue.close()
        for lane in self.lanes:
            lane.unmap_peers()
        self.barrier()
        for lane in self.lanes:
            lane.free_own()
        self.lanes = []
        if self._own and self._dist.is_initialized():
            self._dist.destroy_process_group()

    def abandon(self) -> None:
        """Drop the group without waiting for the peers (a failed
        ``start()``)."""
        for lane in self.lanes:
            lane.unmap_peers()
            lane.free_own()
        self.lanes = []
        if self._own and self._dist.is_initialized():
            self._dist.destroy_process_group()


def processes_of(comm) -> List[int]:
    """The processes that hold ``comm``'s ranks, in process order."""
    return sorted(set(comm.processes))


def _rows_of(comm, count: int) -> List[List[int]]:
    rows = [[] for _ in range(count)]
    for r, q in enumerate(comm.processes):
        rows[q].append(r)
    return rows


def _place(full: torch.Tensor, rows: List[int], part: torch.Tensor) -> None:
    """``full[rows] = part``, a slice when the rows are consecutive."""
    if rows == list(range(rows[0], rows[0] + len(rows))):
        full[rows[0]:rows[0] + len(rows)].copy_(part)
    else:
        full.index_copy_(0, torch.tensor(rows, device=full.device), part)


def gather_rows_host(plane: ControlPlane, comm, x: torch.Tensor) -> torch.Tensor:
    """The full rank-stacked ``[p, ...]`` tensor from every process's rows
    over the gloo group (the vendor path across processes): the rows
    travel as bytes through host memory, padded to the largest process's
    row count. Returns it on ``x``'s device."""
    rows_of = _rows_of(comm, plane.count)
    procs = processes_of(comm)
    most = max(len(r) for r in rows_of)
    shape = tuple(x.shape[1:])
    raw = x.detach().contiguous().cpu().reshape(len(x), -1).view(torch.uint8)
    row_bytes = raw.shape[1]
    padded = torch.zeros((most, row_bytes), dtype=torch.uint8)
    padded[:len(raw)] = raw
    parts = plane.all_gather_bytes(padded, procs)
    full = torch.empty((comm.size, row_bytes), dtype=torch.uint8)
    for q, part in zip(procs, parts):
        _place(full, rows_of[q], part[:len(rows_of[q])])
    return full.view(x.dtype).reshape((comm.size,) + shape).to(x.device)


class Lane:
    """The exchange of one communicator's rows between its processes (see
    the module's protocol). Made collectively by :meth:`ControlPlane.lane`
    at a communicator's first cross-process call; every process calls its
    methods in the same order."""

    def __init__(self, plane: ControlPlane, comm, lane_id: str):
        self.members = processes_of(comm)
        if len({plane.hosts[q] for q in self.members}) > 1:
            raise rest("a lane between hosts (no shared memory or CUDA IPC between them)", 8)
        self.plane = plane
        self.device = comm.device
        self.cuda = comm.device.type == "cuda"
        self.me = plane.index
        self.size = comm.size
        self.procs = comm.processes
        self.rows_of = _rows_of(comm, plane.count)
        self.index_of = [0] * comm.size
        for rows in self.rows_of:
            for i, r in enumerate(rows):
                self.index_of[r] = i
        self.most = max(len(r) for r in self.rows_of)
        self.local = len(self.rows_of[self.me])
        self.seq = 0
        self.cap = 0  # bytes a slot
        self.protocol_s = 0.0  # host seconds spent in the protocol (waits, posts, records)
        self.calls = 0
        self._prefix = f"tm-{plane.job}-l{lane_id}"
        self._gen = 0
        self._slabs: List[Optional[torch.Tensor]] = [None] * plane.count
        name = f"{self._prefix}-f{self.me}"
        own = _shm(name, 16, create=True)
        handles = None
        if self.cuda:
            self._write = [torch.cuda.Event(interprocess=True) for _ in range(2)]
            self._read = [torch.cuda.Event(interprocess=True) for _ in range(2)]
            with torch.cuda.device(self.device):
                handles = [e.ipc_handle() for e in self._write + self._read]
        try:
            info = plane.all_gather_object({"flags": name, "events": handles}, self.members)
            # counters in shared memory (the arrays keep the mappings alive);
            # None for a process outside the lane
            self.flags = [None] * plane.count
            for q, i in zip(self.members, info):
                self.flags[q] = (own if q == self.me else _shm(i["flags"], 16, create=False)
                                 ).view(torch.int64).numpy()
            if self.cuda:
                self._peer_write, self._peer_read = [None] * plane.count, [None] * plane.count
                for q, i in zip(self.members, info):
                    if q != self.me:
                        ev = [torch.cuda.Event.from_ipc_handle(self.device, h) for h in i["events"]]
                        self._peer_write[q], self._peer_read[q] = ev[:2], ev[2:]
            plane.barrier(self.members)
        finally:
            _unlink(name)  # every peer has it mapped (or the start failed)

    # -- the slabs ---------------------------------------------------------
    def _ensure(self, slot_bytes: int) -> None:
        """Grow the slabs (every process at once, since every process asks
        for the same ``slot_bytes``) when a slot is smaller."""
        if slot_bytes <= self.cap:
            return
        if self.cap:
            # every read of the old slabs done before they go
            if self.cuda:
                torch.cuda.synchronize(self.device)
            self.plane.barrier(self.members)
            self.unmap_peers()
            self.plane.barrier(self.members)
            self.free_own()
        cap = -(-max(slot_bytes, 2 * self.cap) // _SLOT_ALIGN) * _SLOT_ALIGN
        self._gen += 1
        slabs: List[Optional[torch.Tensor]] = [None] * self.plane.count
        if self.cuda:
            from ..ops._build import extension

            ext = extension("peer")
            slab, handle = ext.alloc(2 * cap, self.device.index)
            info = self.plane.all_gather_object(handle, self.members)
            for q, h in zip(self.members, info):
                slabs[q] = slab if q == self.me else ext.open(h, 2 * cap, self.device.index)
            self._slabs = slabs
            self.plane.barrier(self.members)
        else:
            name = f"{self._prefix}-d{self.me}-g{self._gen}"
            slab = _shm(name, 2 * cap, create=True)
            try:
                info = self.plane.all_gather_object(name, self.members)
                for q, n in zip(self.members, info):
                    slabs[q] = slab if q == self.me else _shm(n, 2 * cap, create=False)
                self._slabs = slabs
                self.plane.barrier(self.members)
            finally:
                _unlink(name)
        self.cap = cap

    @property
    def growths(self) -> int:
        """Slab allocations so far (the first included), each a collective
        exchange."""
        return self._gen

    def unmap_peers(self) -> None:
        """Close the mappings of the peers' slabs (the deleters run)."""
        self._slabs = [s if q == self.me else None for q, s in enumerate(self._slabs)]

    def free_own(self) -> None:
        """Free this process's slab."""
        self._slabs = [None] * len(self._slabs)
        self.cap = 0

    def _view(self, q: int, s: int, nbytes: int, shape, dtype) -> torch.Tensor:
        base = s * self.cap
        return self._slabs[q][base:base + nbytes].view(dtype).view(shape)

    # -- the protocol ------------------------------------------------------
    def _wait(self, which: int, value: int) -> None:
        """Wait on the host until every peer's counter ``which`` reaches
        ``value``."""
        for q, flags in enumerate(self.flags):
            if q == self.me or flags is None or flags[which] >= value:
                continue
            spins, t0 = 0, time.monotonic()
            check = t0
            while flags[which] < value:
                spins += 1
                if spins < 4096:
                    continue
                time.sleep(2e-5)
                now = time.monotonic()
                if now - check > 0.2:
                    check = now
                    if not _alive(self.plane.pids[q]):
                        raise PeerError(
                            f"process {q} (pid {self.plane.pids[q]}) died while process "
                            f"{self.me} waited for its {'write' if which == _WRITE else 'read'} "
                            f"of call {value - 1}")
                    if now - t0 > wait_bound():
                        raise PeerError(
                            f"process {q} did not post its {'write' if which == _WRITE else 'read'} "
                            f"of call {value - 1} within {wait_bound():.0f} s "
                            "(deadlock_timeout_seconds)")

    def _stream(self, stream):
        return stream if stream is not None else torch.cuda.current_stream(self.device)

    def _on(self, stream):
        """A context that makes ``stream`` current on CUDA (a no-op on the
        CPU)."""
        return torch.cuda.stream(self._stream(stream)) if self.cuda else contextlib.nullcontext()

    def publish(self, rows: Optional[torch.Tensor], row_bytes: int, stream=None) -> int:
        """Steps 1-3 of call k: ``rows`` (this process's rows, or a prefix
        of them, or None for nothing) copied into slot k % 2 once every
        peer has read it, and every peer's slot ready to read. Slots are
        sized for the largest process's rows of ``row_bytes`` each.
        Returns the slot."""
        self.plane.drain()
        self._ensure(max(1, self.most * row_bytes))
        t0 = time.perf_counter()
        k, s = self.seq, self.seq & 1
        st = self._stream(stream) if self.cuda else None
        if k >= 2:
            self._wait(_READ, k - 1)
            if self.cuda:
                for ev in self._peer_read:
                    if ev is not None:
                        st.wait_event(ev[s])
        t1 = time.perf_counter()
        if rows is not None and rows.numel():
            dst = self._view(self.me, s, rows.numel() * rows.element_size(), rows.shape, rows.dtype)
            if self.cuda:
                with torch.cuda.stream(st):
                    dst.copy_(rows)
            else:
                dst.copy_(rows)
        t2 = time.perf_counter()
        if self.cuda:
            self._write[s].record(st)
        self.flags[self.me][_WRITE] = k + 1
        self._wait(_WRITE, k + 1)
        if self.cuda:
            for ev in self._peer_write:
                if ev is not None:
                    st.wait_event(ev[s])
        self.protocol_s += (t1 - t0) + (time.perf_counter() - t2)
        return s

    def views(self, s: int, shape, dtype) -> List[Optional[torch.Tensor]]:
        """Every process's rows in slot ``s``, ``[L_q, *shape]`` of
        ``dtype`` (None for a process outside the lane)."""
        row = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        return [self._view(q, s, len(rows) * row, (len(rows),) + tuple(shape), dtype)
                if rows else None for q, rows in enumerate(self.rows_of)]

    def release(self, stream=None) -> None:
        """Step 4's end: this process has read call k's slot."""
        t0 = time.perf_counter()
        s = self.seq & 1
        if self.cuda:
            self._read[s].record(self._stream(stream))
        self.flags[self.me][_READ] = self.seq + 1
        self.seq += 1
        self.calls += 1
        self.protocol_s += time.perf_counter() - t0

    # -- what crosses ------------------------------------------------------
    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != self.local or x.device != self.device:
            raise ValueError(
                f"lane of {self.local} local rows on {self.device} got {tuple(x.shape)} "
                f"on {x.device}")

    def _carried(self, x: torch.Tensor):
        """``(rows, carrier)``: this process's rows of ``x`` flat and
        contiguous in the dtype the ring adds in, after the checks."""
        from ..ops import ring_kernels

        self._check(x)
        carrier = ring_kernels.carrier_dtype(x.dtype)
        rows = x.reshape(self.local, -1)
        return (rows if carrier == x.dtype else rows.to(carrier)).contiguous(), carrier

    def gather(self, x: torch.Tensor, stream=None) -> torch.Tensor:
        """The full rank-stacked ``[p, ...]`` tensor from every process's
        rows, each copied from the slab where it lies (the ``ring``
        backend's hop across processes)."""
        self._check(x)
        x = x.contiguous()
        shape = tuple(x.shape[1:])
        row_bytes = x[0].numel() * x.element_size()
        s = self.publish(x, row_bytes, stream)
        full = torch.empty((self.size,) + shape, dtype=x.dtype, device=x.device)
        with self._on(stream):
            for q, (rows, part) in enumerate(zip(self.rows_of, self.views(s, shape, x.dtype))):
                if rows:
                    _place(full, rows, x if q == self.me else part)
        self.release(stream)
        return full

    def allreduce(self, x: torch.Tensor, stream=None) -> torch.Tensor:
        """The sum over every rank's rows through the cross-process K3
        (``ops.ring_allreduce_xproc``): this process's rows of the
        result, bit for bit the one-process K3's rows on the same
        ``[p, ...]``."""
        from ..ops import ring_kernels

        rows, carrier = self._carried(x)
        n = rows.shape[1]
        s = self.publish(rows, n * rows.element_size(), stream)
        out = ring_kernels.ring_allreduce_xproc(self._table(s, (n,), carrier), self.local,
                                                stream=stream)
        self.release(stream)
        return out.to(x.dtype).reshape(x.shape)

    def allreduce_groups(self, x: torch.Tensor, groups: List[List[int]],
                         stream=None) -> torch.Tensor:
        """The sum within each of ``groups`` (lists of ranks of one size,
        the intra groups of a two-level communicator, which may span
        processes) through the grouped cross-process K3
        (``ops.ring_allreduce_xproc(..., groups=G)``): this process's rows,
        each its group's sum, bit for bit the one-process grouped K3 on the
        same rows in group-major order. The launch reads every row of each
        group that holds one of this process's ranks, where it lies, and
        writes only its own rows."""
        from ..ops import ring_kernels

        rows, carrier = self._carried(x)
        n = rows.shape[1]
        mine = set(self.rows_of[self.me])
        touched = [r for g in groups if mine.intersection(g) for r in g]
        s = self.publish(rows, n * rows.element_size(), stream)
        views = self.views(s, (n,), carrier)
        table = [views[self.procs[r]][self.index_of[r]] for r in touched]
        out = ring_kernels.ring_allreduce_xproc(
            table, self.local, stream=stream, groups=len(touched) // len(groups[0]),
            owned=[touched.index(r) for r in self.rows_of[self.me]])
        self.release(stream)
        return out.to(x.dtype).reshape(x.shape)

    def broadcast_groups(self, x: torch.Tensor, groups: List[List[int]], root: int,
                         stream=None) -> torch.Tensor:
        """Each of this process's rows given the row of its group's rank
        ``root`` (the rank at that position of its group in ``groups``,
        groups that may span processes) through the grouped cross-process
        K7 (``ops.ring_broadcast_xproc`` with a root row a group): a
        process stages only the root rows it holds, and the launch reads
        each group's root row where it lies."""
        from ..ops import ring_kernels

        self._check(x)
        x = x.contiguous()
        shape = tuple(x.shape[1:])
        row_bytes = x[0].numel() * x.element_size()
        mine = self.rows_of[self.me]
        touched = [g for g in groups if set(mine).intersection(g)]
        staged = [sorted(g[root] for g in groups if self.procs[g[root]] == q)
                  for q in range(self.plane.count)]
        with self._on(stream):
            own = torch.stack([x[self.index_of[r]] for r in staged[self.me]]) \
                if staged[self.me] else None
        s = self.publish(own, row_bytes, stream)
        roots = []
        for g in touched:
            r = g[root]
            q, at = self.procs[r], staged[self.procs[r]].index(r)
            roots.append(self._view(q, s, (at + 1) * row_bytes, (at + 1,) + shape, x.dtype)[at])
        out = ring_kernels.ring_broadcast_xproc(
            roots, self.local, stream=stream,
            owned=[next(i for i, g in enumerate(touched) if r in g) for r in mine])
        self.release(stream)
        return out

    def _table(self, s: int, shape, dtype) -> List[torch.Tensor]:
        """The p rank rows of slot ``s`` in rank order, each where it
        lies."""
        views = self.views(s, shape, dtype)
        return [views[q][self.index_of[r]] for r, q in enumerate(self.procs)]

    def reduce_scatter(self, x: torch.Tensor, stream=None) -> torch.Tensor:
        """The reduce-scatter of every rank's rows over dim 1 (``[L, m,
        ...]``, m divisible by p) through the cross-process K3 'rs'
        (``ops.ring_reduce_scatter_xproc``): this process's rows ``[L, m /
        p, ...]`` of the result, each its rank's slice of the sum, bit for
        bit the one-process 'rs' rows on the same ``[p, ...]``. A process
        reduces only its own ranks' segments."""
        from ..ops import ring_kernels

        rows, carrier = self._carried(x)
        n = rows.shape[1]
        s = self.publish(rows, n * rows.element_size(), stream)
        out = ring_kernels.ring_reduce_scatter_xproc(
            self._table(s, (n,), carrier), self.rows_of[self.me], stream=stream)
        self.release(stream)
        return out.to(x.dtype).reshape((self.local, x.shape[1] // self.size) + tuple(x.shape[2:]))

    def allreduce_quant(self, x: torch.Tensor, wire: str, stream=None) -> torch.Tensor:
        """The f32 sum over every rank's rows with ``wire`` ('int8' or
        'bf16') on every hop, through the cross-process K4
        (``ops.ring_allreduce_quant_xproc``): this process's rows of the
        result, bit for bit the one-process K4's rows on the same ``[p,
        ...]`` (each chunk's owner keeps its f32 sum, every other rank the
        wire's decoding, so the rows differ)."""
        from ..ops import ring_kernels

        self._check(x)
        rows = x.reshape(self.local, -1).contiguous()
        n = rows.shape[1]
        s = self.publish(rows, n * rows.element_size(), stream)
        out = ring_kernels.ring_allreduce_quant_xproc(
            self._table(s, (n,), rows.dtype), self.rows_of[self.me], wire, stream=stream)
        self.release(stream)
        return out.reshape(x.shape)

    def reduce_scatter_quant(self, x: torch.Tensor, wire: str, stream=None) -> torch.Tensor:
        """The reduce-scatter of every rank's f32 rows over dim 1 (``[L,
        m, ...]``, m divisible by p) with ``wire`` on every hop, through
        the cross-process K4 'rs' (``ops.ring_reduce_scatter_quant_xproc``):
        this process's rows ``[L, m / p, ...]``, bit for bit the
        one-process K4 'rs' rows. A process walks only its own ranks'
        segments."""
        from ..ops import ring_kernels

        self._check(x)
        rows = x.reshape(self.local, -1).contiguous()
        n = rows.shape[1]
        s = self.publish(rows, n * rows.element_size(), stream)
        out = ring_kernels.ring_reduce_scatter_quant_xproc(
            self._table(s, (n,), rows.dtype), self.rows_of[self.me], wire, stream=stream)
        self.release(stream)
        return out.reshape((self.local, x.shape[1] // self.size) + tuple(x.shape[2:]))

    def allgather(self, x: torch.Tensor, stream=None) -> torch.Tensor:
        """Every rank's block (``x`` ``[L, *s]``) in each of this
        process's rows, ``[L, p, *s]`` in rank order, through the
        cross-process K3 'ag' (``ops.ring_allgather_xproc``), which reads
        each block from the slab where it lies."""
        from ..ops import ring_kernels

        self._check(x)
        x = x.contiguous()
        shape = tuple(x.shape[1:])
        s = self.publish(x, x[0].numel() * x.element_size(), stream)
        out = ring_kernels.ring_allgather_xproc(self._table(s, shape, x.dtype), self.local,
                                                stream=stream)
        self.release(stream)
        return out

    def broadcast(self, x: torch.Tensor, root: int, stream=None) -> torch.Tensor:
        """Rank ``root``'s row in every one of this process's rows through
        the cross-process K7 (``ops.ring_broadcast_xproc``): only the
        root's process stages a row, the root's, and every process reads
        it from that slab."""
        from ..ops import ring_kernels

        self._check(x)
        owner = self.procs[root]
        shape = tuple(x.shape[1:])
        row_bytes = x[0].numel() * x.element_size()
        mine = x[self.index_of[root]:self.index_of[root] + 1].contiguous() \
            if owner == self.me else None
        s = self.publish(mine, row_bytes, stream)
        src = self._view(owner, s, row_bytes, shape, x.dtype)
        out = ring_kernels.ring_broadcast_xproc(src, self.local, stream=stream)
        self.release(stream)
        return out

    def allreduce_bidir(self, x: torch.Tensor, stream=None) -> torch.Tensor:
        """The sum over every rank's rows through the cross-process K5
        (``ops.ring_allreduce_bidir_xproc``): this process's rows of the
        result, bit for bit the one-process K5's rows on the same ``[p,
        ...]``."""
        from ..ops import ring_kernels

        rows, carrier = self._carried(x)
        n = rows.shape[1]
        s = self.publish(rows, n * rows.element_size(), stream)
        out = ring_kernels.ring_allreduce_bidir_xproc(self._table(s, (n,), carrier), self.local,
                                                      stream=stream)
        self.release(stream)
        return out.to(x.dtype).reshape(x.shape)

    def reduce(self, x: torch.Tensor, root: int, stream=None) -> torch.Tensor:
        """The sum over every rank's rows to rank ``root``, every other
        rank keeping its input: in the root's process the cross-process K6
        (``ops.ring_reduce_xproc``) over the rows where they lie, in every
        other process a copy of its input, which reads no peer's slab (it
        publishes its rows and posts its read all the same). Bit for bit
        the one-process K6's rows on the same ``[p, ...]``."""
        from ..ops import ring_kernels

        rows, carrier = self._carried(x)
        n = rows.shape[1]
        s = self.publish(rows, n * rows.element_size(), stream)
        if self.procs[root] == self.me:
            out = ring_kernels.ring_reduce_xproc(self._table(s, (n,), carrier),
                                                 self.rows_of[self.me], root, stream=stream)
            out = out.to(x.dtype).reshape(x.shape)
        else:
            with self._on(stream):
                out = x.clone()
        self.release(stream)
        return out

    def move(self, x: torch.Tensor, src: List[int], stream=None) -> torch.Tensor:
        """Each of this process's rows taken from a source rank's row:
        rank r's row of the result is rank ``src[r]``'s row of ``x``
        (``src`` names a source for every rank of the communicator, the
        same list in every process). A process stages only the rows of its
        ranks that a rank of another process takes, in rank order, and
        reads only the rows its ranks take from another process, each
        from the slab where it lies (sendreceive: only the destination's
        process reads, only the source's row; the group broadcast: the
        roots' rows). Plain copies: it moves bytes, any dtype."""
        self._check(x)
        x = x.contiguous()
        shape = tuple(x.shape[1:])
        row_bytes = x[0].numel() * x.element_size()
        staged = [sorted({s for r, s in enumerate(src) if self.procs[s] == q != self.procs[r]})
                  for q in range(self.plane.count)]
        mine = staged[self.me]
        with self._on(stream):
            rows = torch.stack([x[self.index_of[r]] for r in mine]) if mine else None
        s = self.publish(rows, row_bytes, stream)
        out = torch.empty_like(x)
        with self._on(stream):
            for i, r in enumerate(self.rows_of[self.me]):
                q = self.procs[src[r]]
                if q == self.me:
                    out[i].copy_(x[self.index_of[src[r]]])
                else:
                    at = staged[q].index(src[r])
                    out[i].copy_(self._view(q, s, (at + 1) * row_bytes,
                                            (at + 1,) + shape, x.dtype)[at])
        self.release(stream)
        return out

    def alltoall(self, x: torch.Tensor, stream=None) -> torch.Tensor:
        """The all-to-all of the ``[L, p, ...]`` rows (block s of rank r's
        row is r's block for rank s): block j of each of this process's
        ranks' rows is its block of rank j's row, copied from the slab
        where that row lies. Every process stages its rows; each reads
        only the blocks its ranks receive. Plain copies, any dtype."""
        self._check(x)
        x = x.contiguous()
        shape = tuple(x.shape[1:])
        s = self.publish(x, x[0].numel() * x.element_size(), stream)
        out = torch.empty_like(x)
        with self._on(stream):
            mine = torch.tensor(self.rows_of[self.me], device=x.device)
            for q, (rows, part) in enumerate(zip(self.rows_of, self.views(s, shape, x.dtype))):
                if not rows:
                    continue
                src = x if q == self.me else part
                # out[i, rows[j]] = src[j, mine[i]]: this process's blocks of q's rows
                blocks = src.index_select(1, mine).transpose(0, 1)
                if rows == list(range(rows[0], rows[0] + len(rows))):
                    out[:, rows[0]:rows[0] + len(rows)].copy_(blocks)
                else:
                    out.index_copy_(1, torch.tensor(rows, device=x.device), blocks)
        self.release(stream)
        return out
