"""Sharded parameter server: device-memory shards + async client protocol.

The single-process port of ``torchmpi_tpu/parameterserver/server.py``
(the reference's ``lib/parameterserver.cpp``, N10). Each tensor is sharded
uniformly over the communicator's ranks (``shard_range``, with the JAX
package's per-instance rotation of the remainder); clients post a rule
name and their slice to every server's mailbox, a single global polling
thread (100 µs cadence) applies the named update rules, and triggers
request shards back (``parameterserver.cpp:296-541,641-663``). Client
``send``/``receive`` run on the parameter-server thread pool and return
future :class:`SyncHandle`\\ s (``resources.cpp:399-434``).

The port's ranks are rows of one card's memory, so the shards live on the
communicator's device, as views of one flat tensor per instance, and the
rules run there: the 'add' rule through the accumulate kernel (K1) or,
with a scale, the scaled-accumulate kernel (K2), in place. That takes the
place of the JAX package's host numpy shards and of its optional native
store. Sends and fetches stay in device memory.

Streams. The polling thread and the pool threads each have their own
current CUDA stream, so every instance owns one stream, and everything
that touches its shards is enqueued there in order:

- ``send`` copies (and, under a compressed wire, scales and round-trips)
  the payload on the caller's stream and records an event; the apply waits
  on that event on the instance stream;
- when every shard has applied, the pool thread records an event on the
  instance stream and the send's handle completes with it, so ``wait()``
  orders the caller's stream after the applies. "Applied", the JAX send
  handle's contract (``server.py:1114-1118``), means enqueued in order on
  the instance stream;
- a trigger clones its shard on the instance stream, the pool thread
  assembles the tensor there, and the receive's handle makes the caller's
  stream wait on the event recorded after it.

A send and a fetch each post to every server's mailbox under one lock
(``_Instance.post_all``), so a fetch assembles one version of the whole
tensor, never shards of two (the serving tier's snapshots rely on it).
``receive``/``prefetch`` take the JAX package's ``read_policy``; with no
replica chain in one process it routes nothing.

Waiting for a later PR (ROADMAP A7's rest): owners in another process (the
socket transport), replication chains and ``reform``, the shm lane, delta
fetches and the native store. A communicator whose ranks span processes
raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future, TimeoutError as FuturesTimeoutError
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from .. import constants
from ..runtime.communicator import Communicator
from ..runtime.handles import StreamResult, SyncHandle
from ..runtime.pools import parameterserver_pool
from . import wire as _wire
from .rules import UPDATE_RULES

_POLL_INTERVAL_S = 100e-6  # the reference server's 100us scan cadence

# Bounded in-flight client ops (kNumAsyncParameterServersInFlight,
# lib/constants.cpp:152-155): enqueue blocks on the oldest op when full.
_inflight_lock = threading.Lock()
_inflight: deque = deque()


def _submit_bounded(fn) -> Future:
    limit = constants.get("num_async_parameterservers_in_flight")
    with _inflight_lock:
        while _inflight and _inflight[0].done():
            _inflight.popleft()
        while len(_inflight) >= limit:
            oldest = _inflight.popleft()
            _inflight_lock.release()
            try:
                # drain only: a failed older op's exception belongs to its
                # own handle, not to this unrelated enqueue
                oldest.exception()
            finally:
                _inflight_lock.acquire()
            while _inflight and _inflight[0].done():
                _inflight.popleft()
        f = parameterserver_pool.submit(fn)
        _inflight.append(f)
    return f


def shard_range(n: int, size: int, rank: int, rotation: int = 0) -> Tuple[int, int]:
    """Uniform shard [start, end) of an n-element tensor for ``rank`` of
    ``size`` (``getRange``, ``parameterserver.cpp:282-294``). The
    ``n % size`` remainder elements land on the cyclic rank interval
    ``[rotation, rotation + extra)``; instances rotate it by their id, so a
    group of instances does not pile every remainder onto server 0."""
    base, extra = divmod(n, size)
    if extra == 0 or size == 1:
        return rank * base, (rank + 1) * base
    rot = rotation % size
    end = rot + extra
    # extras carried by ranks < rank: the cyclic interval [rot, end)
    before = max(0, min(rank, min(end, size)) - rot)
    if end > size:
        before += min(rank, end - size)
    has_extra = ((rank - rot) % size) < extra
    start = rank * base + before
    return start, start + base + (1 if has_extra else 0)


@dataclass
class _Message:
    kind: str  # 'update' | 'trigger'
    client: int
    rule: Optional[str] = None
    payload: Optional[torch.Tensor] = None
    # the 'add' rule's scale, applied server-side by the fused kernel
    scale: Optional[float] = None
    # recorded on the sender's stream after the payload was made
    ready: Optional[torch.cuda.Event] = None
    done: Optional[threading.Event] = None  # update: server-applied event
    reply: Optional[Future] = None  # trigger: fulfilled with a shard copy
    # apply failure message, readable after `done` is set
    error: Optional[str] = None


def _on(stream: Optional[torch.cuda.Stream]):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _record(stream: Optional[torch.cuda.Stream]) -> Optional[torch.cuda.Event]:
    if stream is None:
        return None
    event = torch.cuda.Event()
    event.record(stream)
    return event


class _Instance:
    """Server-side state of one ParameterServer: per-rank shards (views of
    one flat tensor on the device), mailboxes, versions, and the stream
    every apply and read of the shards is enqueued on."""

    def __init__(self, instance_id: int, flat: torch.Tensor, shape: Tuple[int, ...],
                 size: int):
        self.id = instance_id
        self.shape = shape
        self.dtype = flat.dtype
        self.size = size
        self.device = flat.device
        # remainder placement rotated per instance (see shard_range)
        self.shard_rotation = instance_id % size
        self.ranges = [
            shard_range(flat.shape[0], size, r, self.shard_rotation) for r in range(size)
        ]
        self.stream = torch.cuda.Stream(flat.device) if flat.is_cuda else None
        if self.stream is not None:
            # the storage was written on the creator's stream and lives on
            # this one from now on
            self.stream.wait_stream(torch.cuda.current_stream(flat.device))
            flat.record_stream(self.stream)
        self._shards = [flat[s:e] for s, e in self.ranges]
        # applied updates per shard (the JAX version vector)
        self.versions: List[int] = [0] * size
        self.mailboxes: List[deque] = [deque() for _ in range(size)]
        self.locks = [threading.Lock() for _ in range(size)]
        # held while one send or receive posts to every mailbox (see
        # post_all)
        self.post_lock = threading.Lock()
        self.freed = False

    def apply_rule(self, r: int, rule: str, payload: torch.Tensor,
                   scale: Optional[float] = None) -> None:
        UPDATE_RULES[rule](self._shards[r], payload, scale)

    def read_shard(self, r: int) -> torch.Tensor:
        """A copy of shard ``r``, enqueued on the current stream."""
        return self._shards[r].clone()

    def post(self, server_rank: int, msg: _Message) -> None:
        with self.locks[server_rank]:
            if self.freed:
                # never strand a waiter on a freed instance
                if msg.done is not None:
                    msg.done.set()
                if msg.reply is not None:
                    msg.reply.set_exception(RuntimeError("parameter server freed"))
                return
            self.mailboxes[server_rank].append(msg)

    def post_all(self, msgs: List[_Message]) -> None:
        """Post ``msgs[r]`` to server ``r``, for every r, with no other
        send's or receive's posts between them: every mailbox then holds
        sends and fetches in one order, so a fetch assembles the state
        after one prefix of the applied sends, the same on every shard.
        The JAX package posts shard by shard, and a fetch racing a send
        may mix the versions of shards there; the serving tier's
        snapshots are whole versions here."""
        with self.post_lock:
            for r, msg in enumerate(msgs):
                self.post(r, msg)

    def serve_once(self) -> bool:
        """Drain every mailbox once; returns True if any work was done
        (``serverReceive``, ``parameterserver.cpp:404-541``)."""
        worked = False
        for r in range(self.size):
            while True:
                with self.locks[r]:
                    if not self.mailboxes[r]:
                        break
                    msg = self.mailboxes[r].popleft()
                worked = True
                if msg.kind == "update":
                    try:
                        if msg.rule not in UPDATE_RULES:
                            raise KeyError(f"unknown update rule {msg.rule!r}")
                        with _on(self.stream):
                            if self.stream is not None:
                                self.stream.wait_event(msg.ready)
                                # made on the sender's stream, read on this one
                                msg.payload.record_stream(self.stream)
                            self.apply_rule(r, msg.rule, msg.payload, msg.scale)
                        self.versions[r] += 1
                    except Exception as e:
                        # never kill the shared server thread, never strand
                        # the sender: the failure travels in msg.error
                        traceback.print_exc()
                        msg.error = f"{type(e).__name__}: {e}"
                    finally:
                        msg.done.set()
                elif msg.kind == "trigger":
                    try:
                        with _on(self.stream):
                            msg.reply.set_result(self.read_shard(r))
                    except Exception as e:  # fulfil with the error
                        msg.reply.set_exception(e)
        return worked


class _GlobalServer:
    """The single polling thread scanning all PS instances
    (``launchParameterServer``, ``parameterserver.cpp:641-663``).

    Update rules are applied only by the polling thread, or inline by
    :meth:`shutdown` / :meth:`unregister` strictly after that thread has
    exited, so two threads never mutate one shard. Freed instances go to a
    *doomed* list that the polling thread drains (serving what arrived,
    failing stragglers), so no client blocks on a message nobody serves.
    """

    def __init__(self):
        self._instances: Dict[int, _Instance] = {}
        self._doomed: List[_Instance] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._terminate = threading.Event()
        self._ids = itertools.count()

    def register(self, flat: torch.Tensor, shape: Tuple[int, ...], size: int) -> _Instance:
        with self._lock:
            inst = _Instance(next(self._ids), flat, shape, size)
            self._instances[inst.id] = inst
            # clear terminate under the lock whether or not a thread is
            # spawned: an old thread winding down then either keeps serving
            # or has already marked itself dead and a fresh one starts
            self._terminate.clear()
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="tm-ps-server", daemon=True
                )
                self._thread.start()
            return inst

    @staticmethod
    def _drain(inst: _Instance) -> None:
        """Serve what arrived, then fail any racing stragglers."""
        inst.freed = True  # post() completes everything from here on
        inst.serve_once()
        for r in range(inst.size):
            with inst.locks[r]:
                while inst.mailboxes[r]:
                    msg = inst.mailboxes[r].popleft()
                    if msg.done is not None:
                        msg.done.set()
                    if msg.reply is not None:
                        msg.reply.set_exception(RuntimeError("parameter server freed"))

    def unregister(self, inst: _Instance) -> None:
        inst.freed = True  # send()/receive() reject from now on
        with self._lock:
            self._instances.pop(inst.id, None)
            thread_live = (
                self._thread is not None
                and self._thread.is_alive()
                and not self._terminate.is_set()
            )
            if thread_live:
                self._doomed.append(inst)  # the polling thread drains it
            if not self._instances:
                self._terminate.set()
        if not thread_live:
            self._drain(inst)

    def _loop(self):
        while True:
            with self._lock:
                doomed = self._doomed
                self._doomed = []
                instances = list(self._instances.values())
                stop = self._terminate.is_set() and not doomed
                if stop and self._thread is threading.current_thread():
                    # mark dead under the lock so a concurrent register()
                    # spawns a fresh thread
                    self._thread = None
            if stop:
                return
            worked = bool(doomed)
            for inst in doomed:
                self._drain(inst)
            for inst in instances:
                worked |= inst.serve_once()
            if not worked and not self._terminate.is_set():
                time.sleep(_POLL_INTERVAL_S)

    def shutdown(self):
        """Stop serving: join the polling thread, then drain everything
        (``torch_mpi.cpp:287-292``). Draining happens strictly after the
        join, and in-flight client ops are completed or failed, never
        stranded."""
        with self._lock:
            self._doomed.extend(self._instances.values())
            self._instances.clear()
            self._terminate.set()
            thread = self._thread
            self._thread = None
        if thread is not None and thread.is_alive():
            thread.join(timeout=5)
        with self._lock:
            doomed = self._doomed
            self._doomed = []
        for inst in doomed:
            self._drain(inst)


_server = _GlobalServer()


def _timeout() -> Optional[float]:
    return constants.get("deadlock_timeout_seconds") or None


def _resolve_read_policy(read_policy: Optional[str]) -> str:
    """A fetch's read policy: ``read_policy``, else the ``ps_read_policy``
    knob (``Transport.trigger``'s resolution in the JAX package)."""
    return str(read_policy or constants.get("ps_read_policy"))


class ParameterServer:
    """One sharded tensor distributed over a communicator's ranks, its
    shards on the communicator's device.

    Clients are communicator ranks. ``send``/``receive`` are asynchronous
    (run on the PS thread pool) and return :class:`SyncHandle`\\ s; a
    receive's ``wait()`` returns the assembled tensor."""

    def __init__(self, initial_value, comm: Optional[Communicator] = None):
        if comm is None:
            from .. import runtime_state

            comm = runtime_state.current_communicator()
        if comm.num_nodes() > 1:
            raise NotImplementedError(
                "a parameter server over ranks in several processes needs the "
                "socket transport (ROADMAP A7's rest, over the processes of ROADMAP A13)"
            )
        self.comm = comm
        full = torch.as_tensor(initial_value)
        # the reference instantiates Float and Double only
        dtype = full.dtype if full.dtype in (torch.float32, torch.float64) else torch.float32
        self.shape = tuple(full.shape)
        self.dtype = dtype
        self.numel = full.numel()
        flat = full.detach().to(device=comm.device, dtype=dtype).reshape(-1).clone()
        self._inst = _server.register(flat, self.shape, comm.size)
        # client-side prefetch: per-client queues of in-flight receive()
        # handles, at most `depth` outstanding per client
        self._prefetch_lock = threading.Lock()
        self._prefetch_q: Dict[int, deque] = {}

    # ------------------------------------------------------------------
    def send(self, values, rule: str = "add", client: int = 0,
             scale: Optional[float] = None) -> SyncHandle:
        """Apply ``rule`` with this client's ``values`` to every shard
        (``clientSend``, ``parameterserver.cpp:309-353``). The handle
        completes when every server has applied the update, in order on
        the instance stream.

        ``scale`` multiplies the values. Under the full wire an 'add' with
        a scale is applied by the fused kernel, ``shard + scale * values``
        rounded once; under a compressed wire the client scales first, so
        the quantizer sees the values the JAX package quantizes."""
        if rule not in UPDATE_RULES:
            raise KeyError(f"unknown update rule {rule!r} (have {sorted(UPDATE_RULES)})")
        inst = self._inst
        if inst.freed:
            raise RuntimeError("parameter server already freed")
        values = torch.as_tensor(values)
        flat = values.detach().to(device=inst.device, dtype=self.dtype).reshape(-1)
        if flat.shape[0] != self.numel:
            raise ValueError(f"send expects {self.numel} elements, got {flat.shape[0]}")
        wcode = _wire.resolve_ps_wire(self.dtype)
        fused = scale is not None and rule == "add" and wcode == _wire.WIRE_FULL
        if scale is not None and not fused:
            flat = flat * scale
        elif flat.data_ptr() == values.data_ptr():
            # own the buffer now: the apply runs later, on another stream
            flat = flat.clone()
        payloads = [flat[s:e] for s, e in inst.ranges]
        if wcode != _wire.WIRE_FULL:
            # the in-process exchange honours the wire precision: a shard
            # sees what a socket peer would decode
            block = constants.get("wire_quant_block_size")
            payloads = [_wire.roundtrip(p, wcode, block) for p in payloads]
        ready = _record(torch.cuda.current_stream(inst.device) if inst.stream else None)
        msg_scale = scale if fused else None

        def do_send():
            events = [_Message("update", client=client, rule=rule, payload=payloads[r],
                               scale=msg_scale, ready=ready, done=threading.Event())
                      for r in range(inst.size)]
            inst.post_all(events)
            timeout = _timeout()
            for msg in events:
                if not msg.done.wait(timeout):
                    # the reference's spin-abort failure detector
                    raise RuntimeError(
                        f"parameter-server send blocked > {timeout}s "
                        "(possible deadlock: server thread dead or "
                        "mismatched collective ordering)"
                    )
                if msg.error is not None:
                    raise RuntimeError(f"parameter-server update failed: {msg.error}")
            return StreamResult(None, _record(inst.stream))

        return SyncHandle(future=_submit_bounded(do_send))

    def receive(self, client: int = 0, read_policy: Optional[str] = None) -> SyncHandle:
        """Fetch the full tensor: trigger every server, assemble the shards
        (``clientReceive``, ``parameterserver.cpp:356-400``); ``wait()``
        returns it on the communicator's device, a tensor of its own that
        later sends leave as it is. A fetch already in flight for
        ``client`` (see :meth:`prefetch`) is consumed first.

        ``read_policy`` overrides the ``ps_read_policy`` knob for this
        fetch (``owner``/``replica``/``adaptive``; any other value reads as
        ``owner``, as in the JAX package). It routes a fetch over a shard's
        replica chain; every shard of the port's parameter server is in
        this process, with no chain, so the policy routes nothing until
        the socket transport lands (ROADMAP A7's rest)."""
        _resolve_read_policy(read_policy)  # resolved as in JAX; routes nothing yet
        if self._inst.freed:
            raise RuntimeError("parameter server already freed")
        with self._prefetch_lock:
            q = self._prefetch_q.get(client)
            if q:
                return q.popleft()
        return self._issue_receive(client)

    def prefetch(self, client: int = 0, depth: int = 2,
                 read_policy: Optional[str] = None) -> SyncHandle:
        """Start the next :meth:`receive` now, double-buffered per client:
        at most ``depth`` fetches outstanding (further calls return the
        oldest queued handle). The next ``receive(client)`` consumes the
        oldest in-flight fetch. ``read_policy`` as in :meth:`receive`."""
        _resolve_read_policy(read_policy)  # resolved as in JAX; routes nothing yet
        if self._inst.freed:
            raise RuntimeError("parameter server already freed")
        with self._prefetch_lock:
            q = self._prefetch_q.setdefault(client, deque())
            if len(q) >= max(1, depth):
                return q[0]
            h = self._issue_receive(client)
            q.append(h)
            return h

    def _issue_receive(self, client: int) -> SyncHandle:
        inst = self._inst
        shape = self.shape

        def do_receive():
            wcode = _wire.resolve_ps_wire(inst.dtype)
            replies = [Future() for _ in range(inst.size)]
            inst.post_all([_Message("trigger", client=client, reply=f) for f in replies])
            timeout = _timeout()
            shards = []
            for f in replies:
                try:
                    shards.append(f.result(timeout))
                except FuturesTimeoutError:
                    raise RuntimeError(
                        f"parameter-server receive blocked > {timeout}s "
                        "(possible deadlock: server thread dead or "
                        "mismatched collective ordering)"
                    ) from None
            with _on(inst.stream):
                if wcode != _wire.WIRE_FULL:
                    # the local client reads what a socket peer would decode
                    block = constants.get("wire_quant_block_size")
                    shards = [_wire.roundtrip(s, wcode, block) for s in shards]
                out = torch.cat(shards).reshape(shape)
            return StreamResult(out, _record(inst.stream))

        return SyncHandle(future=_submit_bounded(do_receive))

    def free(self) -> None:
        """Free the instance (``parameterserver.cpp:735-745``)."""
        _server.unregister(self._inst)

    @property
    def freed(self) -> bool:
        return self._inst.freed

    def shard_of(self, rank: int) -> torch.Tensor:
        """Introspection copy of a rank's shard, ordered after every apply
        enqueued so far. Raises after free()."""
        inst = self._inst
        if inst.freed:
            raise RuntimeError("parameter server freed")
        with _on(inst.stream):
            shard = inst.read_shard(rank)
            event = _record(inst.stream)
        return SyncHandle(shard, event).wait()


def free_all() -> None:
    """Free every parameter server and stop the polling thread."""
    _server.shutdown()
