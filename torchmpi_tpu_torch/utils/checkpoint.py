"""Checkpoint and resume of the engine and of parameter servers.

The port of ``torchmpi_tpu/utils/checkpoint.py``. The reference has no
checkpointing (SURVEY.md §5: users relied on ``torch.save``); the JAX
package added it, and the port keeps its formats.

A checkpoint holds the engine's **logical** state: each leaf of
``params``, ``opt_state`` and ``model_state`` as one array in the port's
own orientation (dense kernels ``[out, in]``, conv kernels OIHW;
``models.convert``), not the live rank-stacked ``[p, ...]`` tensors:

- a rank-stacked leaf is stored as rank 0's row and restored to every
  rank. Under a compressed wire (``wire_dtype`` 'int8' or 'bf16') the
  replicas differ by the wire's rounding, as in the JAX engine, so a
  restore puts rank 0's values on every rank;
- under ``'fsdp'``/``'zero1'`` a sharded leaf lives as ``[p, n / p]``
  shards, rank r's the r-th p-th of the leaf's row-major flattening,
  which is what ``reshard.Layout(p)`` cuts; its logical value is the
  shards' concatenation;
- a scalar leaf (``Adam``'s step count) is stored as a 0-d int64 array.

Two formats:

- the **portable sharded** format, ``tmsc1``
  (:func:`save_engine_sharded` / :func:`restore_engine_sharded` /
  :func:`reshape_sharded`), the JAX package's format unchanged on disk:
  one ``.npy`` per (leaf, shard rank) under a contiguous
  :class:`~..reshard.Layout`, a ``meta.json`` header (format, step, mode,
  world, sharding, structure fingerprint, one record per leaf), published
  through an atomic ``CURRENT`` pointer (temp dir, fsync, rename: a save
  killed at any point leaves the previous checkpoint intact). So the JAX
  package's ``read_sharded_meta`` and ``reshape_sharded`` read and
  reshape a port checkpoint; a cross-package *restore* is not a goal,
  since the two packages' leaves and fingerprints differ. Trees are
  sharded as in the JAX engine (:func:`_sharded_trees`); an N-way
  checkpoint restores onto an M-way engine through the reshard
  planner, or is reshaped offline with bounded memory
  (``python -m torchmpi_tpu_torch.reshard``).
- the **single-process** format (:func:`save_engine` /
  :func:`restore_engine`): the same atomically written ``meta.json``
  header, and the host state in one ``torch.save`` file where the JAX
  package uses orbax. Cooperative multi-process saves are ROADMAP A13's rest.

Parameter-server centers save and restore through
:func:`save_parameter_servers` / :func:`restore_parameter_servers`.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

SHARDED_FORMAT = "tmsc1"


class CheckpointMismatchError(RuntimeError):
    """A checkpoint's layout header disagrees with the restore target.

    Raised BEFORE any state is touched, naming the mismatched field."""


# --- the engine's logical leaves ---------------------------------------------
def _walk(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``(key path, leaf)`` pairs of a tree of dicts, lists and tuples in
    ``jax.tree_util`` order (dict keys sorted, ``None`` no leaf), each
    path as ``jax.tree_util.keystr`` writes it (``['mu']['fc.weight']``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _walk(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _walk(v, f"{path}[{i}]")]
    return [(path, tree)]


def _rebuild(tree, leaf_fn: Callable[[str, Any], Any], path: str = ""):
    """``tree`` with every leaf replaced by ``leaf_fn(path, leaf)``, in
    :func:`_walk`'s order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaf_fn, f"{path}[{k!r}]") for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf_fn, f"{path}[{i}]") for i, v in enumerate(tree))
    return leaf_fn(path, tree)


def _live_trees(engine) -> Dict[str, Any]:
    trees = {"params": engine.params, "opt_state": engine.opt_state}
    if engine.model_state is not None:
        trees["model_state"] = engine.model_state
    return trees


def _leaf_name(path: str) -> str:
    """The last key of a path: the parameter name that keys a leaf of
    ``params`` and of every per-parameter optimizer tree."""
    return path[path.rfind("[") + 2:-2] if path.endswith("']") else ""


def _is_shard(engine, path: str, leaf) -> bool:
    """Whether a live leaf is a sharded leaf's ``[p, n / p]`` shards (and
    not its whole rank-stacked value)."""
    name = _leaf_name(path)
    return name in engine._sharded and tuple(leaf.shape) != engine._shapes[name]


def _logical_shape(engine, path: str, leaf) -> Tuple[int, ...]:
    if not isinstance(leaf, torch.Tensor):
        return ()
    if _is_shard(engine, path, leaf):
        return engine._shapes[_leaf_name(path)][1:]
    return tuple(leaf.shape[1:])


def _dtype_token(leaf) -> str:
    return str(leaf.dtype) if isinstance(leaf, torch.Tensor) else type(leaf).__name__


def _host_leaf(engine, path: str, leaf):
    """One live leaf's logical value on the host: a CPU tensor, or the
    scalar as it is."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    if _is_shard(engine, path, leaf):
        return leaf.detach().reshape(_logical_shape(engine, path, leaf)).cpu()
    return leaf.detach()[0].cpu()


def host_state(engine) -> Dict[str, Any]:
    """The engine's logical state copied to host memory: ``{"params",
    "opt_state"[, "model_state"]}``, each leaf a CPU tensor (or a scalar).
    One device-to-host copy a leaf, synchronous: what
    ``checkpoint_every`` takes on the step thread."""
    return {name: _rebuild(tree, lambda path, leaf: _host_leaf(engine, path, leaf))
            for name, tree in _live_trees(engine).items()}


def _describe(trees: Dict[str, Any], shape_of: Callable[[str, Any], Tuple[int, ...]]) -> list:
    return [(f"[{name!r}]{path}", tuple(shape_of(path, leaf)), _dtype_token(leaf))
            for name in sorted(trees) for path, leaf in _walk(trees[name])]


def _fingerprint(desc: list) -> str:
    """Structure fingerprint: per-leaf (path, logical shape, dtype). Two
    engines with the same fingerprint can exchange checkpoints; a mismatch
    names what diverged (model width, optimizer kind)."""
    return hashlib.sha1(repr(desc).encode()).hexdigest()[:12]


def _engine_fingerprint(engine) -> str:
    return _fingerprint(_describe(_live_trees(engine),
                                  lambda path, leaf: _logical_shape(engine, path, leaf)))


def _state_fingerprint(state: Dict[str, Any]) -> str:
    return _fingerprint(_describe(state, lambda path, leaf: tuple(np.shape(leaf))))


def _to_numpy(leaf) -> np.ndarray:
    """A host leaf as the array its ``.npy`` files hold: bfloat16 as its
    16-bit patterns (numpy has no bfloat16), a scalar as a 0-d array."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf, dtype=np.int64 if isinstance(leaf, int) else np.float64)
    leaf = leaf.detach().cpu().contiguous()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(np.uint16)
    return leaf.numpy()


def _from_numpy(arr: np.ndarray, rec: dict):
    """The inverse of :func:`_to_numpy` for a leaf whose record says
    ``torch_dtype``."""
    token = rec.get("torch_dtype", "")
    if not token.startswith("torch."):
        value = arr.reshape(()).item()
        return int(value) if token == "int" else value
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if token == "torch.bfloat16":
        return t.view(torch.int16).view(torch.bfloat16)
    return t


# --- atomic file writes ---------------------------------------------------------
def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
    except OSError:
        pass


def _atomic_write_text(path: Path, text: str) -> None:
    """temp + fsync + rename: readers see the old bytes or the new bytes,
    never a torn file, and a crash mid-write leaves the old file."""
    tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}")
    tmp.write_text(text)
    _fsync_file(tmp)
    os.replace(tmp, path)
    _fsync_dir(path.parent)  # land the rename itself before callers rely on it


# --- the layout header ----------------------------------------------------------
def _layout_meta(engine, step: int, extra: Optional[Dict],
                 state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    return {
        "step": int(step),
        "mode": engine.mode,
        "world": int(engine.comm.size),
        "sharding": engine.param_sharding,
        "fingerprint": (_engine_fingerprint(engine) if state is None
                        else _state_fingerprint(state)),
        **(extra or {}),
    }


def _check_layout(meta: Dict[str, Any], engine, path,
                  allow_world_mismatch: bool = False) -> None:
    """Validate a checkpoint header against the restore target, naming
    the first mismatch."""
    want_fp = _engine_fingerprint(engine)
    if meta.get("fingerprint") and meta["fingerprint"] != want_fp:
        raise CheckpointMismatchError(
            f"checkpoint {path} was saved from a different model/optimizer "
            f"structure (fingerprint {meta['fingerprint']} != engine "
            f"{want_fp}): same architecture + optimizer required"
        )
    if meta.get("sharding") and meta["sharding"] != engine.param_sharding:
        raise CheckpointMismatchError(
            f"checkpoint {path} holds param_sharding="
            f"{meta['sharding']!r} state but the engine runs "
            f"{engine.param_sharding!r}; rebuild the engine with "
            f"param_sharding={meta['sharding']!r} (the portable sharded "
            "format reshapes world sizes, not sharding strategies)"
        )
    world = meta.get("world")
    if (
        not allow_world_mismatch
        and world is not None
        and int(world) != engine.comm.size
        and engine.param_sharding != "replicated"  # replicated state is
        # world-independent: the same logical arrays land on any world
    ):
        raise CheckpointMismatchError(
            f"checkpoint {path} was saved from a {world}-way world but "
            f"this engine spans {engine.comm.size} ranks; reshape it "
            f"(`python -m torchmpi_tpu_torch.reshard --from {world} "
            f"--to {engine.comm.size} <ckpt> <out>`) or use "
            "restore_engine_sharded, which reshards transparently"
        )


def _install(engine, values: Dict[str, Dict[str, Any]]) -> None:
    """Put restored values on the engine: ``values[tree][path]`` is a
    sharded leaf's ``[p, n / p]`` shards (where the live leaf is one), a
    leaf's logical value (replicated to every rank), or a scalar."""
    p, dev = engine.comm.size, engine.comm.device

    def leaf_fn(tree_name):
        def put(path, cur):
            new = values[tree_name][path]
            if not isinstance(cur, torch.Tensor):
                return new
            new = new.to(dev, cur.dtype)
            if _is_shard(engine, path, cur):
                return new.reshape(cur.shape).contiguous()
            return new.unsqueeze(0).repeat((p,) + (1,) * new.ndim)
        return put

    trees = _live_trees(engine)
    restored = {name: _rebuild(tree, leaf_fn(name)) for name, tree in trees.items()}
    engine.params = restored["params"]
    engine.opt_state = restored["opt_state"]
    if "model_state" in restored:
        engine.model_state = restored["model_state"]


def _single_process_only(what: str) -> None:
    from .. import runtime_state

    if runtime_state.num_processes() > 1:
        raise RuntimeError(
            f"{what} is single-process only: cooperative multi-process saves "
            "are ROADMAP A13's rest"
        )


# --- the single-process format --------------------------------------------------
def save_engine(path, engine, step: int = 0, extra: Optional[Dict] = None) -> None:
    """Save the engine's logical state (:func:`host_state`) as one
    ``torch.save`` file ``state.pt`` (written to a temp name, fsync'd and
    renamed), then the ``meta.json`` header (world size, sharding, step,
    structure fingerprint), atomically and LAST, so a save killed
    mid-write never publishes a header whose state is torn."""
    _single_process_only("save_engine")
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    state = host_state(engine)
    tmp = path / f"state.pt.tmp-{os.getpid()}"
    torch.save(state, tmp)
    _fsync_file(tmp)
    os.replace(tmp, path / "state.pt")
    _atomic_write_text(path / "meta.json",
                       json.dumps(_layout_meta(engine, step, extra, state=state)))


def restore_engine(path, engine) -> Dict[str, Any]:
    """Restore state saved by :func:`save_engine` into the engine, each
    leaf in its live placement (shards stay shards). The header is
    validated FIRST: a checkpoint from another world size (for sharded
    state), sharding mode or model structure raises
    :class:`CheckpointMismatchError` naming the mismatch, before any of
    the engine's state is touched. Returns the header (with ``step``)."""
    _single_process_only("restore_engine")
    path = Path(path).resolve()
    meta = json.loads((path / "meta.json").read_text())
    _check_layout(meta, engine, path)
    state = torch.load(path / "state.pt", weights_only=True)
    values = {name: dict(_walk(tree)) for name, tree in state.items()}
    _install(engine, values)
    return meta


# --- the portable sharded format ------------------------------------------------
def _sharded_trees(engine) -> Dict[str, str]:
    """tree name -> 'sharded' | 'replicated' under the engine's mode (the
    JAX package's table): fsdp shards params and optimizer state, zero1
    only the optimizer state, replicated engines nothing; the model
    state follows the parameters."""
    kind = {
        "fsdp": {"params": "sharded", "opt_state": "sharded"},
        "zero1": {"params": "replicated", "opt_state": "sharded"},
        "replicated": {"params": "replicated", "opt_state": "replicated"},
    }[engine.param_sharding]
    out = dict(kind)
    if engine.model_state is not None:
        out["model_state"] = kind["params"]
    return out


def _leaf_records(state: Dict[str, Any], kinds: Dict[str, str]) -> List[dict]:
    records = []
    for tree_name in sorted(state):
        for path, leaf in _walk(state[tree_name]):
            arr = _to_numpy(leaf)
            records.append({
                "tree": tree_name,
                "path": path,
                "shape": list(arr.shape),
                "dtype": arr.dtype.str,
                "n": int(arr.size),
                "kind": kinds[tree_name],
                "torch_dtype": _dtype_token(leaf),
            })
    return records


def _shard_file(data_dir: Path, leaf_idx: int, rank: Optional[int]) -> Path:
    name = (
        f"leaf{leaf_idx}.full.npy" if rank is None
        else f"leaf{leaf_idx}.rank{rank}.npy"
    )
    return data_dir / name


def current_data_dir(path) -> Path:
    """The live data directory a sharded checkpoint's CURRENT points at."""
    path = Path(path).resolve()
    cur = (path / "CURRENT").read_text().strip()
    return path / cur


def read_sharded_meta(path) -> Dict[str, Any]:
    meta = json.loads((current_data_dir(path) / "meta.json").read_text())
    if meta.get("format") != SHARDED_FORMAT:
        raise CheckpointMismatchError(
            f"{path} is not a {SHARDED_FORMAT} sharded checkpoint "
            f"(format={meta.get('format')!r})"
        )
    return meta


def save_engine_sharded(
    path, engine, step: int = 0, extra: Optional[Dict] = None,
    world: Optional[int] = None, state: Optional[Dict[str, Any]] = None,
) -> Path:
    """Save the engine's state as a portable sharded checkpoint.

    Every leaf of a sharded tree is flattened and cut into ``world``
    contiguous shards (:class:`~..reshard.Layout`, byte-identical to what a
    fresh ``world``-way scatter would place on each rank; under
    ``'fsdp'`` with ``world`` the engine's, a sharded leaf's shard files
    are its live shards); a replicated tree stores ONE full copy of each
    leaf. All files land in a fresh ``data-<token>/`` directory, fsync'd,
    and only then does the atomic ``CURRENT`` pointer swing to it; the
    superseded data dir and any orphaned temp dirs are removed after the
    swing, and the checkpoint is registered as the newest rollback
    artifact (:func:`~..supervise.checkpoints.register_checkpoint`).

    ``state`` is a :func:`host_state` taken earlier: the engine's
    ``checkpoint_every`` takes it on the step thread and writes the files
    on a background thread, so a save never serializes a tree the next
    step already replaced."""
    from ..reshard import Layout

    _single_process_only("save_engine_sharded")
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    world = int(world or engine.comm.size)
    state = host_state(engine) if state is None else state
    kinds = _sharded_trees(engine)
    records = _leaf_records(state, kinds)
    meta = {
        "format": SHARDED_FORMAT,
        **_layout_meta(engine, step, extra, state=state),
        "world": world,
        "leaves": records,
    }
    token = secrets.token_hex(4)
    data_dir = path / f"data-{token}"
    tmp_dir = path / f".tmp-{token}"
    tmp_dir.mkdir()
    leaves = [leaf for tree_name in sorted(state) for _, leaf in _walk(state[tree_name])]
    layout = Layout(world)
    for i, (rec, leaf) in enumerate(zip(records, leaves)):
        flat = _to_numpy(leaf).reshape(-1)
        if rec["kind"] == "replicated":
            files = [(_shard_file(tmp_dir, i, None), flat)]
        else:
            files = [
                (_shard_file(tmp_dir, i, r), flat[s:e])
                for r, (s, e) in enumerate(layout.intervals(rec["n"]))
            ]
        for f, data in files:
            np.save(f, data)
            _fsync_file(f)
    (tmp_dir / "meta.json").write_text(json.dumps(meta))
    _fsync_file(tmp_dir / "meta.json")
    os.replace(tmp_dir, data_dir)  # the complete payload becomes visible
    prev = None
    try:
        prev = current_data_dir(path)
    except (OSError, ValueError):
        pass
    _atomic_write_text(path / "CURRENT", data_dir.name)
    from ..supervise import checkpoints as _registry

    _registry.register_checkpoint(path, step)
    # remove the superseded payload and the temp dirs of saves that died
    # before publishing, only AFTER the pointer swung
    for stale in list(path.glob(".tmp-*")) + (
        [prev] if prev is not None and prev != data_dir else []
    ):
        if stale.name != data_dir.name:
            shutil.rmtree(stale, ignore_errors=True)
    return data_dir


def _read_leaf(data_dir: Path, leaf_idx: int, rec: dict, world: int, dst_world: int,
               chunk_bytes: Optional[int] = None) -> np.ndarray:
    """One leaf of a sharded checkpoint as ``[dst_world, n / dst_world]``
    rows of its flattening (``dst_world`` 1: the whole leaf), moved from
    the shard files by the reshard executor through its bounded scratch;
    a replicated leaf's one file as it is."""
    from ..reshard import Layout, Redistributor

    dt = np.dtype(rec["dtype"])
    n = int(rec["n"])
    if rec["kind"] == "replicated":
        return np.load(_shard_file(data_dir, leaf_idx, None)).reshape(1, -1)
    srcs = [np.load(_shard_file(data_dir, leaf_idx, r), mmap_mode="r") for r in range(world)]
    flat = np.empty(n, dt)
    dst = Layout(dst_world)
    starts = [s for s, _ in dst.intervals(n)]

    def read(rank, off, view):
        view[:] = srcs[rank][off:off + view.shape[0]]

    def write(rank, off, values):
        flat[starts[rank] + off:starts[rank] + off + values.shape[0]] = values

    Redistributor(n, dt, Layout(world), dst, chunk_bytes).run(read, write)
    return flat.reshape(dst_world, -1) if n else flat.reshape(dst_world, 0)


def restore_engine_sharded(path, engine) -> Dict[str, Any]:
    """Restore a portable sharded checkpoint into the engine, from ANY
    source world size: a sharded leaf whose live value is shards is
    redistributed by the reshard planner from the checkpoint's layout
    onto the engine's ``Layout(p)`` (each rank receives exactly the bytes
    a fresh p-way scatter of the logical leaf would give it), any other
    leaf assembled whole and replicated. Structure and sharding
    mismatches still fail loudly, before any state is touched. Returns
    the header."""
    path = Path(path).resolve()
    meta = read_sharded_meta(path)
    _check_layout(meta, engine, path, allow_world_mismatch=True)
    data_dir = current_data_dir(path)
    world = int(meta["world"])
    p = engine.comm.size
    trees = _live_trees(engine)
    live = [(name, path_, leaf) for name in sorted(trees) for path_, leaf in _walk(trees[name])]
    records = meta["leaves"]
    if len(records) != len(live):
        raise CheckpointMismatchError(
            f"checkpoint {path} holds {len(records)} leaves but the "
            f"engine has {len(live)}"
        )
    values: Dict[str, Dict[str, Any]] = {name: {} for name in trees}
    for i, (rec, (name, leaf_path, cur)) in enumerate(zip(records, live)):
        shard = isinstance(cur, torch.Tensor) and _is_shard(engine, leaf_path, cur)
        rows = _read_leaf(data_dir, i, rec, world, p if shard else 1)
        arr = rows if shard else rows.reshape(tuple(rec["shape"]))
        values[name][leaf_path] = _from_numpy(arr, rec)
    _install(engine, values)
    return meta


def reshape_sharded(
    src_path, dst_path, to_world: int,
    chunk_bytes: Optional[int] = None,
) -> Dict[str, Any]:
    """Offline N-way -> M-way reshape of a sharded checkpoint with
    bounded memory: source shards are mmap'd read-only, target shards are
    preallocated memmaps, and every byte moves through the reshard
    executor's single chunked scratch buffer; the full array is never
    materialized. Returns a stats dict with the ``peak_scratch_bytes``
    bound (the JAX package's, key for key)."""
    from ..reshard import Layout, Redistributor
    from ..reshard.core import chunk_elems_for, chunk_spans

    src_path, dst_path = Path(src_path).resolve(), Path(dst_path).resolve()
    if int(to_world) < 1:
        raise ValueError(f"--to world must be >= 1, got {to_world}")
    meta = read_sharded_meta(src_path)
    src_dir = current_data_dir(src_path)
    from_world = int(meta["world"])
    dst_path.mkdir(parents=True, exist_ok=True)
    token = secrets.token_hex(4)
    tmp_dir = dst_path / f".tmp-{token}"
    tmp_dir.mkdir()
    src_layout, dst_layout = Layout(from_world), Layout(int(to_world))
    stats = {
        "from": from_world, "to": int(to_world), "leaves": len(meta["leaves"]),
        "peak_scratch_bytes": 0, "largest_shard_bytes": 0,
        "moved_bytes": 0, "plans": [],
    }
    for i, rec in enumerate(meta["leaves"]):
        dt = np.dtype(rec["dtype"])
        n = int(rec["n"])
        if rec["kind"] == "replicated":
            # one full copy in, one full copy out, streamed in chunks
            src = np.load(_shard_file(src_dir, i, None), mmap_mode="r")
            out = np.lib.format.open_memmap(
                _shard_file(tmp_dir, i, None), mode="w+", dtype=dt, shape=(n,),
            )
            for s, e in chunk_spans(n, chunk_elems_for(dt.itemsize, chunk_bytes)):
                out[s:e] = src[s:e]
            out.flush()
            continue
        rd = Redistributor(n, dt, src_layout, dst_layout, chunk_bytes)
        srcs = [
            np.load(_shard_file(src_dir, i, r), mmap_mode="r")
            for r in range(from_world)
        ]
        outs = [
            np.lib.format.open_memmap(
                _shard_file(tmp_dir, i, r), mode="w+", dtype=dt,
                shape=(max(0, e - s),),
            )
            for r, (s, e) in enumerate(dst_layout.intervals(n))
        ]

        def read(rank, off, view):
            view[:] = srcs[rank][off:off + view.shape[0]]

        def write(rank, off, values):
            outs[rank][off:off + values.shape[0]] = values

        rd.run(read, write)
        for o in outs:
            o.flush()
        stats["peak_scratch_bytes"] = max(stats["peak_scratch_bytes"], rd.peak_scratch_bytes)
        stats["largest_shard_bytes"] = max(
            stats["largest_shard_bytes"],
            max((a.nbytes for a in srcs), default=0),
            max((a.nbytes for a in outs), default=0),
        )
        stats["moved_bytes"] += sum(t.n for t in rd.transfers) * dt.itemsize
        stats["plans"].append(rd.plan.plan_id)
    new_meta = dict(meta, world=int(to_world))
    (tmp_dir / "meta.json").write_text(json.dumps(new_meta))
    _fsync_file(tmp_dir / "meta.json")
    for f in tmp_dir.iterdir():
        _fsync_file(f)
    data_dir = dst_path / f"data-{token}"
    os.replace(tmp_dir, data_dir)
    _atomic_write_text(dst_path / "CURRENT", data_dir.name)
    return stats


# --- parameter servers ------------------------------------------------------------
def save_parameter_servers(path, ps_group) -> None:
    """Save a ``PSGroup``'s center values (each server's shards
    assembled by a receive) as one ``torch.save`` file
    ``ps_centers.pt``, written to a temp name, fsync'd and renamed."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    centers = [srv.receive().wait().cpu() for srv in ps_group.servers]
    tmp = path / f"ps_centers.pt.tmp-{os.getpid()}"
    torch.save({"centers": centers}, tmp)
    _fsync_file(tmp)
    os.replace(tmp, path / "ps_centers.pt")


def restore_parameter_servers(path, ps_group) -> None:
    """Restore PS centers: each server's shards are overwritten by the
    'copy' rule (a collective in the reference; here applied per
    server, as the JAX package does)."""
    path = Path(path).resolve()
    state = torch.load(path / "ps_centers.pt", weights_only=True)
    for srv, center in zip(ps_group.servers, state["centers"]):
        srv.send(center, rule="copy").wait()
