"""The port's ``FusionBuffer`` against the JAX package's, on the CPU.

The same submits go to both buffers on communicators of 4 ranks, and
each package's ``collectives._dispatch`` is wrapped to record what the
buffer dispatches: the sequence of (op, mode, backend, payload, wire)
must be equal (a fused allreduce is one ``fused`` dispatch of its
layout, a fused reduce-scatter one ``sync`` dispatch of the interleaved
buffer, what cannot fuse one ``async`` dispatch a tensor). Covered: the
reverse flush order under ``overlap_schedule='reverse'``, the gate on
tensors of fewer than two dims, a flush below ``fusion_min_tensors``,
the capacity flush, a disabled buffer, the reduce-scatter's interleaving,
the handles' kind ``fusion`` in the handle table, and the telemetry
(flush and tensor counters, one ``fusion.{op}`` flight entry a flush).

Results: integer payloads must be exact and f32 payloads through the
``ring`` backend bitwise equal (the port's ring keeps the JAX ring's
order of adds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import collectives as jcollectives
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu import telemetry as jtelemetry
from torchmpi_tpu.runtime.handles import handles as jhandles
from torchmpi_tpu.telemetry import flightrecorder as jflight
from torchmpi_tpu_torch import collectives, constants, ops, telemetry
from torchmpi_tpu_torch.collectives import eager, get_fusion_buffer
from torchmpi_tpu_torch.collectives.fusion import FusionHandle
from torchmpi_tpu_torch.runtime.handles import handles
from torchmpi_tpu_torch.telemetry import flightrecorder as tflight

P = 4


def _quiet_telemetry():
    for pkg in (telemetry, jtelemetry):
        pkg.disable()
        pkg.reset()
    for flight in (tflight, jflight):
        flight.disable()


@pytest.fixture(autouse=True)
def _fresh_port():
    # both packages' telemetry and flight recorders are process-wide: a
    # test of another file that ran earlier in the same worker may have
    # left series or flight entries, which the first test here would
    # count as its own
    _quiet_telemetry()
    yield
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()
    ops.reset_launch_counts()
    _quiet_telemetry()


def _both(name, value):
    constants.set(name, value)
    jconstants.set(name, value)


def _describe(x) -> tuple:
    """A dispatched payload: its shape (or fused layout) and dtype name."""
    if isinstance(x, (list, tuple)):
        return ("layout",) + tuple(int(f.shape[1]) for f in x) + (
            str(x[0].dtype).replace("torch.", ""),)
    return tuple(int(d) for d in x.shape) + (str(x.dtype).replace("torch.", ""),)


def _recording(module, monkeypatch) -> list:
    calls = []
    real = module._dispatch

    def record(op, x, comm=None, mode="sync", backend=None, **kw):
        calls.append((op, mode, backend, _describe(x), kw.get("wire_dtype")))
        return real(op, x, comm, mode, backend, **kw)

    monkeypatch.setattr(module, "_dispatch", record)
    return calls


def _inputs(kind: str):
    """(op, numpy array, submit kwargs) in submit order."""
    rng = np.random.RandomState(len(kind))
    ints = lambda *shape: rng.randint(-1000, 1000, (P,) + shape).astype(np.int32)  # noqa: E731
    f32 = lambda *shape: rng.randn(P, *shape).astype(np.float32)  # noqa: E731
    if kind == "reverse":
        return [("allreduce", f32(30), dict(backend="ring")),
                ("allreduce", ints(3, 5), dict(backend="xla")),
                ("allreduce", f32(7, 2), dict(backend="ring")),
                ("allreduce", ints(11), dict(backend="xla"))]
    if kind == "ndim_gate":
        return [("allreduce", ints(), dict(backend="xla")),
                ("allreduce", ints(6), dict(backend="xla")),
                ("allreduce", ints(9), dict(backend="xla"))]
    if kind == "reducescatter":
        return [("reducescatter", f32(8 * P), dict(backend="ring")),
                ("reducescatter", f32(2 * P), dict(backend="ring")),
                ("reducescatter", f32(3, 4 * P), dict(backend="ring"))]
    if kind == "int8_ring":
        return [("allreduce", f32(600), dict(backend="ring", wire_dtype="int8")),
                ("allreduce", f32(300), dict(backend="ring", wire_dtype="int8"))]
    # min_tensors, capacity, disabled
    return [("allreduce", ints(40), dict(backend="xla")),
            ("allreduce", ints(2, 20), dict(backend="xla")),
            ("allreduce", ints(100), dict(backend="xla")),
            ("allreduce", ints(8), dict(backend="xla"))]


SETTINGS = {
    "reverse": {"overlap_schedule": "reverse"},
    "ndim_gate": {},
    "min_tensors": {"fusion_min_tensors": 5},
    "capacity": {"fusion_buffer_bytes": 4 * 100},
    "disabled": {"fusion_buffer_bytes": 0},
    "reducescatter": {},
    "int8_ring": {"wire_quant_min_elements": 256},
}


def _run(pkg, fb, inputs, wait_first: bool):
    subs = [fb.submit(op, pkg(x), **kw) for op, x, kw in inputs]
    n_fusion = handles.outstanding_kind("fusion") if pkg is torch.from_numpy else sum(
        1 for k in jhandles._kinds.values() if k == "fusion")
    if wait_first:
        fb.flush_all()
    return [np.asarray(h.wait()) for h in subs], n_fusion


@pytest.mark.parametrize("kind", list(SETTINGS))
def test_fusion_buffer_dispatches_as_jax(kind, monkeypatch):
    jmpi.start(devices=jax.devices()[:P])
    tmpi.start(ranks=P, device="cpu")
    _both("small_allreduce_size_cpu", 0)
    for name, value in SETTINGS[kind].items():
        _both(name, value)
    telemetry.enable()
    jtelemetry.enable()
    inputs = _inputs(kind)
    calls = _recording(collectives, monkeypatch)
    jcalls = _recording(jcollectives, monkeypatch)
    got, n_fusion = _run(torch.from_numpy, get_fusion_buffer(), inputs, True)
    want, jn_fusion = _run(jnp.asarray, jcollectives.get_fusion_buffer(), inputs, True)
    assert calls == jcalls and calls
    assert n_fusion == jn_fusion
    assert handles.outstanding_kind("fusion") == 0
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    snap, jsnap = telemetry.snapshot(), jtelemetry.snapshot()
    for name in ("tm_fusion_tensors_total", "tm_fusion_flushes_total"):
        assert snap["metrics"].get(name) == jsnap["metrics"].get(name)

    def flushes(s):
        return [(e["op"], e["payload"].replace("torch.", ""), e["wire"], e["backend"],
                 e["routing"], e["status"])
                for e in s["flight_recorder"]["entries"] if e["op"].startswith("fusion.")]

    assert flushes(snap) == flushes(jsnap)


def test_reverse_flush_order_reverses_the_groups(monkeypatch):
    tmpi.start(ranks=P, device="cpu")
    calls = _recording(collectives, monkeypatch)
    fb = get_fusion_buffer()
    for order in ("none", "reverse"):
        constants.set("overlap_schedule", order)
        calls.clear()
        hs = [fb.submit("allreduce", torch.ones(P, 3, dtype=dtype), backend="xla")
              for dtype in (torch.float32, torch.int32) for _ in range(2)]
        fb.flush_all()
        flushed = [c[3][-1] for c in calls]
        assert flushed == (["float32", "int32"] if order == "none" else ["int32", "float32"])
        assert [c[3][:-1] for c in calls] == [("layout", 3, 3)] * 2
        assert [h.wait().dtype for h in hs[::2]] == [torch.float32, torch.int32]


def test_fusion_handles_are_kind_fusion_and_drained_by_sync_all():
    tmpi.start(ranks=P, device="cpu")
    fb = get_fusion_buffer()
    hs = [fb.submit("allreduce", torch.full((P, 5), float(i))) for i in range(3)]
    assert all(isinstance(h, FusionHandle) for h in hs)
    assert handles.outstanding_kind("fusion") == 3
    assert handles.outstanding_kind("collective") == 0
    tmpi.sync_all()
    assert handles.outstanding_kind("fusion") == 0
    assert all(h.done for h in hs)
    assert torch.equal(hs[2].wait(), torch.full((P, 5), 2.0 * P))


def test_unfusable_tensors_dispatch_async():
    tmpi.start(ranks=P, device="cpu")
    fb = get_fusion_buffer()
    h = fb.submit("allreduce", torch.arange(P, dtype=torch.int32))
    assert not isinstance(h, FusionHandle)
    assert handles.outstanding_kind("collective") == 1
    assert torch.equal(h.wait(), torch.full((P,), P * (P - 1) // 2, dtype=torch.int32))
    h = fb.submit("reducescatter", torch.ones(P, 2, 2 * P))  # 3-D: unfused
    assert tuple(h.wait().shape) == (P, 2, 2)


def test_run_fused_matches_one_allreduce_and_rejects_other_ops():
    tmpi.start(ranks=P, device="cpu")
    comm = tmpi.current_communicator()
    rng = np.random.RandomState(0)
    flats = [torch.from_numpy(rng.randint(-99, 99, (P, n)).astype(np.int32)) for n in (3, 9, 1)]
    out = eager.run_fused("allreduce", flats, comm, backend="ring")
    assert torch.equal(out, eager.run("allreduce", torch.cat(flats, dim=1), comm))
    mixed = eager.run_fused("allreduce", [flats[0], flats[1].float()], comm)
    assert mixed.dtype == torch.float32
    with pytest.raises(eager.CollectiveArgumentError, match="allreduce"):
        eager.run_fused("reducescatter", flats, comm)
    with pytest.raises(eager.CollectiveArgumentError, match="at least one"):
        eager.run_fused("allreduce", [], comm)
