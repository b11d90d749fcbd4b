"""The list forms of the accumulate kernels (``ops.accumulate_many``,
``ops.scale_accumulate_many``) and the engine step that uses them, on the
CPU.

Each leaf of a list goes through the JAX package's ``accumulate`` /
``scale_accumulate`` in Pallas interpret mode and through the port's list
form (its plain version: the tensors are on the CPU), with inputs made by
numpy from a seed. Tolerance: none, every leaf bit for bit. The leaf list
is ResNet-like at a small size: one-element, ragged and odd-length leaves,
batch-norm-sized vectors and a view at an odd element offset.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu.ops import reduce_kernel as jreduce
from torchmpi_tpu_torch import ops
from torchmpi_tpu_torch.ops import _build
from torchmpi_tpu_torch.ops import reduce_kernel as rk

# rank-stacked [p=2, ...] leaves: a conv kernel, batch-norm scale and bias,
# a dense layer, one element, odd lengths
SHAPES = [(2, 3, 3, 3, 8), (2, 8), (2, 8), (2, 72, 10), (1,), (2, 7), (1001,), (2, 64)]
OFFSET_LEN = 517  # the last leaf: a view at element offset 1 of a longer buffer


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()
    ops.reset_launch_counts()


def _draw(rs, shape, dtype):
    if dtype in ("float32", "float64", "bfloat16", "float16"):
        return rs.randn(*shape).astype(np.float64 if dtype == "float64" else np.float32)
    info = np.iinfo(dtype)
    return rs.randint(info.min, info.max + 1, size=shape).astype(dtype)


def _to_torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))  # a writable copy
    return t.to(getattr(torch, dtype)) if dtype in ("bfloat16", "float16") else t


def _to_jax(t: torch.Tensor):
    if t.dtype in (torch.bfloat16, torch.float16):
        return jnp.asarray(t.float().numpy()).astype(str(t.dtype).split(".")[1])
    return jnp.asarray(t.numpy())


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy()
    a = t.numpy()
    return a.view({1: np.uint8, 4: np.int32, 8: np.int64}[a.itemsize])


def _bits_t(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _leaf_list(dtype: str, seed: int):
    """(outs, inps): the shapes of SHAPES and then a view at an odd element
    offset, for both operands."""
    rs = np.random.RandomState(seed)
    outs = [_to_torch(_draw(rs, s, dtype), dtype) for s in SHAPES]
    inps = [_to_torch(_draw(rs, s, dtype), dtype) for s in SHAPES]
    base_o = _to_torch(_draw(rs, (OFFSET_LEN + 1,), dtype), dtype)
    base_i = _to_torch(_draw(rs, (OFFSET_LEN + 2,), dtype), dtype)
    outs.append(base_o[1:])
    inps.append(base_i[2:])
    return outs, inps


def _run(fn, outs, inps, in_place):
    if not in_place:
        return fn(outs, inps)
    dests = [o.clone() for o in outs]
    got = fn(dests, inps, dests)
    assert all(g.data_ptr() == d.data_ptr() for g, d in zip(got, dests))
    return got


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int32", "int8", "uint8"])
def test_accumulate_many_matches_pallas_leaf_by_leaf(dtype, in_place):
    outs, inps = _leaf_list(dtype, seed=10)
    got = _run(lambda o, i, d=None: ops.accumulate_many(o, i, out_=d), outs, inps, in_place)
    assert len(got) == len(outs)
    for o, i, g in zip(outs, inps, got):
        ref = jreduce.accumulate(_to_jax(o), _to_jax(i), interpret=True)
        want = _to_torch(np.asarray(ref.astype(jnp.float32) if dtype in ("bfloat16", "float16")
                                    else ref), dtype)
        assert g.dtype == o.dtype and g.shape == o.shape
        np.testing.assert_array_equal(_bits(g), _bits(want))


@pytest.mark.parametrize("alpha", [0.9, -0.0125])
@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "float64"])
def test_scale_accumulate_many_matches_pallas_leaf_by_leaf(dtype, in_place, alpha):
    outs, inps = _leaf_list(dtype, seed=11)
    got = _run(lambda o, i, d=None: ops.scale_accumulate_many(o, i, alpha, out_=d),
               outs, inps, in_place)
    with jax.enable_x64(dtype == "float64"):
        for o, i, g in zip(outs, inps, got):
            ref = jreduce.scale_accumulate(_to_jax(o), _to_jax(i), alpha, interpret=True)
            want = _to_torch(np.asarray(ref.astype(jnp.float32)
                                        if dtype in ("bfloat16", "float16") else ref), dtype)
            assert g.dtype == o.dtype and g.shape == o.shape
            np.testing.assert_array_equal(_bits(g), _bits(want))


@pytest.mark.parametrize("fn", ["accumulate_many", "scale_accumulate_many"])
def test_list_forms_equal_the_single_tensor_forms(fn):
    outs, inps = _leaf_list("float32", seed=12)
    if fn == "accumulate_many":
        got, want = ops.accumulate_many(outs, inps), [ops.accumulate(o, i) for o, i in zip(outs, inps)]
        plain = ops.accumulate_many_plain(outs, inps)
    else:
        got = ops.scale_accumulate_many(outs, inps, 0.1)
        want = [ops.scale_accumulate(o, i, 0.1) for o, i in zip(outs, inps)]
        plain = ops.scale_accumulate_many_plain(outs, inps, 0.1)
    for g, w, pl in zip(got, want, plain):
        assert torch.equal(_bits_t(g), _bits_t(w)) and torch.equal(_bits_t(g), _bits_t(pl))
    assert ops.accumulate_many([], []) == [] and not any(ops.launch_counts().values())


@pytest.mark.parametrize("case", ["mixed devices", "mixed destination device", "shape",
                                  "integer scale", "lengths", "destination shape"])
def test_list_forms_reject(case):
    a, b = torch.ones(4), torch.ones(4)
    meta = torch.empty(4, device="meta")
    calls = {
        "mixed devices": (lambda: ops.accumulate_many([a, meta], [b, meta]),
                          "one device"),
        "mixed destination device": (
            lambda: ops.scale_accumulate_many([a], [b], 0.5, out_=[meta]), "one device"),
        "shape": (lambda: ops.accumulate_many([a, a], [b, torch.ones(5)]), "equal shapes"),
        "integer scale": (
            lambda: ops.scale_accumulate_many([a, torch.ones(3, dtype=torch.int32)],
                                              [b, torch.ones(3, dtype=torch.int32)], 2.0),
            "float32, bfloat16"),
        "lengths": (lambda: ops.accumulate_many([a, a], [b]), "one input and one destination"),
        "destination shape": (lambda: ops.accumulate_many([a], [b], out_=[torch.ones(3)]),
                              "out_ must match"),
    }
    call, match = calls[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_list_forms_raise_off_the_cpu():
    """Leaves on neither the CPU nor a CUDA card get no quiet fallback."""
    x = torch.empty(2, 8, device="meta")
    for call in (lambda: ops.accumulate_many([x, x], [x, x]),
                 lambda: ops.scale_accumulate_many([x], [x], 0.5, out_=[x])):
        with pytest.raises(ValueError, match="CUDA or the CPU"):
            call()
    assert not any(ops.launch_counts().values())


# fake table sizes, and the two the library has (the classic and the large
# parameter table)
@pytest.mark.parametrize("per_launch", [1, 2, 3, 102, 818])
def test_launch_groups_formula(per_launch):
    """ceil(leaves / per_launch) launches per dtype, each launch one dtype,
    every leaf once, in order."""
    rs = np.random.RandomState(per_launch)
    dtypes = [torch.float32] * 161 + [torch.bfloat16] * 7
    dtypes = [dtypes[i] for i in rs.permutation(len(dtypes))]
    groups = rk.launch_groups(dtypes, per_launch)
    assert len(groups) == -(-161 // per_launch) + -(-7 // per_launch)
    assert sorted(i for g in groups for i in g) == list(range(len(dtypes)))
    for g in groups:
        assert 1 <= len(g) <= per_launch and len({dtypes[i] for i in g}) == 1
        assert g == sorted(g)


@pytest.mark.parametrize("per_launch", [102, 818])
def test_leaves_per_launch_reads_the_library(per_launch, monkeypatch):
    """The table size comes from the built library (asked once), not from
    a copy kept in Python."""
    asked = []

    class Lib:
        def tm_leaves_per_launch(self):
            asked.append(1)
            return per_launch

    monkeypatch.setattr(rk, "_lib", Lib)
    rk.leaves_per_launch.cache_clear()
    try:
        assert rk.leaves_per_launch() == per_launch
        assert rk.leaves_per_launch() == per_launch
        assert len(asked) == 1
    finally:
        rk.leaves_per_launch.cache_clear()


class _FakeLibrary:
    """Stands in for the built library: records each launch's leaves as
    the C side reads them (a, b, out, n as 64-bit words)."""

    def __init__(self):
        self.calls = []

    def _read(self, ptr, count):
        words = (ctypes.c_longlong * (4 * count)).from_address(ptr)
        return [tuple(words[4 * i:4 * i + 4]) for i in range(count)]

    def tm_accumulate_many(self, ptr, count, dtype, stream):
        self.calls.append((self._read(ptr, count), dtype, None))
        return 0

    def tm_scale_accumulate_many(self, ptr, count, alpha, dtype, stream):
        self.calls.append((self._read(ptr, count), dtype, alpha))
        return 0


@pytest.mark.parametrize("fn", ["accumulate", "scale_accumulate"])
@pytest.mark.parametrize("per_launch", [1, 3, 50])
def test_launch_path_counts_one_per_launch(fn, per_launch, monkeypatch):
    """The CUDA launch path with the library and the stream faked: one
    call of the C entry, and one count, per launch_groups group of a fake
    table size; each call's table holds the leaves' pointers and counts;
    empty leaves launch nothing."""
    lib = _FakeLibrary()
    monkeypatch.setattr(rk, "_lib", lambda: lib)
    monkeypatch.setattr(rk, "leaves_per_launch", lambda: per_launch)
    monkeypatch.setattr(rk, "_off_cpu", lambda what, out: None)
    monkeypatch.setattr(_build, "launch", lambda device, call, stream=None: call(0))
    rs = np.random.RandomState(per_launch)
    outs = [torch.from_numpy(rs.randn(n).astype(np.float32)) for n in (5, 0, 64, 1, 7, 3, 9)]
    outs += [torch.ones(4, dtype=torch.float16), torch.ones(6, dtype=torch.float16)]
    inps = [torch.ones_like(o) for o in outs]
    codes = rk.NATIVE_DTYPES if fn == "accumulate" else rk.SCALE_DTYPES
    alpha = None if fn == "accumulate" else 0.25
    results = rk._launch(fn, outs, inps, [None] * len(outs), codes, alpha, None)
    assert len(results) == len(outs)
    f32, f16 = 6, 2  # non-empty leaves of each dtype
    want = -(-f32 // per_launch) + -(-f16 // per_launch)
    assert len(lib.calls) == want and ops.launch_counts()[fn] == want
    seen = [leaf for leaves, _, _ in lib.calls for leaf in leaves]
    expect = [(o.data_ptr(), i.data_ptr(), r.data_ptr(), o.numel())
              for o, i, r in zip(outs, inps, results) if o.numel()]
    assert sorted(seen) == sorted(expect)
    assert all(len(leaves) <= per_launch for leaves, _, _ in lib.calls)
    assert {a for _, _, a in lib.calls} == {alpha}


def _lenet_engine(p, many: bool, monkeypatch):
    """A LeNet engine at p ranks, momentum 0.9; ``many=False`` swaps the
    engine's list forms for the single-tensor forms leaf by leaf."""
    from torchmpi_tpu_torch.engine import SGD, AllReduceSGDEngine
    from torchmpi_tpu_torch.engine import optim, sgd
    from torchmpi_tpu_torch.models import LeNet, init_params, make_loss_fn

    if not many:
        monkeypatch.setattr(optim, "scale_accumulate_many", lambda outs, inps, alpha: [
            ops.scale_accumulate(o, i, alpha) for o, i in zip(outs, inps)])
        monkeypatch.setattr(sgd, "accumulate_many", lambda outs, inps: [
            ops.accumulate(o, i) for o, i in zip(outs, inps)])
    tmpi.start(ranks=p, device="cpu")
    model = LeNet()
    return AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0), lr=0.05,
                              optimizer=SGD(0.05, momentum=0.9))


@pytest.mark.parametrize("p", [2, 4])
def test_engine_step_list_form_equals_per_leaf(p, monkeypatch):
    """Two momentum steps through the list forms, bit for bit equal to the
    same steps leaf by leaf (parameters and traces). On the CPU both forms
    run the same plain versions, so this checks the engine's side only:
    that its list calls take every leaf, in order, with the right operands
    and scale. The arithmetic is held against the JAX kernels by the tests
    above, and the engine's momentum steps against the JAX engine's in
    ``test_torch_resnet.py``."""
    rs = np.random.RandomState(p)
    batches = [(torch.from_numpy(rs.rand(p, 4, 28, 28).astype(np.float32)),
                torch.from_numpy(rs.randint(0, 10, (p, 4)))) for _ in range(2)]
    trees = []
    for many in (True, False):
        with monkeypatch.context() as m:
            engine = _lenet_engine(p, many, m)
            for b in batches:
                engine.step(b)
            trees.append((engine.params, engine.opt_state))
            tmpi.stop()
    (pa, sa), (pb, sb) = trees
    assert list(pa) == list(pb) and len(pa) == 8
    for k in pa:
        assert torch.equal(pa[k].view(torch.int32), pb[k].view(torch.int32))
        assert torch.equal(sa[k].view(torch.int32), sb[k].view(torch.int32))
    assert any(float(v.abs().max()) > 0 for v in sa.values())
