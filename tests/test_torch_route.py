"""``eager.run``'s memoized routes, on the CPU.

The route of an eager collective (its plan: effective backend, wire and
bound function) is memoized on the communicator per call shape, in the
schedule compiler's dispatch memo. These tests hold it to what
re-deriving it would give: a changed constant changes the route, freeing
the communicator's resources drops it, and the argument checks still run
on every call. At p=3 the ring's order of adds gives
other f32 bits than the vendor path's sum on some elements, so the route
a call took shows in its result.
"""

import numpy as np
import pytest
import torch

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import constants, ops
from torchmpi_tpu_torch.collectives import CollectiveArgumentError, eager, primitives

P, N = 3, 8 * 128 * 8 + 3


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()
    ops.reset_launch_counts()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _x() -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(P * 1000 + N).randn(P, N).astype(np.float32))


def test_route_follows_a_changed_constant():
    """Below the small-message cutoff the kernel backend's allreduce takes
    the vendor path; with the cutoff set to 0 after that call, the same
    call takes the ring."""
    tmpi.start(ranks=P, device="cpu")
    x = _x()
    vendor, ring = primitives.allreduce(x), ops.ring_allreduce_plain(x)
    assert not torch.equal(_bits(vendor), _bits(ring))
    assert torch.equal(_bits(tmpi.allreduce_tensor(x, backend="kernel")), _bits(vendor))
    assert torch.equal(_bits(tmpi.allreduce_tensor(x, backend="kernel")), _bits(vendor))
    constants.set("small_allreduce_size_cpu", 0)
    assert torch.equal(_bits(tmpi.allreduce_tensor(x, backend="kernel")), _bits(ring))


@pytest.mark.parametrize("op", ["allreduce", "broadcast", "reduce"])
def test_routes_are_memoized_per_call_shape_and_freed(op):
    tmpi.start(ranks=P, device="cpu")
    comm = tmpi.current_communicator()
    x = _x()
    first = eager.run(op, x, comm, backend="ring")
    routes = comm.__dict__["_dispatch_memo"]
    assert len(routes) == 1
    assert torch.equal(eager.run(op, x, comm, backend="ring"), first)
    assert len(routes) == 1
    eager.run(op, x[:, :100].contiguous(), comm, backend="ring")
    assert len(routes) == 2  # one route per size
    eager.free_collective_resources(comm)
    assert "_dispatch_memo" not in comm.__dict__
    assert "_plan_cache" not in comm.__dict__


def test_checks_run_on_a_memoized_route():
    tmpi.start(ranks=P, device="cpu")
    comm = tmpi.current_communicator()
    x = _x()
    eager.run("broadcast", x, comm, backend="ring", root=1)
    with pytest.raises(CollectiveArgumentError, match="root"):
        eager.run("broadcast", x, comm, backend="ring", root=P)
    with pytest.raises(CollectiveArgumentError):
        eager.run("broadcast", x[:2], comm, backend="ring", root=1)
    with pytest.raises(CollectiveArgumentError, match="wire_dtype"):
        eager.run("allreduce", x, comm, backend="ring", wire_dtype="int4")
