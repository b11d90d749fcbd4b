"""The config-5 twin against the JAX example, on the CPU.

``torchmpi_tpu_torch.examples.blocksequential_2host`` and
``examples/blocksequential_2host.py`` train MLP6 with Adam over two
virtual hosts of four ranks (three gradient buckets, each an async
allreduce through the hierarchical plan) at the JAX test's scale,
``--train 512 --epochs 3 --batch-per-rank 4``, from the same weights: the
JAX run's ``init_params`` tree, carried over by ``from_jax_params``. The
twin's leaves are the transposed kernels, so a bucket's rows sum in
another chunk layout than JAX's and the two runs part by f32 rounding:
the epoch losses agree within rtol 1e-4, the accuracies within one test
image in 512.
"""

import numpy as np
import pytest

import torchmpi_tpu.models as jmodels
from torchmpi_tpu_torch.examples import blocksequential_2host
from torchmpi_tpu_torch.models import from_jax_params

ARGS = ["--train", "512", "--epochs", "3", "--batch-per-rank", "4"]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX example's (losses, accuracy, hier_used) and its initial
    parameters, run once for both backends."""
    from examples.blocksequential_2host import main

    seen = {}
    real = jmodels.init_params

    def capture(*args, **kw):
        seen["params"] = real(*args, **kw)
        return seen["params"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodels, "init_params", capture)
        return main(ARGS), seen["params"]


@pytest.mark.parametrize("backend", ["ring", "kernel"])
def test_twin_trains_as_the_jax_example(jax_run, backend):
    (jlosses, jacc, jhier), jparams = jax_run
    init = from_jax_params({m: {k: np.asarray(v) for k, v in leaves.items()}
                            for m, leaves in jparams.items()})
    losses, acc, hier_used, sps = blocksequential_2host.main(
        ARGS + ["--device", "cpu", "--backend", backend], init=init)
    assert jhier and hier_used
    assert losses[-1] < losses[0] and acc > 0.6 and sps > 0
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert abs(acc - jacc) <= 1 / 512 + 1e-9
