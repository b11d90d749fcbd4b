"""Named parallelism axes over the virtual ranks.

The port of ``torchmpi_tpu/parallel/mesh.py:make_parallel_mesh``: factor
p ranks into named axes (dp / tp / pp / sp / ep ...), outermost first,
the last axis fastest. The JAX function returns a device mesh; on one
card the ranks are rows of rank-stacked tensors, so this returns the
index layout: ``layout.ranks[i_dp, i_tp]`` is the rank at those
coordinates.

The layout also answers what the named-axis collectives
(:mod:`torchmpi_tpu_torch.collectives.axis`) need in place of
``lax.axis_index`` and ``lax.axis_size``: each rank's coordinate along an axis
(:meth:`MeshLayout.axis_index`), and the row order that makes an axis
innermost (:meth:`MeshLayout.innermost`), so that the ranks of one
axis group are consecutive rows. The innermost axis is already so; an
outer one (``dp`` of ``{"dp": 2, "tp": 4}``) is strided and takes that
permutation and its inverse.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..runtime.communicator import Communicator


@dataclass(frozen=True)
class MeshLayout:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def ranks(self) -> np.ndarray:
        return np.arange(int(np.prod(self.shape))).reshape(self.shape)

    @property
    def num_ranks(self) -> int:
        return int(np.prod(self.shape))

    def dim(self, axis: str) -> int:
        """The position of ``axis`` in :attr:`shape`."""
        if axis not in self.axis_names:
            mesh = dict(zip(self.axis_names, self.shape))
            raise ValueError(f"no axis {axis!r} in the mesh {mesh}")
        return self.axis_names.index(axis)

    def size(self, axis: str) -> int:
        """The axis size (``lax.axis_size``)."""
        return self.shape[self.dim(axis)]

    def axis_index(self, axis: str) -> np.ndarray:
        """Each rank's coordinate along ``axis``, ``[p]`` (``lax.axis_index``
        evaluated on every rank)."""
        return np.indices(self.shape)[self.dim(axis)].reshape(-1)

    def innermost(self, axis: str) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """``(order, inverse)``: ``x[order]`` puts the ranks of each
        ``axis`` group on consecutive rows, in axis order (group-major), and
        ``y[inverse]`` puts them back. Both None when ``axis`` is the
        innermost axis already (or every other axis has size 1)."""
        order = np.moveaxis(self.ranks, self.dim(axis), -1).reshape(-1)
        if (order == np.arange(order.size)).all():
            return None, None
        return order, np.argsort(order)


def make_parallel_mesh(
    comm: Union[None, int, Communicator] = None,
    axes: Optional[Dict[str, int]] = None,
) -> MeshLayout:
    """Lay ``comm``'s ranks (the current communicator's by default, or a
    rank count) out over ``axes``: axis name -> size in declaration order,
    outermost first, e.g. ``{"dp": 2, "sp": 4}`` on 8 ranks. One size may
    be -1 (inferred); the sizes must multiply to the rank count."""
    if comm is None:
        from .. import runtime_state

        comm = runtime_state.current_communicator()
    n = comm if isinstance(comm, int) else comm.size
    axes = dict(axes or {"dp": n})
    sizes = list(axes.values())
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis size may be -1")
    if unknown:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known != 0:
            raise ValueError(f"cannot infer axis: {n} devices over {known}")
        sizes[unknown[0]] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"axes {dict(zip(axes, sizes))} do not cover {n} devices")
    return MeshLayout(tuple(axes), tuple(sizes))
