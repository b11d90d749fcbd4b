"""Named parallelism axes over the virtual ranks.

The part of ``torchmpi_tpu/parallel/mesh.py:make_parallel_mesh`` that the
long-context path needs: factor p ranks into named axes (dp / sp / ...),
outermost first, the last axis fastest. The JAX function returns a device
mesh; on one card the ranks are rows of rank-stacked tensors, so this
returns the index layout: ``layout.ranks[i_dp, i_sp]`` is the rank at
those coordinates.
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

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]


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
