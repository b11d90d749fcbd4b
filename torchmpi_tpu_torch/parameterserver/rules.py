"""Named shard update rules (reference ``lib/parameterserver.cpp:119-213``):
``zero`` / ``copy`` / ``add`` applied server-side, in place, to a shard
held on the communicator's device.

The port of ``torchmpi_tpu/parameterserver/rules.py``. ``add`` takes the
message's optional scale: with one it runs the scaled-accumulate kernel
(``shard <- shard + scale * incoming``, one rounding), without one the
accumulate kernel; both write into the shard.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import accumulate, scale_accumulate


def _rule_zero(shard: torch.Tensor, incoming: torch.Tensor,
               scale: Optional[float] = None) -> None:
    shard.zero_()


def _rule_copy(shard: torch.Tensor, incoming: torch.Tensor,
               scale: Optional[float] = None) -> None:
    shard.copy_(incoming)


def _rule_add(shard: torch.Tensor, incoming: torch.Tensor,
              scale: Optional[float] = None) -> None:
    if scale is None:
        accumulate(shard, incoming, out_=shard)
    else:
        scale_accumulate(shard, incoming, scale, out_=shard)


UPDATE_RULES = {
    "zero": _rule_zero,
    "copy": _rule_copy,
    "add": _rule_add,
}
