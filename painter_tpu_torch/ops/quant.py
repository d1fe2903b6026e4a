"""Linear layers. Only the floating-point path is ported so far; the
int8 (w8a8) serving path of the JAX package waits for its own slice."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ W.T + b`` with the fp32 params cast to ``x.dtype`` at use.

    ``weight`` is (out, in), the torch/reference layout.
    """
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))
