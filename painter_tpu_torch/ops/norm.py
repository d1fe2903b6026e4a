"""Normalization ops. LayerNorm statistics always run in fp32."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; fp32 statistics, output in x.dtype.

    Biased variance, as torch ``nn.LayerNorm``. Also serves as the
    reference's channel-wise ``LayerNorm2D`` (``vitdet_utils.py:189-209``):
    in the NHWC layout the channel axis is the last axis.
    """
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)
