"""Image preprocessing for the in-context protocol, on tensors.

The reference stitches and normalizes in numpy per image
(``seggpt_engine.py:56-103``); these run on the device beside the model.
"""
from __future__ import annotations

import numpy as np
import torch

from painter_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB -> ImageNet-normalized, last axis = channels."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def denormalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return x * std + mean


# all 256 correctly rounded fp32 values of u/255, computed in float64:
# from_uint8 gathers from this table so a uint8 upload is bit-identical
# to the host ``np.array(img) / 255.``
_U8_TO_UNIT = np.ascontiguousarray(
    (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32))


def from_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 RGB -> [0,1] fp32, bit-exact vs the host divide."""
    table = torch.from_numpy(_U8_TO_UNIT).to(x.device)
    return table[x.long()]


def to_uint8_255(x: torch.Tensor) -> torch.Tensor:
    """[0,1]-scale painted output -> the write path's 0-255 uint8.

    Mirrors ``np.clip(out * 255, 0, 255).astype(np.uint8)``; ``floor`` is
    numpy's truncating cast for non-negative floats.
    """
    x = torch.clamp(x.float() * 255.0, 0.0, 255.0)
    return torch.floor(x).to(torch.uint8)


def stitch_pairs(prompts: torch.Tensor, queries: torch.Tensor
                 ) -> torch.Tensor:
    """Stack prompt over query along height: (N,H,W,3)x2 -> (N,2H,W,3)."""
    return torch.cat([prompts, queries], dim=1)


def bottom_half_mask(batch: int, num_patches: int,
                     device=None) -> torch.Tensor:
    """(B, L) mask: zeros top half, ones bottom (seggpt_engine.py:36-38)."""
    m = torch.zeros((batch, num_patches), dtype=torch.float32, device=device)
    m[:, num_patches // 2:] = 1.0
    return m
