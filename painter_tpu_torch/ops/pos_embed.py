"""Absolute and relative positional-embedding ops.

- ``get_abs_pos``: the pretrained 14x14(+cls) table is bicubic-resized to
  the token grid at every forward (``vitdet_utils.py:128-157``).
- ``get_rel_pos``: per-axis decomposed rel-pos tables, linearly
  interpolated when the resolution differs from training
  (``vitdet_utils.py:63-93``), then gathered by static relative coords.
- ``get_2d_sincos_pos_embed``: scratch init (``util/pos_embed.py:20-35``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from painter_tpu_torch.ops.resample import resize1d, resize2d


def get_abs_pos(abs_pos: torch.Tensor, has_cls_token: bool,
                hw: Tuple[int, int]) -> torch.Tensor:
    """(num_pos, C) or (1, num_pos, C) table -> (1, h, w, C) grid."""
    if abs_pos.ndim == 3:
        abs_pos = abs_pos[0]
    if has_cls_token:
        abs_pos = abs_pos[1:]
    h, w = hw
    xy_num = abs_pos.shape[0]
    size = int(round(xy_num ** 0.5))
    if size * size != xy_num:
        raise ValueError(f"pos table of {xy_num} entries is not square")
    grid = abs_pos.reshape(size, size, -1)
    if size != h or size != w:
        grid = resize2d(grid, (h, w), "bicubic", h_axis=0, w_axis=1)
    return grid[None]


@functools.lru_cache(maxsize=None)
def _relative_coords(q_size: int, k_size: int) -> np.ndarray:
    """Static (q_size, k_size) index matrix into the rel-pos table."""
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel.astype(np.int64)


def get_rel_pos(q_size: int, k_size: int,
                rel_pos: torch.Tensor) -> torch.Tensor:
    """(L, head_dim) table -> (q_size, k_size, head_dim) gathered biases."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize1d(rel_pos, max_rel_dist, "linear", axis=0)
    idx = torch.from_numpy(_relative_coords(q_size, k_size)).to(
        rel_pos.device)
    return rel_pos[idx.reshape(-1)].reshape(q_size, k_size,
                                            rel_pos.shape[-1])


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """Standard MAE 2D sin-cos table, (grid_size**2 [+1], embed_dim)."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = _sincos_1d(embed_dim // 2, grid[1])
    emb_w = _sincos_1d(embed_dim // 2, grid[0])
    pos_embed = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos_embed = np.concatenate(
            [np.zeros((1, embed_dim), np.float32), pos_embed], axis=0)
    return pos_embed


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    if embed_dim % 2:
        raise ValueError(f"sincos embed_dim {embed_dim} must be even")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)],
                          axis=1).astype(np.float32)
