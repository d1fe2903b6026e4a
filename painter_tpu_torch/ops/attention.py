"""Multi-head attention with decomposed relative-position bias.

Behavioral contract from ``Painter/models_painter.py:33-89`` and
``vitdet_utils.py:96-125`` (MViTv2-style decomposed rel-pos):
``attn[b,n,(qh,qw),(kh,kw)] = q.k*scale + rel_h[qh,qw,kh] + rel_w[qh,qw,kw]``.

The attention itself always goes through
:func:`painter_tpu_torch.kernels.flash_relpos.flash_attention_relpos`
(the CUDA kernel on the card, its plain version on the CPU).
``attn_impl="plain"`` asks for the plain version on any device; it exists
so a comparison can run both on the same inputs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from painter_tpu_torch.kernels.flash_relpos import (
    flash_attention_relpos, flash_attention_relpos_reference)
from painter_tpu_torch.ops.pos_embed import get_rel_pos
from painter_tpu_torch.ops.quant import linear

_IMPLS = {"kernel": flash_attention_relpos,
          "plain": flash_attention_relpos_reference}


def rel_pos_bias(q: torch.Tensor, rel_pos_h: torch.Tensor,
                 rel_pos_w: torch.Tensor, q_size: Tuple[int, int],
                 k_size: Tuple[int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decomposed rel-pos terms.

    q: (B, nh, qh*qw, head_dim). Returns (rel_h, rel_w) with shapes
    (B, nh, qh, qw, kh) and (B, nh, qh, qw, kw).
    """
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = get_rel_pos(q_h, k_h, rel_pos_h).to(q.dtype)  # (qh, kh, hd)
    rw = get_rel_pos(q_w, k_w, rel_pos_w).to(q.dtype)  # (qw, kw, hd)
    b, nh, _, hd = q.shape
    r_q = q.reshape(b, nh, q_h, q_w, hd)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)
    return rel_h, rel_w


def attention(x: torch.Tensor, qkv_weight: torch.Tensor,
              qkv_bias: Optional[torch.Tensor], proj_weight: torch.Tensor,
              proj_bias: Optional[torch.Tensor], num_heads: int,
              hw: Tuple[int, int],
              rel_pos: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              attn_impl: str = "kernel") -> torch.Tensor:
    """Full attention over an (B, H, W, C) token grid -> (B, H, W, C).

    Weights are in the torch (out, in) layout. rel_pos: optional
    (rel_pos_h (Lh, hd), rel_pos_w (Lw, hd)) tables.
    """
    if attn_impl not in _IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    b, h, w, c = x.shape
    length = h * w
    head_dim = c // num_heads
    bn = b * num_heads
    scale = head_dim ** -0.5

    qkv = linear(x.reshape(b, length, c), qkv_weight, qkv_bias)
    qkv = qkv.reshape(b, length, 3, num_heads, head_dim)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (b, nh, L, hd)
    if rel_pos is not None:
        rel_h, rel_w = rel_pos_bias(q, rel_pos[0], rel_pos[1], (h, w),
                                    (h, w))
        rel_h = rel_h.reshape(bn, length, h).contiguous()
        rel_w = rel_w.reshape(bn, length, w).contiguous()
    else:
        rel_h = q.new_zeros((bn, length, h))
        rel_w = q.new_zeros((bn, length, w))

    def flat(t):
        return t.reshape(bn, length, head_dim).contiguous()

    out, _ = _IMPLS[attn_impl](flat(q), flat(k), flat(v), rel_h, rel_w,
                               (h, w), scale)
    out = out.reshape(b, num_heads, length, head_dim).transpose(1, 2)
    out = linear(out.reshape(b, length, c), proj_weight, proj_bias)
    return out.reshape(b, h, w, c)
