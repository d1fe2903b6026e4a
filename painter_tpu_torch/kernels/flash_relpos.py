"""Attention forward with a decomposed relative-position bias.

The hand-written CUDA kernel ``csrc/flash_relpos_fwd.cu`` replaces the
TPU kernel ``painter_tpu/kernels/flash_relpos.py:_fwd_impl``; its header
states the contract, what bounds it on an H100 and what its design does
about that. The TPU kernel's layout devices (128-lane padding, a bias
axis folded into the QK contraction, the ones-column in V, the fixed-max
softmax) are not carried over: the kernel is a flash-style online softmax
over streamed K/V tiles.

:func:`flash_attention_relpos` dispatches on the tensors' device: CPU
tensors go to :func:`flash_attention_relpos_reference`, the plain version
(the JAX stock path ``ops/attention.py:78-86``); CUDA tensors launch the
kernel or raise. ``flash_attention_relpos.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from painter_tpu_torch.kernels import build

HEAD_DIM = 64
# the kernel keeps the tile's rel terms in shared memory: 256 bytes per
# (kh + kw) entry beside ~100 KB of tiles, under the 227 KB a block may use
MAX_REL_ENTRIES = 400
_FUNCS = {torch.bfloat16: "flash_relpos_fwd_bf16",
          torch.float32: "flash_relpos_fwd_f32"}


def flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                     k_size: Tuple[int, int], scale: float):
    """Plain version: materializes the (BH, L, L) fp32 logits.

    q, k, v (BH, L, hd); rel_h (BH, L, kh), rel_w (BH, L, kw) with
    kh * kw == L. Returns (out (BH, L, hd) in q.dtype, lse (BH, L) fp32,
    natural log). The softmax runs in fp32 and P is cast to the input
    type before P.V, as in the kernel.
    """
    bh, lq, _ = q.shape
    k_h, k_w = k_size
    s = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    s = s.view(bh, lq, k_h, k_w)
    s = s + rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
    s = s.view(bh, lq, k_h * k_w)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v), lse


def _check(q, k, v, rel_h, rel_w, k_size):
    if q.dtype not in _FUNCS:
        raise TypeError(f"flash_relpos takes bf16 or fp32, got {q.dtype}")
    bh, lq, hd = q.shape
    k_h, k_w = k_size
    if hd != HEAD_DIM:
        raise ValueError(f"the kernel is built for head_dim {HEAD_DIM}, "
                         f"got {hd}")
    if k_h * k_w != lq:
        raise ValueError(f"key grid {k_size} does not cover L={lq}")
    if k_h + k_w > MAX_REL_ENTRIES:
        raise ValueError(f"key grid {k_size} exceeds the kernel's "
                         f"{MAX_REL_ENTRIES} rel-term entries")
    shapes = {"q": (q, (bh, lq, hd)), "k": (k, (bh, lq, hd)),
              "v": (v, (bh, lq, hd)), "rel_h": (rel_h, (bh, lq, k_h)),
              "rel_w": (rel_w, (bh, lq, k_w))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; expected "
                            f"{q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


@functools.cache
def _kernel_fn(dtype: torch.dtype):
    fn = getattr(build.library("flash_relpos_fwd"), _FUNCS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _error_string():
    fn = build.library("flash_relpos_fwd").flash_relpos_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn


def flash_attention_relpos(q, k, v, rel_h, rel_w, k_size: Tuple[int, int],
                           scale: float):
    """Fused attention forward -> (out (BH, L, hd), lse (BH, L) fp32).

    Arguments as :func:`flash_attention_relpos_reference`. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel on the
    current stream (no synchronization) or raises.
    """
    if q.device.type == "cpu":
        return flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                k_size, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_relpos has no kernel for {q.device}")
    _check(q, k, v, rel_h, rel_w, k_size)
    bh, lq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel_fn(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(),
        rel_w.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, lq,
        k_size[0], k_size[1], float(scale), stream)
    if rc:
        raise RuntimeError(f"flash_relpos_fwd launch failed: "
                           f"{_error_string()(rc).decode()} ({rc})")
    flash_attention_relpos.launches += 1
    return out, lse


flash_attention_relpos.launches = 0
