"""Attention with a decomposed relative-position bias: forward (K1) and
backward (K2).

Two hand-written CUDA kernels replace the TPU kernels of
``painter_tpu/kernels/flash_relpos.py``: ``csrc/flash_relpos_fwd.cu``
(``_fwd_impl``) and ``csrc/flash_relpos_bwd.cu`` (``_bwd_impl``). Their
headers state the contracts, what bounds them on an H100 and what their
designs do about that. The TPU kernels' layout devices (128-lane padding,
a bias axis folded into the QK contraction, the ones-column in V, the
fixed-max softmax) are not carried over.

:func:`flash_attention_relpos` and :func:`flash_attention_relpos_bwd`
dispatch on the tensors' device: CPU tensors go to the plain versions
(:func:`flash_attention_relpos_reference`, the JAX stock path
``ops/attention.py:78-86``, and :func:`flash_attention_relpos_bwd_reference`);
CUDA tensors launch the kernel or raise. ``.launches`` on each counts its
launches.

:class:`FlashAttentionRelpos` makes the pair differentiable, as
``_flash_core`` / ``_attach_vjp`` do in JAX: its forward runs K1 and saves
exactly ``(q, k, v, rel_h, rel_w, out, lse)``; its backward runs K2.
:class:`KernelOutputCache` keeps K1's outputs of a checkpointed block, so
the backward's recompute never runs K1 again (the JAX ``save_kernel``
remat policy).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
from typing import Tuple

import torch

from painter_tpu_torch.kernels import build

HEAD_DIM = 64
# the bf16 forward keeps its 128 rows' rel terms in shared memory: 512
# bytes per (kh + kw) entry beside ~129 KiB of Q and the K / V ring, under
# the 227 KB a block may use
MAX_REL_ENTRIES = 190
# the bf16 backward's dq kernel keeps its 128 rows' rel terms and d rel_h
# sums as fp32 pairs: 1 KiB per entry beside ~94 KiB of Q, dO, the K / V
# ring and the expanders
BWD_MAX_REL_ENTRIES = 110
# the bf16 backward forms d rel_w from one-hot key -> column expanders of
# at most 40 columns, and d rel_h from the <= 8 grid rows a 64-key tile
# touches (kw >= 10)
BWD_BF16_KW = (10, 40)
_FWD_FUNCS = {torch.bfloat16: "flash_relpos_fwd_bf16",
              torch.float32: "flash_relpos_fwd_f32"}
_BWD_FUNCS = {torch.bfloat16: "flash_relpos_bwd_bf16",
              torch.float32: "flash_relpos_bwd_f32"}


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


def flash_attention_relpos_bwd_reference(q, k, v, rel_h, rel_w, out, lse,
                                         dout, k_size: Tuple[int, int],
                                         scale: float):
    """Plain backward: materializes P (BH, L, L) fp32 from ``lse``.

    The same math as the kernel, not autograd: P = exp(S - lse),
    delta = rowsum(dout * out) from the saved ``out``,
    dS = P * (dout . v^T - delta); dq = scale dS.k, dk = scale dS^T.q,
    dv = P^T.dout; d_rel_h / d_rel_w are the row sums of dS grouped by
    key-grid row / column. P and dS are cast to the input type before the
    products and sums that read them, as in the kernel and the JAX kernel
    (its ``ds_b``). Returns (dq, dk, dv, d_rel_h, d_rel_w) in q.dtype.
    """
    bh, lq, _ = q.shape
    k_h, k_w = k_size
    dt = q.dtype
    s = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    s = s.view(bh, lq, k_h, k_w)
    s = s + rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
    p = torch.exp(s.view(bh, lq, lq) - lse[..., None])
    do = dout.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(1, 2), do)
    ds = p * (torch.matmul(do, v.float().transpose(1, 2)) - delta)
    del p
    dsr = ds.to(dt).float()
    dq = torch.matmul(dsr, k.float()) * scale
    dk = torch.matmul(dsr.transpose(1, 2), q.float()) * scale
    ds4 = dsr.view(bh, lq, k_h, k_w)
    return (dq.to(dt), dk.to(dt), dv.to(dt), ds4.sum(-1).to(dt),
            ds4.sum(-2).to(dt))


def _check(q, k, v, rel_h, rel_w, k_size, max_rel=MAX_REL_ENTRIES,
           bf16_kw=None, **more):
    if q.dtype not in _FWD_FUNCS:
        raise TypeError(f"flash_relpos takes bf16 or fp32, got {q.dtype}")
    bh, lq, hd = q.shape
    k_h, k_w = k_size
    if hd != HEAD_DIM:
        raise ValueError(f"the kernel is built for head_dim {HEAD_DIM}, "
                         f"got {hd}")
    if k_h * k_w != lq:
        raise ValueError(f"key grid {k_size} does not cover L={lq}")
    if k_h + k_w > max_rel:
        raise ValueError(f"key grid {k_size} exceeds the kernel's "
                         f"{max_rel} rel-term entries")
    if bf16_kw and q.dtype == torch.bfloat16 and not (
            bf16_kw[0] <= k_w <= bf16_kw[1]):
        raise ValueError(f"key grid {k_size}: the bf16 kernel takes a grid "
                         f"width in [{bf16_kw[0]}, {bf16_kw[1]}]")
    shapes = {"q": (q, (bh, lq, hd), q.dtype),
              "k": (k, (bh, lq, hd), q.dtype),
              "v": (v, (bh, lq, hd), q.dtype),
              "rel_h": (rel_h, (bh, lq, k_h), q.dtype),
              "rel_w": (rel_w, (bh, lq, k_w), q.dtype)}
    for name, t in more.items():
        shapes[name] = (t, (bh, lq) if name in ("lse", "delta")
                        else (bh, lq, hd),
                        torch.float32 if name in ("lse", "delta")
                        else q.dtype)
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; expected "
                            f"{dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


@functools.cache
def _kernel_fn(dtype: torch.dtype):
    fn = getattr(build.library("flash_relpos_fwd"), _FWD_FUNCS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel_fn(dtype: torch.dtype):
    fn = getattr(build.library("flash_relpos_bwd"), _BWD_FUNCS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _error_string(name: str):
    fn = getattr(build.library(name), f"{name}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn


def flash_attention_relpos(q, k, v, rel_h, rel_w, k_size: Tuple[int, int],
                           scale: float):
    """Fused attention forward -> (out (BH, L, hd), lse (BH, L) fp32).

    Arguments as :func:`flash_attention_relpos_reference`. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel on the
    current stream (no synchronization) or raises. Not differentiable:
    :func:`flash_attention_relpos_fn` is.
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
                           f"{_error_string('flash_relpos_fwd')(rc).decode()}"
                           f" ({rc})")
    flash_attention_relpos.launches += 1
    return out, lse


flash_attention_relpos.launches = 0


def flash_attention_relpos_bwd(q, k, v, rel_h, rel_w, out, lse, dout,
                               k_size: Tuple[int, int], scale: float):
    """Fused attention backward -> (dq, dk, dv, d_rel_h, d_rel_w).

    Arguments as :func:`flash_attention_relpos_bwd_reference`. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel
    (its dq and dk/dv passes, counted as one launch) on the current
    stream or raises. ``delta = rowsum(dout * out)`` is one torch
    reduction in fp32 from the saved ``out``, as ``_flash_bwd`` forms it.
    """
    if q.device.type == "cpu":
        return flash_attention_relpos_bwd_reference(
            q, k, v, rel_h, rel_w, out, lse, dout, k_size, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_relpos has no kernel for {q.device}")
    _check(q, k, v, rel_h, rel_w, k_size, max_rel=BWD_MAX_REL_ENTRIES,
           bf16_kw=BWD_BF16_KW, out=out, dout=dout, lse=lse)
    bh, lq, _ = q.shape
    delta = (dout.float() * out.float()).sum(-1)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    d_rel_h = torch.empty_like(rel_h)
    d_rel_w = torch.empty_like(rel_w)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bwd_kernel_fn(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(),
        rel_w.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), d_rel_h.data_ptr(),
        d_rel_w.data_ptr(), bh, lq, k_size[0], k_size[1], float(scale),
        stream)
    if rc:
        raise RuntimeError(f"flash_relpos_bwd launch failed: "
                           f"{_error_string('flash_relpos_bwd')(rc).decode()}"
                           f" ({rc})")
    flash_attention_relpos_bwd.launches += 1
    return dq, dk, dv, d_rel_h, d_rel_w


flash_attention_relpos_bwd.launches = 0


class KernelOutputCache:
    """K1's outputs of one checkpointed block, kept for its recompute.

    The "save_kernel" remat policy (``_flash_core``'s named residuals in
    JAX): inside :meth:`active`, the block's first run records each
    attention forward's ``(out, lse)``; a later run of the same block (the
    checkpoint's recompute in the backward) takes them back in order
    instead of launching K1 again. Only the outputs are kept: the
    recompute re-runs LN, the gemms and the MLP.
    """

    def __init__(self):
        self._saved = []
        self._runs = 0

    @contextlib.contextmanager
    def active(self):
        token = _ACTIVE_CACHE.set(self)
        try:
            yield
        finally:
            _ACTIVE_CACHE.reset(token)
            self._runs += 1

    def forward(self, compute):
        if self._runs == 0:
            out, lse = compute()
            # aliases: each Function application returns its own objects
            self._saved.append((out.detach(), lse.detach()))
            return out, lse
        if self._saved:
            return self._saved.pop(0)
        return compute()


_ACTIVE_CACHE: contextvars.ContextVar = contextvars.ContextVar(
    "flash_relpos_kernel_output_cache", default=None)


class FlashAttentionRelpos(torch.autograd.Function):
    """K1 forward, K2 backward (``_attach_vjp`` in JAX).

    Saves exactly ``(q, k, v, rel_h, rel_w, out, lse)``. The gradients
    of ``rel_h`` / ``rel_w`` go on through autograd of the rel-term einsum
    to the tables and into dq, as ``rel_vjp`` carries them in JAX. Under
    an active :class:`KernelOutputCache` a recompute reuses K1's outputs.
    """

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, k_size, scale):
        def compute():
            return flash_attention_relpos(q, k, v, rel_h, rel_w, k_size,
                                          scale)

        cache = _ACTIVE_CACHE.get()
        out, lse = compute() if cache is None else cache.forward(compute)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.k_size = tuple(k_size)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, rel_h, rel_w, out, lse = ctx.saved_tensors
        grads = flash_attention_relpos_bwd(
            q, k, v, rel_h, rel_w, out, lse, dout.contiguous(), ctx.k_size,
            ctx.scale)
        return (*grads, None, None)


def flash_attention_relpos_fn(q, k, v, rel_h, rel_w,
                              k_size: Tuple[int, int], scale: float):
    """Differentiable attention -> (out, lse); K1 forward, K2 backward on
    CUDA tensors, their plain versions on CPU tensors."""
    return FlashAttentionRelpos.apply(q, k, v, rel_h, rel_w, tuple(k_size),
                                      float(scale))
