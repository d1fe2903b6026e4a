"""Attention with a decomposed relative-position bias: forward (K1) and
backward (K2).

Hand-written CUDA kernels replace the TPU kernels of
``painter_tpu/kernels/flash_relpos.py``: ``csrc/flash_relpos_fwd.cu``
(``_fwd_impl``) and ``csrc/flash_relpos_bwd.cu`` (``_bwd_impl``) at the
ViT-L shapes, ``csrc/flash_relpos_generic.cu`` (both) at the rest. Their
headers state the contracts, what bounds them on an H100 and what their
designs do about that. Every route runs both types on the tensor cores:
bf16 on ``wgmma`` bf16, fp32 on ``wgmma`` tf32 in three products per
product (3xTF32, ``csrc/flash_relpos_tf32.cuh``: each operand split into
two tf32 parts: fp32 accuracy, whatever PyTorch's TF32 flags say). The
TPU kernels' layout devices (128-lane padding,
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
Under the ``save_kernel*`` remat policies a checkpointed block keeps K1's
outputs under the name ``attn_kernel`` (``ops/remat.py``), so the
backward's recompute never runs K1 again.

Shapes. The domain is the JAX kernel's: ``kh * kw == L`` and
``hd + min(kh, kw) <= 128`` (``_fold_axis``), plus every shape the ViT-L
kernels take beyond it. :func:`attention_route` sends a shape, by its
shape alone, to the ViT-L kernels (``"vitl"``: head_dim 64 within their
rel-term limits) or to the width-generic kernels K1g / K2g
(``"generic"``: ``csrc/flash_relpos_generic.cu``, head dims padded with
zeros to 16, 32, 64 or 128, rel terms of any length: the bias is staged
per tile, so no kh + kw or kw limit), and raises outside the domain with
the JAX message. Each route counts its own launches:
``flash_attention_relpos.launches`` / ``flash_attention_relpos_bwd.launches``
the ViT-L kernels, ``flash_attention_relpos_generic.launches`` /
``flash_attention_relpos_bwd_generic.launches`` the generic ones.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from painter_tpu_torch.kernels import build
from painter_tpu_torch.ops.remat import kept

HEAD_DIM = 64  # the ViT-L kernels' head dim
# the JAX kernel's domain: hd + min(kh, kw) within one 128-lane MXU tile
MXU_LANES = 128
# the head dims K1g / K2g are built for; other head dims are zero-padded
# to the next (80, a ViT-H-width head, runs at 128)
GENERIC_HEAD_DIMS = (16, 32, 64, 128)
# the bf16 forward keeps its 128 rows' rel terms in shared memory: 512
# bytes per (kh + kw) entry beside ~129 KiB of Q and the K / V ring, under
# the 227 KB a block may use (the fp32 forward: the same pairs beside a
# 128 KiB ring of split K and V^T tiles, room for kh + kw <= 195)
MAX_REL_ENTRIES = 190
# the bf16 backward forms d rel_w from one-hot key -> column expanders of
# at most 40 columns, and d rel_h from the <= 8 grid rows a 64-key tile
# touches (kw >= 10)
BWD_BF16_KW = (10, 40)
# the bf16 backward's dq kernel stages its 128 rows' raw bf16 rel_h and
# rel_w in two 16 KiB ring stages before the first K / V tile
# (csrc/flash_relpos_bwd.cu: raw_stage_bytes <= RAW_STAGE_ROOM, 2 x (128
# (kh + kw) + 16) bytes and the alignment of rel_w's block within 32,768),
# so kh + kw <= 127. No other layout binds first: at kh + kw <= 127 the
# bf16 dq kernel takes at most 221,184 B and its dk/dv kernel 136,192 B;
# the fp32 dq kernel's bytes do not depend on kh + kw (230,464 B at its
# widest key tile) and its dk/dv kernel takes at most 230,848 B (its raw
# rel blocks, 128 B per kh + kw and stage), under the 232,448 B a block
# may opt into. The launchers refuse any grid
# their own byte counts exceed.
BWD_MAX_REL_ENTRIES = 127
# the fp32 backward's dq kernel walks key tiles of whole key-grid rows, at
# most F32_TILE_MAX = 48 keys (csrc/flash_relpos_bwd.cu), so that d rel_w
# sums per tile position in registers: kw <= 48
BWD_F32_KW_MAX = 48
_FWD_FUNCS = {torch.bfloat16: "flash_relpos_fwd_bf16",
              torch.float32: "flash_relpos_fwd_f32"}
_BWD_FUNCS = {torch.bfloat16: "flash_relpos_bwd_bf16",
              torch.float32: "flash_relpos_bwd_f32"}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}


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


def attention_route(hd: int, k_size: Tuple[int, int], length: int,
                    dtype: torch.dtype, backward: bool = False) -> str:
    """The kernel a shape goes to on the card, by its shape alone.

    ``"vitl"``: the ViT-L kernels (K1 / K2) -- head_dim 64 within their
    rel-term limits (K1: kh + kw <= 190; K2: kh + kw <= 127, the raw
    rel-term staging of its bf16 dq kernel, in both types, in bf16 kw in
    [10, 40] and in fp32 kw <= 48). ``"generic"``: K1g / K2g, every other
    shape of the JAX kernel's domain ``hd + min(kh, kw) <= 128``, at
    every size on the tensor cores (so Painter ViT-L's backward at
    1440x720, a 90x45 grid, and its forward at 2048x1024, 128x64, run
    there). Raises outside it, with the message of the JAX kernel's
    ``_fold_axis``.
    """
    if dtype not in _FWD_FUNCS:
        raise TypeError(f"flash_relpos takes bf16 or fp32, got {dtype}")
    k_h, k_w = k_size
    if k_h * k_w != length:
        raise ValueError(f"key grid {tuple(k_size)} does not cover "
                         f"L={length}")
    if hd == HEAD_DIM:
        if not backward and k_h + k_w <= MAX_REL_ENTRIES:
            return "vitl"
        if backward and k_h + k_w <= BWD_MAX_REL_ENTRIES and (
                k_w <= BWD_F32_KW_MAX if dtype == torch.float32
                else BWD_BF16_KW[0] <= k_w <= BWD_BF16_KW[1]):
            return "vitl"
    if hd + min(k_h, k_w) <= MXU_LANES:
        return "generic"
    raise ValueError(
        f"head_dim {hd} + min rel table {min(k_h, k_w)} exceeds the "
        f"{MXU_LANES}-lane MXU tile; use the XLA attention path")


def generic_head_dim(hd: int) -> int:
    """The head dim of the K1g / K2g instance that takes ``hd``."""
    return next(d for d in GENERIC_HEAD_DIMS if d >= hd)


def pad_head_dim(d: int, *tensors):
    """Each (BH, L, hd) tensor zero-padded to head dim ``d``: zero columns
    add nothing to q.k or dout.v, and the padded columns of out, dq, dk
    and dv come out zero."""
    return tuple(t if t.shape[-1] == d else
                 F.pad(t, (0, d - t.shape[-1])).contiguous()
                 for t in tensors)


def unpad_head_dim(hd: int, *tensors):
    """The first ``hd`` columns of each (BH, L, d) tensor."""
    return tuple(t if t.shape[-1] == hd else t[..., :hd].contiguous()
                 for t in tensors)


def _check(q, k, v, rel_h, rel_w, k_size, backward=False, **more):
    """What the wrappers check before a launch: the type, the grid and
    the domain (:func:`attention_route`), then every tensor's shape,
    type, device and layout; returns the route."""
    bh, lq, hd = q.shape
    route = attention_route(hd, k_size, lq, q.dtype, backward)
    k_h, k_w = k_size
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
    return route


@build.lookup
def _kernel_fn(dtype: torch.dtype):
    fn = getattr(build.library("flash_relpos_fwd"), _FWD_FUNCS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@build.lookup
def _bwd_kernel_fn(dtype: torch.dtype):
    fn = getattr(build.library("flash_relpos_bwd"), _BWD_FUNCS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@build.lookup
def _generic_fn(direction: str, dtype: torch.dtype):
    fn = getattr(build.library("flash_relpos_generic"),
                 f"flash_relpos_generic_{direction}_{_DTYPE_NAMES[dtype]}")
    n_ptrs = 7 if direction == "fwd" else 14
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@build.lookup
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
    if _check(q, k, v, rel_h, rel_w, k_size) == "generic":
        return flash_attention_relpos_generic(q, k, v, rel_h, rel_w, k_size,
                                              scale)
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
    if _check(q, k, v, rel_h, rel_w, k_size, backward=True, out=out,
              dout=dout, lse=lse) == "generic":
        return flash_attention_relpos_bwd_generic(
            q, k, v, rel_h, rel_w, out, lse, dout, k_size, scale)
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


def flash_attention_relpos_generic(q, k, v, rel_h, rel_w,
                                   k_size: Tuple[int, int], scale: float):
    """K1g, the width-generic forward -> (out, lse), at any shape of the
    JAX kernel's domain.

    Arguments as :func:`flash_attention_relpos`, which sends the shapes
    the ViT-L kernel does not take here. A CPU tensor runs the plain
    version; a CUDA tensor launches K1g (q, k, v zero-padded to the next
    built head dim) or raises.
    """
    if q.device.type == "cpu":
        return flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                k_size, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_relpos has no kernel for {q.device}")
    _check(q, k, v, rel_h, rel_w, k_size)
    bh, lq, hd = q.shape
    d = generic_head_dim(hd)
    q, k, v = pad_head_dim(d, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _generic_fn("fwd", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(),
        rel_w.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, lq, d,
        k_size[0], k_size[1], float(scale), stream)
    if rc:
        raise RuntimeError(
            f"flash_relpos_generic fwd launch failed: "
            f"{_error_string('flash_relpos_generic')(rc).decode()} ({rc})")
    flash_attention_relpos_generic.launches += 1
    return unpad_head_dim(hd, out)[0], lse


flash_attention_relpos_generic.launches = 0


def flash_attention_relpos_bwd_generic(q, k, v, rel_h, rel_w, out, lse,
                                       dout, k_size: Tuple[int, int],
                                       scale: float):
    """K2g, the width-generic backward -> (dq, dk, dv, d_rel_h, d_rel_w).

    Arguments as :func:`flash_attention_relpos_bwd`, which sends the
    shapes the ViT-L kernel does not take here. A CPU tensor runs the
    plain version; a CUDA tensor launches K2g (its dq and dk/dv kernels,
    counted as one launch; q, k, v, dout zero-padded to the next built
    head dim) or raises. ``delta`` is one torch reduction, as in K2.
    """
    if q.device.type == "cpu":
        return flash_attention_relpos_bwd_reference(
            q, k, v, rel_h, rel_w, out, lse, dout, k_size, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_relpos has no kernel for {q.device}")
    _check(q, k, v, rel_h, rel_w, k_size, backward=True, out=out, dout=dout,
           lse=lse)
    bh, lq, hd = q.shape
    delta = (dout.float() * out.float()).sum(-1)
    d = generic_head_dim(hd)
    q, k, v, dout = pad_head_dim(d, q, k, v, dout)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    d_rel_h = torch.empty_like(rel_h)
    d_rel_w = torch.empty_like(rel_w)
    # the rows' fp32 d rel_w totals, zeroed and owned by the dq kernel
    # (which keeps them in shared memory at kw <= 64 and reads no scratch)
    g_w = torch.empty(rel_w.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _generic_fn("bwd", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(),
        rel_w.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), d_rel_h.data_ptr(),
        d_rel_w.data_ptr(), g_w.data_ptr(), bh, lq, d, k_size[0],
        k_size[1], float(scale), stream)
    if rc:
        raise RuntimeError(
            f"flash_relpos_generic bwd launch failed: "
            f"{_error_string('flash_relpos_generic')(rc).decode()} ({rc})")
    flash_attention_relpos_bwd_generic.launches += 1
    return (*unpad_head_dim(hd, dq, dk, dv), d_rel_h, d_rel_w)


flash_attention_relpos_bwd_generic.launches = 0


class FlashAttentionRelpos(torch.autograd.Function):
    """K1 forward, K2 backward (``_attach_vjp`` in JAX).

    Saves exactly ``(q, k, v, rel_h, rel_w, out, lse)``. The gradients
    of ``rel_h`` / ``rel_w`` go on through autograd of the rel-term einsum
    to the tables and into dq, as ``rel_vjp`` carries them in JAX. Under
    a remat policy that keeps ``attn_kernel`` a recompute reuses K1's
    outputs.
    """

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, k_size, scale):
        def compute():
            return flash_attention_relpos(q, k, v, rel_h, rel_w, k_size,
                                          scale)

        out, lse = kept("attn_kernel", compute)
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
