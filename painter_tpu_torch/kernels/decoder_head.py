"""The fused decoder tail: conv3x3 + bias -> LayerNorm -> GELU -> conv1x1,
forward (K3) and backward (K4).

Two hand-written CUDA kernels replace the TPU kernels of
``painter_tpu/kernels/decoder_head.py``: ``csrc/decoder_tail_fwd.cu``
(``_fwd_impl``) and ``csrc/decoder_tail_bwd.cu`` (``_bwd_impl``). Their
headers state the contracts, what bounds them on an H100 and what their
designs do about that. The TPU kernel's layout devices (128-lane channel
padding, the row-block choice, the dx/dy-packed contraction) are not
carried over.

Both follow the JAX kernel's rounding points, not the stock tail's: the
conv weights and the four row vectors (conv1 bias, LN scale and bias,
conv2 bias) are cast to the input type first; products accumulate in
fp32; LayerNorm (eps 1e-6, fp32 statistics, biased variance) and GELU
run in fp32; the GELU output is cast to the input type before the 1x1
conv; the output comes back in the input type. In the backward the
upstream gradient is cast to the input type, dW2 comes from the cast GELU
output, dpix and dW1 from ``du`` cast to the input type, and db1, dLN and
db2 are fp32 sums; gradients are returned in the parameters' types.

:func:`fused_decoder_tail` and :func:`fused_decoder_tail_bwd` dispatch on
the device: CPU tensors go to the plain versions
(:func:`fused_decoder_tail_reference`,
:func:`fused_decoder_tail_bwd_reference`); CUDA tensors launch the kernel
or raise. ``.launches`` on each counts its launches.
:class:`FusedDecoderTail` makes the pair differentiable, as the JAX
``custom_vjp`` does, saving ``(pix, conv1_w, conv1_b, ln_w, ln_b,
conv2_w)``.

Weights are in the torch layout: conv1 (C, C, 3, 3) (``decoder_pred.0``),
conv2 (3, C, 1, 1) (``decoder_pred.3``); pixels and outputs NHWC.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from painter_tpu_torch.kernels import build

LN_EPS = 1e-6
CHANNELS = 64  # the kernels are built for the decoder width of the presets
# K3's and K4's device kernels, as the profiler names them
KERNEL_NAMES = ("strip_kernel", "dw1_kernel", "decoder_tail_fwd_kernel",
                "decoder_tail_bwd_kernel")
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def gelu_grad(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """d gelu(x) / dx, elementwise fp32 (``decoder_head._gelu_grad``)."""
    if approximate:
        c, a = math.sqrt(2.0 / math.pi), 0.044715
        th = torch.tanh(c * (x + a * x ** 3))
        return (0.5 * (1.0 + th)
                + 0.5 * x * (1.0 - th * th) * c * (1.0 + 3.0 * a * x * x))
    phi = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
    return 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0)))) + x * phi


def _rounded(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``v`` cast to the input type, as fp32 for the math."""
    return v.to(dt).float()


def _forward_chain(pix, conv1_w, conv1_b, ln_w, ln_b, approximate):
    """fp32 (u-side) chain -> (n, xhat, rstd, g) over (B, H, W, C)."""
    dt = pix.dtype
    u = F.conv2d(pix.float().permute(0, 3, 1, 2), _rounded(conv1_w, dt),
                 padding=1).permute(0, 2, 3, 1) + _rounded(conv1_b, dt)
    mean = u.mean(dim=-1, keepdim=True)
    var = ((u - mean) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (u - mean) * rstd
    n = xhat * _rounded(ln_w, dt) + _rounded(ln_b, dt)
    return n, xhat, rstd, _gelu(n, approximate)


def fused_decoder_tail_reference(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                                 conv2_b, approximate: bool):
    """Plain forward: pix (B, H, W, C) -> (B, H, W, 3) in pix.dtype."""
    dt = pix.dtype
    c = pix.shape[-1]
    _, _, _, g = _forward_chain(pix, conv1_w, conv1_b, ln_w, ln_b,
                                approximate)
    w2 = _rounded(conv2_w, dt).reshape(3, c)
    out = torch.matmul(g.to(dt).float(), w2.t()) + _rounded(conv2_b, dt)
    return out.to(dt)


def fused_decoder_tail_bwd_reference(pix, conv1_w, conv1_b, ln_w, ln_b,
                                     conv2_w, grad_out, approximate: bool):
    """Plain backward, the kernel's math (not autograd).

    Recomputes the forward chain, then with ``go`` = grad_out cast to
    pix.dtype: dg = go . W2, dn = dg * gelu'(n), the LayerNorm backward
    ``du = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat))``; dpix is
    the transposed conv of ``du`` (cast to pix.dtype) and dW1 its
    correlation with pix. Returns (dpix in pix.dtype, dW1, db1, dLN scale,
    dLN bias, dW2, db2 in the parameters' types and layouts).
    """
    dt = pix.dtype
    c = pix.shape[-1]
    n, xhat, rstd, g = _forward_chain(pix, conv1_w, conv1_b, ln_w, ln_b,
                                      approximate)
    w2 = _rounded(conv2_w, dt).reshape(3, c)
    go = grad_out.to(dt).float()
    dn = torch.matmul(go, w2) * gelu_grad(n, approximate)
    dxhat = dn * _rounded(ln_w, dt)
    mx = dxhat.mean(dim=-1, keepdim=True)
    mxx = (dxhat * xhat).mean(dim=-1, keepdim=True)
    du = rstd * (dxhat - mx - xhat * mxx)
    du_r = du.to(dt).float().permute(0, 3, 1, 2)
    pix_f = pix.float().permute(0, 3, 1, 2)
    w1 = _rounded(conv1_w, dt)
    dpix = torch.nn.grad.conv2d_input(pix_f.shape, w1, du_r, padding=1)
    dw1 = torch.nn.grad.conv2d_weight(pix_f, w1.shape, du_r, padding=1)
    flat = (-1, c)
    dw2 = torch.matmul(g.to(dt).float().reshape(flat).t(),
                       go.reshape(-1, 3))  # (C, 3)
    return (dpix.permute(0, 2, 3, 1).to(dt),
            dw1.to(conv1_w.dtype),
            du.reshape(flat).sum(0).to(conv1_b.dtype),
            (dn * xhat).reshape(flat).sum(0).to(ln_w.dtype),
            dn.reshape(flat).sum(0).to(ln_b.dtype),
            dw2.t().reshape(conv2_w.shape).to(conv2_w.dtype),
            go.reshape(-1, 3).sum(0).to(conv2_w.dtype))


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

@build.lookup
def _fn(name: str, symbol: str, n_ptrs: int, n_ints: int):
    fn = getattr(build.library(name), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@build.lookup
def _error_string(name: str):
    fn = getattr(build.library(name), f"{name}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn


def _raise_if(rc: int, name: str):
    if rc:
        raise RuntimeError(f"{name} launch failed: "
                           f"{_error_string(name)(rc).decode()} ({rc})")


def _check_pix(pix, *more):
    if pix.device.type != "cuda":
        raise RuntimeError(f"decoder_tail has no kernel for {pix.device}")
    if pix.dtype not in _DTYPES:
        raise TypeError(f"decoder_tail takes bf16 or fp32, got {pix.dtype}")
    if pix.dim() != 4 or pix.shape[-1] != CHANNELS:
        raise ValueError(f"the kernels are built for (B, H, W, {CHANNELS}) "
                         f"pixels, got {tuple(pix.shape)}")
    for t in (pix,) + more:
        if t.device != pix.device:
            raise TypeError(f"tensors on {t.device} and {pix.device}")


def _packed_params(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w):
    """Kernel layout, all in pix.dtype: W1 (3, 3, C_in, C_out) = (tap, c,
    o), b1, LN scale, LN bias (C,), W2 (C, 3)."""
    dt = pix.dtype
    c = pix.shape[-1]
    if tuple(conv1_w.shape) != (c, c, 3, 3) or \
            tuple(conv2_w.shape) != (3, c, 1, 1):
        raise ValueError(f"conv weights {tuple(conv1_w.shape)} / "
                         f"{tuple(conv2_w.shape)} do not fit C={c}")
    w1 = conv1_w.to(dt).permute(2, 3, 1, 0).contiguous()
    w2 = conv2_w.to(dt).reshape(3, c).t().contiguous()
    rows = [v.to(dt).reshape(-1).contiguous() for v in (conv1_b, ln_w, ln_b)]
    return (w1, *rows, w2)


def fused_decoder_tail(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b,
                       approximate: bool):
    """Fused tail forward (B, H, W, C) -> (B, H, W, 3) in pix.dtype.

    A CPU tensor runs the plain version; a CUDA tensor launches K3 on the
    current stream or raises. Not differentiable: :func:`decoder_tail_fn`
    is.
    """
    if pix.device.type == "cpu":
        return fused_decoder_tail_reference(pix, conv1_w, conv1_b, ln_w,
                                            ln_b, conv2_w, conv2_b,
                                            approximate)
    _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b)
    pix = pix.contiguous()
    w1, b1, lns, lnb, w2 = _packed_params(pix, conv1_w, conv1_b, ln_w, ln_b,
                                          conv2_w)
    b2 = conv2_b.to(pix.dtype).reshape(-1).contiguous()
    b, h, w, _ = pix.shape
    out = torch.empty((b, h, w, 3), dtype=pix.dtype, device=pix.device)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    rc = _fn("decoder_tail_fwd", f"decoder_tail_fwd_{_DTYPES[pix.dtype]}",
             8, 4)(pix.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                   lns.data_ptr(), lnb.data_ptr(), w2.data_ptr(),
                   b2.data_ptr(), out.data_ptr(), b, h, w,
                   int(bool(approximate)), stream)
    _raise_if(rc, "decoder_tail_fwd")
    fused_decoder_tail.launches += 1
    return out


fused_decoder_tail.launches = 0


@build.lookup
def _partials_fn():
    fn = build.library("decoder_tail_bwd").decoder_tail_bwd_partials
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    return fn


def _bwd_partial_shapes(b: int, h: int, w: int, dtype: torch.dtype):
    """K4's fp32 partial buffers at (b, h, w) for ``dtype``, as its source
    sizes them: ((sets, 9 C C) for dW1, (rows, 6 C + 3) for db1, dLN scale,
    dLN bias, dW2 (C, 3) and db2)."""
    shape = (ctypes.c_int * 4)()
    _partials_fn()(b, h, w, int(dtype == torch.bfloat16), shape)
    return (shape[0], shape[1]), (shape[2], shape[3])


def fused_decoder_tail_bwd(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                           grad_out, approximate: bool):
    """Fused tail backward -> (dpix, dW1, db1, dLN scale, dLN bias, dW2,
    db2), as :func:`fused_decoder_tail_bwd_reference`.

    A CPU tensor runs the plain version; a CUDA tensor launches K4 on the
    current stream or raises. K4 writes dpix whole and per-CTA fp32
    partials of the parameter gradients; one ``torch.sum`` over the
    partials finishes them, as the JAX package sums its per-block
    partials in XLA. In bf16 K4 is three launches (du, dpix, dW1) that
    pass ``du`` through a scratch tensor; they count as one call in
    ``fused_decoder_tail_bwd.launches``.
    """
    if pix.device.type == "cpu":
        return fused_decoder_tail_bwd_reference(
            pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, grad_out,
            approximate)
    _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, grad_out)
    pix = pix.contiguous()
    b, h, w, c = pix.shape
    if tuple(grad_out.shape) != (b, h, w, 3):
        raise ValueError(f"grad_out has shape {tuple(grad_out.shape)}, "
                         f"expected {(b, h, w, 3)}")
    go = grad_out.to(pix.dtype).contiguous()
    w1, b1, lns, lnb, w2 = _packed_params(pix, conv1_w, conv1_b, ln_w, ln_b,
                                          conv2_w)
    dw1_shape, small_shape = _bwd_partial_shapes(b, h, w, pix.dtype)
    dpix = torch.empty_like(pix)
    # bf16: du (rounded to bf16, as the contract rounds it) between launches
    du = torch.empty_like(pix) if pix.dtype == torch.bfloat16 else None
    dw1_part = torch.empty(dw1_shape, dtype=torch.float32, device=pix.device)
    small_part = torch.empty(small_shape, dtype=torch.float32,
                             device=pix.device)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    rc = _fn("decoder_tail_bwd", f"decoder_tail_bwd_{_DTYPES[pix.dtype]}",
             11, 4)(pix.data_ptr(), go.data_ptr(), w1.data_ptr(),
                    b1.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
                    w2.data_ptr(), dpix.data_ptr(), dw1_part.data_ptr(),
                    small_part.data_ptr(),
                    None if du is None else du.data_ptr(), b, h, w,
                    int(bool(approximate)), stream)
    _raise_if(rc, "decoder_tail_bwd")
    fused_decoder_tail_bwd.launches += 1
    dw1 = dw1_part.sum(0).reshape(3, 3, c, c).permute(3, 2, 0, 1)
    small = small_part.sum(0)
    db1, dlns, dlnb = small[:c], small[c:2 * c], small[2 * c:3 * c]
    dw2 = small[3 * c:6 * c].reshape(c, 3)
    db2 = small[6 * c:]
    return (dpix, dw1.to(conv1_w.dtype), db1.to(conv1_b.dtype),
            dlns.to(ln_w.dtype), dlnb.to(ln_b.dtype),
            dw2.t().reshape(conv2_w.shape).to(conv2_w.dtype),
            db2.to(conv2_w.dtype))


fused_decoder_tail_bwd.launches = 0


class FusedDecoderTail(torch.autograd.Function):
    """K3 forward, K4 backward (the JAX ``custom_vjp`` of
    ``fused_decoder_tail``); saves ``(pix, conv1_w, conv1_b, ln_w, ln_b,
    conv2_w)``, the residuals of ``_tail_fwd``."""

    @staticmethod
    def forward(ctx, pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b,
                approximate):
        ctx.save_for_backward(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w)
        ctx.approximate = approximate
        return fused_decoder_tail(pix, conv1_w, conv1_b, ln_w, ln_b,
                                  conv2_w, conv2_b, approximate)

    @staticmethod
    def backward(ctx, grad_out):
        grads = fused_decoder_tail_bwd(*ctx.saved_tensors,
                                       grad_out.contiguous(),
                                       ctx.approximate)
        return (*grads, None)


def decoder_tail_fn(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b,
                    approximate: bool):
    """Differentiable fused tail: K3 / K4 on CUDA tensors, their plain
    versions on CPU tensors."""
    return FusedDecoderTail.apply(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                                  conv2_b, bool(approximate))
