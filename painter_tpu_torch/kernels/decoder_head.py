"""The fused decoder tail: conv3x3 + bias -> LayerNorm -> GELU -> conv1x1,
forward (K3) and backward (K4).

Hand-written CUDA kernels replace the TPU kernels of
``painter_tpu/kernels/decoder_head.py``: in bf16 ``csrc/decoder_tail_fwd.cu``
(``_fwd_impl``) and ``csrc/decoder_tail_bwd.cu`` (``_bwd_impl``) at the
presets' C = 64; ``csrc/decoder_tail_tc_fwd.cu`` / ``decoder_tail_tc_bwd.cu``
(a tensor-core implicit GEMM: bf16, or 3xTF32 in fp32) at every other C >= 9
and, in fp32, at C = 64 too; ``csrc/decoder_tail_generic.cu``
(``mma.sync`` with the taps packed into K, bf16 or 3xTF32) at C <= 8.
Their headers state the contracts, what bounds them on an H100 and what
their designs do about that. The TPU kernel's layout devices
(128-lane channel padding, the row-block choice, the dx/dy-packed
contraction) are not carried over.

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

Widths. :func:`decoder_route` sends a width, by its shape alone, to the
kernels the presets' C = 64 runs on (``"vitl"``: any H and W; K3 / K4,
whose fp32 route launches the tensor-core kernels in 3xTF32) or to the
width-generic kernels K3g / K4g (``"generic"``: every other C >= 1, as
the JAX kernel takes any C). :func:`generic_tail_route` picks K3g / K4g's
route by shape and type: ``"tc"`` (C >= 9 in bf16 and fp32: the tensor-core
implicit GEMM of ``csrc/decoder_tail_tc_fwd.cu`` / ``decoder_tail_tc_bwd.cu``,
the pixels read unpadded where C % 8 == 0, the parameters packed by one
launch, in fp32 with W1 split into big and small tf32 parts; past 512
channels in bf16, 256 in fp32, u in an fp32 scratch) or ``"narrow"``
(``csrc/decoder_tail_generic.cu`` at C <= 8 in both types: the unpadded
pixels and the parameters in their torch layouts, padded to 8 channels in
shared memory; tiles by :func:`narrow_tiling`); :func:`generic_channels`
gives the padded width. LayerNorm runs over the real C. Each route counts
its own launches: ``fused_decoder_tail.launches`` /
``fused_decoder_tail_bwd.launches`` the C = 64 kernels (both types),
``fused_decoder_tail_generic.launches`` /
``fused_decoder_tail_bwd_generic.launches`` the generic ones on the narrow
route, ``fused_decoder_tail_tc.launches`` /
``fused_decoder_tail_bwd_tc.launches`` on the tensor-core route.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from painter_tpu_torch.kernels import build

LN_EPS = 1e-6
CHANNELS = 64  # the ViT-L kernels are built for the presets' decoder width
# widths from TC_MIN_CHANNELS on go to the tensor-core route
# (csrc/decoder_tail_tc_*.cu; bf16 C = 64 goes to K3 / K4 first); past
# TC_ROW_CHANNELS (bf16) / TC_ROW_CHANNELS_F32 its u goes through an fp32
# scratch. Below it the narrow route (csrc/decoder_tail_generic.cu): the
# tensor-core route's 64-channel K chunks and N >= 64 warpgroup tiles
# multiply mostly zeros there (at tiny_test's (2, 64, 32, 8) they took
# 1.3-1.6x the device time of a one-thread-per-pixel FMA design; H100 80GB
# HBM3, 700 W; PERF.md section 6)
TC_MIN_CHANNELS = 9
# the narrow route (C <= 8): the width the pixels are padded to in shared
# memory; output columns of a tile (TW of the source); the tile's rows, the
# most of these that gives two tiles per SM (narrow_tiling); the values of
# a row of K4g's partial sums (NPART). The persistent CTAs an SM holds come
# from the kernels themselves (_narrow_ctas_per_sm)
NARROW_CHANNELS = 8
NARROW_TILE_W = 32
NARROW_TILE_ROWS = (16, 8, 4, 2)
NARROW_PARTIALS = 9 * NARROW_CHANNELS ** 2 + 6 * NARROW_CHANNELS + 3
TC_ROW_CHANNELS = 512
TC_ROW_CHANNELS_F32 = 256  # fp32 warpgroups stop at N = 128
TC_STEP = 8  # the tensor-core route's channel padding (16-byte rows)
TC_TILE = 64  # pixels per unit: du^T's image rows are padded to it (fp32)
# K3's and K4's device kernels, as the profiler names them (bf16: the strip
# kernels; fp32: the tensor-core route's)
KERNEL_NAMES = ("strip_kernel", "dw1_kernel", "tc::conv_kernel<",
                "tc::dw1_tf32_kernel", "tc::pack_kernel", "tc::row_")
# the narrow route's device kernels, as the profiler names them
NARROW_KERNEL_NAMES = ("narrow::fwd_kernel<", "narrow::bwd_kernel<",
                       "narrow::reduce_kernel")
# the tensor-core route's (K1's forward kernel is a fwd_kernel< too)
TC_KERNEL_NAMES = ("tc::pack_kernel", "tc::conv_kernel<", "tc::dw1_kernel<",
                   "tc::dw1_tf32_kernel", "tc::row_fwd_kernel<",
                   "tc::row_bwd_kernel<")
# K3g's and K4g's device kernels on either route
GENERIC_KERNEL_NAMES = NARROW_KERNEL_NAMES + TC_KERNEL_NAMES
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


def decoder_route(c: int, dtype: torch.dtype) -> str:
    """The kernel a decoder width goes to on the card, by its shape alone:
    ``"vitl"`` (K3 / K4, C = 64) or ``"generic"`` (K3g / K4g, every other
    C >= 1). Raises on other types and on C < 1."""
    if dtype not in _DTYPES:
        raise TypeError(f"decoder_tail takes bf16 or fp32, got {dtype}")
    if c == CHANNELS:
        return "vitl"
    if c >= 1:
        return "generic"
    raise ValueError(f"decoder width {c}: the kernels take C >= 1")


def generic_tail_route(c: int, dtype: torch.dtype) -> str:
    """K3g / K4g's route for a width :func:`decoder_route` sends to them,
    by shape and type alone: ``"tc"`` (C >= ``TC_MIN_CHANNELS`` in bf16 and
    fp32, the tensor-core kernels) or ``"narrow"`` (C <= 8:
    ``csrc/decoder_tail_generic.cu``). Raises as decoder_route."""
    decoder_route(c, dtype)
    return "tc" if c >= TC_MIN_CHANNELS else "narrow"


def generic_channels(c: int, dtype: torch.dtype = torch.float32) -> int:
    """The width K3g / K4g run ``c`` channels at: on the tensor-core route
    ``c`` rounded up to a multiple of ``TC_STEP``; on the narrow route
    ``NARROW_CHANNELS`` (in shared memory)."""
    if generic_tail_route(c, dtype) == "tc":
        return -(-c // TC_STEP) * TC_STEP
    return NARROW_CHANNELS


def narrow_tiling(b: int, h: int, w: int, sms: int):
    """(th, tiles) of the narrow route at (b, h, w) on ``sms`` SMs: tiles of
    ``NARROW_TILE_W`` columns by th rows, th the most of
    ``NARROW_TILE_ROWS`` that gives at least two tiles per SM (else the
    fewest rows), and the number of tiles."""
    cols = -(-w // NARROW_TILE_W)
    for th in NARROW_TILE_ROWS:
        tiles = b * cols * -(-h // th)
        if tiles >= 2 * sms:
            break
    return th, tiles


def narrow_grid(tiles: int, per_sm: int, sms: int) -> int:
    """The narrow route's persistent CTAs: the fewest that take ``tiles``
    in as few rounds as ``per_sm`` CTAs on each of ``sms`` SMs would; CTA
    i takes tiles i, i + grid, ..."""
    rounds = -(-tiles // (per_sm * sms))
    return -(-tiles // rounds)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_pix(pix, *more) -> str:
    """Checks the pixels and the other tensors' device; returns the
    route (:func:`decoder_route`)."""
    if pix.device.type != "cuda":
        raise RuntimeError(f"decoder_tail has no kernel for {pix.device}")
    if pix.dim() != 4:
        raise ValueError(f"the kernels take (B, H, W, C) pixels, got "
                         f"{tuple(pix.shape)}")
    for t in (pix,) + more:
        if t.device != pix.device:
            raise TypeError(f"tensors on {t.device} and {pix.device}")
    return decoder_route(pix.shape[-1], pix.dtype)


def _pad_channels(x: torch.Tensor, n: int, dims) -> torch.Tensor:
    """``x`` zero-padded to ``n`` along each of ``dims``."""
    pad = [0] * (2 * x.dim())
    for d in dims:
        pad[2 * (x.dim() - 1 - d) + 1] = n - x.shape[d]
    return F.pad(x, pad)


def _check_weights(c, conv1_w, conv2_w):
    if tuple(conv1_w.shape) != (c, c, 3, 3) or \
            tuple(conv2_w.shape) != (3, c, 1, 1):
        raise ValueError(f"conv weights {tuple(conv1_w.shape)} / "
                         f"{tuple(conv2_w.shape)} do not fit C={c}")


def _packed_params(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w):
    """The C = 64 kernels' layout, all in pix.dtype: W1 (3, 3, C_in, C_out)
    = (tap, c, o), b1, LN scale, LN bias (C,), W2 (C, 3)."""
    dt = pix.dtype
    c = pix.shape[-1]
    _check_weights(c, conv1_w, conv2_w)
    w1 = conv1_w.to(dt).permute(2, 3, 1, 0).contiguous()
    w2 = conv2_w.to(dt).reshape(3, c).t().contiguous()
    rows = [v.to(dt).reshape(-1).contiguous() for v in (conv1_b, ln_w, ln_b)]
    return (w1, *rows, w2)


def fused_decoder_tail(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b,
                       approximate: bool):
    """Fused tail forward (B, H, W, C) -> (B, H, W, 3) in pix.dtype.

    A CPU tensor runs the plain version; a CUDA tensor launches K3 on the
    current stream or raises: in bf16 ``csrc/decoder_tail_fwd.cu``'s
    kernel, in fp32 the packing launch and ``csrc/decoder_tail_tc_fwd.cu``'s
    3xTF32 kernel. Not differentiable: :func:`decoder_tail_fn` is.
    """
    if pix.device.type == "cpu":
        return fused_decoder_tail_reference(pix, conv1_w, conv1_b, ln_w,
                                            ln_b, conv2_w, conv2_b,
                                            approximate)
    if _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                  conv2_b) == "generic":
        return fused_decoder_tail_generic(pix, conv1_w, conv1_b, ln_w, ln_b,
                                          conv2_w, conv2_b, approximate)
    if pix.dtype == torch.float32:
        out = _tc_forward(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                          conv2_b, approximate)
        fused_decoder_tail.launches += 1
        return out
    pix = pix.contiguous()
    w1, b1, lns, lnb, w2 = _packed_params(pix, conv1_w, conv1_b, ln_w, ln_b,
                                          conv2_w)
    b2 = conv2_b.to(pix.dtype).reshape(-1).contiguous()
    b, h, w, _ = pix.shape
    out = torch.empty((b, h, w, 3), dtype=pix.dtype, device=pix.device)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    rc = _fn("decoder_tail_fwd", "decoder_tail_fwd_bf16", 8, 4)(pix.data_ptr(), w1.data_ptr(), b1.data_ptr(),
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


def _bwd_partial_shapes(b: int, h: int, w: int):
    """bf16 K4's fp32 partial buffers at (b, h, w), as its source sizes
    them: ((sets, 9 C C) for dW1, (rows, 6 C + 3) for db1, dLN scale,
    dLN bias, dW2 (C, 3) and db2)."""
    shape = (ctypes.c_int * 4)()
    _partials_fn()(b, h, w, 1, shape)
    return (shape[0], shape[1]), (shape[2], shape[3])


def fused_decoder_tail_bwd(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                           grad_out, approximate: bool):
    """Fused tail backward -> (dpix, dW1, db1, dLN scale, dLN bias, dW2,
    db2), as :func:`fused_decoder_tail_bwd_reference`.

    A CPU tensor runs the plain version; a CUDA tensor launches K4 on the
    current stream or raises. K4 writes dpix whole and per-CTA fp32
    partials of the parameter gradients; one ``torch.sum`` over the
    partials finishes them, as the JAX package sums its per-block
    partials in XLA. In bf16 K4 is three launches of
    ``csrc/decoder_tail_bwd.cu`` (du, dpix, dW1) that pass ``du`` through
    a scratch tensor; in fp32 the packing launch and the three 3xTF32
    launches of ``csrc/decoder_tail_tc_bwd.cu``. Either counts as one call
    in ``fused_decoder_tail_bwd.launches``.
    """
    if pix.device.type == "cpu":
        return fused_decoder_tail_bwd_reference(
            pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, grad_out,
            approximate)
    if _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                  grad_out) == "generic":
        return fused_decoder_tail_bwd_generic(pix, conv1_w, conv1_b, ln_w,
                                              ln_b, conv2_w, grad_out,
                                              approximate)
    _check_grad_out(pix, grad_out)
    if pix.dtype == torch.float32:
        grads = _tc_backward(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                             grad_out, approximate)
        fused_decoder_tail_bwd.launches += 1
        return grads
    pix = pix.contiguous()
    b, h, w, c = pix.shape
    go = grad_out.to(pix.dtype).contiguous()
    w1, b1, lns, lnb, w2 = _packed_params(pix, conv1_w, conv1_b, ln_w, ln_b,
                                          conv2_w)
    dw1_shape, small_shape = _bwd_partial_shapes(b, h, w)
    dpix = torch.empty_like(pix)
    # du (rounded to bf16, as the contract rounds it) between launches
    du = torch.empty_like(pix)
    dw1_part = torch.empty(dw1_shape, dtype=torch.float32, device=pix.device)
    small_part = torch.empty(small_shape, dtype=torch.float32,
                             device=pix.device)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    rc = _fn("decoder_tail_bwd", "decoder_tail_bwd_bf16", 11, 4)(
        pix.data_ptr(), go.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        lns.data_ptr(), lnb.data_ptr(), w2.data_ptr(), dpix.data_ptr(),
        dw1_part.data_ptr(), small_part.data_ptr(), du.data_ptr(), b, h, w,
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


@build.lookup
def _generic_fn(direction: str, dtype: torch.dtype):
    fn = getattr(build.library("decoder_tail_generic"),
                 f"decoder_tail_generic_{direction}_{_DTYPES[dtype]}")
    n_ptrs, n_ints = (8, 7) if direction == "fwd" else (10, 7)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@build.lookup
def _narrow_ctas_per_sm(direction: str, dtype: torch.dtype, th: int,
                        approximate: bool, index: int) -> int:
    """CTAs of the narrow ``direction`` ("fwd" or "bwd") kernel at ``th``
    rows a tile that card ``index``'s SMs hold at once, by the kernel's
    registers and shared memory (the CUDA occupancy query)."""
    fn = getattr(build.library("decoder_tail_generic"),
                 f"decoder_tail_generic_ctas_per_sm_{_DTYPES[dtype]}")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = fn(int(direction == "bwd"), th, int(approximate),
                ctypes.byref(n))
    _raise_if(rc, "decoder_tail_generic")
    return n.value


def _narrow_launch_grid(pix, direction: str, approximate: bool):
    """(th, persistent CTAs) of the narrow ``direction`` kernel on ``pix``:
    :func:`narrow_tiling`'s tiles over as few rounds as the SMs hold."""
    b, h, w, _ = pix.shape
    index = pix.device.index
    sms = _sm_count(index)
    th, tiles = narrow_tiling(b, h, w, sms)
    per_sm = _narrow_ctas_per_sm(direction, pix.dtype, th,
                                 bool(approximate), index)
    return th, narrow_grid(tiles, per_sm, sms)


@build.lookup
def _tc_partials_fn(f32: bool):
    lib = build.library("decoder_tail_tc_bwd")
    fn = (lib.decoder_tail_tc_partials_f32 if f32
          else lib.decoder_tail_tc_partials)
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    return fn


@build.lookup
def _tc_partial_rows(b: int, h: int, w: int, c: int, cd: int, f32: bool):
    """(dW1 partial rows, small-partial rows) of the tensor-core backward
    at (b, h, w, c) in fp32 or bf16, as its source sizes them (forgotten,
    as the symbols are, when ``build.swapped`` swaps the library)."""
    shape = (ctypes.c_int * 2)()
    _tc_partials_fn(f32)(b, h, w, c, cd, shape)
    return shape[0], shape[1]


def _packed_size(cd: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Values of the packed parameters (csrc/decoder_tail_tc.cuh): W1 in
    two parts in fp32 (big and small tf32)."""
    parts = 2 if dtype == torch.float32 else 1
    return 18 * cd * cd * parts + 6 * cd + 3


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to tf32 as ``cvt.rna.tf32.f32`` rounds: to
    nearest, ties away from zero, on the low 13 bits (zero after it)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """``x`` = big + small (to ~2^-22 relative), both tf32: the 3xTF32
    kernels' split."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)


def pack_reference(conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b, cd,
                   dtype=torch.bfloat16):
    """Plain version of the packing launch: the parameters in ``dtype``
    (bf16: rounded; fp32: W1 split by :func:`tf32_split` into its big,
    then its small planes) in csrc/decoder_tail_tc.cuh's layout, zero-padded
    to ``cd`` channels (``conv2_b`` may be None: zeros), as one flat
    tensor."""
    c = conv1_w.shape[0]
    dev = conv1_w.device
    w1 = torch.zeros((9, cd, cd), dtype=torch.float32, device=dev)
    w1[:, :c, :c] = conv1_w.float().permute(2, 3, 0, 1).reshape(9, c, c)
    rows = torch.zeros((6, cd), dtype=torch.float32, device=dev)
    for i, v in enumerate((conv1_b, ln_w, ln_b)):
        rows[i, :c] = v.float().reshape(-1)
    w2 = torch.zeros((cd, 3), dtype=torch.float32, device=dev)
    w2[:c] = conv2_w.float().reshape(3, c).t()
    b2 = (torch.zeros(3, device=dev) if conv2_b is None
          else conv2_b.float().reshape(-1))
    planes = [w1.reshape(-1), w1.transpose(1, 2).reshape(-1)]
    if dtype == torch.float32:
        planes = [p for w in planes for p in tf32_split(w)]
    return torch.cat([*planes, rows[:3].reshape(-1), w2.reshape(-1),
                      b2]).to(dtype)


def _pack(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b, cd):
    """One launch: the parameters (fp32, or cast to it) packed in
    pix.dtype as csrc/decoder_tail_tc.cuh lays them out
    (:func:`pack_reference`), zero-padded to ``cd`` channels (``conv2_b``
    may be None: zeros). Offsets (values, p = 1 in bf16, 2 in fp32): W1
    (p, tap, o, c) at 0, W1 (p, tap, c, o) at 9 p cd^2, b1, LN scale, LN
    bias at 18 p cd^2 + (0, 1, 2) cd, W2 (c, k) at 18 p cd^2 + 3 cd, b2
    after it."""
    c = pix.shape[-1]
    _check_weights(c, conv1_w, conv2_w)
    params = [v.float().contiguous() for v in (
        conv1_w, conv1_b, ln_w, ln_b, conv2_w)]
    b2 = None if conv2_b is None else conv2_b.float().contiguous()
    packed = torch.empty(_packed_size(cd, pix.dtype), dtype=pix.dtype,
                         device=pix.device)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    symbol = ("decoder_tail_tc_pack" if pix.dtype == torch.bfloat16
              else "decoder_tail_tc_pack_f32")
    rc = _fn("decoder_tail_tc_fwd", symbol, 7, 2)(
        *(v.data_ptr() for v in params),
        None if b2 is None else b2.data_ptr(), packed.data_ptr(), c, cd,
        stream)
    _raise_if(rc, "decoder_tail_tc_fwd")
    return packed


def _tc_u_scratch(pix, c):
    """The tensor-core route's fp32 u scratch (pix's shape) past
    ``TC_ROW_CHANNELS`` (bf16) or ``TC_ROW_CHANNELS_F32`` (fp32), else
    None."""
    limit = (TC_ROW_CHANNELS if pix.dtype == torch.bfloat16
             else TC_ROW_CHANNELS_F32)
    if c <= limit:
        return None
    return torch.empty(pix.shape, dtype=torch.float32, device=pix.device)


def _narrow_params(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                   conv2_b=None):
    """The narrow route's parameters: fp32 and contiguous in their torch
    layouts (the kernels cast and pad them), each checked against C."""
    _check_weights(pix.shape[-1], conv1_w, conv2_w)
    params = (conv1_w, conv1_b, ln_w, ln_b, conv2_w) + (
        () if conv2_b is None else (conv2_b,))
    return [v.float().contiguous() for v in params]


def fused_decoder_tail_generic(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                               conv2_b, approximate: bool):
    """K3g, the width-generic forward (B, H, W, C) -> (B, H, W, 3).

    Arguments as :func:`fused_decoder_tail`, which sends the widths the
    C = 64 kernel does not take here. A CPU tensor runs the plain
    version; a CUDA tensor goes by :func:`generic_tail_route`: to
    :func:`fused_decoder_tail_tc` (which counts its own launches), or at
    C <= 8 it launches the narrow kernel (one launch, the unpadded pixels,
    the parameters as they are) or raises.
    """
    if pix.device.type == "cpu":
        return fused_decoder_tail_reference(pix, conv1_w, conv1_b, ln_w,
                                            ln_b, conv2_w, conv2_b,
                                            approximate)
    _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b)
    if generic_tail_route(pix.shape[-1], pix.dtype) == "tc":
        return fused_decoder_tail_tc(pix, conv1_w, conv1_b, ln_w, ln_b,
                                     conv2_w, conv2_b, approximate)
    b, h, w, c = pix.shape
    params = _narrow_params(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                            conv2_b)
    pix = pix.contiguous()
    out = torch.empty((b, h, w, 3), dtype=pix.dtype, device=pix.device)
    th, grid = _narrow_launch_grid(pix, "fwd", approximate)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    rc = _generic_fn("fwd", pix.dtype)(
        pix.data_ptr(), *(v.data_ptr() for v in params), out.data_ptr(), b,
        h, w, c, th, grid, int(bool(approximate)), stream)
    _raise_if(rc, "decoder_tail_generic")
    fused_decoder_tail_generic.launches += 1
    return out


fused_decoder_tail_generic.launches = 0


def _check_tc(pix):
    if generic_tail_route(pix.shape[-1], pix.dtype) != "tc":
        raise ValueError(f"the tensor-core tail takes C >= "
                         f"{TC_MIN_CHANNELS}, got {pix.dtype} "
                         f"C={pix.shape[-1]}")


def _tc_forward(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b,
                approximate):
    """The tensor-core forward's launches on CUDA tensors (the packing,
    then the kernel; past the row width the row kernel): no count."""
    b, h, w, c = pix.shape
    cd = generic_channels(c, pix.dtype)
    packed = _pack(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b, cd)
    pix = (pix if cd == c else _pad_channels(pix, cd, (3,))).contiguous()
    out = torch.empty((b, h, w, 3), dtype=pix.dtype, device=pix.device)
    u = _tc_u_scratch(pix, c)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    symbol = ("decoder_tail_tc_fwd" if pix.dtype == torch.bfloat16
              else "decoder_tail_tc_fwd_f32")
    rc = _fn("decoder_tail_tc_fwd", symbol, 4, 6)(
        pix.data_ptr(), packed.data_ptr(),
        None if u is None else u.data_ptr(), out.data_ptr(), b, h, w, c, cd,
        int(bool(approximate)), stream)
    _raise_if(rc, "decoder_tail_tc_fwd")
    return out


def fused_decoder_tail_tc(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                          conv2_b, approximate: bool):
    """K3g on the tensor cores (C >= ``TC_MIN_CHANNELS``, bf16 or fp32):
    the packing launch, then ``csrc/decoder_tail_tc_fwd.cu``'s kernel on
    the unpadded pixels (padded to a multiple of 8 only where C is not);
    past ``TC_ROW_CHANNELS`` (fp32: ``TC_ROW_CHANNELS_F32``) its two
    launches pass u through an fp32 scratch. A CPU tensor runs the plain
    version; other widths and types raise."""
    if pix.device.type == "cpu":
        return fused_decoder_tail_reference(pix, conv1_w, conv1_b, ln_w,
                                            ln_b, conv2_w, conv2_b,
                                            approximate)
    _check_tc(pix)
    _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b)
    out = _tc_forward(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b,
                      approximate)
    fused_decoder_tail_tc.launches += 1
    return out


fused_decoder_tail_tc.launches = 0


def fused_decoder_tail_bwd_generic(pix, conv1_w, conv1_b, ln_w, ln_b,
                                   conv2_w, grad_out, approximate: bool):
    """K4g, the width-generic backward -> (dpix, dW1, db1, dLN scale,
    dLN bias, dW2, db2), as :func:`fused_decoder_tail_bwd`.

    A CPU tensor runs the plain version; a CUDA tensor goes by
    :func:`generic_tail_route`: to :func:`fused_decoder_tail_bwd_tc`, or
    at C <= 8 it launches the narrow kernels (counted as one call) or
    raises: the backward kernel (dpix, and one row of fp32 partial sums per
    persistent CTA, :func:`narrow_grid`) and its reduction, which sums the
    rows in a fixed order into one fp32 buffer of the parameter gradients
    in their torch layouts.
    """
    if pix.device.type == "cpu":
        return fused_decoder_tail_bwd_reference(
            pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, grad_out,
            approximate)
    _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, grad_out)
    if generic_tail_route(pix.shape[-1], pix.dtype) == "tc":
        return fused_decoder_tail_bwd_tc(pix, conv1_w, conv1_b, ln_w, ln_b,
                                         conv2_w, grad_out, approximate)
    _check_grad_out(pix, grad_out)
    b, h, w, c = pix.shape
    params = _narrow_params(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w)
    pix = pix.contiguous()
    go = grad_out.to(pix.dtype).contiguous()
    th, grid = _narrow_launch_grid(pix, "bwd", approximate)
    dpix = torch.empty_like(pix)
    # the gradients (dW1, db1, dLN scale, dLN bias, dW2, db2 in their torch
    # layouts), then the per-CTA partial rows: one fp32 buffer
    sizes = (9 * c * c, c, c, c, 3 * c, 3)
    buf = torch.empty(sum(sizes) + grid * NARROW_PARTIALS,
                      dtype=torch.float32, device=pix.device)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    rc = _generic_fn("bwd", pix.dtype)(
        pix.data_ptr(), go.data_ptr(), *(v.data_ptr() for v in params),
        dpix.data_ptr(), buf.data_ptr() + 4 * sum(sizes), buf.data_ptr(),
        b, h, w, c, th, grid, int(bool(approximate)), stream)
    _raise_if(rc, "decoder_tail_generic")
    fused_decoder_tail_bwd_generic.launches += 1
    dw1, db1, dlns, dlnb, dw2, db2, _ = buf.split(
        sizes + (grid * NARROW_PARTIALS,))
    return (dpix, dw1.view(conv1_w.shape).to(conv1_w.dtype),
            db1.to(conv1_b.dtype), dlns.to(ln_w.dtype), dlnb.to(ln_b.dtype),
            dw2.view(conv2_w.shape).to(conv2_w.dtype),
            db2.to(conv2_w.dtype))


fused_decoder_tail_bwd_generic.launches = 0


def _check_grad_out(pix, grad_out):
    b, h, w, _ = pix.shape
    if tuple(grad_out.shape) != (b, h, w, 3):
        raise ValueError(f"grad_out has shape {tuple(grad_out.shape)}, "
                         f"expected {(b, h, w, 3)}")


def _tc_backward(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, grad_out,
                 approximate):
    """The tensor-core backward's launches on CUDA tensors and the sums
    that finish its partials: no count."""
    b, h, w, c = pix.shape
    f32 = pix.dtype == torch.float32
    cd = generic_channels(c, pix.dtype)
    go = grad_out.to(pix.dtype).contiguous()
    packed = _pack(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, None, cd)
    pix = (pix if cd == c else _pad_channels(pix, cd, (3,))).contiguous()
    slices, rows = _tc_partial_rows(b, h, w, c, cd, f32)
    du = torch.empty_like(pix)
    dpix = torch.empty_like(pix)
    dw1_part = torch.empty((slices, 9, c, c), dtype=torch.float32,
                           device=pix.device)
    small_part = torch.empty((rows, 6 * c + 3), dtype=torch.float32,
                             device=pix.device)
    u = _tc_u_scratch(pix, c)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    if f32:
        # du^T split into big and small tf32 parts, each image row's
        # channel padded to whole 64-pixel units: dW1's K-major B
        dut = torch.empty((2, b, h, cd, -(-w // TC_TILE) * TC_TILE),
                          dtype=torch.float32, device=pix.device)
        rc = _fn("decoder_tail_tc_bwd", "decoder_tail_tc_bwd_f32", 9, 6)(
            pix.data_ptr(), go.data_ptr(), packed.data_ptr(),
            None if u is None else u.data_ptr(), du.data_ptr(),
            dut.data_ptr(), dpix.data_ptr(), dw1_part.data_ptr(),
            small_part.data_ptr(), b, h, w, c, cd, int(bool(approximate)),
            stream)
    else:
        rc = _fn("decoder_tail_tc_bwd", "decoder_tail_tc_bwd", 8, 6)(
            pix.data_ptr(), go.data_ptr(), packed.data_ptr(),
            None if u is None else u.data_ptr(), du.data_ptr(),
            dpix.data_ptr(), dw1_part.data_ptr(), small_part.data_ptr(), b,
            h, w, c, cd, int(bool(approximate)), stream)
    _raise_if(rc, "decoder_tail_tc_bwd")
    dw1 = dw1_part.sum(0).reshape(3, 3, c, c).permute(3, 2, 0, 1)
    small = small_part.sum(0)
    return ((dpix if cd == c else dpix[..., :c].contiguous()),
            dw1.to(conv1_w.dtype), small[:c].to(conv1_b.dtype),
            small[c:2 * c].to(ln_w.dtype), small[2 * c:3 * c].to(ln_b.dtype),
            small[3 * c:6 * c].reshape(c, 3).t().reshape(
                conv2_w.shape).to(conv2_w.dtype),
            small[6 * c:].to(conv2_w.dtype))


def fused_decoder_tail_bwd_tc(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                              grad_out, approximate: bool):
    """K4g on the tensor cores (C >= ``TC_MIN_CHANNELS``, bf16 or fp32):
    the packing launch and ``csrc/decoder_tail_tc_bwd.cu``'s three kernels
    (du into a scratch of pix's type, dpix, dW1 over pixel slices; one
    count; fp32 also writes du^T split for dW1's B; past the row width du
    is two, through an fp32 scratch for u), then one ``torch.sum`` over
    each fp32 partial. A CPU tensor runs the plain version; other widths
    and types raise."""
    if pix.device.type == "cpu":
        return fused_decoder_tail_bwd_reference(
            pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, grad_out,
            approximate)
    _check_tc(pix)
    _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, grad_out)
    _check_grad_out(pix, grad_out)
    grads = _tc_backward(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                         grad_out, approximate)
    fused_decoder_tail_bwd_tc.launches += 1
    return grads


fused_decoder_tail_bwd_tc.launches = 0


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
