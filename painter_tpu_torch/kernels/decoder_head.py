"""The fused decoder tail: conv3x3 + bias -> LayerNorm -> GELU -> conv1x1,
forward (K3) and backward (K4).

Hand-written CUDA kernels replace the TPU kernels of
``painter_tpu/kernels/decoder_head.py``: ``csrc/decoder_tail_fwd.cu``
(``_fwd_impl``) and ``csrc/decoder_tail_bwd.cu`` (``_bwd_impl``) at the
presets' C = 64, ``csrc/decoder_tail_tc_fwd.cu`` /
``decoder_tail_tc_bwd.cu`` (bf16) and ``csrc/decoder_tail_generic.cu``
(fp32, and bf16 at C <= 8) at other widths. Their headers state the
contracts, what bounds them on an H100 and what their designs do about
that. The TPU kernel's layout devices (128-lane channel padding, the
row-block choice, the dx/dy-packed contraction) are not carried over.

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
kernels built for the presets' C = 64 (``"vitl"``: any H and W) or to
the width-generic kernels K3g / K4g (``"generic"``: every other C >= 1, as
the JAX kernel takes any C). :func:`generic_tail_route` picks K3g / K4g's
route by shape and type: ``"tc"`` (bf16 at C >= 9: the tensor-core
implicit GEMM of ``csrc/decoder_tail_tc_fwd.cu`` / ``decoder_tail_tc_bwd.cu``,
the pixels read unpadded where C % 8 == 0, the parameters packed by one
launch; past 512 channels u in an fp32 scratch) or ``"scalar"``
(``csrc/decoder_tail_generic.cu``: fp32 at every width and bf16 at C <= 8,
zero-padded to 8, 16, 32, 64 or 128 channels, past 128 to a multiple of 8
with the input channels staged in chunks and u in an fp32 scratch);
:func:`generic_channels` gives the padded width. LayerNorm runs over the
real C. Each route counts its own launches: ``fused_decoder_tail.launches`` /
``fused_decoder_tail_bwd.launches`` the C = 64 kernels,
``fused_decoder_tail_generic.launches`` /
``fused_decoder_tail_bwd_generic.launches`` the generic ones on the scalar
route, ``fused_decoder_tail_tc.launches`` /
``fused_decoder_tail_bwd_tc.launches`` on the tensor-core route.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from painter_tpu_torch.kernels import build

LN_EPS = 1e-6
CHANNELS = 64  # the ViT-L kernels are built for the presets' decoder width
# the widths K3g / K4g are built for up to 128 channels; other widths up
# to 128 are zero-padded to the next, wider ones to a multiple of
# WIDE_STEP (the chunked route of csrc/decoder_tail_generic.cu)
GENERIC_CHANNELS = (8, 16, 32, 64, 128)
WIDE_STEP = 8
# bf16 widths from TC_MIN_CHANNELS on go to the tensor-core route
# (csrc/decoder_tail_tc_*.cu; C = 64 goes to K3 / K4 first); past
# TC_ROW_CHANNELS its u goes through an fp32 scratch. Below it the scalar
# kernels stay: at tiny_test's (2, 64, 32, 8) in bf16 they took 0.0125 /
# 0.0334 ms of device time (K3g / K4g, tanh, with the packing launch)
# where the tensor-core kernels took 0.0190 / 0.0420, the event time per
# call being the wrapper's host work on both (H100 80GB HBM3, 700 W, in
# turns; PERF.md section 6)
TC_MIN_CHANNELS = 9
TC_ROW_CHANNELS = 512
TC_STEP = 8  # the tensor-core route's channel padding (16-byte rows)
# pixels per partial row of the chunked route's dW1 (at most WIDE_SLICES
# rows)
WIDE_SLICE_PIXELS = 4096
WIDE_SLICES = 64
# K3's and K4's device kernels, as the profiler names them
KERNEL_NAMES = ("strip_kernel", "dw1_kernel", "decoder_tail_fwd_kernel",
                "decoder_tail_bwd_kernel")
# K3g's and K4g's device kernels (templates), as the profiler names them
GENERIC_KERNEL_NAMES = ("fwd_kernel<", "du_kernel<", "dpix_kernel<",
                        "dw1_kernel<", "conv_kernel<", "pack_kernel")
# the tensor-core route's alone (K1's forward kernel is a fwd_kernel< too)
TC_KERNEL_NAMES = ("tc::pack_kernel", "tc::conv_kernel<", "tc::dw1_kernel<",
                   "tc::row_fwd_kernel<", "tc::row_bwd_kernel<")
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
    by shape and type alone: ``"tc"`` (bf16 at C >= ``TC_MIN_CHANNELS``,
    the tensor-core kernels) or ``"scalar"`` (fp32, and bf16 at C <= 8:
    ``csrc/decoder_tail_generic.cu``). Raises as decoder_route."""
    decoder_route(c, dtype)
    if dtype == torch.bfloat16 and c >= TC_MIN_CHANNELS:
        return "tc"
    return "scalar"


def generic_channels(c: int, dtype: torch.dtype = torch.float32) -> int:
    """The width K3g / K4g run ``c`` channels at: on the tensor-core route
    ``c`` rounded up to a multiple of ``TC_STEP``; on the scalar route the
    next built width up to 128, past that ``c`` rounded up to a multiple
    of ``WIDE_STEP``."""
    if generic_tail_route(c, dtype) == "tc":
        return -(-c // TC_STEP) * TC_STEP
    if c <= GENERIC_CHANNELS[-1]:
        return next(n for n in GENERIC_CHANNELS if n >= c)
    return -(-c // WIDE_STEP) * WIDE_STEP


def wide_slices(n_pixels: int) -> int:
    """Rows of the chunked route's dW1 partial for ``n_pixels`` pixels."""
    return max(1, min(WIDE_SLICES, -(-n_pixels // WIDE_SLICE_PIXELS)))


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


def _packed_params(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, cp=None):
    """Kernel layout, all in pix.dtype, zero-padded to ``cp`` channels
    (default C): W1 (3, 3, C_in, C_out) = (tap, c, o), b1, LN scale, LN
    bias (C,), W2 (C, 3)."""
    dt = pix.dtype
    c = pix.shape[-1]
    cp = cp or c
    if tuple(conv1_w.shape) != (c, c, 3, 3) or \
            tuple(conv2_w.shape) != (3, c, 1, 1):
        raise ValueError(f"conv weights {tuple(conv1_w.shape)} / "
                         f"{tuple(conv2_w.shape)} do not fit C={c}")
    w1 = _pad_channels(conv1_w.to(dt), cp, (0, 1)).permute(
        2, 3, 1, 0).contiguous()
    w2 = _pad_channels(conv2_w.to(dt).reshape(3, c).t(), cp,
                       (0,)).contiguous()
    rows = [_pad_channels(v.to(dt).reshape(-1), cp, (0,)).contiguous()
            for v in (conv1_b, ln_w, ln_b)]
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
    if _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                  conv2_b) == "generic":
        return fused_decoder_tail_generic(pix, conv1_w, conv1_b, ln_w, ln_b,
                                          conv2_w, conv2_b, approximate)
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
    if _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                  grad_out) == "generic":
        return fused_decoder_tail_bwd_generic(pix, conv1_w, conv1_b, ln_w,
                                              ln_b, conv2_w, grad_out,
                                              approximate)
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


@build.lookup
def _generic_tiles_fn():
    fn = build.library("decoder_tail_generic").decoder_tail_generic_tiles
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn


@build.lookup
def _generic_fn(direction: str, dtype: torch.dtype, wide: bool = False):
    route = "_wide" if wide else ""
    fn = getattr(build.library("decoder_tail_generic"),
                 f"decoder_tail_generic{route}_{direction}_{_DTYPES[dtype]}")
    n_ptrs = (8 if direction == "fwd" else 12) + int(wide)
    n_ints = 6 + int(wide and direction == "bwd")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@build.lookup
def _tc_partials_fn():
    fn = build.library("decoder_tail_tc_bwd").decoder_tail_tc_partials
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    return fn


@build.lookup
def _tc_partial_rows(b: int, h: int, w: int, c: int, cd: int):
    """(dW1 slices, small-partial rows) of the tensor-core K4g at (b, h,
    w, c), as its source sizes them (forgotten, as the symbols are, when
    ``build.swapped`` swaps the library)."""
    shape = (ctypes.c_int * 2)()
    _tc_partials_fn()(b, h, w, c, cd, shape)
    return shape[0], shape[1]


def _packed_size(cd: int) -> int:
    """bf16 values of the packed parameters (csrc/decoder_tail_tc.cuh)."""
    return 18 * cd * cd + 6 * cd + 3


def pack_reference(conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b, cd,
                   dtype=torch.bfloat16):
    """Plain version of the packing launch: the parameters rounded to bf16
    (``conv2_b`` may be None: zeros) in csrc/decoder_tail_tc.cuh's layout,
    zero-padded to ``cd`` channels, as one flat bf16 tensor (``dtype``
    another type for the tests' fp32 restatements of the route)."""
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
    return torch.cat([w1.reshape(-1), w1.transpose(1, 2).reshape(-1),
                      rows[:3].reshape(-1), w2.reshape(-1), b2]).to(dtype)


def _pack(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b, cd):
    """One launch: the parameters (fp32, or cast to it) rounded to bf16 and
    packed as csrc/decoder_tail_tc.cuh lays them out, zero-padded to ``cd``
    channels (``conv2_b`` may be None: zeros). Offsets (bf16 values): W1
    (tap, o, c) at 0, W1 (tap, c, o) at 9 cd^2, b1, LN scale, LN bias at
    18 cd^2 + (0, 1, 2) cd, W2 (c, k) at 18 cd^2 + 3 cd, b2 after it."""
    c = pix.shape[-1]
    if tuple(conv1_w.shape) != (c, c, 3, 3) or \
            tuple(conv2_w.shape) != (3, c, 1, 1):
        raise ValueError(f"conv weights {tuple(conv1_w.shape)} / "
                         f"{tuple(conv2_w.shape)} do not fit C={c}")
    params = [v.float().contiguous() for v in (
        conv1_w, conv1_b, ln_w, ln_b, conv2_w)]
    b2 = None if conv2_b is None else conv2_b.float().contiguous()
    packed = torch.empty(_packed_size(cd), dtype=torch.bfloat16,
                         device=pix.device)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    rc = _fn("decoder_tail_tc_fwd", "decoder_tail_tc_pack", 7, 2)(
        *(v.data_ptr() for v in params),
        None if b2 is None else b2.data_ptr(), packed.data_ptr(), c, cd,
        stream)
    _raise_if(rc, "decoder_tail_tc_fwd")
    return packed


def _tc_u_scratch(pix, c):
    """The tensor-core route's fp32 u scratch (pix's shape) past
    ``TC_ROW_CHANNELS``, else None."""
    if c <= TC_ROW_CHANNELS:
        return None
    return torch.empty(pix.shape, dtype=torch.float32, device=pix.device)


def _packed_views(packed, cd):
    """The scalar kernels' bf16 parameters at cp = cd inside the packed
    buffer: W1 (tap, c, o), W1 (tap, o, c), b1, LN scale, LN bias, W2."""
    p2 = cd * cd * 9
    rows = 18 * cd * cd
    return (packed[p2:2 * p2], packed[:p2], packed[rows:rows + cd],
            packed[rows + cd:rows + 2 * cd],
            packed[rows + 2 * cd:rows + 3 * cd],
            packed[rows + 3 * cd:rows + 6 * cd],
            packed[rows + 6 * cd:rows + 6 * cd + 3])


def fused_decoder_tail_generic(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                               conv2_b, approximate: bool):
    """K3g, the width-generic forward (B, H, W, C) -> (B, H, W, 3).

    Arguments as :func:`fused_decoder_tail`, which sends the widths the
    C = 64 kernel does not take here. A CPU tensor runs the plain
    version; a CUDA tensor goes by :func:`generic_tail_route`: to
    :func:`fused_decoder_tail_tc` (which counts its own launches), or it
    launches the scalar kernel (channels zero-padded to
    :func:`generic_channels`; past 128 with an fp32 (B, H, W, CP) scratch
    for u; bf16 at C <= 8 after the packing launch) or raises.
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
    cp = generic_channels(c, pix.dtype)
    wide = cp > GENERIC_CHANNELS[-1]
    if pix.dtype == torch.bfloat16:
        # bf16 at C <= 8: the packed buffer at cd = 8 holds the scalar
        # kernels' layouts
        w1, _, b1, lns, lnb, w2, b2 = _packed_views(_pack(
            pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b, cp), cp)
    else:
        w1, b1, lns, lnb, w2 = _packed_params(pix, conv1_w, conv1_b, ln_w,
                                              ln_b, conv2_w, cp)
        b2 = conv2_b.to(pix.dtype).reshape(-1).contiguous()
    pix = (pix if cp == c else _pad_channels(pix, cp, (3,))).contiguous()
    out = torch.empty((b, h, w, 3), dtype=pix.dtype, device=pix.device)
    u = (torch.empty((b, h, w, cp), dtype=torch.float32, device=pix.device)
         if wide else None)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    rc = _generic_fn("fwd", pix.dtype, wide)(
        pix.data_ptr(), w1.data_ptr(), b1.data_ptr(), lns.data_ptr(),
        lnb.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        *([u.data_ptr()] if wide else []), b, h, w, cp, c,
        int(bool(approximate)), stream)
    _raise_if(rc, "decoder_tail_generic")
    fused_decoder_tail_generic.launches += 1
    return out


fused_decoder_tail_generic.launches = 0


def _check_tc(pix):
    if generic_tail_route(pix.shape[-1], pix.dtype) != "tc":
        raise ValueError(f"the tensor-core tail takes bf16 at C >= "
                         f"{TC_MIN_CHANNELS}, got {pix.dtype} "
                         f"C={pix.shape[-1]}")


def fused_decoder_tail_tc(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                          conv2_b, approximate: bool):
    """K3g on the tensor cores (bf16 at C >= ``TC_MIN_CHANNELS``): the
    packing launch, then ``csrc/decoder_tail_tc_fwd.cu``'s kernel on the
    unpadded pixels (padded to a multiple of 8 only where C is not); past
    ``TC_ROW_CHANNELS`` its two launches pass u through an fp32 scratch. A
    CPU tensor runs the plain version; other widths and types raise."""
    if pix.device.type == "cpu":
        return fused_decoder_tail_reference(pix, conv1_w, conv1_b, ln_w,
                                            ln_b, conv2_w, conv2_b,
                                            approximate)
    _check_tc(pix)
    _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b)
    b, h, w, c = pix.shape
    cd = generic_channels(c, pix.dtype)
    packed = _pack(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, conv2_b, cd)
    pix = (pix if cd == c else _pad_channels(pix, cd, (3,))).contiguous()
    out = torch.empty((b, h, w, 3), dtype=pix.dtype, device=pix.device)
    u = _tc_u_scratch(pix, c)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    rc = _fn("decoder_tail_tc_fwd", "decoder_tail_tc_fwd", 4, 6)(
        pix.data_ptr(), packed.data_ptr(),
        None if u is None else u.data_ptr(), out.data_ptr(), b, h, w, c, cd,
        int(bool(approximate)), stream)
    _raise_if(rc, "decoder_tail_tc_fwd")
    fused_decoder_tail_tc.launches += 1
    return out


fused_decoder_tail_tc.launches = 0


def fused_decoder_tail_bwd_generic(pix, conv1_w, conv1_b, ln_w, ln_b,
                                   conv2_w, grad_out, approximate: bool):
    """K4g, the width-generic backward -> (dpix, dW1, db1, dLN scale,
    dLN bias, dW2, db2), as :func:`fused_decoder_tail_bwd`.

    A CPU tensor runs the plain version; a CUDA tensor goes by
    :func:`generic_tail_route`: to :func:`fused_decoder_tail_bwd_tc`, or
    it launches the scalar kernels (counted as one call) or raises: two
    kernels (du, then dpix with dW1), past 128 channels three (du, dpix,
    dW1 over pixel slices) with an fp32 scratch for u and dpix's sums; bf16
    at C <= 8 after the packing launch. One ``torch.sum`` over each fp32
    partial (per CTA, dW1 per pixel slice where sliced) finishes the
    parameter gradients.
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
    cp = generic_channels(c, pix.dtype)
    wide = cp > GENERIC_CHANNELS[-1]
    go = grad_out.to(pix.dtype).contiguous()
    if pix.dtype == torch.bfloat16:
        # bf16 at C <= 8: the packed buffer at cd = 8 holds the scalar
        # kernels' layouts
        w1, w1t, b1, lns, lnb, w2, _ = _packed_views(_pack(
            pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, None, cp), cp)
    else:
        w1, b1, lns, lnb, w2 = _packed_params(pix, conv1_w, conv1_b, ln_w,
                                              ln_b, conv2_w, cp)
        w1t = w1.transpose(2, 3).contiguous()  # (tap, o, c): dpix's taps
    pix = (pix if cp == c else _pad_channels(pix, cp, (3,))).contiguous()
    du = torch.empty_like(pix)
    dpix = torch.empty_like(pix)
    tiles = _generic_tiles_fn()(b, h, w)  # one small partial row per CTA
    # dW1: one partial row per CTA, or per pixel slice past 128 channels
    slices = wide_slices(b * h * w) if wide else tiles
    dw1_part = torch.empty((slices, 9 * cp * cp), dtype=torch.float32,
                           device=pix.device)
    small_part = torch.empty((tiles, 6 * cp + 3), dtype=torch.float32,
                             device=pix.device)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    ptrs = [pix.data_ptr(), go.data_ptr(), w1.data_ptr(), w1t.data_ptr(),
            b1.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w2.data_ptr()]
    if wide:
        u = torch.empty(pix.shape, dtype=torch.float32, device=pix.device)
        rc = _generic_fn("bwd", pix.dtype, True)(
            *ptrs, u.data_ptr(), du.data_ptr(), dpix.data_ptr(),
            dw1_part.data_ptr(), small_part.data_ptr(), b, h, w, cp, c,
            slices, int(bool(approximate)), stream)
    else:
        rc = _generic_fn("bwd", pix.dtype)(
            *ptrs, du.data_ptr(), dpix.data_ptr(), dw1_part.data_ptr(),
            small_part.data_ptr(), b, h, w, cp, c, int(bool(approximate)),
            stream)
    _raise_if(rc, "decoder_tail_generic")
    fused_decoder_tail_bwd_generic.launches += 1
    dw1 = dw1_part.sum(0).reshape(3, 3, cp, cp)[:, :, :c, :c].permute(
        3, 2, 0, 1)
    small = small_part.sum(0)
    dw2 = small[3 * cp:6 * cp].reshape(cp, 3)[:c]
    return ((dpix if cp == c else dpix[..., :c].contiguous()),
            dw1.to(conv1_w.dtype), small[:c].to(conv1_b.dtype),
            small[cp:cp + c].to(ln_w.dtype),
            small[2 * cp:2 * cp + c].to(ln_b.dtype),
            dw2.t().reshape(conv2_w.shape).to(conv2_w.dtype),
            small[6 * cp:].to(conv2_w.dtype))


fused_decoder_tail_bwd_generic.launches = 0


def _check_grad_out(pix, grad_out):
    b, h, w, _ = pix.shape
    if tuple(grad_out.shape) != (b, h, w, 3):
        raise ValueError(f"grad_out has shape {tuple(grad_out.shape)}, "
                         f"expected {(b, h, w, 3)}")


def fused_decoder_tail_bwd_tc(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w,
                              grad_out, approximate: bool):
    """K4g on the tensor cores (bf16 at C >= ``TC_MIN_CHANNELS``): the
    packing launch and ``csrc/decoder_tail_tc_bwd.cu``'s three kernels (du
    into a bf16 scratch, dpix, dW1 over pixel slices; one count; past
    ``TC_ROW_CHANNELS`` du is two, through an fp32 scratch for u), then one
    ``torch.sum`` over each fp32 partial. A CPU tensor runs the plain
    version; other widths and types raise."""
    if pix.device.type == "cpu":
        return fused_decoder_tail_bwd_reference(
            pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, grad_out,
            approximate)
    _check_tc(pix)
    _check_pix(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, grad_out)
    _check_grad_out(pix, grad_out)
    b, h, w, c = pix.shape
    cd = generic_channels(c, pix.dtype)
    go = grad_out.to(pix.dtype).contiguous()
    packed = _pack(pix, conv1_w, conv1_b, ln_w, ln_b, conv2_w, None, cd)
    pix = (pix if cd == c else _pad_channels(pix, cd, (3,))).contiguous()
    slices, rows = _tc_partial_rows(b, h, w, c, cd)
    du = torch.empty_like(pix)
    dpix = torch.empty_like(pix)
    dw1_part = torch.empty((slices, 9, c, c), dtype=torch.float32,
                           device=pix.device)
    small_part = torch.empty((rows, 6 * c + 3), dtype=torch.float32,
                             device=pix.device)
    u = _tc_u_scratch(pix, c)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    rc = _fn("decoder_tail_tc_bwd", "decoder_tail_tc_bwd", 8, 6)(
        pix.data_ptr(), go.data_ptr(), packed.data_ptr(),
        None if u is None else u.data_ptr(), du.data_ptr(), dpix.data_ptr(),
        dw1_part.data_ptr(), small_part.data_ptr(), b, h, w, c, cd,
        int(bool(approximate)), stream)
    _raise_if(rc, "decoder_tail_tc_bwd")
    fused_decoder_tail_bwd_tc.launches += 1
    dw1 = dw1_part.sum(0).reshape(3, 3, c, c).permute(3, 2, 0, 1)
    small = small_part.sum(0)
    return ((dpix if cd == c else dpix[..., :c].contiguous()),
            dw1.to(conv1_w.dtype), small[:c].to(conv1_b.dtype),
            small[c:2 * c].to(ln_w.dtype), small[2 * c:3 * c].to(ln_b.dtype),
            small[3 * c:6 * c].reshape(c, 3).t().reshape(
                conv2_w.shape).to(conv2_w.dtype),
            small[6 * c:].to(conv2_w.dtype))


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
