"""The fused w8a8 transformer MLP (K5, and K5g at the other widths).

Hand-written CUDA kernels replace the TPU kernel of
``painter_tpu/kernels/int8_mlp.py`` (``_int8_mlp_2d``): per-row int8
quantization of x, the int8 fc1 product, dequantization + bias, tanh
GELU, per-row requantization from the fp32 hidden activation, the int8
fc2 product, dequantization + bias. ``csrc/int8_mlp.cu`` (K5) serves the
ViT-L widths in bf16 and fp32: the fp32 hidden activation stays on the SM
(its row maxima are exchanged across a thread-block cluster), and only
its int8 codes pass to fc2 through a scratch tensor.
``csrc/int8_mlp_generic.cu`` (K5g) serves every other shape: four
launches (quantize, fc1 with the GELU into an fp32 hidden scratch,
requantize, fc2), both products on the int8 tensor cores (``wgmma``)
with the tile counts, the output-tile width (:func:`k5g_tile_n`) and
the weights' row strides (:func:`k5g_staged_weight`) given at run
time. Their headers
state the contracts, the bound on an H100 and what the designs do about
it. The TPU kernel's row-block choice (``default_block_m``) is a layout
device and is not carried over.

Routes. :func:`int8_mlp_route` picks the kernel by shape and type alone:
``"vitl"`` (K5) for N = 4096 hidden and K a multiple of 128, ``"generic"``
(K5g) for every other K >= 1 and N >= 1, each in bf16 or fp32 -- the
shapes and types the JAX kernel takes (x in bf16 or fp32, output in
x's type). :func:`int8_mlp` dispatches on the device: a CPU tensor runs
:func:`int8_mlp_reference`, a CUDA tensor launches the routed kernel or
raises. ``int8_mlp.launches`` counts K5's launches,
``int8_mlp_generic.launches`` K5g's. Weights are the torch (out, in)
layout: fc1 int8 (N, K), fc2 int8 (K, N), fp32 per-out-channel scales
and biases.

:func:`int8_matmul`, the exact int8 product of the plain versions and of
the unfused int8 linears, routes by shape too: ``torch._int_mm`` where
its cuBLASLt path takes the shape on the card (M > 16, K and N multiples
of 8) and on the CPU, else an exact product through float64 on the card
(:func:`int8_matmul_f64`), as XLA's int8 dot takes any shape.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from painter_tpu_torch.kernels import build

# the hidden width K5 is built for (a cluster of 8 CTAs of 512 hidden
# columns each) and the multiple of K its tiles take
HIDDEN = 4096
_K_STEP = 128
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_K5_FUNCS = {torch.bfloat16: "int8_mlp_bf16", torch.float32: "int8_mlp_fp32"}


def int_mm_takes(m: int, k: int, n: int) -> bool:
    """Whether ``torch._int_mm``'s cuBLASLt path takes (M, K) x (K, N) on
    the card: M > 16 and K, N multiples of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def int8_matmul_f64(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a (M, K) . b_t (N, K)^T`` as int32 through float64. Exact: every
    product and partial sum is an integer of magnitude <= K * 127^2 <
    2^53, so no sum rounds, in any order."""
    return (a.double() @ b_t.double().t()).to(torch.int32)


def int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product ``a (M, K) . b_t (N, K)^T``.

    ``torch._int_mm`` (exact int32 sums) on the CPU and where its cuBLASLt
    path takes the shape on the card (:func:`int_mm_takes`); other shapes
    on the card go through :func:`int8_matmul_f64`, exact as well.
    """
    m, k = a.shape
    n = b_t.shape[0]
    if a.device.type == "cuda" and not int_mm_takes(m, k, n):
        return int8_matmul_f64(a, b_t)
    return torch._int_mm(a, b_t.t())


def row_quant(xf: torch.Tensor):
    """fp32 (M, K) -> (int8 values, fp32 (M, 1) row scale = absmax/127),
    symmetric per row, rint half to even (``int8_mlp._row_quant``)."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a true division (``127.0 / t`` would be 127 * reciprocal(t))
    inv = amax.new_tensor(127.0) / amax.clamp_min(1e-20)
    q = torch.clamp(torch.round(xf * inv), -127.0, 127.0).to(torch.int8)
    return q, amax * (1.0 / 127.0)


def gelu_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """tanh GELU written out as the TPU kernel's ``_gelu_tanh_f32``."""
    inner = math.sqrt(2.0 / math.pi) * (x + 0.044715 * (x * x * x))
    return 0.5 * x * (1.0 + torch.tanh(inner))


def int8_mlp_reference(x, w1q, s1, b1, w2q, s2, b2):
    """Plain version: x (..., K) -> (..., K) in x.dtype; int32 products,
    fp32 everything else, in the TPU kernel's order."""
    k = x.shape[-1]
    lead = x.shape[:-1]
    xq, row1 = row_quant(x.reshape(-1, k).float())
    h = int8_matmul(xq, w1q).float() * (row1 * s1.float()) + b1.float()
    h = gelu_tanh_f32(h)
    hq, row2 = row_quant(h)
    out = int8_matmul(hq, w2q).float() * (row2 * s2.float()) + b2.float()
    return out.to(x.dtype).reshape(*lead, k)


def int8_mlp_route(k: int, n: int, dtype: torch.dtype) -> str:
    """The kernel an MLP of width K and hidden width N takes on the card,
    by its shape alone, x in bf16 or fp32: ``"vitl"`` (K5) for N = 4096
    and K a multiple of 128, ``"generic"`` (K5g) for every other K >= 1,
    N >= 1. Raises on other types."""
    if dtype not in _DTYPES:
        raise TypeError(f"int8_mlp takes bf16 or fp32 x, got {dtype}")
    if k < 1 or n < 1:
        raise ValueError(f"int8_mlp takes K, N >= 1, got K={k}, N={n}")
    if n == HIDDEN and k % _K_STEP == 0:
        return "vitl"
    return "generic"


@build.lookup
def _kernel_fn(name: str, symbol: str, n_ptrs: int, n_ints: int):
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


def _check(x, w1q, w2q) -> str:
    """Checks a CUDA call's operands; returns the route."""
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_mlp has no kernel for {x.device}")
    k = x.shape[-1]
    n = w1q.shape[0]
    if tuple(w1q.shape) != (n, k) or tuple(w2q.shape) != (k, n):
        raise ValueError(f"fc1 {tuple(w1q.shape)} / fc2 {tuple(w2q.shape)} "
                         f"do not make a ({k} -> N -> {k}) MLP")
    for name, w in (("fc1", w1q), ("fc2", w2q)):
        if w.dtype != torch.int8 or w.device != x.device:
            raise TypeError(f"{name} weights are {w.dtype} on {w.device}")
    return int8_mlp_route(k, n, x.dtype)


def _operands(x, w1q, s1, b1, w2q, s2, b2):
    """x as (M, K) at a 16-byte aligned address, the weights contiguous,
    the four row vectors fp32."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    vecs = [v.to(device=x.device, dtype=torch.float32).contiguous()
            for v in (s1, b1, s2, b2)]
    return x2, w1q.contiguous(), w2q.contiguous(), vecs


def int8_mlp(x, w1q, s1, b1, w2q, s2, b2):
    """Fused w8a8 MLP: x (..., K) -> (..., K) in x.dtype.

    A CPU tensor runs :func:`int8_mlp_reference`; a CUDA tensor launches
    the kernel :func:`int8_mlp_route` names on the current stream (no
    synchronization) or raises: K5 here, K5g through
    :func:`int8_mlp_generic`. K5's three launches (quantize, fc1 on a
    cluster, fc2) count as one call in ``int8_mlp.launches``.
    """
    if x.device.type == "cpu":
        return int8_mlp_reference(x, w1q, s1, b1, w2q, s2, b2)
    if _check(x, w1q, w2q) == "generic":
        return int8_mlp_generic(x, w1q, s1, b1, w2q, s2, b2)
    k = x.shape[-1]
    n = w1q.shape[0]
    x2, w1c, w2c, vecs = _operands(x, w1q, s1, b1, w2q, s2, b2)
    m = x2.shape[0]
    out = torch.empty_like(x2)
    # scratch of the kernel's three launches: xq and its row scales, the
    # int8 hidden codes and theirs
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    hq = torch.empty((m, n), dtype=torch.int8, device=x.device)
    rows = torch.empty((2, m), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_fn("int8_mlp", _K5_FUNCS[x.dtype], 12, 3)(
        x2.data_ptr(), w1c.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
        w2c.data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(),
        out.data_ptr(), xq.data_ptr(), rows[0].data_ptr(), hq.data_ptr(),
        rows[1].data_ptr(), m, k, n, stream)
    _raise_if(rc, "int8_mlp")
    int8_mlp.launches += 1
    return out.reshape(*x.shape[:-1], k)


int8_mlp.launches = 0


def _round16(v: int) -> int:
    return -(-v // 16) * 16


# K5g's tiles (csrc/int8_mlp_generic.cu): rows per CTA and the output-tile
# widths its products take
K5G_ROWS = 128
K5G_TILE_N = (128, 256)
# K5g's device kernels (``namespace k5g``): the row quantization and the
# tensor-core product
K5G_KERNEL_NAMES = ("k5g::quant_rows", "k5g::tc_gemm")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def k5g_tile_n(m: int, n: int, sms: int) -> int:
    """The output-tile width of a K5g product of M rows and N output
    columns on a card of ``sms`` SMs: of 128 and 256, the one whose waves
    of CTAs (one per SM) leave each SM the fewest output columns to
    compute, 256 on a tie (it reads each A tile once per 256 columns)."""
    row_tiles = -(-m // K5G_ROWS)

    def columns_per_sm(bn):
        return -(-row_tiles * -(-n // bn) // sms) * bn

    return min(reversed(K5G_TILE_N), key=columns_per_sm)


def k5g_staged_weight(w: torch.Tensor) -> torch.Tensor:
    """An int8 weight (rows, cols) as K5g's TMA maps take it: itself where
    its rows are 16-byte aligned (cols a multiple of 16, the storage
    aligned), else a copy with the columns zero-padded to a multiple of
    16. The kernel reads no column past ``cols``."""
    rows, cols = w.shape
    if cols % 16 == 0 and w.data_ptr() % 16 == 0:
        return w
    staged = w.new_zeros((rows, _round16(cols)))
    staged[:, :cols] = w
    return staged


def int8_mlp_generic(x, w1q, s1, b1, w2q, s2, b2):
    """K5g, the width-generic fused w8a8 MLP: x (..., K) -> (..., K) in
    x.dtype, bf16 or fp32, any K, N and rows.

    Arguments as :func:`int8_mlp`, which sends the shapes K5 does not
    take here. A CPU tensor runs :func:`int8_mlp_reference`; a CUDA
    tensor launches K5g on the current stream or raises. Its four
    launches (quantize, fc1 + GELU into an fp32 hidden scratch, requantize,
    fc2) count as one call in ``int8_mlp_generic.launches``; an x with no
    rows launches nothing.
    """
    if x.device.type == "cpu":
        return int8_mlp_reference(x, w1q, s1, b1, w2q, s2, b2)
    _check(x, w1q, w2q)
    k = x.shape[-1]
    n = w1q.shape[0]
    x2, w1c, w2c, vecs = _operands(x, w1q, s1, b1, w2q, s2, b2)
    m = x2.shape[0]
    out = torch.empty_like(x2)
    if m == 0:
        return out.reshape(*x.shape[:-1], k)
    dev = x.device
    w1c, w2c = k5g_staged_weight(w1c), k5g_staged_weight(w2c)
    sms = _sm_count(dev.index)
    bn1, bn2 = k5g_tile_n(m, n, sms), k5g_tile_n(m, k, sms)
    # scratch of the four launches: xq and hq with rows zero-padded to 16
    # bytes (TMA sources), the fp32 hidden activation and its rows' |h|
    # maxima per fc1 tile, the two row scales
    xq = torch.empty((m, _round16(k)), dtype=torch.int8, device=dev)
    h = torch.empty((m, n), dtype=torch.float32, device=dev)
    tmax = torch.empty((m, -(-n // bn1)), dtype=torch.float32, device=dev)
    hq = torch.empty((m, _round16(n)), dtype=torch.int8, device=dev)
    rows = torch.empty((2, m), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel_fn("int8_mlp_generic",
                    f"int8_mlp_generic_{_DTYPES[x.dtype]}", 14, 7)(
        x2.data_ptr(), w1c.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
        w2c.data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(),
        out.data_ptr(), xq.data_ptr(), rows[0].data_ptr(), h.data_ptr(),
        tmax.data_ptr(), hq.data_ptr(), rows[1].data_ptr(), m, k, n,
        w1c.shape[1], w2c.shape[1], bn1, bn2, stream)
    _raise_if(rc, "int8_mlp_generic")
    int8_mlp_generic.launches += 1
    return out.reshape(*x.shape[:-1], k)


int8_mlp_generic.launches = 0
