"""The fused w8a8 transformer MLP (K5).

A hand-written CUDA kernel, ``csrc/int8_mlp.cu``, replaces the TPU kernel
of ``painter_tpu/kernels/int8_mlp.py`` (``_int8_mlp_2d``): per-row int8
quantization of x, the int8 fc1 product, dequantization + bias, tanh
GELU, per-row requantization from the fp32 hidden activation, the int8
fc2 product, dequantization + bias; the fp32 hidden activation stays on
the SM (its row maxima are exchanged across a thread-block cluster), and
only its int8 codes pass to fc2 through a scratch tensor. Its header
states the contract, the bound on an H100 and what the design does about
it. The TPU kernel's row-block choice (``default_block_m``) is a layout
device and is not carried over.

:func:`int8_mlp` dispatches on the device: a CPU tensor runs
:func:`int8_mlp_reference`, a CUDA tensor launches the kernel or raises;
``int8_mlp.launches`` counts its launches. Weights are the torch (out, in)
layout: fc1 int8 (N, K), fc2 int8 (K, N), fp32 per-out-channel scales and
biases.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from painter_tpu_torch.kernels import build

# the hidden width the kernel is built for (a cluster of 8 CTAs of 512
# hidden columns each) and the multiple of K its tiles take
HIDDEN = 4096
_K_STEP = 128


def int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product ``a (M, K) . b_t (N, K)^T``.

    ``torch._int_mm`` on both devices (exact int32 sums). On a CUDA tensor
    its cuBLASLt path takes M > 16 and K, N multiples of 8: other shapes
    raise here instead of being routed elsewhere.
    """
    m, k = a.shape
    n = b_t.shape[0]
    if a.device.type == "cuda" and (m <= 16 or k % 8 or n % 8):
        raise ValueError(f"int8 product ({m}, {k}) x ({k}, {n}) on CUDA "
                         f"needs M > 16 and K, N multiples of 8")
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


@functools.cache
def _kernel_fn():
    fn = build.library("int8_mlp").int8_mlp_bf16
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _error_string():
    fn = build.library("int8_mlp").int8_mlp_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn


def int8_mlp(x, w1q, s1, b1, w2q, s2, b2):
    """Fused w8a8 MLP: x (..., K) -> (..., K) in x.dtype.

    A CPU tensor runs :func:`int8_mlp_reference`; a CUDA tensor launches
    the kernel on the current stream (no synchronization) or raises. The
    kernel's three launches (quantize, fc1 on a cluster, fc2) count as one
    call in ``int8_mlp.launches``.
    """
    if x.device.type == "cpu":
        return int8_mlp_reference(x, w1q, s1, b1, w2q, s2, b2)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_mlp has no kernel for {x.device}")
    if x.dtype != torch.bfloat16:
        # the kernel serves the bf16 tanh-GELU configs; fp32 configs use
        # exact GELU and so the unfused path
        raise TypeError(f"the int8_mlp kernel takes bf16, got {x.dtype}")
    k = x.shape[-1]
    n = w1q.shape[0]
    if tuple(w1q.shape) != (n, k) or tuple(w2q.shape) != (k, n):
        raise ValueError(f"fc1 {tuple(w1q.shape)} / fc2 {tuple(w2q.shape)} "
                         f"do not make a ({k} -> N -> {k}) MLP")
    if k % _K_STEP or n != HIDDEN:
        raise ValueError(f"the kernel takes K a multiple of {_K_STEP} and "
                         f"N = {HIDDEN}, got K={k}, N={n}")
    for name, w in (("fc1", w1q), ("fc2", w2q)):
        if w.dtype != torch.int8 or w.device != x.device:
            raise TypeError(f"{name} weights are {w.dtype} on {w.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    vecs = [v.to(device=x.device, dtype=torch.float32).contiguous()
            for v in (s1, b1, s2, b2)]
    w1c, w2c = w1q.contiguous(), w2q.contiguous()
    out = torch.empty_like(x2)
    # scratch of the kernel's three launches: xq and its row scales, the
    # int8 hidden codes and theirs
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    hq = torch.empty((m, n), dtype=torch.int8, device=x.device)
    rows = torch.empty((2, m), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_fn()(
        x2.data_ptr(), w1c.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
        w2c.data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(),
        out.data_ptr(), xq.data_ptr(), rows[0].data_ptr(), hq.data_ptr(),
        rows[1].data_ptr(), m, k, n, stream)
    if rc:
        raise RuntimeError(f"int8_mlp launch failed: "
                           f"{_error_string()(rc).decode()} ({rc})")
    int8_mlp.launches += 1
    return out.reshape(*lead, k)


int8_mlp.launches = 0
