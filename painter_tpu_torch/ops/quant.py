"""Linear layers: floating point, and the int8 (w8a8) serving path.

The port of ``painter_tpu/ops/quant.py``. Weights are quantized once, at
load time, symmetric per output channel (absmax over the contraction
axis, ``rint``, clip at +-127); activations per row (per token) at run
time, absmax in fp32; the int32 product is dequantized by the rank-1
``row_scale * col_scale`` and the bias added. :func:`quantize_model`
gives a serving copy of a model whose targeted ``nn.Linear`` modules are
:class:`QuantizedLinear`; untargeted parameters are shared with the
original. Its ``weight`` is an :class:`Int8Weight`, so every caller of
:func:`linear` (the MLP, attention's qkv and proj, the decoder embedding)
dispatches on it unchanged. The quantized copy is for inference only: no
gradient flows through ``round``.

:func:`mlp` runs the fused w8a8 kernel (K5,
:mod:`painter_tpu_torch.kernels.int8_mlp`) when the block's ``mlp_impl``
is ``"fused"`` and the config's GELU is the tanh one (the kernel's);
exact-GELU configs take the unfused path, as the JAX package's ``mlp``
dispatches on the config. On a CUDA tensor ``"fused"`` launches K5 or
raises.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from painter_tpu_torch.kernels.int8_mlp import int8_matmul, int8_mlp
from painter_tpu_torch.ops.remat import named_linear

#: The quantized sites by default: the MLP gemms only (the JAX package's
#: measured choice, ``quant.DEFAULT_TARGETS``)
DEFAULT_TARGETS = ("mlp",)
MLP_IMPLS = ("xla", "fused")

# target -> the module-name suffixes it selects
_TARGET_SUFFIXES = {"attn": (".attn.qkv", ".attn.proj"),
                    "mlp": (".mlp.fc1", ".mlp.fc2"),
                    "dec": ("decoder_embed",)}


def quantize_linear_params(kernel: np.ndarray):
    """fp weights -> (int8 values, fp32 scales), numpy.

    Symmetric per out-channel: absmax over the contraction (second-to-
    last) axis of a JAX-layout (..., K, N) kernel; leading axes pass
    through. Returns (kernel_q (..., K, N) int8, scale (..., N) fp32), as
    ``painter_tpu.ops.quant.quantize_linear_params``.
    """
    k = np.asarray(kernel, np.float32)
    amax = np.max(np.abs(k), axis=-2, keepdims=True)
    scale = np.maximum(amax, 1e-20) / 127.0
    kq = np.clip(np.rint(k / scale), -127, 127).astype(np.int8)
    return kq, np.squeeze(scale, axis=-2)


class Int8Weight(nn.Module):
    """int8 weight (out, in) and its fp32 per-out-channel scale (out,)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)


class QuantizedLinear(nn.Module):
    """A serving-only linear: ``weight`` an :class:`Int8Weight`, ``bias``
    fp32 (out,)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        self.weight = Int8Weight(q, scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "QuantizedLinear":
        w = lin.weight.detach()
        kq, scale = quantize_linear_params(w.float().cpu().numpy().T)
        bias = (lin.bias.detach().float() if lin.bias is not None
                else torch.zeros(w.shape[0], device=w.device))
        return cls(torch.from_numpy(np.ascontiguousarray(kq.T)).to(w.device),
                   torch.from_numpy(scale).to(w.device), bias)


def is_quantized(weight) -> bool:
    return isinstance(weight, Int8Weight)


def quantize_model(model: nn.Module, targets: Iterable[str] = DEFAULT_TARGETS,
                   mlp_impl: str = "xla") -> nn.Module:
    """A serving copy of ``model`` with the target linears in int8.

    targets: any of "attn" (qkv + proj), "mlp" (fc1 + fc2), "dec"
    (decoder_embed); unknown ones raise. ``mlp_impl`` ("xla" or "fused")
    is set on every block's MLP and read by its forward; "fused" needs the
    mlp target. Untargeted parameters are the original tensors, not
    copies.
    """
    targets = set(targets)
    unknown = targets - set(_TARGET_SUFFIXES)
    if unknown:
        raise ValueError(f"unknown quant targets {sorted(unknown)}")
    if mlp_impl not in MLP_IMPLS:
        raise ValueError(f"mlp_impl must be one of {MLP_IMPLS}, got "
                         f"{mlp_impl!r}")
    if mlp_impl == "fused" and "mlp" not in targets:
        raise ValueError('mlp_impl="fused" needs the "mlp" target')
    with torch.device("meta"):
        qmodel = type(model)(model.cfg)
    qmodel.load_state_dict(model.state_dict(), assign=True)
    suffixes = tuple(s for t in sorted(targets) for s in _TARGET_SUFFIXES[t])
    for name, mod in list(qmodel.named_modules()):
        if isinstance(mod, nn.Linear) and name.endswith(suffixes):
            qmodel.set_submodule(name, QuantizedLinear.from_linear(mod))
    for blk in qmodel.blocks:
        blk.mlp.mlp_impl = mlp_impl
    return qmodel.eval()


def int8_linear(x: torch.Tensor, weight: Int8Weight,
                bias: torch.Tensor) -> torch.Tensor:
    """w8a8 linear: dynamic per-row activation quant, the exact int32
    product, rank-1 dequant + bias. x (..., K) -> (..., N) in x.dtype."""
    k = x.shape[-1]
    xf = x.reshape(-1, k).float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    inv = amax.new_tensor(127.0) / amax.clamp_min(1e-20)
    xq = torch.clamp(torch.round(xf * inv), -127.0, 127.0).to(torch.int8)
    y = int8_matmul(xq, weight.q)
    row = amax.clamp_min(1e-20) * (1.0 / 127.0)
    y = y.float() * row * weight.scale
    return (y + bias).to(x.dtype).reshape(*x.shape[:-1], -1)


def linear(x: torch.Tensor, weight, bias: Optional[torch.Tensor],
           name: Optional[str] = None) -> torch.Tensor:
    """``x @ W.T + b``: int8 when ``weight`` is an :class:`Int8Weight`,
    else the fp32 params cast to ``x.dtype`` at use. A floating-point
    linear with a ``name`` is one a remat policy can keep
    (``ops/remat.py``).

    A floating-point ``weight`` is (out, in), the torch/reference layout.
    """
    if is_quantized(weight):
        return int8_linear(x, weight, bias)
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if name is None:
        return F.linear(x, w, b)
    return named_linear(name, x, w, b)


def mlp(x: torch.Tensor, fc1: nn.Module, fc2: nn.Module, gelu_approx: bool,
        mlp_impl: str = "xla") -> torch.Tensor:
    """fc1 -> GELU -> fc2. The fused int8 kernel when ``mlp_impl`` is
    "fused" and the GELU is tanh; else the two linears (fp or int8) with
    the GELU between them in ``x.dtype``. "fused" takes int8 layers only:
    on floating-point ones it raises."""
    if mlp_impl not in MLP_IMPLS:
        raise ValueError(f"mlp_impl must be one of {MLP_IMPLS}, got "
                         f"{mlp_impl!r}")
    if mlp_impl == "fused" and not (is_quantized(fc1.weight)
                                    and is_quantized(fc2.weight)):
        raise TypeError('mlp_impl="fused" needs int8 fc1 and fc2 '
                        "(quantize_model with the mlp target)")
    if mlp_impl == "fused" and gelu_approx:
        return int8_mlp(x, fc1.weight.q, fc1.weight.scale, fc1.bias,
                        fc2.weight.q, fc2.weight.scale, fc2.bias)
    h = linear(x, fc1.weight, fc1.bias, "mlp_fc1")  # the pre-activation
    h = F.gelu(h, approximate="tanh" if gelu_approx else "none")
    return linear(h, fc2.weight, fc2.bias, "mlp_fc2")
