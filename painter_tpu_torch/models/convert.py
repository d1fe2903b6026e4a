"""Weights carried across from the JAX package's parameter tree.

The JAX model keeps NHWC/HWIO kernels, (in, out) dense kernels and
block leaves stacked on a leading depth axis; the port keeps the
reference's torch layout and ``.pth`` names. This is the same transposing
as the JAX package's ``train/checkpoint.py:params_to_torch_state_dict``,
written again here so the port needs nothing of that package: a param
tree of nested dicts of numpy arrays in, a reference-named state dict
out. Released ``.pth`` checkpoints need no converter: they load with
``model.load_state_dict(sd, strict=False)``.

A tree from the JAX package's ``quantize_params`` (int8 serving) carries
``{kernel_q, scale, bias}`` leaves in place of ``{kernel, bias}``; those
become ``<name>.weight.q`` (int8, transposed to (out, in)),
``<name>.weight.scale`` and ``<name>.bias``, and :func:`load_jax_params`
makes the matching modules
:class:`~painter_tpu_torch.ops.quant.QuantizedLinear`.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from painter_tpu_torch.configs import ModelConfig
from painter_tpu_torch.ops.quant import QuantizedLinear


def _conv(kernel: np.ndarray) -> np.ndarray:
    """HWIO -> (out, in, kh, kw)."""
    return kernel.transpose(3, 2, 0, 1)


def _linear(sd: Dict[str, np.ndarray], name: str, lp: Mapping, i=None):
    """One dense layer (layer ``i`` of a stacked leaf) under ``name``."""
    def at(v):
        return v if i is None else v[i]

    if "kernel_q" in lp:
        sd[name + ".weight.q"] = at(lp["kernel_q"]).T
        sd[name + ".weight.scale"] = at(lp["scale"])
    else:
        sd[name + ".weight"] = at(lp["kernel"]).T
    sd[name + ".bias"] = at(lp["bias"])


def state_dict_from_jax_params(params_np: Mapping,
                               cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of numpy arrays) -> state dict."""
    p = params_np
    sd: Dict[str, np.ndarray] = {}
    sd["patch_embed.proj.weight"] = _conv(p["patch_embed"]["kernel"])
    sd["patch_embed.proj.bias"] = p["patch_embed"]["bias"]
    for tok in ("mask_token", "segment_token_x", "segment_token_y",
                "type_token_cls", "type_token_ins"):
        if tok in p:
            sd[tok] = p[tok].reshape(1, 1, 1, -1)
    if "pos_embed" in p:
        sd["pos_embed"] = p["pos_embed"][None]
    sd["norm.weight"] = p["norm"]["scale"]
    sd["norm.bias"] = p["norm"]["bias"]
    _linear(sd, "decoder_embed", p["decoder_embed"])
    dp = p["decoder_pred"]
    sd["decoder_pred.0.weight"] = _conv(dp["conv1"]["kernel"])
    sd["decoder_pred.0.bias"] = dp["conv1"]["bias"]
    sd["decoder_pred.1.weight"] = dp["ln"]["scale"]
    sd["decoder_pred.1.bias"] = dp["ln"]["bias"]
    sd["decoder_pred.3.weight"] = _conv(dp["conv2"]["kernel"])
    sd["decoder_pred.3.bias"] = dp["conv2"]["bias"]
    b = p["blocks"]
    att = b["attn"]
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            sd[pre + f"{norm}.weight"] = b[norm]["scale"][i]
            sd[pre + f"{norm}.bias"] = b[norm]["bias"][i]
        for name, lp in (("attn.qkv", att["qkv"]), ("attn.proj", att["proj"]),
                         ("mlp.fc1", b["mlp"]["fc1"]),
                         ("mlp.fc2", b["mlp"]["fc2"])):
            _linear(sd, pre + name, lp, i)
        if "rel_pos_h" in att:
            # a windowed block of a window-trained tree reads its
            # window-sized tables (models_painter.py:309)
            win = "rel_pos_h_win" in att and i in cfg.window_block_indexes
            suffix = "_win" if win else ""
            sd[pre + "attn.rel_pos_h"] = att["rel_pos_h" + suffix][i]
            sd[pre + "attn.rel_pos_w"] = att["rel_pos_w" + suffix][i]
    for i, rp in p.get("residual_blocks", {}).items():
        pre = f"blocks.{i}.residual."
        for conv in ("conv1", "conv2", "conv3"):
            sd[pre + f"{conv}.weight"] = _conv(rp[conv]["kernel"])
        for norm in ("norm1", "norm2", "norm3"):
            sd[pre + f"{norm}.weight"] = rp[norm]["scale"]
            sd[pre + f"{norm}.bias"] = rp[norm]["bias"]
    return {k: torch.from_numpy(np.array(
        v, np.int8 if k.endswith(".weight.q") else np.float32))
        for k, v in sd.items()}


def load_jax_params(model: torch.nn.Module,
                    params_np: Mapping) -> torch.nn.Module:
    """Load a JAX param tree into ``model`` (all keys must match); the
    linears that the tree holds in int8 become quantized modules."""
    sd = state_dict_from_jax_params(params_np, model.cfg)
    dev = next(model.parameters()).device
    for key in [k for k in sd if k.endswith(".weight.q")]:
        name = key[:-len(".weight.q")]
        model.set_submodule(name, QuantizedLinear(
            sd[key].to(dev), sd[name + ".weight.scale"].to(dev),
            sd[name + ".bias"].to(dev)))
    model.load_state_dict(sd, strict=True)
    return model
