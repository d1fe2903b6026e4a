"""Optimizer: AdamW + BEiT layer-wise lr decay + per-update cosine schedule.

Reference recipe (``Painter/train_painter_vit_large.sh:14-19``,
``main_train.py:344-348``, ``util/lr_decay.py``, ``util/lr_sched.py``):
AdamW betas (0.9, 0.999), eps 1e-8, weight decay 0.1 on every parameter
but 1-D ones (biases, norm scales) and ``pos_embed``, grad-clip 3.0 by the
global norm, absolute lr 1e-3, layer decay 0.8, half-cycle cosine with
linear warmup, lr set once per optimizer update.

The JAX package's optax chain (``painter_tpu/train/optim.py:135-146``)
clips, takes Adam's direction, adds ``weight_decay * p``, multiplies by the
layer scale and then by the scheduled lr. Torch's decoupled AdamW with a
param group per (decay, layer scale) and group ``lr = schedule(step) *
scale`` computes the same update: ``p -= lr * scale * (adam + wd * p)``.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional

import torch

from painter_tpu_torch.configs import ModelConfig


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-3
    min_lr: float = 0.0
    weight_decay: float = 0.1  # main_train.py:91 + train_painter_vit_large.sh
    layer_decay: float = 0.8
    clip_grad: Optional[float] = 3.0
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    warmup_epochs: float = 1.0
    epochs: float = 15.0
    steps_per_epoch: int = 1000  # optimizer updates per epoch


def decays(name: str, param: torch.Tensor) -> bool:
    """Weight decay applies (``param_groups_lrd``, lr_decay.py:32): not to
    1-D parameters (biases, norm scales) nor to ``pos_embed``; the
    (1, 1, 1, C) tokens do decay."""
    return param.ndim > 1 and name != "pos_embed"


def layer_id(name: str, depth: int) -> int:
    """``get_layer_id_for_vit`` (lr_decay.py:64-76): pos_embed and
    patch_embed -> 0, blocks.i -> i + 1, everything else -> depth + 1.
    A block's ResBottleneck (``blocks.i.residual.*``) counts as "everything
    else", as the JAX package's ``layer_lr_scales`` places its separate
    ``residual_blocks`` tree."""
    if name == "pos_embed" or name.startswith("patch_embed"):
        return 0
    m = re.match(r"blocks\.(\d+)\.(?!residual\.)", name)
    if m:
        return int(m.group(1)) + 1
    return depth + 1


def param_groups(model: torch.nn.Module, cfg: ModelConfig,
                 weight_decay: float, layer_decay: float) -> List[Dict]:
    """One group per (layer, decay) with its ``lr_scale``
    ``layer_decay ** (depth + 1 - layer)``; parameter names in ``names``."""
    num_layers = cfg.depth + 1
    groups: Dict = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        lid = layer_id(name, cfg.depth)
        dec = decays(name, p)
        g = groups.setdefault((lid, dec), {
            "params": [], "names": [],
            "weight_decay": weight_decay if dec else 0.0,
            "lr_scale": layer_decay ** (num_layers - lid)})
        g["params"].append(p)
        g["names"].append(name)
    return [groups[k] for k in sorted(groups)]


def cosine_warmup_schedule(oc: OptimConfig):
    """Half-cycle cosine on fractional epoch with linear warmup
    (lr_sched.py:9-21), evaluated once per optimizer update."""
    warmup_steps = oc.warmup_epochs * oc.steps_per_epoch
    total_steps = oc.epochs * oc.steps_per_epoch

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return oc.lr * step / max(warmup_steps, 1.0)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps,
                                               1.0)
        return oc.min_lr + (oc.lr - oc.min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * progress))

    return schedule


class LayerDecayAdamW:
    """Clip by global norm, then AdamW with per-group layer-scaled lr.

    ``step()`` reads the parameters' ``.grad``, returns the global norm
    before clipping (a 0-d device tensor: no host sync), and advances the
    update count that the schedule reads.
    """

    def __init__(self, model: torch.nn.Module, cfg: ModelConfig,
                 oc: OptimConfig):
        self.oc = oc
        self.schedule = cosine_warmup_schedule(oc)
        self.groups = param_groups(model, cfg, oc.weight_decay,
                                   oc.layer_decay)
        self.adamw = torch.optim.AdamW(self.groups, lr=oc.lr,
                                       betas=oc.betas, eps=oc.eps)
        self.count = 0

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        params = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in params]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        if self.oc.clip_grad is not None:
            # optax.clip_by_global_norm: g * max / norm where norm > max
            factor = torch.where(norm < self.oc.clip_grad,
                                 torch.ones_like(norm),
                                 self.oc.clip_grad / norm)
            torch._foreach_mul_(grads, factor)
        lr = self.schedule(self.count)
        for g in self.adamw.param_groups:
            g["lr"] = lr * g["lr_scale"]
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])
