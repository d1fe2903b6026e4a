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
import torch.distributed as dist

from painter_tpu_torch.configs import ModelConfig
from painter_tpu_torch.parallel.mesh import local_slice, param_dim


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

    With a ``mesh`` whose ``fsdp`` dim is larger than 1, each rank keeps
    the AdamW moments of, and updates, only its slice of each parameter
    along the dim ``parallel.mesh.param_dim`` picks (parameters without
    one are updated whole on every rank); the updated slices are then
    all-gathered into the whole parameter within the fsdp group, in one
    bucket. AdamW is elementwise, so this is the unsharded update. The
    gradients the norm and the clip read are the whole reduced ones, the
    same on every rank. The parameters themselves stay whole between
    updates (JAX keeps them sharded as well: a memory-only difference).
    """

    def __init__(self, model: torch.nn.Module, cfg: ModelConfig,
                 oc: OptimConfig, mesh=None):
        self.oc = oc
        self.schedule = cosine_warmup_schedule(oc)
        self.groups = param_groups(model, cfg, oc.weight_decay,
                                   oc.layer_decay)
        self.fsdp_group, self.fsdp_size, self.fsdp_rank = None, 1, 0
        if mesh is not None and mesh["fsdp"].size() > 1:
            self.fsdp_group = mesh.get_group("fsdp")
            self.fsdp_size = mesh["fsdp"].size()
            self.fsdp_rank = mesh.get_local_rank("fsdp")
        # per parameter, in the optimizer's order: the sharded dim or None
        self.dims = [param_dim(name, p.shape, self.fsdp_size)
                     for g in self.groups
                     for name, p in zip(g["names"], g["params"])]
        dims = iter(self.dims)
        self.shards: List[Optional[torch.Tensor]] = []
        adam_groups = []
        for g in self.groups:
            members = []
            for p in g["params"]:
                d = next(dims)
                shard = None if d is None else self._slice(p.detach(), d) \
                    .clone()
                self.shards.append(shard)
                members.append(p if shard is None else shard)
            adam_groups.append({**g, "params": members})
        self.adamw = torch.optim.AdamW(adam_groups, lr=oc.lr,
                                       betas=oc.betas, eps=oc.eps)
        self.count = 0

    def _slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return local_slice(t, dim, self.fsdp_size, self.fsdp_rank)

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)
        for p in self.params:
            p.grad = None

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
        for p, d, shard in zip(self.params, self.dims, self.shards):
            if shard is not None:
                shard.grad = (None if p.grad is None
                              else self._slice(p.grad, d).contiguous())
        lr = self.schedule(self.count)
        for g in self.adamw.param_groups:
            g["lr"] = lr * g["lr_scale"]
        self.adamw.step()
        self._gather()
        self.count += 1
        return norm

    def _gather(self) -> None:
        """The updated slices -> the whole parameters, one all-gather."""
        pairs = [(p, d, s) for p, d, s in
                 zip(self.params, self.dims, self.shards) if s is not None]
        if not pairs:
            return
        flat = torch.cat([s.detach().reshape(-1) for _, _, s in pairs])
        parts = [torch.empty_like(flat) for _ in range(self.fsdp_size)]
        dist.all_gather(parts, flat, group=self.fsdp_group)
        sizes = [s.numel() for _, _, s in pairs]
        with torch.no_grad():
            for r, part in enumerate(parts):
                for (p, d, s), piece in zip(pairs, part.split(sizes)):
                    local_slice(p, d, self.fsdp_size, r).copy_(
                        piece.view_as(s))

    def state_dict(self) -> Dict:
        """The whole optimizer state, the same at every fsdp size (the
        moments of sharded parameters gathered over the fsdp group: every
        rank of it must call this)."""
        sd = self.adamw.state_dict()
        for i, (d, shard) in enumerate(zip(self.dims, self.shards)):
            if shard is None or i not in sd["state"]:
                continue
            st = dict(sd["state"][i])
            for key in ("exp_avg", "exp_avg_sq"):
                parts = [torch.empty_like(st[key])
                         for _ in range(self.fsdp_size)]
                dist.all_gather(parts, st[key].contiguous(),
                                group=self.fsdp_group)
                st[key] = torch.cat(parts, dim=d)
            sd["state"][i] = st
        return {"adamw": sd, "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        """Load a whole state (any fsdp size wrote it): each rank keeps
        its slices, and the shards are re-cut from the parameters."""
        sd = state["adamw"]
        sd = {**sd, "state": dict(sd["state"])}
        for i, d in enumerate(self.dims):
            if d is None or i not in sd["state"]:
                continue
            st = dict(sd["state"][i])
            for key in ("exp_avg", "exp_avg_sq"):
                st[key] = self._slice(st[key], d).clone()
            sd["state"][i] = st
        with torch.no_grad():
            for p, d, shard in zip(self.params, self.dims, self.shards):
                if shard is not None:
                    shard.copy_(self._slice(p, d))
        self.adamw.load_state_dict(sd)
        self.count = int(state["count"])



# optax.lars' defaults, which the JAX package's ``lars`` keeps
LARS_TRUST_COEFFICIENT = 0.001
LARS_EPS = 0.0


class _Lars(torch.optim.Optimizer):
    def __init__(self, params, learning_rate, weight_decay, momentum):
        super().__init__(params, dict(lr=learning_rate,
                                      weight_decay=weight_decay,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad + group["weight_decay"] * p
                p_norm = torch.linalg.vector_norm(p)
                u_norm = torch.linalg.vector_norm(u)
                ratio = torch.where(
                    (p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                    LARS_TRUST_COEFFICIENT * p_norm / (u_norm + LARS_EPS))
                u = u * ratio * -group["lr"]
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p)
                trace = state["trace"]
                trace.mul_(group["momentum"]).add_(u)
                p.add_(trace)
        return loss


def lars(params, learning_rate: float = 0.0, weight_decay: float = 0.0,
         momentum: float = 0.9) -> torch.optim.Optimizer:
    """LARS over ``params`` with the JAX package's ``lars`` arguments
    (``Painter/util/lars.py``, MoCo v3), in ``optax.lars``' order: every
    parameter decayed and trust-scaled, momentum not Nesterov. Per
    parameter ``p`` with gradient ``g``:

    1. ``u = g + weight_decay * p`` (``add_decayed_weights``);
    2. ``u *= LARS_TRUST_COEFFICIENT * ||p|| / (||u|| + LARS_EPS)``, or 1
       where either norm is 0 (``scale_by_trust_ratio``);
    3. ``u *= -learning_rate`` (``scale_by_learning_rate``);
    4. ``t = u + momentum * t``, the update is ``t`` (``trace``, applied
       after the learning rate);
    5. ``p += t``.

    Unused by the trainer, as in JAX."""
    return _Lars(params, learning_rate, weight_decay, momentum)
