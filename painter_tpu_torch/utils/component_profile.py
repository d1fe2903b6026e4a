"""Measured per-component device-time profiles (forward and backward).

The port of ``painter_tpu/utils/component_profile.py``: the same timing
method, the same components and keys, on the port's eager ops. The
reference has no analogue (its only timing is the wall-clock
``MetricLogger`` loop, ``Painter/util/misc.py:124-168``).

Method:

- **Two-length chains.** Each component runs as a chain of n
  data-dependent applications (each one's output is the next one's
  input), closed by a device-to-host fetch of one scalar; the time per
  application is the *slope* between two chain lengths, which cancels the
  fixed cost of the launches' start and of the fetch.
- **Backward timing fetches every gradient.** The fetched value is
  ``loss + global_norm(grads)``, so the timed run computes every dW.
- **Backward chains mirror the real trunk**: n separate copies of the
  block's parameters (the JAX tool stacks n copies), each layer
  checkpointed under the port's remat policy (``_checkpointed`` of
  ``models/incontext_vit.py``, ``ops/remat.py``'s kept outputs). Drop
  path is off, as in the trainer at rate 0, which draws no masks.

``attn_impl="kernel"`` (the JAX tool's ``pallas``) runs the attention
through K1 / K2 on the card; "plain" (its ``xla``) through the plain
attention. Forward keys: ``block_ms``, ``mlp_ms``, ``ln_ms``,
``qkv_proj_ms`` and, under the kernel, ``flash_kernel_ms`` (K1 alone);
backward keys: ``block_ms``, ``attn_sub_ms``, ``mlp_sub_ms``, under the
kernel ``kernel_ms`` (K1 + K2 with no remat, a chain of at most 8 / 24
layers), then ``decoder_ms``, ``loss_ms`` and ``patch_embed_ms``.

CLI (runs on ``cuda`` unless ``--device cpu``)::

    python -m painter_tpu_torch.utils.component_profile --mode fwd,bwd \\
        --preset painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1 \\
        --batch 8 --dtype bfloat16 [--attn_impl kernel|plain]
        [--remat_policy save_kernel] [--n1 16 --n2 0 --reps 3]
"""
from __future__ import annotations

import argparse
import copy
import functools
import json
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from painter_tpu_torch import configs
from painter_tpu_torch.configs import ModelConfig
from painter_tpu_torch.device import resolve_device

ATTN_IMPLS = ("kernel", "plain")


# ---------------------------------------------------------------------------
# Timing primitives
# ---------------------------------------------------------------------------

def _fetch_scalar(x) -> float:
    """Device -> host copy of one value: the completion barrier."""
    return float(x.detach() if isinstance(x, torch.Tensor) else x)


def chain_time(body: Callable, carry, n: int, *consts, reps: int = 3
               ) -> float:
    """Min wall time (s) of an n-application chain of ``body`` (a
    tensor to a tensor of the same shape)."""
    def run():
        c = carry
        for _ in range(n):
            c = body(c, *consts)
        return _fetch_scalar(c.reshape(-1)[0])

    with torch.no_grad():
        run()  # warm
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
    return min(ts)


def chain_slope_ms(body: Callable, carry, *consts, n1: int = 16,
                   n2: int = 64, reps: int = 3) -> float:
    """Per-application forward time (ms) as the two-length slope."""
    t1 = chain_time(body, carry, n1, *consts, reps=reps)
    t2 = chain_time(body, carry, n2, *consts, reps=reps)
    return (t2 - t1) / (n2 - n1) * 1e3


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The l2 norm of all of ``grads`` together (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        [g.float() for g in torch._foreach_norm(list(grads))]))


def _timed_grads(run: Callable, reps: int) -> float:
    """Min wall time (s) of ``run() -> (loss, grads)`` closed by fetching
    the loss and the gradients' global norm, after one checked run."""
    lv, gr = run()
    s = _fetch_scalar(lv) + _fetch_scalar(global_norm(gr))
    if not np.isfinite(s):
        raise FloatingPointError(f"non-finite probe value {s}")
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        lv, gr = run()
        _fetch_scalar(lv)
        _fetch_scalar(global_norm(gr))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def grad_chain_time(body: Callable, carry: torch.Tensor, layer: nn.Module,
                    n: int, reps: int = 3) -> float:
    """Min wall time (s) of loss and gradients over an n-layer chain.

    ``body(carry, layer) -> new_carry``; each of the n layers is its own
    copy of ``layer``'s parameters (the trunk's separate blocks); the
    gradients are those of the chain's input and of every copy.
    """
    layers = [copy.deepcopy(layer) for _ in range(n)]
    params = [p for lyr in layers for p in lyr.parameters()]
    for p in params:
        p.requires_grad_(True)
    c0 = carry.detach().clone().requires_grad_(True)

    def run():
        c = c0
        for lyr in layers:
            c = body(c, lyr)
        loss = c.float().sum() * 1e-9
        return loss, torch.autograd.grad(loss, [c0, *params])

    return _timed_grads(run, reps)


def grad_chain_slope_ms(body: Callable, carry, layer, n1: int = 16,
                        n2: int = 48, reps: int = 3) -> float:
    """Per-layer forward+backward time (ms) as the two-length slope."""
    t1 = grad_chain_time(body, carry, layer, n1, reps=reps)
    t2 = grad_chain_time(body, carry, layer, n2, reps=reps)
    return (t2 - t1) / (n2 - n1) * 1e3


def grad_repeat_slope_ms(loss_fn: Callable, args: Tuple, n1: int = 1,
                         n2: int = 9, reps: int = 3) -> float:
    """Forward+backward time (ms) of a single-application component.

    ``loss_fn(*args, acc) -> scalar`` is chained n times through the
    ``acc`` scalar, so no application is the same as another; the
    gradients are those of ``args``' tensors and modules' parameters; the
    slope cancels the fixed cost."""
    args = tuple(a.detach().clone().requires_grad_(True)
                 if isinstance(a, torch.Tensor) else a for a in args)
    leaves = [x for a in args for x in (
        [a] if isinstance(a, torch.Tensor) else a.parameters())]
    device = leaves[0].device

    def timed(n):
        def run():
            acc = torch.zeros((), device=device)
            for _ in range(n):
                acc = acc + loss_fn(*args, acc)
            return acc, torch.autograd.grad(acc, leaves)
        return _timed_grads(run, reps)

    return (timed(n2) - timed(n1)) / (n2 - n1) * 1e3


# ---------------------------------------------------------------------------
# Model-component profiles
# ---------------------------------------------------------------------------

def _holder(cfg: ModelConfig, **modules: nn.Module) -> nn.Module:
    """A module holding ``modules`` (shared, not copied) and ``cfg``: what
    a model function reads of the model."""
    m = nn.Module()
    m.cfg = cfg
    for name, mod in modules.items():
        setattr(m, name, mod)
    return m


def _inputs(cfg: ModelConfig, batch: int, device):
    from painter_tpu_torch.models import incontext_vit as tm
    rng = np.random.RandomState(0)
    gh, gw = cfg.grid_size
    model = tm.build_model(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    x_grid = torch.from_numpy(rng.randn(batch, gh, gw, cfg.embed_dim)
                              * 0.02).to(device, cfg.compute_dtype)
    return model, model.blocks[0], x_grid, rng


def _qkv_rel(cfg: ModelConfig, batch: int, rng, blk, device):
    """(q, k, v) (B*heads, L, hd) in the compute type and the block's
    rel terms of q, (B*heads, L, gh) and (B*heads, L, gw)."""
    from painter_tpu_torch.ops.attention import rel_pos_bias
    gh, gw = cfg.grid_size
    nh, hd, length = cfg.num_heads, cfg.head_dim, gh * gw

    def rnd():
        return torch.from_numpy(rng.randn(batch * nh, length, hd) * 0.02).to(
            device, cfg.compute_dtype)

    q, k, v = rnd(), rnd(), rnd()
    rel_h, rel_w = rel_pos_bias(q.reshape(batch, nh, length, hd),
                                blk.attn.rel_pos_h.detach(),
                                blk.attn.rel_pos_w.detach(), (gh, gw),
                                (gh, gw))
    return (q, k, v, rel_h.reshape(batch * nh, length, gh).contiguous(),
            rel_w.reshape(batch * nh, length, gw).contiguous())


def profile_forward(cfg: ModelConfig, batch: int = 8,
                    attn_impl: str = "kernel", n1: int = 16, n2: int = 64,
                    reps: int = 3, device=None) -> Dict[str, float]:
    """Forward per-component profile, ms per application."""
    from painter_tpu_torch.kernels.flash_relpos import flash_attention_relpos
    from painter_tpu_torch.models import incontext_vit as tm
    from painter_tpu_torch.ops.norm import layer_norm
    from painter_tpu_torch.ops.quant import mlp

    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
    device = resolve_device(device)
    model, blk, x_grid, rng = _inputs(cfg, batch, device)
    gh, gw = cfg.grid_size
    d = cfg.embed_dim
    dt = cfg.compute_dtype
    length = gh * gw
    out: Dict[str, float] = {}

    out["block_ms"] = chain_slope_ms(
        lambda x, b: tm.block_apply(b, x, cfg, attn_impl=attn_impl),
        x_grid, blk, n1=n1, n2=n2, reps=reps)
    out["mlp_ms"] = chain_slope_ms(
        lambda x, b: mlp(x, b.mlp.fc1, b.mlp.fc2, cfg.gelu_approximate,
                         b.mlp.mlp_impl),
        x_grid, blk, n1=n1, n2=n2, reps=reps)
    out["ln_ms"] = chain_slope_ms(
        lambda x, b: layer_norm(x, b.norm1.weight, b.norm1.bias, cfg.ln_eps),
        x_grid, blk, n1=n1, n2=n2, reps=reps)
    out["qkv_proj_ms"] = chain_slope_ms(
        lambda x, qk, pk: ((x.reshape(batch, length, d) @ qk)[..., :d]
                           @ pk).reshape(batch, gh, gw, d),
        x_grid, blk.attn.qkv.weight.detach().t().to(dt),
        blk.attn.proj.weight.detach().t().to(dt), n1=n1, n2=n2, reps=reps)
    if cfg.use_rel_pos and attn_impl == "kernel":
        q0, k0, v0, rh, rw = _qkv_rel(cfg, batch, rng, blk, device)
        out["flash_kernel_ms"] = chain_slope_ms(
            lambda q, k, v, h, w: flash_attention_relpos(
                q, k, v, h, w, (gh, gw), cfg.head_dim ** -0.5)[0],
            q0, k0, v0, rh, rw, n1=n1, n2=n2, reps=reps)
    return out


def profile_backward(cfg: ModelConfig, batch: int = 8,
                     attn_impl: str = "kernel",
                     remat_policy: Optional[str] = "save_kernel",
                     n1: int = 16, n2: int = 48, reps: int = 3,
                     include_single: bool = True,
                     device=None) -> Dict[str, float]:
    """Backward (forward + backward, the remat recompute included)
    per-component profile, ms per application.

    The full block and the attention and MLP sub-blocks each run
    checkpointed under ``remat_policy`` (None: no checkpointing), as the
    trainer's trunk runs its blocks.
    """
    from painter_tpu_torch.kernels.flash_relpos import (
        flash_attention_relpos_fn)
    from painter_tpu_torch.models import incontext_vit as tm
    from painter_tpu_torch.ops.attention import attention
    from painter_tpu_torch.ops.norm import layer_norm
    from painter_tpu_torch.ops.quant import mlp

    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
    if remat_policy is not None and remat_policy not in tm.REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; the "
                         f"policies are {tm.REMAT_POLICIES} or None")
    device = resolve_device(device)
    model, blk, x_grid, rng = _inputs(cfg, batch, device)
    gh, gw = cfg.grid_size
    H, W = cfg.img_size
    length = gh * gw
    dt = cfg.compute_dtype
    out: Dict[str, float] = {}

    def ckpt(fn):
        """``fn(layer, x, drop_mask=None)`` -> ``body(x, layer)`` under
        the policy."""
        def body(x, layer):
            f = functools.partial(fn, layer)
            if remat_policy is None:
                return f(x, drop_mask=None)
            return tm._checkpointed(f, remat_policy, attn_impl)(x, None)
        return body

    def emit(key, val):
        out[key] = val
        print(f"BWD[{key}] {val:.3f} ms", flush=True)

    def block_fn(b, x, drop_mask=None):
        return tm.block_apply(b, x, cfg, attn_impl=attn_impl,
                              drop_mask=drop_mask)

    emit("block_ms", grad_chain_slope_ms(ckpt(block_fn), x_grid, blk,
                                         n1=n1, n2=n2, reps=reps))

    def attn_fn(b, x, drop_mask=None):
        at = b.attn
        rel = (at.rel_pos_h, at.rel_pos_w) if cfg.use_rel_pos else None
        xn = layer_norm(x, b.norm1.weight, b.norm1.bias, cfg.ln_eps)
        return x + attention(xn, at.qkv.weight, at.qkv.bias, at.proj.weight,
                             at.proj.bias, cfg.num_heads, (gh, gw),
                             rel_pos=rel, attn_impl=attn_impl)

    emit("attn_sub_ms", grad_chain_slope_ms(
        ckpt(attn_fn), x_grid, _holder(cfg, norm1=blk.norm1, attn=blk.attn),
        n1=n1, n2=n2, reps=reps))

    def mlp_fn(b, x, drop_mask=None):
        xn = layer_norm(x, b.norm2.weight, b.norm2.bias, cfg.ln_eps)
        return x + mlp(xn, b.mlp.fc1, b.mlp.fc2, cfg.gelu_approximate,
                       b.mlp.mlp_impl)

    emit("mlp_sub_ms", grad_chain_slope_ms(
        ckpt(mlp_fn), x_grid, _holder(cfg, norm2=blk.norm2, mlp=blk.mlp),
        n1=n1, n2=n2, reps=reps))

    if cfg.use_rel_pos and attn_impl == "kernel":
        q0, k0, v0, rh, rw = _qkv_rel(cfg, batch, rng, blk, device)
        kv = nn.ParameterDict({"k": k0, "v": v0, "rh": rh, "rw": rw})

        def kernel_body(q, p):
            return flash_attention_relpos_fn(q, p["k"], p["v"], p["rh"],
                                             p["rw"], (gh, gw),
                                             cfg.head_dim ** -0.5)[0]

        # the bare-kernel chain runs without remat, so every layer keeps
        # its K1 outputs and inputs (~130 MB at ViT-L b8): the long chain
        # stops at 24 layers
        emit("kernel_ms", grad_chain_slope_ms(
            kernel_body, q0, kv, n1=min(n1, 8), n2=min(n2, 24), reps=reps))

    if include_single:
        dec = _holder(cfg, decoder_embed=model.decoder_embed,
                      decoder_pred=model.decoder_pred)

        def dec_loss(dp_, xg, acc):
            pred = tm.forward_decoder(dp_, [xg + (acc * 1e-20).to(dt)] * 4)
            return pred.float().sum() * 1e-9

        # n2=5: each chained decoder holds ~0.4 GB of conv temporaries at
        # b8
        emit("decoder_ms", grad_repeat_slope_ms(dec_loss, (dec, x_grid),
                                                n2=5, reps=reps))

        def rnd(*shape, scale=1.0):
            return torch.from_numpy(rng.randn(*shape) * scale).to(
                device, torch.float32)

        imgs = rnd(batch, H, W, 3)
        tgts = rnd(batch, H, W, 3)
        mask = torch.zeros((batch, length), device=device)
        mask[:, length // 2:] = 1.0
        valid = torch.ones((batch, H, W, 3), device=device)
        pred_fake = rnd(batch, H, W, 3, scale=0.1)

        def loss_only(tg, acc):
            return tm.forward_loss(cfg, pred_fake + acc * 1e-20, tg, mask,
                                   valid)

        emit("loss_ms", grad_repeat_slope_ms(loss_only, (tgts,), reps=reps))

        pe = _holder(cfg, patch_embed=model.patch_embed)

        def embed_loss(im, acc):
            y = tm._patch_embed(pe, im + acc * 1e-20)
            return y.float().sum() * 1e-9

        emit("patch_embed_ms", grad_repeat_slope_ms(embed_loss, (imgs,),
                                                    reps=reps))
    return out


def main(argv=None):
    from painter_tpu_torch.models.incontext_vit import REMAT_POLICIES

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default=(
        "painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1"))
    ap.add_argument("--mode", default="fwd,bwd",
                    help="comma list of fwd,bwd")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--attn_impl", default="kernel", choices=ATTN_IMPLS)
    ap.add_argument("--remat_policy", default="save_kernel",
                    choices=(*REMAT_POLICIES, "none"),
                    help="bwd-mode remat policy (the trainer's default "
                         "save_kernel; none: no checkpointing)")
    ap.add_argument("--n1", type=int, default=16)
    ap.add_argument("--n2", type=int, default=0,
                    help="0 = 64 for fwd, 48 for bwd")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.preset, dtype=args.dtype,
                             drop_path_rate=0.0)
    result: Dict[str, Any] = {"preset": args.preset, "batch": args.batch,
                              "dtype": args.dtype,
                              "attn_impl": args.attn_impl}
    modes = args.mode.split(",")
    if "fwd" in modes:
        result["fwd"] = profile_forward(
            cfg, args.batch, args.attn_impl, n1=args.n1,
            n2=args.n2 or 64, reps=args.reps, device=args.device)
        print("FWD " + json.dumps(result["fwd"]), flush=True)
    if "bwd" in modes:
        result["bwd"] = profile_backward(
            cfg, args.batch, args.attn_impl,
            remat_policy=(None if args.remat_policy == "none"
                          else args.remat_policy),
            n1=args.n1, n2=args.n2 or 48, reps=args.reps,
            device=args.device)
        print("BWD " + json.dumps(result["bwd"]), flush=True)
    print("PROFILE " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
