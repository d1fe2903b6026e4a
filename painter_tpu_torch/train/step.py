"""Training step: forward/backward, gradient accumulation, optimizer update.

The port of ``painter_tpu/train/step.py``: bf16 compute with fp32 params
(no loss scaler needed in bf16), gradients summed over ``accum_iter``
micro-batches and averaged, the global norm taken before clipping. The
micro-batch loop is a Python loop.

With a ``mesh`` (``parallel/mesh.py``, one process per device) the step
is data-parallel over every rank, and computes what the JAX mesh step
computes on the global batch:

- the loss of a micro-batch is normalized over the global micro-batch:
  each rank sums its loss weights before the forward, one ``all_reduce``
  gives the global sum for every micro-batch, and each rank's loss is its
  own weighted sum over that. A mean of per-rank means would differ
  whenever the ranks hold different masked counts, the usual case with
  ``half_mask_ratio`` and the near-black check;
- the drop-path masks are those of the global batch
  (``incontext_vit._drop_masks``);
- the gradients are summed over the ranks once per update, after the
  micro-batch loop, in one bucketed ``all_reduce`` (the all-reduce XLA
  inserts), with the loss riding in the same bucket;
- the optimizer shards its moments over the mesh's ``fsdp`` dim
  (``train/optim.py``).

The model is not wrapped in ``DistributedDataParallel`` or
``fully_shard``: their hooks need the module's ``__call__``, and the
port's forward is functional (``forward_encoder`` reads
``blk.attn.qkv.weight`` and the like directly).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from painter_tpu_torch.configs import ModelConfig
from painter_tpu_torch.models import incontext_vit as model_lib
from painter_tpu_torch.train.optim import LayerDecayAdamW


def _loss(cfg: ModelConfig, model, micro: Dict[str, torch.Tensor], **kw):
    loss, _, _ = model_lib.forward(
        model, micro["imgs"], micro["tgts"], micro["mask"], micro["valid"],
        seg_type=micro.get("seg_type"), **kw)
    return loss


def _all_reduce_sum(tensors: List[torch.Tensor]) -> None:
    """Sum ``tensors`` over every rank in place, as one flat bucket."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def make_train_step(cfg: ModelConfig, optimizer: LayerDecayAdamW,
                    accum_iter: int = 1, remat: bool = True,
                    remat_policy: str = "save_kernel",
                    attn_impl: str = "kernel", decoder_impl: str = "auto",
                    mesh=None):
    """Returns step(model, batch, generator) -> {"loss", "grad_norm"}.

    batch: dict of device tensors 'imgs', 'tgts' (B, H, W, 3), 'mask'
    (B, L), 'valid' (B, H, W, 3), optional 'seg_type' (B, 1); with
    accum_iter > 1 every leaf carries a leading (accum_iter,) micro-batch
    axis. ``generator`` draws the drop-path masks. The metrics are 0-d
    device tensors, read without a host sync until the caller asks.
    ``decoder_impl`` "auto" resolves to "xla", the stock tail, as in the
    JAX step; "fused" runs the decoder tail through K3 / K4. With a
    ``mesh``, ``batch`` is this rank's rows of the global batch and the
    step is the global batch's (module docstring); the optimizer must be
    built on the same mesh.
    """
    model_lib.saved_names(remat_policy)  # raises on an unknown policy
    if decoder_impl == "auto":
        decoder_impl = "xla"
    shard = None
    if mesh is not None:
        if dist.get_world_size() != mesh.size():
            raise ValueError("the mesh must span every rank")
        shard = (dist.get_rank(), dist.get_world_size())

    def train_step(model, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]):
        optimizer.zero_grad()
        micros = ([{k: v[i] for k, v in batch.items()}
                   for i in range(accum_iter)] if accum_iter > 1
                  else [batch])
        denoms = [None] * len(micros)
        if shard is not None:
            # the global loss denominators, from the inputs alone
            counts = torch.stack([model_lib.loss_weights(
                cfg, m["tgts"], m["mask"], m["valid"]).sum() for m in micros])
            dist.all_reduce(counts)
            denoms = list(counts)
        lsum = None
        for micro, denom in zip(micros, denoms):
            loss = _loss(cfg, model, micro, attn_impl=attn_impl, train=True,
                         generator=generator, remat=remat,
                         remat_policy=remat_policy, decoder_impl=decoder_impl,
                         batch_shard=shard, loss_denom=denom)
            # .grad sums the micro-batches' gradients
            loss.backward()
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
        grads = [p.grad for p in optimizer.params if p.grad is not None]
        if shard is not None:
            lsum = lsum.reshape(1)
            _all_reduce_sum(grads + [lsum])
            lsum = lsum[0]
        if accum_iter > 1:
            torch._foreach_div_(grads, float(accum_iter))
        grad_norm = optimizer.step()
        return {"loss": lsum / accum_iter, "grad_norm": grad_norm}

    return train_step


def make_eval_step(cfg: ModelConfig, attn_impl: str = "kernel"):
    """Masked-loss validation step (``engine_train.py:147-203``), with the
    stock decoder tail as the JAX ``make_eval_step``."""

    @torch.no_grad()
    def eval_step(model, batch: Dict[str, torch.Tensor]):
        return {"loss": _loss(cfg, model, batch, attn_impl=attn_impl)}

    return eval_step
