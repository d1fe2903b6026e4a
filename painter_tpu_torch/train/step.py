"""Training step: forward/backward, gradient accumulation, optimizer update.

The port of ``painter_tpu/train/step.py``: bf16 compute with fp32 params
(no loss scaler needed in bf16), gradients summed over ``accum_iter``
micro-batches and averaged, the global norm taken before clipping. One
device, eagerly: the micro-batch loop is a Python loop.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from painter_tpu_torch.configs import ModelConfig
from painter_tpu_torch.models import incontext_vit as model_lib
from painter_tpu_torch.train.optim import LayerDecayAdamW


def _loss(cfg: ModelConfig, model, micro: Dict[str, torch.Tensor], **kw):
    loss, _, _ = model_lib.forward(
        model, micro["imgs"], micro["tgts"], micro["mask"], micro["valid"],
        seg_type=micro.get("seg_type"), **kw)
    return loss


def make_train_step(cfg: ModelConfig, optimizer: LayerDecayAdamW,
                    accum_iter: int = 1, remat: bool = True,
                    remat_policy: str = "save_kernel",
                    attn_impl: str = "kernel", decoder_impl: str = "auto"):
    """Returns step(model, batch, generator) -> {"loss", "grad_norm"}.

    batch: dict of device tensors 'imgs', 'tgts' (B, H, W, 3), 'mask'
    (B, L), 'valid' (B, H, W, 3), optional 'seg_type' (B, 1); with
    accum_iter > 1 every leaf carries a leading (accum_iter,) micro-batch
    axis. ``generator`` draws the drop-path masks. The metrics are 0-d
    device tensors, read without a host sync until the caller asks.
    ``decoder_impl`` "auto" resolves to "xla", the stock tail, as in the
    JAX step; "fused" runs the decoder tail through K3 / K4.
    """
    if remat_policy not in model_lib.REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} is not ported; the "
                         f"port has {model_lib.REMAT_POLICIES}")
    if decoder_impl == "auto":
        decoder_impl = "xla"

    def train_step(model, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]):
        optimizer.zero_grad()
        micros = ([{k: v[i] for k, v in batch.items()}
                   for i in range(accum_iter)] if accum_iter > 1
                  else [batch])
        lsum = None
        for micro in micros:
            loss = _loss(cfg, model, micro, attn_impl=attn_impl, train=True,
                         generator=generator, remat=remat,
                         remat_policy=remat_policy, decoder_impl=decoder_impl)
            # .grad sums the micro-batches' gradients
            loss.backward()
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
        if accum_iter > 1:
            torch._foreach_div_([p.grad for p in optimizer.params
                                 if p.grad is not None], float(accum_iter))
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
