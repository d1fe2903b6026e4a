"""The outputs a checkpointed block keeps for its recompute (the remat
policies of ``models/incontext_vit.py``).

The port of JAX's ``checkpoint_name`` / ``save_only_these_names``: inside
:meth:`SavedOutputs.active`, the block's first run records the output of
each op it runs under a name the policy keeps; the checkpoint's recompute
in the backward (a second run of the same block) takes them back in order
instead of running the op again. The names are JAX's: ``attn_kernel``
(the attention kernel's (out, lse)), ``qkv``, ``attn_out`` (the
attention's post-proj output), ``mlp_fc1`` (the fc1 pre-activation) and
``mlp_fc2``.

One mechanism serves both kinds of op. The attention kernel's autograd
Function (``kernels/flash_relpos.py``) and :func:`named_linear`'s Function
each take their output from :func:`kept`, so the recompute builds the same
autograd nodes, saving the same tensors, without launching the op.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F


class SavedOutputs:
    """The kept outputs of one checkpointed block, by name."""

    def __init__(self, names: Iterable[str]):
        self.names = frozenset(names)
        self._saved = {name: [] for name in self.names}
        self._runs = 0

    @contextlib.contextmanager
    def active(self):
        token = _ACTIVE.set(self)
        try:
            yield
        finally:
            _ACTIVE.reset(token)
            self._runs += 1

    def forward(self, name: str, compute: Callable):
        if name not in self.names:
            return compute()
        saved = self._saved[name]
        if self._runs == 0:
            out = compute()
            # aliases: each Function application returns its own objects
            saved.append(out.detach() if isinstance(out, torch.Tensor)
                         else tuple(o.detach() for o in out))
            return out
        if saved:
            return saved.pop(0)
        return compute()


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "painter_tpu_torch_saved_outputs", default=None)


def kept(name: str, compute: Callable):
    """``compute()``, or the output the active :class:`SavedOutputs` kept
    for it under ``name``."""
    cache = _ACTIVE.get()
    return compute() if cache is None else cache.forward(name, compute)


class _NamedLinear(torch.autograd.Function):
    """``F.linear`` whose forward output may come from :func:`kept`; the
    backward is the linear's own (dx = g W, dW = gᵀ x, db = Σ g)."""

    @staticmethod
    def forward(ctx, x, weight, bias, name):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return kept(name, lambda: F.linear(x, weight, bias))

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        g2 = grad.reshape(-1, grad.shape[-1])
        dx = grad @ weight if ctx.needs_input_grad[0] else None
        dw = (g2.t() @ x.reshape(-1, x.shape[-1])
              if ctx.needs_input_grad[1] else None)
        db = g2.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db, None


def named_linear(name: str, x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` whose output a remat policy can keep under
    ``name``. Under autograd it always runs through one Function, in a
    checkpointed block or not, so a kept output and a computed one
    differentiate the same way, bit for bit."""
    if not torch.is_grad_enabled():
        return F.linear(x, weight, bias)
    return _NamedLinear.apply(x, weight, bias, name)
