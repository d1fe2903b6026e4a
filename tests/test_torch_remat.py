"""PyTorch port: the seven remat policies against the JAX package's.

Each policy's loss and gradients (drop-path 0, fp32) are held to
``jax.value_and_grad`` of the JAX forward under the same policy
(``torch_port_common.remat_grads_match_jax``; the first four policies
here, the other three in ``test_torch_remat_jax.py``). What each policy
keeps is pinned by counting the gemms the
backward's recompute runs again; the attention forward's count is pinned
in ``test_torch_train.py::test_remat_policies_same_grads_and_attention_calls``.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from painter_tpu import configs as jcfg
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.models import incontext_vit as tm

from torch_port_common import (jax_params_np, port_model,
                               remat_grads_match_jax, stitched_batch, t)


def _batch(cfg, seed):
    imgs, tgts, mask = stitched_batch(cfg, 2, seed)
    valid = np.ones_like(tgts)
    valid[:, :4] = 0.0
    return imgs, tgts, mask, valid


@pytest.fixture(scope="module")
def jax_params():
    return jax_params_np(jcfg.tiny_test_config(), seed=41)


@pytest.mark.parametrize("policy", tm.REMAT_POLICIES[:4])
def test_remat_policy_grads_match_jax(jax_params, policy):
    remat_grads_match_jax(jax_params, policy)


class _CountGemms(TorchDispatchMode):
    """Counts the ``addmm`` calls (the block's biased linears) run under
    it."""

    def __init__(self):
        super().__init__()
        self.addmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.addmm.default:
            self.addmm += 1
        return func(*args, **(kwargs or {}))


# linears the backward runs again, over the tiny model's 6 blocks of 4
# (qkv, proj, fc1, fc2; each a biased ``addmm`` in the forward of
# ``ops/remat.py``'s Function, its backward none): "full" recomputes all
# 24, attn_out saves the proj (6), mlp_fc1 the fc1 (6), save_dots all four.
RECOMPUTED_LINEARS = {"full": 24, "save_kernel": 24, "save_attn": 18,
                      "save_kernel_attn": 18, "save_kernel_mlp": 18,
                      "save_attn_mlp": 12, "save_dots": 0}


@pytest.mark.parametrize("policy", tm.REMAT_POLICIES)
def test_remat_policy_skips_the_gemms_it_keeps(jax_params, policy):
    cfg = tcfg.tiny_test_config(drop_path_rate=0.5)
    imgs, tgts, mask, valid = _batch(cfg, seed=43)
    model = port_model(cfg, jax_params).train()
    loss, _, _ = tm.forward(model, t(imgs), t(tgts), t(mask), t(valid),
                            train=True, remat=True, remat_policy=policy,
                            generator=torch.Generator().manual_seed(1))
    with _CountGemms() as counted:
        loss.backward()
    assert counted.addmm == RECOMPUTED_LINEARS[policy]


@pytest.mark.parametrize("policy,names", [
    ("full", ()), ("save_attn", ("attn_out",)),
    ("save_kernel", ("attn_out",)),
    ("save_kernel_attn", ("attn_out",)),
    ("save_kernel_mlp", ("attn_out", "mlp_fc1")),
    ("save_attn_mlp", ("attn_out", "mlp_fc1")),
    ("save_dots", ("qkv", "attn_out", "mlp_fc1", "mlp_fc2"))])
def test_kernel_policies_resolve_to_attn_out_without_the_kernel(policy,
                                                                names):
    """Under plain attention the save_kernel* names resolve to attn_out,
    as JAX's ``seg_impl != "pallas"`` branch; with the kernel they keep
    the kernel's outputs."""
    assert tm.saved_names(policy, "plain") == names
    with_kernel = tm.saved_names(policy, "kernel")
    assert ("attn_kernel" in with_kernel) == policy.startswith("save_kernel")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tm.saved_names("save_all", "kernel")
