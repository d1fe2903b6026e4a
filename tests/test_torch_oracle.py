"""PyTorch port: the float64 oracle (``painter_tpu_torch.utils.torch_oracle``)
against the JAX package's (``painter_tpu.utils.torch_oracle``) and the
port's fp32 forward, on one set of numpy weights and inputs.

The port's oracle reads the state dict that ``models.convert`` makes of
the JAX tree; the JAX oracle reads the tree itself. Both are float64: they
agree within 1e-9. The port's fp32 forward (plain attention) agrees with
either within 1e-4, painted output and loss.
"""
import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from painter_tpu import configs as jcfg
from painter_tpu.models import incontext_vit as jm
from painter_tpu.ops.patches import unpatchify as j_unpatchify
from painter_tpu.utils.torch_oracle import torch_forward as jax_oracle
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.models import convert
from painter_tpu_torch.models import incontext_vit as tm
from painter_tpu_torch.ops.patches import unpatchify
from painter_tpu_torch.utils import torch_oracle

from torch_port_common import jax_params_np, port_model, stitched_batch, t

ORACLE_TOL = 1e-9  # float64 against float64
PORT_TOL = 1e-4    # the port's fp32 forward against float64

# (config overrides, batch, seg_type, merge_between_batch, a near-black
# target in sample 1)
CASES = {
    "global": ({}, 2, None, -1, False),
    # windows of 3 over the 8x4 grid pad both axes; the windowed blocks
    # carry window-sized tables (the JAX tree's _win leaves)
    "windowed_win_tables": (dict(window_size=3,
                                 window_block_indexes=(0, 1, 3, 4),
                                 window_rel_pos_tables=True), 2, None, -1,
                            False),
    "seg_type_tokens": (dict(seg_type_tokens=True), 2, [[0], [1]], -1,
                        False),
    "residual_blocks": (dict(residual_block_indexes=(1, 4)), 2, None, -1,
                        False),
    "merge_between_batch_0": ({}, 3, None, 0, False),
    "near_black_check_on": (dict(near_black_check=True), 2, None, -1, True),
    "near_black_check_off": (dict(near_black_check=False), 2, None, -1,
                             True),
}


def _inputs(cfg, batch, near_black):
    imgs, tgts, mask = stitched_batch(cfg, batch, 5)
    valid = np.ones_like(tgts)
    valid[:, :3] = 0.0
    if near_black:
        mean = np.asarray(tcfg.IMAGENET_MEAN, np.float32)
        std = np.asarray(tcfg.IMAGENET_STD, np.float32)
        tgts[1] = (0.0 - mean) / std
    return imgs, tgts, mask, valid


@pytest.mark.parametrize("case", list(CASES))
def test_oracle_matches_jax_oracle_and_port(case):
    over, batch, seg_type, merge, near_black = CASES[case]
    cfg_j = jcfg.tiny_test_config(**over)
    cfg_t = tcfg.tiny_test_config(**over)
    params = jax_params_np(cfg_j, seed=3)
    imgs, tgts, mask, valid = _inputs(cfg_t, batch, near_black)
    st = None if seg_type is None else np.asarray(seg_type, np.int32)

    sd = convert.state_dict_from_jax_params(params, cfg_t)
    loss, pred = torch_oracle.torch_forward(
        sd, cfg_t, imgs, tgts, mask, valid, seg_type=st,
        merge_between_batch=merge, device="cpu")
    ref_loss, ref_pred = jax_oracle(params, cfg_j, imgs, tgts, mask, valid,
                                    seg_type=st, merge_between_batch=merge)
    assert pred.dtype == np.float64 and pred.shape == imgs.shape
    np.testing.assert_allclose(pred, ref_pred, rtol=0, atol=ORACLE_TOL)
    assert abs(loss - ref_loss) <= ORACLE_TOL

    model = port_model(cfg_t, params)
    p_loss, p_patches, _ = tm.forward(
        model, t(imgs), t(tgts), t(mask), t(valid),
        seg_type=None if st is None else torch.from_numpy(st).long(),
        merge_between_batch=merge, attn_impl="plain")
    p_pred = unpatchify(p_patches, cfg_t.patch_size).detach().numpy()
    np.testing.assert_allclose(p_pred, pred, rtol=0, atol=PORT_TOL)
    assert abs(p_loss.item() - loss) <= PORT_TOL
    # and the JAX package's own fp32 forward agrees with both oracles
    j_loss, j_patches, _ = jm.forward(
        params, cfg_j, jnp.asarray(imgs), jnp.asarray(tgts),
        jnp.asarray(mask), jnp.asarray(valid),
        seg_type=None if st is None else jnp.asarray(st),
        merge_between_batch=merge)
    j_pred = np.asarray(j_unpatchify(j_patches, cfg_j.patch_size))
    np.testing.assert_allclose(j_pred, pred, rtol=0, atol=PORT_TOL)
    assert abs(float(j_loss) - loss) <= PORT_TOL
    if near_black:
        # sample 1 drops out of the loss only with the check on
        sd_loss_one, _ = torch_oracle.torch_forward(
            sd, cfg_t, imgs[:1], tgts[:1], mask[:1], valid[:1],
            device="cpu")
        same = abs(sd_loss_one - loss) <= ORACLE_TOL
        assert same == cfg_t.near_black_check


def test_oracle_is_independent_of_the_port_model():
    """The oracle reads only the configs and the device helper of the
    port: nothing of ``models`` or ``ops`` (the check would be circular)."""
    tree = ast.parse(inspect.getsource(torch_oracle))
    mods = {n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    ours = {m for m in mods if m.startswith("painter_tpu_torch")}
    assert ours == {"painter_tpu_torch.configs", "painter_tpu_torch.device"}


def test_oracle_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.tiny_test_config()
    sd = tm.build_model(cfg, device="cpu").state_dict()
    imgs, tgts, mask = stitched_batch(cfg, 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_oracle.torch_forward(sd, cfg, imgs, tgts, mask,
                                   np.ones_like(tgts))
