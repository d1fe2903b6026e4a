"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

One set of weights and inputs, made with numpy from a seed, goes through
the JAX package and the port; both run on the CPU.
"""
import functools
import os

import jax
import numpy as np
import torch

from painter_tpu.models import incontext_vit as jm
from painter_tpu_torch.models import convert
from painter_tpu_torch.models import incontext_vit as tm

# Under pytest-xdist each worker shares the host's cores with the others.
# torch's intra-op pool defaults to one thread per core in every worker,
# so six workers on eight cores oversubscribe them, and a test of many
# small ops stalls at each op's barrier on descheduled threads (a model
# restatement that takes 3.5 s alone took 1170 s under the 6-worker run).
# Every worker imports this module while it collects the port's tests, so
# each takes its share of the cores here.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def jax_params_np(cfg_j, seed=0):
    """A JAX-structured param tree for ``cfg_j`` filled with numpy normals
    from ``seed``: every leaf nonzero (the init zeroes the rel-pos tables
    and biases, which would leave those paths untested); LayerNorm scales
    near 1."""
    shapes = jax.eval_shape(functools.partial(jm.init_params, cfg=cfg_j),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.randn(*leaf.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * x
        return (0.1 if "rel_pos" in name else 0.05) * x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_init_params_np(cfg_j, seed=0):
    """The JAX package's own init at PRNGKey(seed), as a numpy tree."""
    params = jax.jit(jm.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg_j)
    return jax.tree_util.tree_map(np.asarray, params)


def port_model(cfg_t, params_np):
    """The port's model on the CPU holding ``params_np``."""
    model = tm.build_model(cfg_t, device="cpu")
    return convert.load_jax_params(model, params_np)


def t(a, dtype=torch.float32):
    """numpy -> CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def stitched_batch(cfg, n, seed):
    """(imgs, tgts, bottom-half mask) numpy inputs for ``n`` samples."""
    rng = np.random.RandomState(seed)
    h, w = cfg.img_size
    length = cfg.num_patches
    imgs = rng.randn(n, h, w, 3).astype(np.float32)
    tgts = rng.randn(n, h, w, 3).astype(np.float32)
    mask = np.zeros((n, length), np.float32)
    mask[:, length // 2:] = 1.0
    return imgs, tgts, mask


REMAT_GRAD_RTOL = 1e-4


def remat_grads_match_jax(params, policy):
    """The port's loss and gradients under remat ``policy`` (drop-path 0,
    fp32) == ``jax.value_and_grad`` of the JAX forward under the same
    policy: loss 1e-5 relative, each gradient 1e-4 x its own max abs."""
    from painter_tpu import configs as jcfg
    from painter_tpu_torch import configs as tcfg
    cfg_j, cfg_t = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    imgs, tgts, mask = stitched_batch(cfg_j, 2, 42)
    valid = np.ones_like(tgts)
    valid[:, :4] = 0.0

    def loss_fn(p):
        return jm.forward(p, cfg_j, imgs, tgts, mask, valid, train=True,
                          rng=jax.random.PRNGKey(0), attn_impl="xla",
                          remat=True,
                          remat_policy=None if policy == "full" else policy
                          )[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = port_model(cfg_t, params).train()
    loss_t, _, _ = tm.forward(model, t(imgs), t(tgts), t(mask), t(valid),
                              train=True, remat=True, remat_policy=policy,
                              generator=torch.Generator().manual_seed(0))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    ref = {k: v.numpy() for k, v in convert.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads_j), cfg_t).items()}
    for name, p in model.named_parameters():
        err = np.abs(p.grad.numpy() - ref[name]).max()
        assert err <= REMAT_GRAD_RTOL * max(np.abs(ref[name]).max(), 1e-30), \
            (name, err)
