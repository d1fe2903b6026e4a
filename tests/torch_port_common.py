"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

One set of weights and inputs, made with numpy from a seed, goes through
the JAX package and the port; both run on the CPU.
"""
import functools

import jax
import numpy as np
import torch

from painter_tpu.models import incontext_vit as jm
from painter_tpu_torch.models import convert
from painter_tpu_torch.models import incontext_vit as tm


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
