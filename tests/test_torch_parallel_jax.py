"""PyTorch port: the two-rank data-parallel update against the JAX
package's mesh step on the forced host devices (``make_mesh(2, 1)`` /
``make_mesh(1, 2)``), drop-path off: loss and grad norm 1e-5 relative,
parameters 1e-5 absolute, Adam's moments 1e-4 of their max abs (fp32
sums in another order than XLA's). The ranks and their inputs are
``torch_parallel_common.py``'s."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from painter_tpu import configs as jcfg
from painter_tpu.parallel import mesh as jmesh
from painter_tpu.train import optim as joptim
from painter_tpu.train import step as jstep
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.models import convert
from painter_tpu_torch.train import optim as toptim

from torch_parallel_common import OC, close, two_ranks  # noqa: F401
from torch_port_common import port_model


def _by_name(tree_np, cfg_t):
    return {k: v.numpy() for k, v in
            convert.state_dict_from_jax_params(tree_np, cfg_t).items()}


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_two_rank_update_equals_jax_mesh_step(two_ranks, mode):
    """Two updates (accum 2) on two ranks == the JAX mesh step on two
    devices over the same global batches: loss and grad norm, parameters,
    and Adam's moments, on both ranks."""
    inputs, ranks = two_ranks
    n_dp, n_fsdp = (2, 1) if mode == "dp" else (1, 2)
    mesh = jmesh.make_mesh(n_dp, n_fsdp, jax.devices()[:2])
    cfg_j = jcfg.tiny_test_config()
    params = inputs["params"]
    optimizer = joptim.make_optimizer(params, cfg_j,
                                      joptim.OptimConfig(**OC))
    state = jstep.init_train_state(params, optimizer)
    state_sh = jax.tree_util.tree_map(
        lambda leaf: NamedSharding(mesh, jmesh.param_spec(leaf, n_fsdp)),
        state)
    state = jax.tree_util.tree_map(jax.device_put, state, state_sh)
    batch_sh = NamedSharding(mesh, P(None, ("dp", "fsdp")))
    step = jax.jit(jstep.make_train_step(cfg_j, optimizer, accum_iter=2,
                                         mesh=mesh),
                   in_shardings=(state_sh, batch_sh, None),
                   out_shardings=(state_sh, None))
    metrics = []
    for i, b in enumerate(inputs["batches"]):
        b = {k: jax.device_put(v.numpy(), batch_sh) for k, v in b.items()}
        state, m = step(state, b, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    cfg_t = tcfg.tiny_test_config()
    ref = _by_name(jax.tree_util.tree_map(np.asarray, state["params"]),
                   cfg_t)
    adam = next(s for s in state["opt_state"] if hasattr(s, "mu"))
    mu = _by_name(jax.tree_util.tree_map(np.asarray, adam.mu), cfg_t)
    nu = _by_name(jax.tree_util.tree_map(np.asarray, adam.nu), cfg_t)
    model = port_model(cfg_t, params)
    names = [n for g in toptim.param_groups(model, cfg_t, 0.1, 0.8)
             for n in g["names"]]
    for out in ranks:
        got = out["train"][mode, 0.0]
        for mg, mj in zip(got["metrics"], metrics):
            np.testing.assert_allclose(mg["loss"], mj["loss"], rtol=1e-5)
            np.testing.assert_allclose(mg["grad_norm"], mj["grad_norm"],
                                       rtol=1e-5)
        for name, v in got["params"].items():
            np.testing.assert_allclose(v.numpy(), ref[name], atol=1e-5,
                                       err_msg=name)
        st = got["optimizer"]["adamw"]["state"]
        for i, name in enumerate(names):
            close(st[i]["exp_avg"], torch.from_numpy(mu[name]), 1e-4, name)
            close(st[i]["exp_avg_sq"], torch.from_numpy(nu[name]), 1e-4,
                  name)
