"""PyTorch port: ``train/optim.py``'s ``lars`` against the JAX package's
(``optax.lars``) over 5 steps on the same fp32 parameters and gradients,
to 1e-6. One parameter is all zeros and one gradient is all zeros, so
the trust ratio's guard (1 where a norm is 0) runs."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from painter_tpu.train import optim as joptim
from painter_tpu_torch.train import optim as toptim

SHAPES = ((7, 5), (13,), (3, 4, 2), (6,), (4, 4))
TOL = 1e-6


def _params_and_grads(seed=0, steps=5):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    params[1][:] = 0.0  # a zero parameter
    grads = [[rng.randn(*s).astype(np.float32) * 0.1 for s in SHAPES]
             for _ in range(steps)]
    for g in grads:
        g[3][:] = 0.0  # a zero gradient every step
    return params, grads


@pytest.mark.parametrize("lr,wd,momentum", [(0.1, 0.0, 0.9),
                                            (0.5, 1e-2, 0.9),
                                            (2.0, 0.1, 0.0)])
def test_lars_matches_optax(lr, wd, momentum):
    params, grads = _params_and_grads()
    tx = joptim.lars(lr, weight_decay=wd, momentum=momentum)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = toptim.lars(tp, learning_rate=lr, weight_decay=wd,
                      momentum=momentum)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=0, atol=TOL)
    # the zero parameter moved only by its trust ratio of 1 (and decay)
    assert np.abs(tp[1].detach().numpy()).max() > 0
    # a parameter without a gradient is left alone
    frozen = torch.nn.Parameter(torch.ones(3))
    toptim.lars([frozen], learning_rate=lr).step()
    assert torch.equal(frozen.detach(), torch.ones(3))
