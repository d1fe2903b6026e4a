"""PyTorch port: the last three of the seven remat policies against the
JAX package's (``torch_port_common.remat_grads_match_jax``; the first
four in ``test_torch_remat.py``, split for the per-file time)."""
import pytest

from painter_tpu import configs as jcfg
from painter_tpu_torch.models import incontext_vit as tm

from torch_port_common import jax_params_np, remat_grads_match_jax


@pytest.mark.parametrize("policy", tm.REMAT_POLICIES[4:])
def test_remat_policy_grads_match_jax(policy):
    remat_grads_match_jax(jax_params_np(jcfg.tiny_test_config(), seed=41),
                          policy)
