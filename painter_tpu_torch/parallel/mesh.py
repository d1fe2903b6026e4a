"""Device mesh and the fsdp sharding rule (the port of
``painter_tpu/parallel/mesh.py``).

One process per device, as PyTorch's own idiom has it: the collectives go
through ``torch.distributed`` (NCCL on the card, gloo on the CPU), and a
:class:`~torch.distributed.device_mesh.DeviceMesh` with dims
``("dp", "fsdp")`` stands in for the JAX ``Mesh``:

- ``dp``: data parallelism; the parameters are replicated and the
  gradients all-reduced once per update (``train/step.py``);
- ``fsdp``: the AdamW moments, and the update, of each large parameter are
  sharded along the dim :func:`param_dim` picks; the updated slices are
  all-gathered into the whole parameter (``train/optim.py``).

Ranks are laid out as JAX's ``reshape(n_dp, n_fsdp)``: rank
``i * n_fsdp + j`` sits at (dp ``i``, fsdp ``j``). The global batch is
sharded over (dp, fsdp) jointly, so rank ``r`` holds rows
``[r * b, (r + 1) * b)`` of a global batch of ``world * b``.

Nothing stands in for the JAX ``shard_batch0_kernel``: with one process
per device, every kernel sees only its own rank's rows, and the gradients
of the rel-pos tables are reduced like any other parameter's.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

MESH_DIMS = ("dp", "fsdp")


def make_mesh(n_dp: Optional[int] = None, n_fsdp: int = 1,
              device_type: Optional[str] = None):
    """A ``("dp", "fsdp")`` DeviceMesh over every rank of the initialized
    process group. ``device_type`` defaults to :func:`collective_device`'s.
    Raises unless ``n_dp * n_fsdp`` is the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_dp is None:
        n_dp = world // n_fsdp
    if n_dp * n_fsdp != world:
        raise ValueError(f"mesh (dp {n_dp}, fsdp {n_fsdp}) does not cover "
                         f"the {world} ranks")
    if device_type is None:
        device_type = collective_device().type
    return init_device_mesh(device_type, (n_dp, n_fsdp),
                            mesh_dim_names=MESH_DIMS)


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the
    current card under NCCL, the host under any other backend."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _jax_axis_order(name: str, ndim: int) -> Tuple[int, ...]:
    """The port's dims of a parameter in the order of the JAX leaf's axes
    (``models/convert.py`` transposes): a conv weight (out, in, kh, kw) is
    HWIO there, a linear weight (out, in) is (in, out); the rest keep
    their order (leading singleton dims never shard)."""
    if ndim == 4:
        return (2, 3, 1, 0)
    if ndim == 2 and name.endswith(".weight"):
        return (1, 0)
    return tuple(range(ndim))


def param_dim(name: str, shape: Sequence[int], fsdp_size: int
              ) -> Optional[int]:
    """The dim of parameter ``name`` that the fsdp axis shards, or None.

    JAX's ``param_spec`` rule on the JAX layout of the same parameter: the
    largest axis that is >= 128 and divisible by ``fsdp_size``, ties to
    the later axis; parameters with no such axis are replicated.
    """
    if fsdp_size == 1 or not len(shape):
        return None
    order = _jax_axis_order(name, len(shape))
    jshape = [shape[d] for d in order]
    candidates = [k for k, n in enumerate(jshape)
                  if n % fsdp_size == 0 and n >= 128]
    if not candidates:
        return None
    return order[max(candidates, key=lambda k: (jshape[k], k))]


def local_slice(t: torch.Tensor, dim: int, size: int, index: int
                ) -> torch.Tensor:
    """Shard ``index`` of ``size`` equal slices of ``t`` along ``dim``."""
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)
