"""PyTorch port: data parallelism over ``torch.distributed`` on the CPU.

Two gloo ranks (``tests/torch_dist_worker.py``, single-threaded, a
``file://`` store in ``tmp_path``) run the port's data-parallel update on
a ``make_mesh(2, 1)`` (dp 2) and a ``make_mesh(1, 2)`` (fsdp 2) mesh, and
serve a ragged batch over a dp mesh. They are held to the port's
one-process update at the global batch (parameters and AdamW moments to
1e-5 of each tensor's max abs: fp32 sums in another order), to the JAX
package's mesh step on the forced host devices (drop-path off; loss and
grad norm 1e-5 relative, parameters 1e-5 absolute, moments 1e-4 of their
max abs), and to the JAX ``InContextModel(mesh=...)`` (2e-5 on the [0,1]
scale, uint8 outputs within one step). The two ranks' batches hold
different masked counts: the masks differ in size, and one sample of rank
1 is zeroed by the near-black check.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from painter_tpu import configs as jcfg
from painter_tpu.infer import engine as je
from painter_tpu.models import incontext_vit as jm
from painter_tpu.parallel import mesh as jmesh
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.infer import engine as te
from painter_tpu_torch.models import convert
from painter_tpu_torch.models import incontext_vit as tm
from painter_tpu_torch.parallel import mesh as tmesh

from torch_parallel_common import (SERVE_KW, close, one_process,  # noqa: F401
                                   two_ranks)
from torch_port_common import port_model

VITL = "painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1"
ATOL_SERVE = 2e-5


# ---------------------------------------------------------------------------
# the fsdp rule and the mesh layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [2, 4, 8])
def test_param_dim_matches_jax_param_spec_on_every_vitl_leaf(fsdp):
    """On every leaf of ViT-L, the dim ``param_dim`` picks for the port's
    parameter is the axis JAX's ``param_spec`` picks for its leaf,
    carried through the port's own converter; every parameter of 1 MB or
    more is sharded at fsdp 2.

    The carrying uses a small probe per leaf in the JAX layout: each
    non-singleton axis gets a size of its own (a stacked block leaf keeps
    its depth axis), and every element holds the probe size of the axis
    JAX shards (-1: replicated). After the converter, the port dim of
    that size is the one the JAX axis became."""
    cfg_j = jcfg.get_config(VITL)
    cfg_t = tcfg.get_config(VITL)
    shapes = jax.eval_shape(functools.partial(jm.init_params, cfg=cfg_j),
                            jax.random.PRNGKey(0))

    def probe(path, leaf):
        stacked = "blocks" in jax.tree_util.keystr(path)
        sizes = iter((2, 3, 5, 7, 11))
        shape = [n if n == 1 or (k == 0 and stacked) else next(sizes)
                 for k, n in enumerate(leaf.shape)]
        spec = tuple(jmesh.param_spec(leaf, fsdp))
        mark = shape[spec.index("fsdp")] if "fsdp" in spec else -1
        return np.full(shape, mark, np.float32)

    probes = convert.state_dict_from_jax_params(
        jax.tree_util.tree_map_with_path(probe, shapes), cfg_t)
    with torch.device("meta"):
        model = tm.InContextViT(cfg_t)
    sharded = 0
    for name, p in model.named_parameters():
        dim = tmesh.param_dim(name, tuple(p.shape), fsdp)
        mark = int(probes[name].reshape(-1)[0])
        if mark < 0:
            assert dim is None, (name, dim)
        else:
            assert dim is not None and probes[name].shape[dim] == mark, \
                (name, dim, tuple(probes[name].shape), mark)
            sharded += 1
        if fsdp == 2 and p.numel() * 4 >= 1 << 20:
            assert dim is not None, name
    assert sharded > 100


@pytest.mark.parametrize("n_dp,n_fsdp", [(4, 1), (2, 2), (1, 4)])
def test_make_mesh_rank_layout_matches_jax(n_dp, n_fsdp):
    """``make_mesh`` places rank i * n_fsdp + j at (dp i, fsdp j), as
    JAX's ``reshape(n_dp, n_fsdp)`` places the devices; checked at every
    rank of a 4-rank world of torch's fake process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist
    jlayout = np.vectorize(lambda d: d.id)(
        jmesh.make_mesh(n_dp, n_fsdp, jax.devices()[:4]).devices)
    for rank in range(4):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=4)
        try:
            mesh = tmesh.make_mesh(n_dp, n_fsdp)
            assert mesh.mesh_dim_names == ("dp", "fsdp")
            assert mesh.mesh.tolist() == jlayout.tolist()
            i, j = np.argwhere(jlayout == rank)[0]
            assert (mesh.get_local_rank("dp"),
                    mesh.get_local_rank("fsdp")) == (i, j)
            with pytest.raises(ValueError, match="does not cover"):
                tmesh.make_mesh(3, n_fsdp)
        finally:
            dist.destroy_process_group()


def test_two_ranks_hold_different_masked_counts(two_ranks):
    inputs, _ = two_ranks
    cfg = tcfg.tiny_test_config()
    b = inputs["batches"][0]
    counts = [float(tm.loss_weights(cfg, b["tgts"][0, r:r + 1],
                                    b["mask"][0, r:r + 1],
                                    b["valid"][0, r:r + 1]).sum())
              for r in range(2)]
    assert counts[0] > 0 and counts[1] == 0  # the near-black zeroing
    b = inputs["batches"][1]
    counts = [float(tm.loss_weights(cfg, b["tgts"][0, r:r + 1],
                                    b["mask"][0, r:r + 1],
                                    b["valid"][0, r:r + 1]).sum())
              for r in range(2)]
    assert counts[0] != counts[1] and min(counts) > 0


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_two_rank_mesh_layout(two_ranks, mode):
    _, ranks = two_ranks
    grid = [[0], [1]] if mode == "dp" else [[0, 1]]
    for r, out in enumerate(ranks):
        layout, dp, fsdp = out["layout"][mode]
        assert layout == grid
        assert (dp, fsdp) == ((r, 0) if mode == "dp" else (0, r))


@pytest.mark.parametrize("drop_path", [0.0, 0.5])
@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_two_rank_update_equals_one_process_update(two_ranks, mode,
                                                   drop_path):
    """Two updates (accum 2) on two ranks == the one-process updates at
    the global batch: metrics, parameters and AdamW moments, on both
    ranks; drop-path on draws the global batch's masks on each rank."""
    inputs, ranks = two_ranks
    model, opt, metrics = one_process(inputs, drop_path)
    ref_state = opt.state_dict()["adamw"]["state"]
    params = dict(model.named_parameters())
    for out in ranks:
        got = out["train"][mode, drop_path]
        assert (got["shards"] > 0) == (mode == "fsdp")
        for mg, mr in zip(got["metrics"], metrics):
            for k in mr:
                np.testing.assert_allclose(mg[k], mr[k], rtol=1e-5)
        for name, p in params.items():
            close(got["params"][name], p.detach(), 1e-5, name)
        state = got["optimizer"]["adamw"]["state"]
        assert sorted(state) == sorted(ref_state)
        for i in ref_state:
            for key in ("exp_avg", "exp_avg_sq"):
                close(state[i][key], ref_state[i][key], 1e-5, (i, key))
    if drop_path:  # the masks were drawn: another seed moves the loss
        _, _, base = one_process(inputs, 0.0)
        assert base[0]["loss"] != metrics[0]["loss"]


@pytest.fixture(scope="module")
def jax_dp_serving(two_ranks):
    """The JAX engine on a 2-device dp mesh, on the serving inputs."""
    inputs, _ = two_ranks
    sv = inputs["serve"]
    cfg_j = jcfg.tiny_test_config(**SERVE_KW)
    eng = je.InContextModel(cfg_j, inputs["serve_params"], attn_impl="xla",
                            mesh=Mesh(np.asarray(jax.devices()[:2]), ("dp",)))
    return {"queries": eng.run_queries(sv["imgs"], sv["tgts"],
                                       real_count=sv["real"]),
            "shared": eng.run_queries_shared(sv["queries"], sv["img2"],
                                             sv["tgt2"]),
            "shared_u8": eng.run_queries_shared(
                sv["queries_u8"], sv["img2"], sv["tgt2"],
                out_dtype=np.uint8)}


def _port_serving(eng, sv):
    return {"queries": eng.run_queries(sv["imgs"], sv["tgts"],
                                       real_count=sv["real"]),
            "shared": eng.run_queries_shared(sv["queries"], sv["img2"],
                                             sv["tgt2"]),
            "shared_u8": eng.run_queries_shared(
                sv["queries_u8"], sv["img2"], sv["tgt2"],
                out_dtype=np.uint8)}


def _assert_serving(got, ref, atol=ATOL_SERVE):
    for key in ("queries", "shared"):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key], ref[key], atol=atol,
                                   err_msg=key)
    assert got["shared_u8"].dtype == ref["shared_u8"].dtype == np.uint8
    assert got["shared_u8"].shape == ref["shared_u8"].shape
    assert np.abs(got["shared_u8"].astype(int) -
                  ref["shared_u8"].astype(int)).max() <= 1


def test_dp_serving_across_processes_matches_jax(two_ranks, jax_dp_serving):
    """A ``DeviceMesh`` model on two ranks: each paints its rows of the
    ragged (3 -> padded 4) batch and all-gathers; both ranks hold the same
    outputs, equal to the JAX engine on a 2-device dp mesh."""
    _, ranks = two_ranks
    for key in ("queries", "shared", "shared_u8"):
        np.testing.assert_array_equal(ranks[0]["serve"][key],
                                      ranks[1]["serve"][key])
    assert ranks[0]["serve"]["queries"].shape[0] == 3
    assert [r["serve_device"] for r in ranks] == ["cpu", "cpu"]
    _assert_serving(ranks[0]["serve"], jax_dp_serving)


def test_dp_serving_device_follows_the_mesh_device_type():
    """With a DeviceMesh and no ``device``, the engine serves on the
    mesh's device type: the host for a cpu mesh; a cuda mesh (gloo also
    carries CUDA tensors) without a card raises instead of moving the
    model to the host."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist
    cfg = tcfg.tiny_test_config(**SERVE_KW)
    model = tm.build_model(cfg, device="cpu")

    class CudaMesh:  # a real cuda DeviceMesh needs a card to be built
        device_type = "cuda"

        def __getitem__(self, name):
            return self

        def size(self):
            return 2

        def get_local_rank(self, name):
            return 0

    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.InContextModel(cfg, model, mesh=CudaMesh())
    dist.init_process_group("fake", store=FakeStore(), rank=1,
                            world_size=2)
    try:
        eng = te.InContextModel(cfg, model, mesh=tmesh.make_mesh(2, 1))
        assert (eng.device.type, eng.n_dp, eng._dp_rank) == ("cpu", 2, 1)
    finally:
        dist.destroy_process_group()


def test_dp_serving_replicas_on_one_process_match_jax(two_ranks,
                                                      jax_dp_serving):
    """``InContextModel(mesh=["cpu", "cpu"])``: one replica per named
    device, each painting its row block; equal to the JAX dp engine."""
    inputs, _ = two_ranks
    cfg_t = tcfg.tiny_test_config(**SERVE_KW)
    eng = te.InContextModel(cfg_t, port_model(cfg_t, inputs["serve_params"]),
                            mesh=["cpu", "cpu"])
    assert eng.n_dp == 2 and len(eng._replicas) == 2
    _assert_serving(_port_serving(eng, inputs["serve"]), jax_dp_serving)


def test_dp_serving_three_replicas_equal_one_device(two_ranks):
    """Three replicas (the batch of 3, one row each) paint what one device
    paints for each row alone at batch 1, bit for bit on the CPU. (One
    device's batch of 3 is no bitwise reference: a CPU GEMM at M = 3 need
    not round as it does at M = 1.)"""
    inputs, _ = two_ranks
    sv = inputs["serve"]
    cfg_t = tcfg.tiny_test_config(**SERVE_KW)
    model = port_model(cfg_t, inputs["serve_params"])
    one = te.InContextModel(cfg_t, model, device="cpu")
    three = te.InContextModel(cfg_t, model, mesh=["cpu"] * 3)
    rows = [_port_serving(one, {
        **sv, "imgs": sv["imgs"][i:i + 1], "tgts": sv["tgts"][i:i + 1],
        "real": 1, "queries": sv["queries"][i:i + 1],
        "queries_u8": sv["queries_u8"][i:i + 1]}) for i in range(3)]
    ref = {key: np.concatenate([r[key] for r in rows])
           for key in ("queries", "shared", "shared_u8")}
    _assert_serving(_port_serving(three, sv), ref, atol=0)
