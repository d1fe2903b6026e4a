"""One rank of the port's multi-process CPU tests (``test_torch_parallel.py``).

    python tests/torch_dist_worker.py <rank> <world> <dir>

Joins a gloo group through a ``file://`` store in ``<dir>``, reads the
inputs the test wrote to ``<dir>/inputs.pt``, runs on the port alone (no
JAX in this process) and writes ``<dir>/rank<rank>.pt``:

- the mesh layouts of ``make_mesh(2, 1)`` and ``make_mesh(1, 2)``;
- two data-parallel updates (accum 2) on each mesh, with drop-path off
  and on: the parameters, the gathered AdamW state and the metrics;
- the dp-serving outputs of ``InContextModel(mesh=make_mesh(2, 1))``
  through ``run_queries`` and ``run_queries_shared`` on a ragged batch.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from painter_tpu_torch import configs  # noqa: E402
from painter_tpu_torch.infer import engine  # noqa: E402
from painter_tpu_torch.models import incontext_vit as tm  # noqa: E402
from painter_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from painter_tpu_torch.train import optim, step as step_lib  # noqa: E402


def _model(cfg, state_dict):
    model = tm.build_model(cfg, device="cpu")
    model.load_state_dict(state_dict)
    return model.train()


def _train(inp, mesh, rank, world, drop_path):
    cfg = configs.tiny_test_config(drop_path_rate=drop_path)
    model = _model(cfg, inp["state_dict"])
    opt = optim.LayerDecayAdamW(model, cfg, optim.OptimConfig(**inp["oc"]),
                                mesh=mesh)
    step = step_lib.make_train_step(cfg, opt, accum_iter=2, mesh=mesh)
    gen = torch.Generator().manual_seed(inp["gen_seed"])
    metrics = []
    for batch in inp["batches"]:  # (accum, global batch, ...) leaves
        b = batch["imgs"].shape[1] // world
        local = {k: v[:, rank * b:(rank + 1) * b] for k, v in batch.items()}
        m = step(model, local, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "optimizer": opt.state_dict(), "metrics": metrics,
            "shards": sum(s is not None for s in opt.shards)}


def main(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
        out = {"layout": {}, "train": {}}
        meshes = {"dp": make_mesh(2, 1), "fsdp": make_mesh(1, 2)}
        for name, mesh in meshes.items():
            out["layout"][name] = (mesh.mesh.tolist(),
                                   mesh.get_local_rank("dp"),
                                   mesh.get_local_rank("fsdp"))
            for drop_path in (0.0, 0.5):
                out["train"][name, drop_path] = _train(
                    inp, mesh, rank, world, drop_path)
        sv = inp["serve"]
        cfg = configs.tiny_test_config(**sv["cfg_kw"])
        # no device: the engine serves on the gloo mesh's device type
        eng = engine.InContextModel(cfg, _model(cfg, sv["state_dict"]),
                                    mesh=meshes["dp"])
        out["serve_device"] = str(eng.device)
        out["serve"] = {
            "queries": eng.run_queries(sv["imgs"], sv["tgts"],
                                       real_count=sv["real"]),
            "shared": eng.run_queries_shared(sv["queries"], sv["img2"],
                                             sv["tgt2"]),
            "shared_u8": eng.run_queries_shared(
                sv["queries_u8"], sv["img2"], sv["tgt2"],
                out_dtype=np.uint8)}
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
