"""Multi-process dryrun of the port (the counterpart of
``__graft_entry__.py --dryrun``).

    python -m painter_tpu_torch.dryrun N [--procs P] [--device cpu]

Spawns one process per rank (``--procs`` must equal ``N``, its default:
torch.distributed runs one rank per process, where JAX can hold several
devices in one) joined through a ``file://`` store. Each rank, on a
``("dp", "fsdp")`` mesh of the N ranks (fsdp 2 when N is even):

- one full train step of a small config whose widths shard (embed 256,
  head_dim 64, 6 blocks, a 20x10 token grid, bf16 compute, drop-path
  0.1): accumulation 2, AdamW with layer decay and fsdp-sharded moments,
  ``save_kernel`` remat, two rows per rank of a global micro-batch;
- the cross-process meter sync (``MetricLogger``): every rank adds its
  rank to the loss, the synced mean must be ``loss + (N - 1) / 2``;
- dp serving through ``InContextModel(mesh=...)`` on a pure-dp mesh: a
  ragged batch of N + 1 queries, the same painted batch on every rank;
- the flagship plan: Painter ViT-L 896x448 built on the ``meta`` device,
  the port's fsdp rule applied through the optimizer, and the sharded
  parameters and the bytes per rank printed, nothing allocated.

The ranks run on the card by default (raises without one): over NCCL
with one card per rank, over gloo when they share cards (the
collectives then take host tensors, ``parallel.mesh.collective_device``).
``--device cpu`` runs them on the host over gloo.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from painter_tpu_torch.device import resolve_device

FLAGSHIP = "painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1"
# the grid width is 10: on the card the bf16 attention backward stays on
# the ViT-L kernel, which takes grid widths in [10, 40]
# (kernels/flash_relpos.py attention_route)
TINY = dict(img_size=(160, 80), patch_size=8, embed_dim=256, num_heads=4,
            depth=6, drop_path_rate=0.1, pretrain_img_size=32,
            dtype="bfloat16")
ACCUM = 2
ROWS_PER_RANK = 2


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun check failed: {msg}")


def _global_batch(cfg, n: int):
    """(accum, 2n, ...) float32 leaves, the same on every rank."""
    rng = np.random.RandomState(0)
    h, w = cfg.img_size
    b, length = ROWS_PER_RANK * n, cfg.num_patches
    mask = np.zeros((ACCUM, b, length), np.float32)
    mask[..., length // 2:] = 1.0
    return {"imgs": rng.randn(ACCUM, b, h, w, 3).astype(np.float32),
            "tgts": rng.randn(ACCUM, b, h, w, 3).astype(np.float32),
            "mask": mask,
            "valid": np.ones((ACCUM, b, h, w, 3), np.float32)}


def _train_step(cfg, mesh, rank: int, n: int, device: torch.device):
    from painter_tpu_torch.models import incontext_vit as model_lib
    from painter_tpu_torch.train import optim, step as step_lib
    model = model_lib.build_model(
        cfg, torch.Generator(device=device).manual_seed(0),
        device=device).train()
    opt = optim.LayerDecayAdamW(model, cfg,
                                optim.OptimConfig(steps_per_epoch=10),
                                mesh=mesh)
    step = step_lib.make_train_step(cfg, opt, accum_iter=ACCUM, remat=True,
                                    remat_policy="save_kernel", mesh=mesh)
    lo = rank * ROWS_PER_RANK
    local = {k: torch.from_numpy(v[:, lo:lo + ROWS_PER_RANK]).to(device)
             for k, v in _global_batch(cfg, n).items()}
    m = step(model, local, torch.Generator(device=device).manual_seed(1))
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    _check(np.isfinite(loss) and np.isfinite(gnorm), f"loss {loss}, "
           f"grad norm {gnorm}")
    sharded = sum(s is not None for s in opt.shards)
    print(f"dryrun({n}) rank {rank}: mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} on "
          f"{device}, loss={loss:.4f} grad_norm={gnorm:.4f} "
          f"step={opt.count}, {sharded} parameters' moments sharded",
          flush=True)
    return model, loss


def _meter_sync(loss: float, rank: int, n: int) -> None:
    """The cross-process meter reduction (misc.py:43-54 role)."""
    from painter_tpu_torch.utils.logging import MetricLogger
    logger = MetricLogger()
    logger.update(loss=loss + rank)
    logger.synchronize_between_processes()
    mean, expect = logger.summary()["loss"], loss + (n - 1) / 2
    _check(abs(mean - expect) < 1e-6, f"meter mean {mean}, expected "
           f"{expect} (are the ranks' losses equal?)")
    print(f"dryrun({n}): {n}-process meter sync ok (mean={mean:.4f})",
          flush=True)


def _serve(cfg, model, n: int, device: torch.device) -> None:
    """dp serving of a ragged batch; every rank must hold the same."""
    from painter_tpu_torch.infer import engine
    from painter_tpu_torch.parallel.mesh import make_mesh
    from painter_tpu_torch.utils.logging import MetricLogger
    eng = engine.InContextModel(cfg, model, device=device,
                                mesh=make_mesh(n, 1,
                                               device_type=device.type))
    rng = np.random.RandomState(1)
    res = cfg.img_size[1]
    img2, tgt2 = rng.rand(res, res, 3), rng.rand(res, res, 3)
    queries = [rng.rand(res, res, 3) for _ in range(n + 1)]
    qi, qt = engine.build_query_batch(queries, img2, tgt2)
    outs = eng.run_queries(qi, qt, real_count=len(queries))
    _check(outs.shape == (len(queries), res, res, 3)
           and np.isfinite(outs).all(), f"served {outs.shape}")
    digest = float(np.abs(outs).sum())
    logger = MetricLogger()
    logger.update(digest=digest)
    logger.synchronize_between_processes()
    _check(abs(logger.summary()["digest"] - digest)
           <= 1e-5 * max(1.0, abs(digest)),
           f"the ranks served different batches ({digest})")
    print(f"dryrun({n}): dp-sharded serving batch {outs.shape} finite, the "
          f"same on all {n} processes", flush=True)


def _flagship_plan(mesh, n: int) -> None:
    """Painter ViT-L's fsdp plan on ``mesh`` from the ``meta`` device."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.models.incontext_vit import InContextViT
    from painter_tpu_torch.train import optim
    vitl = configs.get_config(FLAGSHIP)
    with torch.device("meta"):
        model = InContextViT(vitl)
    opt = optim.LayerDecayAdamW(model, vitl, optim.OptimConfig(), mesh=mesh)
    params = opt.params
    _check(all(p.is_meta for p in params), "the plan allocated parameters")
    sharded = [s for s in opt.shards if s is not None]
    members = [p if s is None else s for p, s in zip(params, opt.shards)]
    whole = 4 * sum(p.numel() for p in params)
    slices = 4 * sum(s.numel() for s in sharded)
    moments = 2 * 4 * sum(m.numel() for m in members)
    print(f"dryrun({n}): flagship ViT-L 896x448 on mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}: "
          f"{len(sharded)} of {len(params)} parameters sharded over fsdp "
          f"{opt.fsdp_size}; per rank {whole / 1e9:.3f} GB of fp32 "
          f"parameters (whole), {slices / 1e9:.3f} GB of fsdp slices, "
          f"{moments / 1e9:.3f} GB of AdamW moments, "
          f"{(whole + slices + moments) / 1e9:.3f} GB in all (meta device, "
          f"nothing allocated)", flush=True)


def run_rank(n: int, rank: int, store: str, device: str,
             backend: str) -> None:
    """One rank of the dryrun (a process of :func:`spawn`)."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=n,
                            device_id=dev if backend == "nccl" else None)
    try:
        n_fsdp = 2 if n % 2 == 0 else 1
        mesh = make_mesh(n // n_fsdp, n_fsdp, device_type=dev.type)
        cfg = configs.tiny_test_config(**TINY)
        model, loss = _train_step(cfg, mesh, rank, n, dev)
        _meter_sync(loss, rank, n)
        _serve(cfg, model, n, dev)
        _flagship_plan(mesh, n)
    finally:
        dist.destroy_process_group()


def rank_placement(n: int, device=None):
    """(backend, device of each rank): NCCL with one card per rank, gloo
    when the ranks share cards or run on the host."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", ["cpu"] * n
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= n else "gloo"
    return backend, [f"cuda:{r % cards}" for r in range(n)]


def spawn(backend: str, devices, timeout: float = 900) -> str:
    """Run one process per rank, rank ``r`` on ``devices[r]``; raises if
    any fails. Returns rank 0's output."""
    n = len(devices)
    with tempfile.TemporaryDirectory() as tmp:
        children = [subprocess.Popen(
            [sys.executable, "-m", "painter_tpu_torch.dryrun", str(n),
             "--worker", str(r), "--store", os.path.join(tmp, "store"),
             "--rank_device", devices[r], "--backend", backend],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        outs = []
        try:
            for c in children:
                outs.append(c.communicate(timeout=timeout)[0])
        finally:
            for c in children:
                if c.poll() is None:
                    c.kill()
                    c.wait()
    for r, (c, out) in enumerate(zip(children, outs)):
        if c.returncode != 0:
            raise RuntimeError(f"dryrun rank {r} failed:\n{out[-4000:]}")
    return outs[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser("painter_tpu_torch dryrun")
    p.add_argument("n", type=int, nargs="?", default=2,
                   help="ranks of the mesh")
    p.add_argument("--procs", type=int, default=None,
                   help="processes (one per rank; default N)")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the ranks on the host over gloo; "
                        "default: the cards")
    # a rank's own arguments, set by spawn()
    p.add_argument("--worker", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--store", help=argparse.SUPPRESS)
    p.add_argument("--rank_device", help=argparse.SUPPRESS)
    p.add_argument("--backend", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker is not None:
        run_rank(args.n, args.worker, args.store, args.rank_device,
                 args.backend)
        return
    if args.procs not in (None, args.n):
        raise ValueError(f"--procs {args.procs}: each of the {args.n} "
                         f"ranks is its own process, so --procs must be "
                         f"{args.n}")
    backend, devices = rank_placement(args.n, args.device)
    print(spawn(backend, devices), end="")
    print(f"dryrun({args.n}): {args.n} real processes over {backend} on "
          f"{', '.join(devices)}: rendezvous, sharded step, meter sync, dp "
          f"serving and the flagship plan all ok", flush=True)


if __name__ == "__main__":
    main()
