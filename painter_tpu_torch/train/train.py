"""Training CLI of the PyTorch port (``main_train.py`` equivalent).

The flags and flow of ``painter_tpu/train/train.py`` (itself mirroring
``Painter/main_train.py:48-391``): a model from a named preset, MAE-init
surgery, mixture dataset, weighted sampler, per-update cosine lr with
warmup, AdamW + layer decay, gradient accumulation, grad-clip 3.0, epoch
loop with masked-loss validation, checkpoint save / auto-resume, JSON-lines
log, NaN watchdog (engine_train.py:70-72). The trainer runs on ``cuda``
unless ``--platform cpu`` is given.

Without ``--distributed`` it is one process on one device. With it, one
process per device (PyTorch's idiom; the JAX trainer's
``jax.distributed.initialize``): NCCL on ``cuda:{LOCAL_RANK}``, gloo under
``--platform cpu``, the ranks on a ``("dp", "fsdp")`` mesh
(``parallel/mesh.py``, ``--n_fsdp`` ranks per fsdp group), each loading
its shard of the weighted draw, the update data-parallel over the global
batch (``train/step.py``); log lines, ``log.txt``, ``scalars.jsonl``,
panels and checkpoints come from rank 0, the meters are summed over the
ranks at the end of each epoch.

Run: python -m painter_tpu_torch.train.train --json_path a.json \\
    --data_path datasets/ --output_dir out/ [--finetune mae.pth] ...
Multi-GPU: torchrun --nproc_per_node N -m painter_tpu_torch.train.train \\
    --distributed ...
"""
from __future__ import annotations

import argparse
import itertools
import math
import os
import sys
import time

import torch
import torch.distributed as dist

from painter_tpu_torch.models.incontext_vit import REMAT_POLICIES


def get_args_parser():
    p = argparse.ArgumentParser("Painter training (PyTorch port)",
                                add_help=False)
    p.add_argument("--batch_size", default=2, type=int,
                   help="per-device batch size")
    p.add_argument("--accum_iter", default=16, type=int)
    p.add_argument("--model", default="painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1")
    p.add_argument("--epochs", default=15, type=int)
    p.add_argument("--warmup_epochs", default=1, type=float)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--min_lr", default=0.0, type=float)
    p.add_argument("--weight_decay", default=0.1, type=float)
    p.add_argument("--layer_decay", default=0.8, type=float)
    p.add_argument("--clip_grad", default=3.0, type=float)
    p.add_argument("--drop_path", default=0.1, type=float)
    p.add_argument("--input_size", default=(896, 448), type=int, nargs=2)
    p.add_argument("--num_mask_patches", default=784, type=int)
    p.add_argument("--max_mask_patches_per_block", default=392, type=int)
    p.add_argument("--min_mask_patches_per_block", default=16, type=int)
    p.add_argument("--min_random_scale", default=0.3, type=float)
    p.add_argument("--half_mask_ratio", default=0.1, type=float)
    p.add_argument("--data_path", default="datasets/")
    p.add_argument("--json_path", nargs="+", default=[])
    p.add_argument("--val_json_path", nargs="+", default=[])
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--finetune", default="",
                   help="MAE-pretrained .pth for init surgery")
    p.add_argument("--resume", default="",
                   help="torch .pth to warm-start weights from")
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--save_freq", default=1, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--print_freq", default=20, type=int)
    p.add_argument("--panel_freq", default=0, type=int,
                   help="every N update steps, dump an [x, masked, pred, "
                        "tgt] PNG panel of the current batch (0 = off)")
    p.add_argument("--loss_func", default="smoothl1")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--n_fsdp", default=1, type=int,
                   help="fsdp mesh dim size: ranks that shard the AdamW "
                        "moments and update between them; divides the "
                        "world size")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction,
                   default=True, help="per-block activation checkpointing")
    p.add_argument("--remat_policy", default="save_kernel",
                   choices=REMAT_POLICIES,
                   help="'save_kernel' (default) keeps the attention "
                        "kernel's out + lse, so the backward's recompute "
                        "skips the attention forward; 'full' recomputes "
                        "the whole block; 'save_attn' keeps the post-proj "
                        "attention output, 'save_kernel_attn' / "
                        "'save_kernel_mlp' add it / the fc1 "
                        "pre-activation to 'save_kernel', "
                        "'save_attn_mlp' keeps both, 'save_dots' the "
                        "outputs of qkv, proj, fc1 and fc2 "
                        "(models/incontext_vit.py)")
    p.add_argument("--attn_impl", default="kernel", choices=["kernel", "plain"],
                   help="'kernel': the CUDA attention kernels on the card "
                        "(their plain versions on the CPU); 'plain': plain "
                        "attention differentiated by autograd")
    p.add_argument("--decoder_impl", default="auto",
                   choices=["auto", "xla", "fused"],
                   help="'auto' and 'xla' run the stock decoder tail; "
                        "'fused' runs it through the fused decoder-tail "
                        "kernels (forward and backward) on the card, their "
                        "plain versions on the CPU; validation keeps the "
                        "stock tail")
    p.add_argument("--max_steps_per_epoch", default=-1, type=int,
                   help="truncate epochs (smoke tests)")
    p.add_argument("--watchdog_freq", default=10, type=int,
                   help="read the metrics and NaN-check every N steps")
    p.add_argument("--num_workers", default=None, type=int,
                   help="data worker processes (default min(8, cores-1))")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="one process per device over torch.distributed "
                        "(NCCL; gloo under --platform cpu); the rendezvous "
                        "from --coordinator / --num_processes / "
                        "--process_id, else from torchrun's environment")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (or an init URL such as "
                        "file:///path); default: torchrun's MASTER_ADDR")
    p.add_argument("--num_processes", default=None, type=int)
    p.add_argument("--process_id", default=None, type=int)
    p.add_argument("--platform", default=None,
                   help="'cpu' trains on the host; default: cuda")
    return p


def _init_distributed(args):
    """Join the process group -> (rank, world, device). From
    ``--coordinator`` / ``--num_processes`` / ``--process_id`` when
    given, else from torchrun's ``MASTER_ADDR`` / ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK``; NCCL on ``cuda:{LOCAL_RANK}`` (the
    process id modulo the cards when no launcher set it), gloo on the
    host under ``--platform cpu``."""
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            raise ValueError("--coordinator needs --num_processes and "
                             "--process_id")
        init = (args.coordinator if "://" in args.coordinator
                else f"tcp://{args.coordinator}")
        rank, world = args.process_id, args.num_processes
    else:
        init = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if args.platform == "cpu":
        backend, device = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed trains on CUDA devices over "
                               "NCCL; pass --platform cpu for gloo")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        backend, device = "nccl", torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            device_id=device if backend == "nccl" else None)
    return rank, world, device


def main(args=None):
    """Train; returns {"model", "optimizer", "step"}."""
    if args is None:  # console-script entry point
        args = get_args_parser().parse_args()
    if not args.distributed and args.n_fsdp > 1:
        raise ValueError(f"--n_fsdp {args.n_fsdp} does not divide the world "
                         "of one process; pass --distributed")
    if not args.distributed:
        return _train(args, None)
    import builtins
    from painter_tpu_torch.utils.logging import setup_for_distributed
    own_print = builtins.print
    rank, world, device = _init_distributed(args)
    try:
        # reference: silence print on non-master ranks (misc.py:152-168)
        setup_for_distributed(rank == 0)
        print(f"process {rank}/{world} ({device})", force=True)
        return _train(args, device)
    finally:
        builtins.print = own_print
        dist.destroy_process_group()


def _train(args, device):
    """The training loop; ``device`` is the rank's device under
    ``torch.distributed``, None for one process."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.data import pairdataset as pd
    from painter_tpu_torch.device import resolve_device
    from painter_tpu_torch.models import incontext_vit as model_lib
    from painter_tpu_torch.ops import image as image_ops
    from painter_tpu_torch.train import checkpoint as ckpt_lib
    from painter_tpu_torch.train import optim, step as step_lib
    from painter_tpu_torch.utils.logging import (MetricLogger, ScalarWriter,
                                                 append_log_line,
                                                 dump_sample_panel)

    distributed = device is not None
    rank, world = ((dist.get_rank(), dist.get_world_size()) if distributed
                   else (0, 1))
    master = rank == 0
    mesh = None
    if distributed:
        from painter_tpu_torch.parallel.mesh import make_mesh
        if world % args.n_fsdp:
            raise ValueError(f"--n_fsdp {args.n_fsdp} does not divide the "
                             f"world size {world}")
        mesh = make_mesh(world // args.n_fsdp, args.n_fsdp,
                         device_type=device.type)
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
              f"on {device.type}")
    else:
        device = resolve_device(args.platform)
    cfg = configs.get_config(
        args.model, img_size=tuple(args.input_size),
        drop_path_rate=args.drop_path, loss_func=args.loss_func,
        dtype=args.dtype)
    model = model_lib.build_model(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    for path, what in ((args.finetune, "initialized"),
                       (args.resume, "resumed weights")):
        if path:
            ckpt_lib.load_torch_params(path, model)
            print(f"{what} from {path}")
    model.train()
    print(f"device: {device}")

    dataset = pd.make_train_dataset(
        args.data_path, args.json_path, img_size=tuple(args.input_size),
        num_mask_patches=args.num_mask_patches,
        max_mask_patches_per_block=args.max_mask_patches_per_block,
        min_mask_patches_per_block=args.min_mask_patches_per_block,
        min_random_scale=args.min_random_scale,
        half_mask_ratio=args.half_mask_ratio, patch_size=cfg.patch_size)
    val_dataset = (pd.make_val_dataset(args.data_path, args.val_json_path,
                                       img_size=tuple(args.input_size),
                                       num_mask_patches=args.num_mask_patches,
                                       patch_size=cfg.patch_size)
                   if args.val_json_path else None)
    # each rank loads its shard of the weighted draw
    # (DistributedSamplerWrapper semantics, data/sampler.py)
    sampler = pd.WeightedMixtureSampler(dataset.weights, num_replicas=world,
                                        rank=rank, seed=args.seed)

    global_batch = args.batch_size * world
    steps_per_epoch = len(dataset) // (global_batch * args.accum_iter)
    if args.max_steps_per_epoch > 0:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    print(f"effective batch {global_batch * args.accum_iter}, "
          f"{steps_per_epoch} updates/epoch")

    oc = optim.OptimConfig(
        lr=args.lr, min_lr=args.min_lr, weight_decay=args.weight_decay,
        layer_decay=args.layer_decay, clip_grad=args.clip_grad,
        warmup_epochs=args.warmup_epochs, epochs=args.epochs,
        steps_per_epoch=max(steps_per_epoch, 1))
    optimizer = optim.LayerDecayAdamW(model, cfg, oc, mesh=mesh)
    train_step = step_lib.make_train_step(
        cfg, optimizer, accum_iter=args.accum_iter, remat=args.remat,
        remat_policy=args.remat_policy, attn_impl=args.attn_impl,
        decoder_impl=args.decoder_impl, mesh=mesh)
    eval_step = step_lib.make_eval_step(cfg, attn_impl=args.attn_impl)
    # drop-path masks (the same draws on every rank: each keeps its rows'
    # columns); saved and restored with the checkpoints
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)

    ckpt_dir = os.path.abspath(os.path.join(args.output_dir, "checkpoints"))
    start_epoch = 0
    if args.auto_resume:
        resumed = ckpt_lib.restore_state(ckpt_dir, model, optimizer,
                                         generator)
        if resumed is not None:
            start_epoch = resumed // max(steps_per_epoch, 1)
            print(f"auto-resumed from step {resumed} (epoch {start_epoch})")
    scalar_writer = ScalarWriter(args.output_dir) if master else None

    def put_batch(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    for epoch in range(start_epoch, args.epochs):
        logger = MetricLogger()
        it = pd.data_iterator(dataset, sampler, args.batch_size, epoch,
                              seed=args.seed, accum_iter=args.accum_iter,
                              num_workers=args.num_workers)
        t_epoch = time.time()
        pending = []

        def drain_metrics():
            # one host sync for the whole window; the device ran ahead
            for gstep, mt in pending:
                loss_v = float(mt["loss"])
                if not math.isfinite(loss_v):
                    print(f"Loss is {loss_v}, stopping training "
                          "(engine_train.py:70-72 watchdog)")
                    sys.exit(1)
                gn = float(mt["grad_norm"])
                logger.update(loss=loss_v, grad_norm=gn)
                if scalar_writer is not None:
                    scalar_writer.write(
                        gstep, gstep / max(steps_per_epoch, 1), loss=loss_v,
                        grad_norm=gn, lr=optimizer.schedule(gstep))
            pending.clear()

        for step_idx, batch in enumerate(logger.log_every(
                itertools.islice(it, steps_per_epoch), args.print_freq,
                header=f"Epoch [{epoch}]", total=steps_per_epoch)):
            batch = put_batch(batch)
            gstep = epoch * steps_per_epoch + step_idx
            if master and args.panel_freq > 0 and \
                    gstep % args.panel_freq == 0:
                mb = ({k: v[0] for k, v in batch.items()}
                      if args.accum_iter > 1 else batch)
                with torch.no_grad():
                    pred = image_ops.denormalize(model_lib.predict_image(
                        model, mb["imgs"], mb["tgts"], mb["mask"],
                        attn_impl=args.attn_impl))
                path = dump_sample_panel(
                    args.output_dir, gstep, mb["imgs"].cpu().numpy(),
                    mb["tgts"].cpu().numpy(), mb["mask"].cpu().numpy(),
                    pred.cpu().numpy(), cfg.patch_size)
                print(f"sample panel -> {path}")
            pending.append((gstep, train_step(model, batch, generator)))
            if (step_idx + 1) % max(args.watchdog_freq, 1) == 0:
                drain_metrics()
        it.close()
        drain_metrics()
        # cross-process meter reduction (misc.py:43-54 role)
        logger.synchronize_between_processes()
        stats = {f"train_{k}": v for k, v in logger.summary().items()}

        if val_dataset is not None:
            vlogger = MetricLogger()
            vsampler = pd.WeightedMixtureSampler(
                val_dataset.weights, num_replicas=world, rank=rank,
                seed=args.seed)
            vit = pd.data_iterator(val_dataset, vsampler, args.batch_size,
                                   epoch, seed=args.seed,
                                   num_workers=args.num_workers)
            vsteps = (args.max_steps_per_epoch
                      if args.max_steps_per_epoch > 0 else None)
            for batch in itertools.islice(vit, vsteps):
                m = eval_step(model, put_batch(batch))
                vlogger.update(loss=float(m["loss"]))
            vit.close()
            vlogger.synchronize_between_processes()
            stats.update({f"val_{k}": v for k, v in
                          vlogger.summary().items()})

        stats.update({"epoch": epoch,
                      "epoch_time_s": round(time.time() - t_epoch, 1)})
        print(stats, flush=True)
        if master:  # main_train.py:379 master-only log
            append_log_line(args.output_dir, stats)
        if (epoch + 1) % args.save_freq == 0 or epoch + 1 == args.epochs:
            ckpt_lib.save_state(ckpt_dir, optimizer.count, epoch, model,
                                optimizer, generator)
    if scalar_writer is not None:
        scalar_writer.close()
    return {"model": model, "optimizer": optimizer, "step": optimizer.count}


if __name__ == "__main__":
    main(get_args_parser().parse_args())
