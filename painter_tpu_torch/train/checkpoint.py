"""Checkpoints of the port's trainer: reference ``.pth`` loading with the
MAE-init surgery, and save / auto-resume of the whole training state.

- ``--finetune`` / ``--resume`` (``main_train.py:199-224``,
  ``util/pos_embed.py:75-96``): a reference-named state dict loads over
  the model; a ``pos_embed`` of another size is bicubic-resized (the cls
  slot kept), and every other entry whose shape differs, or that the model
  lacks, is skipped and reported (``strict=False``), as the JAX package's
  ``load_torch_params`` does.
- Save / auto-resume (``misc.py:296-378``; Orbax in the JAX package):
  ``{model, optimizer, step, epoch, generator}`` as
  ``<output_dir>/checkpoints/checkpoint-<step>.pth``, written to a
  temporary name and renamed, the newest 3 kept. Under
  ``torch.distributed`` every rank gathers the whole optimizer state
  (``LayerDecayAdamW.state_dict``), rank 0 alone writes it, and every rank
  restores it and keeps its own slices, so a checkpoint resumes at any
  world size; a barrier closes both.
- ``export_torch_checkpoint`` (and ``python -m
  painter_tpu_torch.train.checkpoint``): a training checkpoint's model as
  a reference-format ``{"model": state_dict}`` ``.pth``.
"""
from __future__ import annotations

import glob
import os
import re
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from painter_tpu_torch.ops.resample import resize2d

KEEP = 3


def interpolate_pos_embed_table(table: torch.Tensor, target_positions: int,
                                has_cls: bool = True) -> torch.Tensor:
    """Bicubic-resize a square (N, C) pos-embed table to
    ``target_positions`` rows, keeping the cls slot."""
    extra = 1 if has_cls else 0
    grid = table[extra:].float()
    src = int(round(grid.shape[0] ** 0.5))
    dst = int(round((target_positions - extra) ** 0.5))
    if src * src != grid.shape[0] or dst * dst != target_positions - extra:
        raise ValueError(f"pos_embed tables must be square grids: "
                         f"{tuple(table.shape)} -> {target_positions}")
    resized = resize2d(grid.reshape(src, src, -1), (dst, dst), "bicubic",
                       h_axis=0, w_axis=1).reshape(dst * dst, -1)
    return torch.cat([table[:extra].float(), resized]).to(table.dtype)


def load_torch_params(path: str, model: torch.nn.Module,
                      key: str = "model") -> List[Tuple]:
    """Load a reference ``.pth`` over ``model``; returns the skipped
    entries as (name, checkpoint shape, model shape or "absent")."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get(key, ckpt) if isinstance(ckpt, dict) else ckpt
    own = model.state_dict()
    sd = dict(sd)
    pe = sd.get("pos_embed")
    if pe is not None and "pos_embed" in own and \
            pe.shape[-2] != own["pos_embed"].shape[-2]:
        table = interpolate_pos_embed_table(
            pe.reshape(pe.shape[-2], pe.shape[-1]),
            own["pos_embed"].shape[-2], model.cfg.pretrain_use_cls_token)
        sd["pos_embed"] = table[None]
        print(f"[checkpoint] interpolated pos_embed to "
              f"{tuple(sd['pos_embed'].shape)}")
    load, skipped = {}, []
    for k, v in sd.items():
        if k not in own:
            skipped.append((k, tuple(v.shape), "absent"))
        elif tuple(own[k].shape) != tuple(v.shape):
            skipped.append((k, tuple(v.shape), tuple(own[k].shape)))
        else:
            load[k] = v
    model.load_state_dict(load, strict=False)
    for name, got, want in skipped:
        print(f"[checkpoint] skipping {name}: ckpt {got} vs model {want}")
    return skipped


def _steps(directory: str) -> List[int]:
    found = []
    for p in glob.glob(os.path.join(directory, "checkpoint-*.pth")):
        m = re.fullmatch(r"checkpoint-(\d+)\.pth", os.path.basename(p))
        if m:
            found.append(int(m.group(1)))
    return sorted(found)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def save_state(directory: str, step: int, epoch: int, model, optimizer,
               generator: torch.Generator) -> str:
    """Write the training state for ``step``; keep the newest ``KEEP``.
    Under ``torch.distributed`` every rank calls it (the optimizer state
    is gathered) and rank 0 writes."""
    path = os.path.join(directory, f"checkpoint-{step}.pth")
    opt_state = optimizer.state_dict()
    if not _distributed() or dist.get_rank() == 0:
        os.makedirs(directory, exist_ok=True)
        torch.save({"model": model.state_dict(), "optimizer": opt_state,
                    "step": step, "epoch": epoch,
                    "generator": generator.get_state()}, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in _steps(directory)[:-KEEP]:
            os.remove(os.path.join(directory, f"checkpoint-{old}.pth"))
    if _distributed():
        dist.barrier()
    return path


def restore_state(directory: str, model, optimizer,
                  generator: torch.Generator) -> Optional[int]:
    """Load the newest checkpoint into model, optimizer and generator;
    returns its step, or None when there is none (``--auto_resume``)."""
    if _distributed():
        dist.barrier()  # every rank sees the same newest checkpoint
    steps = _steps(directory)
    if not steps:
        return None
    state = torch.load(os.path.join(directory,
                                    f"checkpoint-{steps[-1]}.pth"),
                       map_location="cpu", weights_only=False)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    generator.set_state(state["generator"])
    return int(state["step"])


def export_torch_checkpoint(path: str, out_path: str) -> None:
    """A training checkpoint's model -> a reference-format ``.pth``
    (``{"model": state_dict}``, the reference's parameter names), so
    weights trained here load in the original torch codebase."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    torch.save({"model": state["model"]}, out_path)


def _export_cli(argv=None):
    import argparse
    p = argparse.ArgumentParser("painter_tpu_torch checkpoint export")
    p.add_argument("--ckpt_dir", required=True,
                   help="the trainer's <output_dir>/checkpoints")
    p.add_argument("--step", type=int, default=None,
                   help="default: the newest checkpoint")
    p.add_argument("--out", required=True, help="output .pth path")
    args = p.parse_args(argv)
    steps = _steps(args.ckpt_dir)
    step = args.step if args.step is not None or not steps else steps[-1]
    if step not in steps:
        raise SystemExit(f"no checkpoint {step or ''} in {args.ckpt_dir}")
    export_torch_checkpoint(
        os.path.join(args.ckpt_dir, f"checkpoint-{step}.pth"), args.out)
    print(f"exported step {step} -> {args.out}")


if __name__ == "__main__":
    _export_cli()
