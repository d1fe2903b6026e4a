"""Checkpoint-parity check: the port's fp32 forward against the float64
oracle (``utils/torch_oracle.py``) on one fixed stitched input.

Loads a released checkpoint (``--ckpt_path``, through
``train/checkpoint.py``'s ``load_torch_params``) or keeps the random
weights of ``build_model`` from a CPU generator seeded 0, runs
``models.incontext_vit.forward`` and the oracle on the model's own state
dict, and reports the painted output's and the loss's divergence:

    python -m painter_tpu_torch.utils.parity [--ckpt_path x.pth]
        [--model seggpt_vit_large_patch16_input896x448] [--batch 1]
        [--tolerance 1e-3] [--device cuda] [--attn_impl kernel|plain]

Runs on ``cuda`` unless ``--device cpu``. On the card cuDNN convolutions
and matmuls would take TF32 by default, which alone can put the patch
embed and the decoder's convs over 1e-3: the check turns TF32 off while
it runs and restores both switches after. With ``--attn_impl kernel`` the
fp32 forward runs K1's fp32 route (one launch per block). Prints the
painted-output and loss errors and ``PARITY OK`` or ``PARITY FAILED``;
exits 1 on failure.
"""
from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def no_tf32():
    """fp32 matmuls and cuDNN convolutions in full fp32 inside, the
    switches as they were after."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def main(argv=None):
    p = argparse.ArgumentParser("painter-tpu-torch parity check")
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--model",
                   default="seggpt_vit_large_patch16_input896x448")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--tolerance", type=float, default=1e-3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--attn_impl", default="kernel",
                   choices=["kernel", "plain"])
    args = p.parse_args(argv)

    from painter_tpu_torch import configs
    from painter_tpu_torch.device import resolve_device
    from painter_tpu_torch.models import incontext_vit as tm
    from painter_tpu_torch.ops.patches import unpatchify
    from painter_tpu_torch.train import checkpoint as ckpt_lib
    from painter_tpu_torch.utils.torch_oracle import torch_forward

    dev = resolve_device(args.device)
    cfg = configs.get_config(args.model, dtype="float32")
    model = tm.build_model(cfg, torch.Generator().manual_seed(0), device=dev)
    if args.ckpt_path:
        ckpt_lib.load_torch_params(args.ckpt_path, model)
        print(f"loaded {args.ckpt_path}")

    h, w = cfg.img_size
    length = cfg.num_patches
    rng = np.random.RandomState(2)
    imgs = rng.randn(args.batch, h, w, 3).astype(np.float32)
    tgts = rng.randn(args.batch, h, w, 3).astype(np.float32)
    mask = np.zeros((args.batch, length), np.float32)
    mask[:, length // 2:] = 1.0
    valid = np.ones((args.batch, h, w, 3), np.float32)
    seg_type = (np.zeros((args.batch, 1), np.int32)
                if cfg.seg_type_tokens else None)

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    with no_tf32(), torch.no_grad():
        loss, pred_patches, _ = tm.forward(
            model, on_dev(imgs), on_dev(tgts), on_dev(mask), on_dev(valid),
            seg_type=None if seg_type is None else on_dev(seg_type).long(),
            attn_impl=args.attn_impl)
        pred = unpatchify(pred_patches, cfg.patch_size).cpu().numpy()
        ref_loss, ref_pred = torch_forward(model.state_dict(), cfg, imgs,
                                           tgts, mask, valid,
                                           seg_type=seg_type, device=dev)
    max_err = float(np.abs(pred - ref_pred).max())
    loss_err = abs(float(loss) - ref_loss)
    print(f"painted-output max abs err: {max_err:.3e}")
    print(f"loss abs err:              {loss_err:.3e}")
    ok = max_err < args.tolerance and loss_err < args.tolerance
    print("PARITY OK" if ok else "PARITY FAILED")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
