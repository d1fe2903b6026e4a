"""Per-task evaluation drivers — paint, decode and score as one CLI
(PyTorch port of the JAX package's ``evals/run_eval.py``).

Mirrors the reference's two-phase shape: phase 1 paints predictions for a
validation set with a fixed prompt pair (``eval/*/painter_inference_*.py``),
phase 2 decodes painted PNGs into task outputs and computes metrics
(``eval/*/*EvaluatorCustom.py``, ``eval_with_pngs.py``). Both phases live
in one driver; the val file list is sharded by ``--num_shards/--shard``
instead of torch DistributedSampler (``ddp_utils.py:84-108``). The model
and the palette decode run on ``--device`` (default ``cuda``).

Usage:
  python -m painter_tpu_torch.evals.run_eval --task ade20k_semseg \
      --ckpt_path painter_vit_large.pth --image_dir .../validation \
      --gt_dir .../annotations --prompt_image p.jpg --prompt_target t.png \
      --output_dir out/ [--batch_size 8] [--quant int8-fused]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

from painter_tpu_torch.infer.engine import QUANT_MODES

PAINTER_MODEL = "painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1"
SEGGPT_MODEL = "seggpt_vit_large_patch16_input896x448"


def get_args_parser():
    p = argparse.ArgumentParser("painter eval (PyTorch)", add_help=False)
    p.add_argument("--task", required=True,
                   choices=["ade20k_semseg", "coco_semseg", "coco_inst",
                            "depth", "derain", "sidd", "lol",
                            "seggpt_semseg", "pose"])
    p.add_argument("--ckpt_path", default=None,
                   help="reference torch .pth (default: random weights "
                        "from seed 0)")
    p.add_argument("--model", default=None,
                   help="preset name; default picked per task")
    p.add_argument("--image_dir", default=None)
    p.add_argument("--image_ext", default="*.jpg")
    p.add_argument("--gt_dir", default=None,
                   help="labels (semseg) / depth pngs / clean images")
    p.add_argument("--sidd_mat", default=None,
                   help="ValidationNoisyBlocksSrgb.mat (40x32x256x256x3); "
                        "replaces --image_dir for the real SIDD protocol")
    p.add_argument("--sidd_gt_mat", default=None,
                   help="ValidationGtBlocksSrgb.mat for PSNR/SSIM")
    p.add_argument("--derain_root", default=None,
                   help="derain test root containing "
                        "{Rain100L,Rain100H,Test100,Test1200,Test2800}/"
                        "{input,target}; replaces --image_dir and runs "
                        "the 5-dataset sweep with an aggregate")
    p.add_argument("--gt_ext", default="*.png")
    p.add_argument("--prompt_image", required=True)
    p.add_argument("--prompt_target", required=True)
    p.add_argument("--input_size", type=int, default=448)
    p.add_argument("--output_dir", default="./eval_out")
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--dist_type", default="abs")
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=1,
                   help="queries per device batch in phase 1. 1 runs the "
                        "reference's per-image loop; >1 the batched path "
                        "with one shared prompt")
    p.add_argument("--n_dp", type=int, default=1,
                   help=">1: split each query batch over that many local "
                        "devices, one model replica each (cuda:0.."
                        "n_dp-1; replicas on the host under --device "
                        "cpu); combine with --num_shards across hosts")
    p.add_argument("--quant", default="none", choices=list(QUANT_MODES),
                   help="int8: w8a8 quantized MLP gemms (ops/quant.py); "
                        "int8-fused also runs each MLP through the fused "
                        "int8 kernel (kernels/int8_mlp.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device ('cpu' runs on the host)")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--decode_only", action="store_true",
                   help="phase 2 only: score existing painted PNGs in "
                        "--output_dir (the reference's separate decode "
                        "process, e.g. after multi-shard painting)")
    return p


TASK_TO_ENGINE_SPEC = {
    "ade20k_semseg": "ade20k_semseg",
    "coco_semseg": "coco_semseg",
    "coco_inst": "coco_inst",     # paint @560, decode via run_panoptic
    "seggpt_semseg": "seggpt",
    "depth": "depth",
    "derain": "restoration",
    "sidd": "restoration",
    "lol": "restoration",
    "pose": "pose",               # paints 256x192 crops; AP via run_pose
}


def build_model(args, device=None):
    """The task's preset at ``--input_size`` in bf16 on ``device``
    (default ``args.device``, else ``cuda``; raises without a card unless
    the device is the CPU): random weights from a generator seeded 0, the
    ``--ckpt_path`` .pth loaded over them when given, served at
    ``--quant``; ``--n_dp`` > 1 serves the batched paths data-parallel
    over the first ``n_dp`` local cards (replicas on the host under
    ``--device cpu``), and raises ``SystemExit`` when there are fewer."""
    import torch
    from painter_tpu_torch import configs
    from painter_tpu_torch.device import resolve_device
    from painter_tpu_torch.infer.engine import InContextModel
    from painter_tpu_torch.models import incontext_vit as model_lib
    from painter_tpu_torch.train.checkpoint import load_torch_params

    dev = resolve_device(device or getattr(args, "device", None))
    n_dp = getattr(args, "n_dp", 1)
    mesh = None
    if n_dp > 1 and dev.type == "cuda":
        if torch.cuda.device_count() < n_dp:
            raise SystemExit(f"--n_dp {n_dp} > {torch.cuda.device_count()} "
                             "local devices")
        mesh = [torch.device("cuda", i) for i in range(n_dp)]
    elif n_dp > 1:
        mesh = [dev] * n_dp
    model_name = args.model or (
        SEGGPT_MODEL if args.task.startswith("seggpt") else PAINTER_MODEL)
    cfg = configs.get_config(
        model_name, img_size=(2 * args.input_size, args.input_size),
        dtype="bfloat16")
    model = model_lib.build_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if args.ckpt_path:
        load_torch_params(args.ckpt_path, model)
    return InContextModel(cfg, model, device=dev,
                          quant=getattr(args, "quant", "none"), mesh=mesh)


def _load_depth_target(path: str, res: int):
    """NYUv2 depth png -> [0,1] RGB at res^2, matching the reference's
    load order exactly (painter_inference_depth.py:140-145): /10000*255
    float -> PIL 'F' -> convert RGB (clamps+casts) -> default resize."""
    import numpy as np
    from PIL import Image
    tgt = np.array(Image.open(path)) / 10000.0 * 255
    tgt = Image.fromarray(tgt).convert("RGB").resize((res, res))
    return np.array(tgt) / 255.0


def paint_predictions(args, model) -> list:
    """Phase 1: fixed-prompt painting of the sharded val list."""
    import numpy as np
    from PIL import Image
    from painter_tpu_torch.infer.engine import (TASK_SPECS, _load_rgb,
                                                build_prompt_batch,
                                                scale_and_resize)
    from painter_tpu_torch.ops.resample import np_resize2d

    res = args.input_size
    spec = TASK_SPECS[TASK_TO_ENGINE_SPEC[args.task]]
    files = sorted(glob.glob(os.path.join(args.image_dir, args.image_ext)))
    files = files[args.shard::args.num_shards]
    if args.max_images > 0:
        files = files[:args.max_images]
    os.makedirs(args.output_dir, exist_ok=True)

    # Painter protocol resizes the prompt target with PIL default
    # (bicubic); SegGPT uses NEAREST (painter_inference_segm.py:138-141
    # vs seggpt_engine.py:70-72)
    nearest_tgt = args.task.startswith("seggpt")
    img2 = _load_rgb(args.prompt_image, res)
    if args.task == "depth":
        # the depth prompt target is a raw NYUv2 sync_depth uint16 png
        # mapped /10000*255 BEFORE RGB conversion
        # (painter_inference_depth.py:140-145); plain convert('RGB')
        # would saturate uint16 values to ~255
        tgt2 = _load_depth_target(args.prompt_target, res)
    else:
        tgt2 = _load_rgb(args.prompt_target, res, nearest=nearest_tgt)

    # uint8 output fetch is protocol-exact only when the host-side
    # post-processing is a nearest resize of the x255-clipped image
    # (nearest-gather commutes with the per-pixel uint8 cast); bilinear
    # (ade20k/coco semseg, depth) and bicubic (restoration) tasks must
    # resize in float, so they keep the fp32 fetch
    u8_out = (spec.out_scale == 255.0 and spec.resize_mode == "nearest"
              and spec.clip == (0.0, 255.0) and not spec.channel_mean)
    outputs = []
    bs = max(1, args.batch_size)
    for i0 in range(0, len(files), bs):
        chunk = files[i0:i0 + bs]
        queries, sizes = [], []
        for path in chunk:
            image = Image.open(path).convert("RGB")
            sizes.append(image.size)
            # raw uint8; the batched path does /255 on the device
            # (bit-exact, ops/image.from_uint8), the per-image path here
            queries.append(np.array(image.resize((res, res))))
        if bs == 1 and model.mesh is None:
            # --batch_size 1 = the reference's per-image mode
            imgs, tgts = build_prompt_batch(queries[0] / 255.0,
                                            [(img2, tgt2)])
            outs = model.run_one_image(imgs, tgts)[None]
        else:
            # batched independent queries sharing the prompt; the tail
            # chunk is padded so every batch has one shape
            real = len(queries)
            while len(queries) < bs:
                queries.append(queries[0])
            outs = model.run_queries_shared(
                np.stack(queries), img2, tgt2, real_count=real,
                out_dtype=np.uint8 if u8_out else np.float32)
        for path, size, out in zip(chunk, sizes, outs):
            if u8_out and out.dtype == np.uint8:
                # already x255-clipped on the device; nearest resize is a
                # pure gather, so going through float32 and back is
                # exact (integral values round-trip)
                out = np_resize2d(out.astype(np.float32),
                                  (size[1], size[0]), "nearest")
            else:
                out = scale_and_resize(out, size, spec)
            base = os.path.splitext(os.path.basename(path))[0] + ".png"
            out_path = os.path.join(args.output_dir, base)
            if args.task == "depth":
                # x1000 mm uint16 png (painter_inference_depth.py:69-74
                # via x10000 scale then /1000 at eval -> store int)
                Image.fromarray(out.astype(np.int32),
                                mode="I").save(out_path)
            elif spec.out_scale == 1.0:
                Image.fromarray(
                    (np.clip(out, 0, 1) * 255).astype(
                        np.uint8)).save(out_path)
                if args.task == "sidd":
                    # reference also emits Idenoised .mat blocks
                    # (painter_inference_sidd.py:169)
                    from scipy.io import savemat
                    savemat(out_path.replace(".png", ".mat"),
                            {"Idenoised_crop": np.clip(out, 0, 1)})
            else:
                Image.fromarray(out.astype(np.uint8)).save(out_path)
            outputs.append((path, out_path))
    return outputs


DERAIN_DATASETS = ("Rain100L", "Rain100H", "Test100", "Test1200",
                   "Test2800")


def run_sidd_mat(args, model) -> Optional[dict]:
    """The real SIDD protocol (painter_inference_sidd.py:112-169):

    paint every 256^2 block of ValidationNoisyBlocksSrgb.mat (queries
    resized 256->448 with cv2 bilinear on [0,1] floats), clip to [0,1],
    emit Idenoised.mat; PSNR/SSIM against the GT blocks .mat when given
    (the reference defers metrics to unshipped MATLAB scripts)."""
    import cv2
    import numpy as np
    from scipy.io import loadmat, savemat
    from painter_tpu_torch.evals.restoration import RestorationEvaluator
    from painter_tpu_torch.infer.engine import (TASK_SPECS, _load_rgb,
                                                scale_and_resize)

    res = args.input_size
    noisy = np.float32(loadmat(args.sidd_mat)["ValidationNoisyBlocksSrgb"])
    noisy /= 255.0
    n_img, n_blk = noisy.shape[:2]
    img2 = _load_rgb(args.prompt_image, res)
    tgt2 = _load_rgb(args.prompt_target, res)
    os.makedirs(args.output_dir, exist_ok=True)

    bs = max(1, args.batch_size)
    restored = np.zeros_like(noisy)
    flat = [(i, j) for i in range(n_img) for j in range(n_blk)]
    for k0 in range(0, len(flat), bs):
        chunk = flat[k0:k0 + bs]
        queries = [cv2.resize(noisy[i, j], (res, res)) for i, j in chunk]
        real = len(queries)
        while len(queries) < bs:
            queries.append(queries[0])
        outs = model.run_queries_shared(
            np.stack(queries).astype(np.float32), img2, tgt2,
            real_count=real)
        for (i, j), out in zip(chunk, outs):
            out = scale_and_resize(out, noisy[i, j].shape[1::-1],
                                   TASK_SPECS["restoration"])
            restored[i, j] = np.clip(out, 0, 1)
    savemat(os.path.join(args.output_dir, "Idenoised.mat"),
            {"Idenoised": restored})
    print(f"Idenoised.mat written ({n_img}x{n_blk} blocks)")
    if not args.sidd_gt_mat:
        return None
    gt = np.float32(loadmat(args.sidd_gt_mat)["ValidationGtBlocksSrgb"])
    gt /= 255.0
    ev = RestorationEvaluator(data_range=1.0)
    for i in range(n_img):
        for j in range(n_blk):
            ev.process(restored[i, j].astype(np.float64),
                       gt[i, j].astype(np.float64))
    return ev.evaluate()


def run_derain_sweep(args, model) -> dict:
    """5-dataset derain sweep + aggregate PSNR/SSIM

    (painter_inference_derain.py:120-130; the published 29.42/0.867 is
    the aggregate over all five test sets)."""
    import numpy as np
    from PIL import Image
    from painter_tpu_torch.evals.restoration import RestorationEvaluator

    agg = RestorationEvaluator(data_range=1.0)
    results = {}
    n_total = 0
    for dset in DERAIN_DATASETS:
        src = os.path.join(args.derain_root, dset, "input")
        if not os.path.isdir(src):
            print(f"[derain] {dset}: missing, skipped")
            continue
        sub = argparse.Namespace(**vars(args))
        sub.image_dir = src
        sub.gt_dir = os.path.join(args.derain_root, dset, "target")
        sub.output_dir = os.path.join(args.output_dir, dset)
        outputs = []
        for ext in ("*.png", "*.jpg"):
            sub.image_ext = ext
            outputs += paint_predictions(sub, model)
        ev = RestorationEvaluator(data_range=1.0)
        for img_path, pred_path in outputs:
            base = os.path.splitext(os.path.basename(img_path))[0]
            cands = glob.glob(os.path.join(sub.gt_dir, base + ".*"))
            if not cands:
                print(f"[derain] {dset}: no GT for {base}, skipped")
                continue
            pred = np.asarray(Image.open(pred_path), np.float64) / 255.0
            gt = np.asarray(Image.open(cands[0]).convert("RGB"),
                            np.float64) / 255.0
            ev.process(pred, gt)
            agg.process(pred, gt)
        results[dset] = ev.evaluate()
        n_total += len(outputs)
    results["aggregate"] = agg.evaluate()
    results["num_images"] = n_total
    return results


def compute_metrics(args, outputs) -> Optional[dict]:
    """Phase 2: decode + metric (the palette decode on ``--device``)."""
    import numpy as np
    from PIL import Image

    if args.gt_dir is None:
        return None

    def gt_for(img_path):
        base = os.path.splitext(os.path.basename(img_path))[0]
        cands = glob.glob(os.path.join(args.gt_dir, base + ".*"))
        if not cands:
            # surface dataset-layout mismatches instead of silently
            # shrinking the eval set
            print(f"[warn] no GT matching {base}.* in {args.gt_dir}")
        return cands[0] if cands else None

    if args.task in ("ade20k_semseg", "coco_semseg"):
        from painter_tpu_torch.evals.semseg import SemSegEvaluator
        from painter_tpu_torch.ops.palette import (ade20k_palette,
                                                   coco_semseg_palette)
        pal = (ade20k_palette() if args.task == "ade20k_semseg"
               else coco_semseg_palette())
        ev = SemSegEvaluator(len(pal), pal, dist_type=args.dist_type,
                             device=args.device)
        for img_path, pred_path in outputs:
            gt_path = gt_for(img_path)
            if gt_path is None:
                continue
            gt = np.asarray(Image.open(gt_path), np.int64)
            if args.task == "ade20k_semseg":
                gt = np.where(gt == 0, 255, gt - 1)  # 1-based + ignore
            pred = np.asarray(Image.open(pred_path), np.float32)
            ev.process(pred, gt)
        return ev.evaluate()

    if args.task == "depth":
        from painter_tpu_torch.evals.depth import DepthEvaluator
        ev = DepthEvaluator(min_depth=1e-3, max_depth=10.0,
                            eigen_crop=True)
        for img_path, pred_path in outputs:
            gt_path = gt_for(img_path)
            if gt_path is None:
                continue
            pred = np.asarray(Image.open(pred_path)).astype(np.float64) \
                / 1000.0
            gt = np.asarray(Image.open(gt_path)).astype(np.float64) \
                / 1000.0
            ev.process(pred, gt)
        return ev.evaluate()

    if args.task in ("derain", "sidd", "lol"):
        from painter_tpu_torch.evals.restoration import RestorationEvaluator
        ev = RestorationEvaluator(data_range=1.0)
        for img_path, pred_path in outputs:
            gt_path = gt_for(img_path)
            if gt_path is None:
                continue
            pred = np.asarray(Image.open(pred_path), np.float64) / 255.0
            gt = np.asarray(Image.open(gt_path).convert("RGB"),
                            np.float64) / 255.0
            ev.process(pred, gt)
        return ev.evaluate()
    return None


def recover_outputs(args) -> list:
    """Pair existing painted PNGs in output_dir with their source images."""
    outputs = []
    for pred_path in sorted(glob.glob(os.path.join(args.output_dir,
                                                   "*.png"))):
        base = os.path.splitext(os.path.basename(pred_path))[0]
        cands = glob.glob(os.path.join(args.image_dir, base + ".*"))
        if cands:
            outputs.append((cands[0], pred_path))
    return outputs


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    if args.decode_only:
        outputs = recover_outputs(args)
        print(f"decoding {len(outputs)} existing predictions")
        metrics = compute_metrics(args, outputs)
        if metrics is not None:
            print(json.dumps({"task": args.task, **metrics}))
        return
    model = build_model(args)
    if args.task == "sidd" and args.sidd_mat:
        metrics = run_sidd_mat(args, model)
        if metrics is not None:
            print(json.dumps({"task": "sidd", **metrics}))
        return
    if args.task == "derain" and args.derain_root:
        results = run_derain_sweep(args, model)
        print(json.dumps({"task": "derain_sweep", **results}))
        with open(os.path.join(args.output_dir, "metrics.json"),
                  "w") as f:
            json.dump(results, f)
        return
    if not args.image_dir:
        raise SystemExit("--image_dir required (or --sidd_mat/--derain_root "
                         "for those protocols)")
    print(f"model ready; painting shard {args.shard}/{args.num_shards}")
    outputs = paint_predictions(args, model)
    print(f"painted {len(outputs)} predictions -> {args.output_dir}")
    if not args.skip_metrics:
        metrics = compute_metrics(args, outputs)
        if metrics is not None:
            print(json.dumps({"task": args.task, **metrics}))
            with open(os.path.join(args.output_dir, "metrics.json"),
                      "w") as f:
                json.dump(metrics, f)


if __name__ == "__main__":
    main()
