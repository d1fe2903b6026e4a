"""SegGPT inference CLI, PyTorch port: mirrors
``SegGPT_inference/seggpt_inference.py`` and the JAX package's
``infer/seggpt_cli.py``.

Usage:
    python -m painter_tpu_torch.infer.seggpt_cli \
        --ckpt_path seggpt_vit_large.pth --input_image img.jpg \
        --prompt_image p.jpg --prompt_target t.png --output_dir out/ \
        [--seg_type instance] [--num_frames 4] [--quant int8-fused] \
        [--device cuda]

Image mode writes ``output_<stem>.png``; video mode (``--input_video``,
needs cv2) writes ``output_<stem>.mp4``.
"""
import argparse
import os

from painter_tpu_torch.infer.engine import QUANT_MODES


def get_args_parser():
    parser = argparse.ArgumentParser("SegGPT inference (PyTorch)",
                                     add_help=False)
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="path to a reference torch .pth (default: "
                             "random weights from seed 0)")
    parser.add_argument("--model", type=str,
                        default="seggpt_vit_large_patch16_input896x448")
    parser.add_argument("--input_image", type=str, default=None)
    parser.add_argument("--input_video", type=str, default=None)
    parser.add_argument("--num_frames", type=int, default=0)
    parser.add_argument("--prompt_image", type=str, nargs="+", default=None)
    parser.add_argument("--prompt_target", type=str, nargs="+", default=None)
    parser.add_argument("--seg_type", type=str, default="instance",
                        choices=["instance", "semantic"])
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to serve on ('cpu' runs on the "
                             "host)")
    parser.add_argument("--output_dir", type=str, default="./")
    parser.add_argument("--quant", type=str, default="none",
                        choices=list(QUANT_MODES),
                        help="int8: w8a8 quantized MLP gemms "
                             "(ops/quant.py); int8-fused additionally runs "
                             "each MLP through the fused int8 kernel "
                             "(kernels/int8_mlp.py)")
    return parser


def prepare_model(ckpt_path, model_name, seg_type, quant="none",
                  device=None):
    """The serving engine: ``model_name`` in bf16 with random weights from
    a generator seeded 0, a reference ``.pth`` loaded over them when
    given, served at ``quant`` on ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``)."""
    import torch
    from painter_tpu_torch import configs
    from painter_tpu_torch.device import resolve_device
    from painter_tpu_torch.infer.engine import InContextModel
    from painter_tpu_torch.models import incontext_vit as model_lib
    from painter_tpu_torch.train.checkpoint import load_torch_params

    dev = resolve_device(device)
    cfg = configs.get_config(model_name, dtype="bfloat16")
    model = model_lib.build_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if ckpt_path:
        load_torch_params(ckpt_path, model)
    return InContextModel(cfg, model, seg_type=seg_type, device=dev,
                          quant=quant)


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    from painter_tpu_torch.infer.engine import (inference_image,
                                                inference_video)

    if not (args.input_image or args.input_video):
        raise SystemExit("give --input_image or --input_video")
    if not args.prompt_target:
        raise SystemExit("give --prompt_target")
    model = prepare_model(args.ckpt_path, args.model, args.seg_type,
                          quant=args.quant, device=args.device)
    print("Model loaded.")
    os.makedirs(args.output_dir, exist_ok=True)
    res = model.cfg.img_size[1]

    if args.input_image is not None:
        if not args.prompt_image:
            raise SystemExit("image mode needs --prompt_image")
        out_path = os.path.join(
            args.output_dir,
            "output_" + os.path.basename(args.input_image).split(".")[0]
            + ".png")
        inference_image(model, args.input_image, args.prompt_image,
                        args.prompt_target, out_path, res=res)
    else:
        if len(args.prompt_target) != 1:
            raise SystemExit("video mode takes one --prompt_target")
        out_path = os.path.join(
            args.output_dir,
            "output_" + os.path.basename(args.input_video).split(".")[0]
            + ".mp4")
        inference_video(model, args.input_video, args.num_frames,
                        args.prompt_image, args.prompt_target, out_path,
                        res=res)
    print("Finished.")


if __name__ == "__main__":
    main()
