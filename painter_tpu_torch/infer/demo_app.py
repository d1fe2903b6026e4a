"""Interactive demo and HTTP endpoint, PyTorch port: the counterpart of
the JAX package's ``infer/demo_app.py`` (the reference's
``SegGPT/app_gradio.py``, which POSTs to an endpoint it does not ship).

    python -m painter_tpu_torch.infer.demo_app serve --port 8080
        # POST /paint {image: b64 png, prompt_image: b64, prompt_target:
        #              b64} -> {output: b64 png}
        # POST /paint_video {frames: [b64 png, ...], prompt_target: b64,
        #              prompt_image?: b64, num_frames?: int}
        #              -> {frames: [b64 png, ...]}   (rolling prompt
        #              cache; without prompt_image the first frame is
        #              the prompt)
        # POST /paint_point {image, prompt_image: b64, points: [[x, y]],
        #              labels: [int]} -> {output, prompt_target} (501
        #              without a registered point segmenter)
    python -m painter_tpu_torch.infer.demo_app ui    # gradio, if installed

Serving is threaded with micro-batching: concurrent /paint requests (each
its own prompt) become one ``InContextModel.run_queries`` batch, padded to
a power-of-two bucket. ``--max_batch 1`` serves one request at a time.
``--device`` picks the torch device (default ``cuda``).
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import os
import queue
import threading


def _decode_b64_image(data: str):
    import numpy as np
    from PIL import Image
    return np.array(Image.open(io.BytesIO(base64.b64decode(data)))
                    .convert("RGB"))


def _encode_b64_image(arr) -> str:
    import numpy as np
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr, np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _build_model(args):
    from painter_tpu_torch.infer.seggpt_cli import prepare_model
    return prepare_model(args.ckpt_path, args.model, args.seg_type,
                         quant=getattr(args, "quant", "none"),
                         device=getattr(args, "device", None))


def _prep_query(model, image, prompt_image, prompt_target):
    """Request images -> one normalized stitched (2R, R, 3) pair."""
    import numpy as np
    from PIL import Image
    from painter_tpu_torch.infer.engine import _np_normalize
    res = model.cfg.img_size[1]
    query = np.array(Image.fromarray(image).resize((res, res))) / 255.0
    p_img = np.array(Image.fromarray(prompt_image).resize((res, res))) \
        / 255.0
    p_tgt = np.array(Image.fromarray(prompt_target).resize(
        (res, res), Image.NEAREST)) / 255.0
    img = _np_normalize(np.concatenate([p_img, query], axis=0))
    tgt = _np_normalize(np.concatenate([p_tgt, p_tgt], axis=0))
    return img, tgt


def _finish_output(image, out):
    import numpy as np
    from painter_tpu_torch.infer.engine import (TASK_SPECS, _composite,
                                                scale_and_resize)
    size = (image.shape[1], image.shape[0])
    out = scale_and_resize(np.asarray(out), size, TASK_SPECS["seggpt"])
    return _composite(image, out)


def _run(model, image, prompt_image, prompt_target):
    """Single-request path (the max_batch=1 behavior)."""
    import numpy as np
    img, tgt = _prep_query(model, image, prompt_image, prompt_target)
    out = model.run_queries(np.stack([img]), np.stack([tgt]),
                            real_count=1)[0]
    return _finish_output(image, out)


class MicroBatcher:
    """Coalesce concurrent requests into one device batch.

    Each request is its own (prompt, query) pair; ``run_queries``
    evaluates them independently, so mixed prompts batch freely. The
    worker thread takes whatever is queued (up to ``max_batch``) the
    moment the device is free, pads the batch to a power-of-two bucket by
    repeating its first sample, and fans the results (or the error) back
    to every caller.
    """

    def __init__(self, model, max_batch: int = 8):
        self.model = model
        self.max_batch = max(1, max_batch)
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 60.0):
        """Stop the worker thread once the queued requests are served."""
        self._q.put(None)
        self._thread.join(timeout)

    def submit(self, image, prompt_image, prompt_target):
        img, tgt = _prep_query(self.model, image, prompt_image,
                               prompt_target)
        done = threading.Event()
        slot = {}
        self._q.put((img, tgt, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return _finish_output(image, slot["out"])

    def _loop(self):
        import numpy as np
        from painter_tpu_torch.infer.engine import _prompt_bucket
        while True:
            first = self._q.get()
            if first is None:  # close()
                return
            batch = [first]
            while len(batch) < self.max_batch:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is None:  # serve this batch, then stop
                    self._q.put(None)
                    break
                batch.append(item)
            imgs = [b[0] for b in batch]
            tgts = [b[1] for b in batch]
            nb = _prompt_bucket(len(batch))
            imgs += [imgs[0]] * (nb - len(batch))
            tgts += [tgts[0]] * (nb - len(batch))
            try:
                outs = self.model.run_queries(
                    np.stack(imgs), np.stack(tgts), real_count=len(batch))
                for (_, _, done, slot), out in zip(batch, outs):
                    slot["out"] = out
                    done.set()
            except Exception as e:  # noqa: BLE001 — reported to callers
                for _, _, done, slot in batch:
                    slot["error"] = e
                    done.set()


def _run_video(model, req):
    """/paint_video: in-memory frames through the device-cache engine."""
    import numpy as np
    from PIL import Image
    from painter_tpu_torch.infer.engine import run_video_frames_device
    res = model.cfg.img_size[1]
    frames = [_decode_b64_image(f) for f in req["frames"]]
    p_tgt = np.array(Image.fromarray(
        _decode_b64_image(req["prompt_target"])).resize(
            (res, res), Image.NEAREST)) / 255.0
    img2 = None
    if req.get("prompt_image"):
        img2 = np.array(Image.fromarray(
            _decode_b64_image(req["prompt_image"])).resize(
                (res, res))) / 255.0
    num_frames = int(req.get("num_frames", 4))
    outs = run_video_frames_device(model, frames, p_tgt, num_frames,
                                   img2=img2, res=res)
    return [_encode_b64_image(o) for o in outs]


def serve(args, ready_event=None, stop_event=None):
    """Build the model and serve /paint, /paint_video and /paint_point on
    127.0.0.1:``args.port``; ``ready_event`` is set once the socket
    listens. Serves until the process ends, or until ``stop_event`` is
    set: then the socket closes, the batcher's thread ends and the model
    is released."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    model = _build_model(args)
    batcher = MicroBatcher(model, max_batch=args.max_batch)
    # a video request holds the device for many sequential ensemble
    # steps: serialize them against each other (image requests ride the
    # batcher)
    video_lock = threading.Lock()
    print("model ready")

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length))
            if self.path == "/paint":
                out = batcher.submit(
                    _decode_b64_image(req["image"]),
                    _decode_b64_image(req["prompt_image"]),
                    _decode_b64_image(req["prompt_target"]))
                body = json.dumps(
                    {"output": _encode_b64_image(out)}).encode()
            elif self.path == "/paint_video":
                with video_lock:
                    frames = _run_video(model, req)
                body = json.dumps({"frames": frames}).encode()
            elif self.path == "/paint_point":
                # SAM-assisted route (app_gradio.py:151-179): points ->
                # mask via the registered segmenter -> the same pair flow
                if _POINT_SEGMENTER is None:
                    self.send_error(
                        501, "no point segmenter registered (needs "
                             "external SAM weights; see "
                             "register_point_segmenter)")
                    return
                p_img, p_tgt = point_prompt_to_pair(
                    _decode_b64_image(req["prompt_image"]),
                    req["points"], req["labels"])
                out = batcher.submit(
                    _decode_b64_image(req["image"]), p_img, p_tgt)
                body = json.dumps(
                    {"output": _encode_b64_image(out),
                     "prompt_target": _encode_b64_image(p_tgt)}).encode()
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"serving on 127.0.0.1:{args.port} (max_batch {args.max_batch})")
    if stop_event is not None:
        threading.Thread(target=lambda: (stop_event.wait(),
                                         server.shutdown()),
                         daemon=True).start()
    if ready_event is not None:
        ready_event.set()
    try:
        server.serve_forever()
    finally:
        server.server_close()
        batcher.close()


# ---------------------------------------------------------------------------
# SAM-assisted point prompting seam
# ---------------------------------------------------------------------------
# The reference demo runs the user's clicked points through SAM to make
# the prompt mask before SegGPT paints (``SegGPT/app_gradio.py:14-36,
# 151-179``). SAM's weights are external to the repo, so the integration
# point is a registry: anything with the SamPredictor-shaped signature
# below plugs in. Until one is registered, /paint_point answers 501 and
# the drawing-prompt flow (a hand-drawn mask) covers the use.

_POINT_SEGMENTER = None


def register_point_segmenter(fn):
    """Register the point->mask model for SAM-assisted prompting.

    ``fn(image_rgb_uint8 (H, W, 3), point_coords (N, 2) float xy,
    point_labels (N,) int {0,1}) -> mask (H, W) bool-like``: the
    ``SamPredictor.predict`` contract (app_gradio.py:27-36). Pass None
    to unregister."""
    global _POINT_SEGMENTER
    _POINT_SEGMENTER = fn


def load_point_segmenter(spec: str):
    """Load and register a segmenter from a '<module>:<attr>' spec (the
    ``--point_segmenter`` flag): the attr is called with no arguments and
    must return the predict fn, so loading SAM's weights stays inside the
    plugin."""
    import importlib
    mod, _, attr = spec.partition(":")
    factory = getattr(importlib.import_module(mod), attr)
    register_point_segmenter(factory())


def point_prompt_to_pair(image, point_coords, point_labels):
    """(image, clicked points) -> (prompt_image, white-mask target), the
    same pair flow as a hand-drawn mask (app_gradio.py:41-45)."""
    import numpy as np
    if _POINT_SEGMENTER is None:
        raise RuntimeError(
            "no point segmenter registered: SAM-assisted prompting "
            "needs external SAM weights; register one via "
            "register_point_segmenter()/--point_segmenter, or use the "
            "drawing-prompt flow")
    img = np.asarray(image)[..., :3]
    mask = np.asarray(_POINT_SEGMENTER(
        img, np.asarray(point_coords, np.float32),
        np.asarray(point_labels, np.int32)))
    tgt = np.repeat((mask > 0).astype(np.uint8)[..., None] * 255, 3,
                    axis=-1)
    return img, tgt


def _mask_prompt_to_pair(prompt):
    """gradio ImageMask/ImageEditor payload -> (image, white-mask target).

    The reference's drawing-prompt flow (app_gradio.py:41-45): the strokes
    drawn on the prompt image become the white-on-black prompt target.
    Takes the legacy {"image", "mask"} dict and the ImageEditor
    {"background", "layers"} dict.
    """
    import numpy as np
    if "image" in prompt:  # legacy ImageMask
        img = np.asarray(prompt["image"])
        mask = np.asarray(prompt["mask"])
    else:  # ImageEditor
        img = np.asarray(prompt["background"])
        mask = np.zeros(img.shape[:2] + (4,), np.uint8)
        for layer in prompt.get("layers") or []:
            mask = np.maximum(mask, np.asarray(layer))
    if mask.ndim == 3:
        mask = mask[..., -1] if mask.shape[-1] == 4 else mask.mean(-1)
    tgt = np.repeat((mask > 0).astype(np.uint8)[..., None] * 255, 3,
                    axis=-1)
    return img[..., :3], tgt


def ui(args):
    """Tabbed demo (``app_gradio.py:126-198``): drawing-prompt 1-shot,
    video and explicit prompt-pair tabs, served by the local model. The
    reference's SAM tab is left out: it needs external SAM weights."""
    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("gradio is not installed in this image; "
                         "use `serve` for the HTTP endpoint instead")
    model = _build_model(args)

    def infer_pair(image, prompt_image, prompt_target):
        return _run(model, image, prompt_image, prompt_target)

    def infer_mask(prompt, img1, img2):
        p_img, p_tgt = _mask_prompt_to_pair(prompt)
        return [None if im is None else _run(model, im, p_img, p_tgt)
                for im in (img1, img2)]

    def infer_video(prompt, vid_path, num_frames=4, max_frames=16):
        import tempfile

        import cv2
        import numpy as np
        from PIL import Image
        from painter_tpu_torch.infer.engine import run_video_frames_device
        p_img, p_tgt = _mask_prompt_to_pair(prompt)
        res = model.cfg.img_size[1]
        img2 = np.array(Image.fromarray(p_img).resize((res, res))) / 255.0
        tgt2 = np.array(Image.fromarray(p_tgt).resize(
            (res, res), Image.NEAREST)) / 255.0
        cap = cv2.VideoCapture(vid_path)
        fps = cap.get(cv2.CAP_PROP_FPS) or 24

        def frames():
            # the reference demo caps the video tab at 16 frames
            for _ in range(max_frames):
                ret, frame = cap.read()
                if not ret:
                    return
                yield np.ascontiguousarray(frame[:, :, ::-1])

        fd, out_path = tempfile.mkstemp(suffix=".mp4")
        os.close(fd)
        writer = None
        try:
            for comp in run_video_frames_device(model, frames(), tgt2,
                                                num_frames, img2=img2,
                                                res=res):
                if writer is None:
                    writer = cv2.VideoWriter(
                        out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                        (comp.shape[1], comp.shape[0]), True)
                writer.write(np.ascontiguousarray(comp[:, :, ::-1]))
        finally:
            if writer is not None:
                writer.release()
            cap.release()
        return out_path

    mask_input = (gr.ImageMask if hasattr(gr, "ImageMask")
                  else gr.ImageEditor)
    tab_oneshot = gr.Interface(
        fn=infer_mask,
        inputs=[mask_input(label="prompt (draw the mask)"),
                gr.Image(label="img1"), gr.Image(label="img2")],
        outputs=[gr.Image(label="output1"), gr.Image(label="output2")],
        allow_flagging="never")
    tab_video = gr.Interface(
        fn=infer_video,
        inputs=[mask_input(label="prompt (draw the mask)"),
                gr.Video(label="video")],
        outputs=gr.Video(label="output"))
    tab_pair = gr.Interface(
        fn=infer_pair,
        inputs=[gr.Image(label="query"), gr.Image(label="prompt image"),
                gr.Image(label="prompt target")],
        outputs=gr.Image(label="output"))
    demo = gr.TabbedInterface(
        [tab_oneshot, tab_video, tab_pair],
        ["General 1-shot", "Anything in a Video", "Prompt pair"],
        title="SegGPT (PyTorch): segment everything in context")
    demo.launch(server_port=args.port)


def get_args_parser():
    p = argparse.ArgumentParser("painter-tpu-torch demo")
    p.add_argument("mode", choices=["serve", "ui"])
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--model",
                   default="seggpt_vit_large_patch16_input896x448")
    p.add_argument("--seg_type", default="semantic")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max_batch", type=int, default=8,
                   help="micro-batch cap for concurrent /paint requests "
                        "(1 = strict serial)")
    p.add_argument("--quant", default="none",
                   choices=["none", "int8", "int8-fused"],
                   help="int8: w8a8 quantized MLP gemms; int8-fused adds "
                        "the fused int8 MLP kernel")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on ('cpu' runs on the host)")
    p.add_argument("--point_segmenter", default=None,
                   help="'<module>:<factory>' plugin for SAM-assisted "
                        "point prompting (/paint_point): the factory "
                        "returns a SamPredictor-shaped predict fn")
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    if args.point_segmenter:
        load_point_segmenter(args.point_segmenter)
    (serve if args.mode == "serve" else ui)(args)


if __name__ == "__main__":
    main()
