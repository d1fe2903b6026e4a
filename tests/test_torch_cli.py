"""PyTorch port: the SegGPT CLI (``infer/seggpt_cli.py``) and the HTTP
endpoint (``infer/demo_app.py``) on the CPU, against the JAX package's
CLI on one ``.pth``.

bf16 tolerance: both CLIs serve in bf16 (``dtype="bfloat16"``), each
rounding every activation to 8 mantissa bits (2^-9 relative) in other
places; over the 6 tiny blocks that compounds to a few units of 2^-8 on
the O(1) painted scale, so the painted outputs are held to 4·2^-8 on the
[0,1] scale, and the composite PNG (0.6·255 times the painted value) to 3
uint8 steps.
"""
import base64
import io
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from painter_tpu import configs as jcfg
from painter_tpu.infer import demo_app as jdemo
from painter_tpu.infer import engine as je
from painter_tpu.infer import seggpt_cli as jcli
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.infer import demo_app as tdemo
from painter_tpu_torch.infer import engine as te
from painter_tpu_torch.infer import seggpt_cli as tcli
from painter_tpu_torch.models import convert
from painter_tpu_torch.ops.quant import QuantizedLinear

from torch_port_common import jax_params_np

BF16_ATOL = 4 * 2.0 ** -8
BF16_PNG_STEPS = 3


def _write_img(path, size=(50, 40), seed=0):
    arr = (np.random.RandomState(seed).rand(size[1], size[0], 3) * 255) \
        .astype(np.uint8)
    Image.fromarray(arr).save(path)
    return str(path)


def _pair_files(d, n_prompts):
    q = _write_img(d / "query.png", seed=1)
    prompts = [_write_img(d / f"p{i}.png", seed=2 + i)
               for i in range(n_prompts)]
    targets = [_write_img(d / f"t{i}.png", seed=10 + i)
               for i in range(n_prompts)]
    return q, prompts, targets


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """One reference-named ``.pth`` of random tiny weights."""
    params = jax_params_np(jcfg.get_config("tiny_test"), seed=0)
    sd = convert.state_dict_from_jax_params(params,
                                            tcfg.get_config("tiny_test"))
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pth"
    torch.save({"model": sd}, path)
    return str(path)


@pytest.mark.parametrize("n_prompts", [1, 2])
def test_pth_through_both_clis_matches_jax(pth, tmp_path, n_prompts):
    jax_model = jcli.prepare_model(pth, "tiny_test", "instance")
    port = tcli.prepare_model(pth, "tiny_test", "instance", device="cpu")
    assert port.cfg.dtype == "bfloat16" and port.seg_type == "instance"
    res = port.cfg.img_size[1]
    q, prompts, targets = _pair_files(tmp_path, n_prompts)
    got = te.inference_image(port, q, prompts, targets,
                             str(tmp_path / "port.png"), res=res)
    ref = je.inference_image(jax_model, q, prompts, targets,
                             str(tmp_path / "jax.png"), res=res)
    assert got.shape == (40, 50, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got / 255.0, ref / 255.0, atol=BF16_ATOL)
    diff = np.abs(np.asarray(Image.open(tmp_path / "port.png"), np.int32)
                  - np.asarray(Image.open(tmp_path / "jax.png"), np.int32))
    assert diff.max() <= BF16_PNG_STEPS, diff.max()


def test_main_image_and_video_modes_write_their_files(tmp_path, monkeypatch):
    import cv2
    q, prompts, targets = _pair_files(tmp_path, 2)
    out = tmp_path / "out"
    tcli.main(["--model", "tiny_test", "--device", "cpu", "--input_image", q,
               "--prompt_image", *prompts, "--prompt_target", *targets,
               "--output_dir", str(out)])
    png = Image.open(out / "output_query.png")
    assert png.size == (50, 40) and png.mode == "RGB"

    vid = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 5, (48, 36))
    rng = np.random.RandomState(3)
    for _ in range(3):
        w.write((rng.rand(36, 48, 3) * 255).astype(np.uint8))
    w.release()
    # through sys.argv, as a console run reads it
    monkeypatch.setattr(sys, "argv", [
        "seggpt_cli", "--model", "tiny_test", "--device", "cpu",
        "--input_video", vid, "--num_frames", "2",
        "--prompt_target", targets[0], "--output_dir", str(out)])
    tcli.main()
    cap = cv2.VideoCapture(str(out / "output_clip.mp4"))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    assert n == 2  # the first frame is the prompt
    with pytest.raises(SystemExit):
        tcli.main(["--model", "tiny_test", "--device", "cpu"])


def test_cli_flags_match_jax():
    """The same flags and defaults as the JAX CLI; ``--device`` is
    honoured (default ``cuda``) where the JAX CLI ignores it."""
    mine = {a.dest: a for a in tcli.get_args_parser()._actions}
    theirs = {a.dest: a for a in jcli.get_args_parser()._actions}
    assert mine.keys() == theirs.keys()
    for dest, a in theirs.items():
        if dest != "device":
            assert (mine[dest].default, mine[dest].choices, mine[dest].nargs) \
                == (a.default, a.choices, a.nargs), dest
    assert mine["device"].default == "cuda"


@pytest.mark.parametrize("quant", ["int8", "int8-fused"])
def test_quant_plumbing(tmp_path, quant):
    """--quant flows from the CLI into a quantized engine that serves an
    image end to end (the ensemble path included), as
    ``tests/test_quant.py``'s plumbing test does for the JAX CLI."""
    model = tcli.prepare_model(None, "tiny_test", "semantic", quant=quant,
                               device="cpu")
    fc1 = model.model.blocks[0].mlp.fc1
    assert isinstance(fc1, QuantizedLinear)
    q, prompts, targets = _pair_files(tmp_path, 2)
    out = te.inference_image(model, q, prompts, targets,
                             str(tmp_path / "o.png"),
                             res=model.cfg.img_size[1])
    assert out.shape == (40, 50, 3) and np.isfinite(out).all()


# ---------------------------------------------------------------------------
# the HTTP endpoint
# ---------------------------------------------------------------------------

class _Args:
    ckpt_path = None
    model = "tiny_test"
    seg_type = "semantic"
    port = None
    max_batch = 4
    quant = "none"
    device = "cpu"


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _b64_png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _png(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _post(args, route, req, timeout=120):
    r = urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{args.port}{route}", json.dumps(req).encode(),
        {"Content-Type": "application/json"}), timeout=timeout)
    return json.loads(r.read())


@pytest.fixture(scope="module")
def server(pth):
    """The endpoint in a thread on a free port, serving the shared
    ``.pth``; stopped through its stop event, which must end the serving
    thread. Yields the serve arguments."""
    args = _Args()
    args.ckpt_path, args.port = pth, _free_port()
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=tdemo.serve, args=(args, ready, stop),
                         daemon=True)
    t.start()
    assert ready.wait(120), "the endpoint never came up"
    yield args
    stop.set()
    t.join(60)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def jax_served(pth):
    """The JAX package's serving model on the same ``.pth``."""
    return jcli.prepare_model(pth, "tiny_test", "semantic")


def _assert_png_steps(got, ref, what):
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= BF16_PNG_STEPS, (what, int(diff.max()))


def _mask_png(rng, hw=(20, 24)):
    """A binary prompt target: blocks of 255 on 0, so that a resize of
    the target other than NEAREST would show."""
    block = rng.rand(hw[0] // 4, hw[1] // 4, 1) > 0.5
    return _b64_png((block.repeat(4, 0).repeat(4, 1).repeat(3, 2)
                     * 255).astype(np.uint8))


def _paint_request(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "image": _b64_png((rng.rand(20, 24, 3) * 255).astype(np.uint8)),
        "prompt_image": _b64_png((rng.rand(20, 24, 3) * 255)
                                 .astype(np.uint8)),
        "prompt_target": _mask_png(rng),
    }


def test_request_host_pieces_match_jax(monkeypatch):
    """The endpoint's host pieces bit for bit against the JAX package's
    ``demo_app`` on the same request: ``_prep_query`` (the resizes, the
    NEAREST target, the normalize), ``_finish_output`` (the resize back
    and the composite) and ``_run_video``'s decoding of the frames, the
    prompt image and the prompt target (the video engine itself is
    replaced by a recorder on both sides)."""
    import types
    rng = np.random.RandomState(5)
    req = _paint_request(5)
    decoded = [_png(req[k]) for k in ("image", "prompt_image",
                                      "prompt_target")]
    port_cfg = types.SimpleNamespace(cfg=tcfg.get_config("tiny_test"))
    jax_cfg = types.SimpleNamespace(cfg=jcfg.get_config("tiny_test"))
    for a, b in zip(tdemo._prep_query(port_cfg, *decoded),
                    jdemo._prep_query(jax_cfg, *decoded)):
        np.testing.assert_array_equal(a, b)
    out = rng.rand(32, 32, 3).astype(np.float32)
    np.testing.assert_array_equal(tdemo._finish_output(decoded[0], out),
                                  jdemo._finish_output(decoded[0], out))

    seen = {}

    def recorder(side):
        def run(model, frames, p_tgt, num_frames, img2=None, res=448):
            seen[side] = (frames, p_tgt, num_frames, img2, res)
            return [np.zeros((20, 24, 3), np.uint8)]
        return run

    monkeypatch.setattr(te, "run_video_frames_device", recorder("port"))
    monkeypatch.setattr(je, "run_video_frames_device", recorder("jax"))
    for vreq in ({"frames": [req["image"], req["prompt_image"]],
                  "prompt_target": req["prompt_target"]},
                 {"frames": [req["image"]], "prompt_image":
                  req["prompt_image"], "prompt_target":
                  req["prompt_target"], "num_frames": 2}):
        assert tdemo._run_video(port_cfg, vreq) \
            == jdemo._run_video(jax_cfg, vreq)
        (f_t, tgt_t, n_t, img2_t, res_t), (f_j, tgt_j, n_j, img2_j, res_j) \
            = seen["port"], seen["jax"]
        for a, b in zip(f_t, f_j):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tgt_t, tgt_j)
        assert (n_t, res_t, img2_t is None) == (n_j, res_j, img2_j is None)
        if img2_t is not None:
            np.testing.assert_array_equal(img2_t, img2_j)


def test_paint_single_and_concurrent(server, jax_served):
    """One /paint, then 6 concurrent identical requests (micro-batched,
    padded to bucket 8): all seven answers within one uint8 step of each
    other, the single one within one step of the port's own unbatched
    ``_run``, and every one within BF16_PNG_STEPS of the JAX package's
    ``demo_app._run`` on the same request and ``.pth``."""
    req = _paint_request()
    single = _png(_post(server, "/paint", req)["output"])
    assert single.shape == (20, 24, 3)
    decoded = [_png(req[k]) for k in ("image", "prompt_image",
                                      "prompt_target")]
    direct = tdemo._run(tdemo._build_model(server), *decoded)
    assert np.abs(single.astype(int) - direct.astype(int)).max() <= 1
    ref = jdemo._run(jax_served, *decoded)

    results = [None] * 6

    def one(i):
        try:
            results[i] = _post(server, "/paint", req)["output"]
        except Exception as e:  # noqa: BLE001 — reported below
            results[i] = e

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
        assert not th.is_alive()
    for res in results:
        assert isinstance(res, str), res
    answers = np.stack([single] + [_png(r) for r in results]).astype(int)
    assert (answers.max(0) - answers.min(0)).max() <= 1
    for i, answer in enumerate(answers):
        _assert_png_steps(answer, ref, f"/paint answer {i}")


def test_paint_video(server, jax_served):
    """3 frames, first frame as the prompt -> 2 painted frames, each
    within BF16_PNG_STEPS of the JAX package's ``demo_app._run_video`` on
    the same request and ``.pth``."""
    rng = np.random.RandomState(1)
    vreq = {"frames": [_b64_png((rng.rand(20, 24, 3) * 255)
                                .astype(np.uint8)) for _ in range(3)],
            "prompt_target": _mask_png(rng), "num_frames": 2}
    frames = _post(server, "/paint_video", vreq)["frames"]
    ref = jdemo._run_video(jax_served, vreq)
    assert len(frames) == len(ref) == 2
    for i, (got, want) in enumerate(zip(frames, ref)):
        assert _png(got).shape == (20, 24, 3)
        _assert_png_steps(_png(got), _png(want), f"/paint_video frame {i}")


def test_paint_point_501_then_registered_segmenter(server):
    req = _paint_request(2)
    preq = {"image": req["image"], "prompt_image": req["prompt_image"],
            "points": [[12.0, 10.0]], "labels": [1]}
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server, "/paint_point", preq)
    assert exc.value.code == 501

    def fake_sam(img, coords, labels):
        m = np.zeros(img.shape[:2], bool)
        x, y = int(coords[0][0]), int(coords[0][1])
        m[max(0, y - 4):y + 4, max(0, x - 4):x + 4] = labels[0] > 0
        return m

    tdemo.register_point_segmenter(fake_sam)
    try:
        out = _post(server, "/paint_point", preq)
        assert _png(out["output"]).shape == (20, 24, 3)
        tgt = _png(out["prompt_target"])
        assert set(np.unique(tgt)) <= {0, 255} and tgt.max() == 255
    finally:
        tdemo.register_point_segmenter(None)
    with pytest.raises(RuntimeError, match="no point segmenter"):
        tdemo.point_prompt_to_pair(_png(req["image"]), [[1.0, 1.0]], [1])


def test_mask_prompt_to_pair_matches_jax():
    """Both gradio payload forms: the legacy ImageMask dict and the
    ImageEditor background + layers."""
    rng = np.random.RandomState(4)
    img = (rng.rand(12, 10, 4) * 255).astype(np.uint8)
    mask = (rng.rand(12, 10, 4) > 0.7).astype(np.uint8) * 200
    layers = [(rng.rand(12, 10, 4) > 0.8).astype(np.uint8) * 255
              for _ in range(2)]
    for payload in ({"image": img, "mask": mask},
                    {"image": img, "mask": mask[..., :3]},
                    {"background": img, "layers": layers},
                    {"background": img, "layers": None}):
        got = tdemo._mask_prompt_to_pair(payload)
        ref = jdemo._mask_prompt_to_pair(payload)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert got[0].shape == (12, 10, 3)


def test_ui_without_gradio_exits_with_the_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(SystemExit, match="gradio is not installed"):
        tdemo.ui(_Args())
    args = tdemo.get_args_parser().parse_args(["serve"])
    assert (args.device, args.max_batch, args.port) == ("cuda", 8, 8080)
