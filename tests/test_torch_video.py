"""PyTorch port: the file drivers, both video caches and the attention
route of ``InContextModel`` against the JAX package on the CPU (one set
of weights, the same numpy inputs).

Tolerances: painted [0,1] outputs atol 2e-5 (fp32 through the tiny
model, sums in another order), times the task's scale where the output is
scaled; uint8 composites and PNGs may differ by one step where a value
sits on a quantization boundary, on under 1% of the pixels.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from painter_tpu import configs as jcfg
from painter_tpu.infer import engine as je
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD
from painter_tpu_torch.infer import engine as te

from torch_port_common import jax_params_np, port_model

ATOL = 2e-5


@pytest.fixture(scope="module")
def engines():
    kw = dict(img_size=(64, 32), pretrain_img_size=32, seg_type_tokens=True)
    cfg_j = jcfg.tiny_test_config(**kw)
    cfg_t = tcfg.tiny_test_config(**kw)
    params = jax_params_np(cfg_j, seed=0)
    # lift the painted output to straddle the re-prompt threshold, so the
    # cached masks hold both classes (unlifted, every pixel of this tiny
    # model paints below 128/255)
    conv2 = params["decoder_pred"]["conv2"]
    conv2["bias"] = conv2["bias"] + np.float32(0.2)
    model = port_model(cfg_t, params)
    return (je.InContextModel(cfg_j, params, attn_impl="xla"),
            te.InContextModel(cfg_t, model, device="cpu"))


def _write_img(path, size=(50, 40), seed=0, color=None):
    rng = np.random.RandomState(seed)
    arr = (rng.rand(size[1], size[0], 3) * 255).astype(np.uint8) \
        if color is None else np.full((size[1], size[0], 3), color, np.uint8)
    Image.fromarray(arr).save(path)
    return str(path)


def _assert_steps(a, b, what):
    """uint8 images within one step, on under 1% of the pixels."""
    diff = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, \
        (what, int(diff.max()), float((diff > 0).mean()))


def _frames(n, seed, size=(40, 52)):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*size, 3) * 255).astype(np.uint8) for _ in range(n)]


def _mask_target(res, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(res, res, 1) > 0.5).astype(np.float32).repeat(3, -1)


@pytest.mark.parametrize("n_prompts", [1, 3])
def test_inference_image_matches_jax(engines, tmp_path, n_prompts):
    """1 prompt, and 3 prompts (the 4-bucket ensemble): the x255 output at
    the input's size and the composite PNG."""
    jax_eng, port = engines
    res = port.cfg.img_size[1]
    img = _write_img(tmp_path / "q.png", seed=1)
    prompts = [_write_img(tmp_path / f"p{i}.png", seed=2 + i)
               for i in range(n_prompts)]
    targets = [_write_img(tmp_path / f"t{i}.png", seed=10 + i)
               for i in range(n_prompts)]
    got = te.inference_image(port, img, prompts, targets,
                             str(tmp_path / "port.png"), res=res)
    ref = je.inference_image(jax_eng, img, prompts, targets,
                             str(tmp_path / "jax.png"), res=res)
    assert got.shape == (40, 50, 3)
    np.testing.assert_allclose(got / 255.0, ref / 255.0, atol=ATOL)
    png = np.asarray(Image.open(tmp_path / "port.png"))
    assert png.shape == (40, 50, 3) and png.dtype == np.uint8
    _assert_steps(png, np.asarray(Image.open(tmp_path / "jax.png")), "png")


@pytest.mark.parametrize("task", sorted(set(je.TASK_SPECS) - {"seggpt"}))
def test_painter_task_inference_matches_jax(engines, tmp_path, task):
    """Every Painter task: bicubic prompt target, the task's scale, clip,
    resize and channel mean."""
    jax_eng, port = engines
    res = port.cfg.img_size[1]
    img = _write_img(tmp_path / "q.png", size=(30, 26), seed=1)
    p = _write_img(tmp_path / "p.png", seed=2)
    t = _write_img(tmp_path / "t.png", seed=3)
    got = te.painter_task_inference(port, img, p, t, task, res=res)
    ref = je.painter_task_inference(jax_eng, img, p, t, task, res=res)
    spec = te.TASK_SPECS[task]
    assert got.shape == ((26, 30) if spec.channel_mean else (26, 30, 3))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL * spec.out_scale)


def test_load_rgb_matches_jax(tmp_path):
    path = _write_img(tmp_path / "a.png", size=(37, 29), seed=4)
    for nearest in (False, True):
        np.testing.assert_array_equal(te._load_rgb(path, 16, nearest),
                                      je._load_rgb(path, 16, nearest))


@pytest.mark.parametrize("path", ["host", "device"])
def test_video_frames_match_jax(engines, path):
    """7 frames of 40x52, ``num_frames=2``: the device cache grows 1 -> 2
    -> 4 and wraps (as ``test_infer_engine.py``'s device-vs-host test)."""
    jax_eng, port = engines
    res = port.cfg.img_size[1]
    frames = _frames(7, seed=3)
    tgt2 = _mask_target(res, seed=4)
    run_t = te.run_video_frames if path == "host" \
        else te.run_video_frames_device
    run_j = je.run_video_frames if path == "host" \
        else je.run_video_frames_device
    got = list(run_t(port, frames, tgt2, num_frames=2, res=res))
    ref = list(run_j(jax_eng, frames, tgt2, num_frames=2, res=res))
    assert len(got) == len(ref) == 6
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == (40, 52, 3) and a.dtype == np.uint8
        _assert_steps(a, b, (path, i))


def test_video_device_cache_matches_host_cache(engines):
    """The port's device cache against its host cache, with an img2
    given: every frame painted, and bitwise equal before the wrap (the
    same rows in the same order)."""
    _, port = engines
    res = port.cfg.img_size[1]
    frames = _frames(7, seed=5)
    img2 = np.random.RandomState(6).rand(res, res, 3)
    tgt2 = _mask_target(res, seed=7)
    host = list(te.run_video_frames(port, frames, tgt2, 2, img2=img2,
                                    res=res))
    dev = list(te.run_video_frames_device(port, frames, tgt2, 2, img2=img2,
                                          res=res))
    assert len(host) == len(dev) == 7
    # frames 0-2 see rows in the host's order; frame 3 is the first after
    # the circular insert
    for i in range(3):
        np.testing.assert_array_equal(host[i], dev[i])
    for i, (a, b) in enumerate(zip(host, dev)):
        _assert_steps(a, b, i)


def test_video_engine_state_and_uint8_io_match_jax(engines):
    """``VideoEngine.paint_frame`` with uint8 queries and uint8 outputs
    against the JAX engine; the bucket grows 1 -> 2 -> 4 and the insert
    wraps; uint8 and [0,1] float queries paint the same bits."""
    jax_eng, port = engines
    res = port.cfg.img_size[1]
    rng = np.random.RandomState(8)
    img2 = rng.rand(res, res, 3)
    tgt2 = _mask_target(res, seed=9)
    ve_j = je.VideoEngine(jax_eng, 2, img2, tgt2)
    ve_u8 = te.VideoEngine(port, 2, img2, tgt2)
    ve_f = te.VideoEngine(port, 2, img2, tgt2)
    state = []
    for _ in range(5):
        q = (rng.rand(res, res, 3) * 255).astype(np.uint8)
        got = ve_u8.paint_frame(q, out_dtype=np.uint8)
        ref = ve_j.paint_frame(q, out_dtype=np.uint8)
        assert got.dtype == np.uint8 and got.shape == (res, res, 3)
        _assert_steps(got, ref, "paint_frame")
        out_f = ve_f.paint_frame((q / 255.0).astype(np.float32))
        assert out_f.dtype == np.float32
        np.testing.assert_array_equal(
            got, np.clip(out_f * np.float32(255.0), 0, 255).astype(np.uint8))
        state.append((ve_u8.bucket, ve_u8._n_real, ve_u8._wrap))
    assert state == [(2, 2, 0), (4, 3, 0), (4, 3, 1), (4, 3, 0), (4, 3, 1)]
    masks = ve_u8._tgts_half[1:3].numpy() * np.asarray(IMAGENET_STD) \
        + np.asarray(IMAGENET_MEAN)
    assert 0.05 < masks.mean() < 0.95  # both classes in the cached masks
    for mine, theirs in ((ve_u8._imgs_top, ve_j._imgs_top),
                         (ve_u8._tgts_half, ve_j._tgts_half)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=1e-5)


def test_device_binarize_is_the_host_math_bit_for_bit():
    """``_binarize`` == ``clip(out * 255, 0, 255).mean(-1) > 128`` in
    numpy, on random outputs and on the values around the threshold."""
    rng = np.random.RandomState(10)
    out = rng.rand(64, 64, 3).astype(np.float32) * 1.2 - 0.1
    edge = np.float32(128.0 / 255.0)
    near = np.nextafter(edge, np.float32(1.0), dtype=np.float32)
    out[:8] = np.array([edge, near, 0.5, 0.501], np.float32)[
        rng.randint(0, 4, (8, 64, 3))]
    want = np.clip(out * 255.0, 0, 255).mean(-1) > 128
    np.testing.assert_array_equal(te._binarize(torch.from_numpy(out))
                                  .numpy(), want)


@pytest.mark.parametrize("path", ["host", "device"])
def test_video_binarize_reference_threshold(engines, monkeypatch, path):
    """A painted 0.501 (in (0.5, 128/255]) gives an all-background cached
    mask and 0.503 an all-foreground one, on both caches (mirrors
    ``test_infer_engine.py``'s threshold test)."""
    _, port = engines
    res = port.cfg.img_size[1]
    frames = _frames(4, seed=11)
    tgt2 = _mask_target(res, seed=12)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    for val, expect in ((0.501, 0.0), (0.503, 1.0)):
        painted = np.full((res, res, 3), val, np.float32)
        if path == "host":
            captured = []
            orig = te.build_prompt_batch

            def spy(query, prompts, _c=captured, _orig=orig):
                _c.append([t for _, t in prompts])
                return _orig(query, prompts)

            monkeypatch.setattr(port, "run_one_image",
                                lambda imgs, tgts, _o=painted: _o)
            monkeypatch.setattr(te, "build_prompt_batch", spy)
            list(te.run_video_frames(port, frames, tgt2, 2, res=res))
            cached = captured[-1][1:]
        else:
            normalized = torch.from_numpy((painted - mean) / std)
            monkeypatch.setattr(te.model_lib, "predict_query_half",
                                lambda *a, _o=normalized, **k: _o.clone())
            engine = te.VideoEngine(port, 2, tgt2, tgt2)
            for f in frames[1:]:
                engine.paint_frame(f[:res, :res])
            cached = [t.numpy() * std + mean
                      for t in engine._tgts_half[1:engine._n_real]]
        monkeypatch.undo()
        assert len(cached) == 2
        for t in cached:
            np.testing.assert_allclose(t, expect, atol=1e-6)


@pytest.mark.parametrize("cache_impl", ["device", "host"])
def test_inference_video_matches_jax(engines, tmp_path, cache_impl):
    """A 4-frame mp4 written with cv2, first frame as the prompt: 3
    frames written, decoded back equal to the JAX driver's file."""
    import cv2
    jax_eng, port = engines
    res = port.cfg.img_size[1]
    vid = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 5, (48, 36))
    for f in _frames(4, seed=13, size=(36, 48)):
        w.write(f)
    w.release()
    tgt = _write_img(tmp_path / "t.png", seed=14)
    outs = {}
    for name, eng, drv in (("port", port, te), ("jax", jax_eng, je)):
        path = str(tmp_path / f"{name}.mp4")
        n = drv.inference_video(eng, vid, num_frames=2, img2_paths=None,
                                tgt2_paths=[tgt], out_path=path, res=res,
                                cache_impl=cache_impl)
        assert n == 3 and os.path.exists(path)
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
        outs[name] = frames
    assert len(outs["port"]) == len(outs["jax"]) == 3
    for a, b in zip(outs["port"], outs["jax"]):
        assert a.shape == (36, 48, 3)
        _assert_steps(a, b, cache_impl)
    with pytest.raises(ValueError, match="cache_impl"):
        te.inference_video(port, vid, 2, None, [tgt],
                           str(tmp_path / "x.mp4"), res=res,
                           cache_impl="disk")


def test_attn_impl_plain_matches_kernel_and_unknown_raises(engines):
    """``attn_impl="plain"`` paints what the default kernel route paints
    (its plain version on the CPU), through every engine path."""
    _, port = engines
    res = port.cfg.img_size[1]
    plain = te.InContextModel(port.cfg, port.model, attn_impl="plain",
                              device="cpu")
    assert port.attn_impl == "kernel" and plain.attn_impl == "plain"
    rng = np.random.RandomState(15)
    prompts = [(rng.rand(res, res, 3), rng.rand(res, res, 3))
               for _ in range(3)]
    img, tgt = te.build_prompt_batch(rng.rand(res, res, 3), prompts)
    np.testing.assert_allclose(plain.run_one_image(img, tgt),
                               port.run_one_image(img, tgt), atol=ATOL)
    np.testing.assert_allclose(plain.run_queries(img, tgt),
                               port.run_queries(img, tgt), atol=ATOL)
    q = (rng.rand(2, res, res, 3) * 255).astype(np.uint8)
    np.testing.assert_allclose(
        plain.run_queries_shared(q, *prompts[0]),
        port.run_queries_shared(q, *prompts[0]), atol=ATOL)
    frame = (rng.rand(res, res, 3) * 255).astype(np.uint8)
    np.testing.assert_allclose(
        te.VideoEngine(plain, 2, *prompts[0]).paint_frame(frame),
        te.VideoEngine(port, 2, *prompts[0]).paint_frame(frame), atol=ATOL)
    with pytest.raises(ValueError, match="attn_impl"):
        te.InContextModel(port.cfg, port.model, attn_impl="pallas",
                          device="cpu")
