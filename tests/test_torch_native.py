"""PyTorch port: the host C++ image ops (``painter_tpu_torch.native``,
built by ``kernels/build.py``'s ``g++`` target). Bitwise against the JAX
package's ``painter_tpu.native`` (the same source and flags), against the
port's numpy versions to ``tests/test_native.py``'s tolerances, the same
draws through the transforms either way, and a failed build raises
instead of falling back."""
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from painter_tpu import native as jnative
from painter_tpu_torch import native as tnative
from painter_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD
from painter_tpu_torch.data import pairdataset as tpd
from painter_tpu_torch.data import transforms as T
from painter_tpu_torch.kernels import build
from painter_tpu_torch.ops.resample import nearest_indices, resize_weights
from painter_tpu_torch.train import train as ttrain

from test_torch_train import _cli_args, toy_data  # noqa: F401

MEAN = np.asarray(IMAGENET_MEAN, np.float32)
STD = np.asarray(IMAGENET_STD, np.float32)
JITTERS = [([3, 0, 2, 1], [0.07, 1.2, 0.85, 1.1]),
           ([0, 1, 2, 3], [np.nan, np.nan, np.nan, -0.09]),
           ([1, 3, 0, 2], [0.6, np.nan, 1.4, 0.0])]
RESIZES = [(mode, out_hw) for mode in ("bicubic", "bilinear", "nearest")
           for out_hw in ((17, 40), (64, 9), (29, 21))]


@pytest.fixture(autouse=True)
def _jax_native_on():
    jnative.set_enabled(True)
    assert jnative.available(), "the JAX package's native build failed"


def test_build_target_and_library():
    assert build.HOST_SOURCES == ("image_ops",)
    path = build._target("image_ops")
    assert path.startswith(build.BUILD_DIR) and "image_ops-" in path
    lib = tnative.library()
    assert os.path.exists(path) and lib._name == path
    for fn in ("color_jitter", "normalize_u8", "normalize_f32",
               "resize_hwc", "resize_nearest_hwc"):
        assert getattr(lib, fn).argtypes


def test_build_key_covers_source_flags_and_isa(tmp_path, monkeypatch):
    base = build._target("image_ops")
    src = tmp_path / "native"
    shutil.copytree(build.NATIVE_SRC, src)
    monkeypatch.setattr(build, "NATIVE_SRC", str(src))
    assert build._target("image_ops") == base
    with open(src / "image_ops.cpp", "a") as f:
        f.write("// edited\n")
    edited = build._target("image_ops")
    monkeypatch.setattr(build, "GXX_FLAGS", build.GXX_FLAGS + ("-g",))
    flags = build._target("image_ops")
    monkeypatch.setattr(build, "_host_isa", lambda: "another cpu")
    isa = build._target("image_ops")
    assert len({base, edited, flags, isa}) == 4


def test_build_in_a_fresh_directory(tmp_path, monkeypatch):
    """A build from nothing writes the library and the compiler's log,
    and leaves no temporary file."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    paths = build.build_all(build.HOST_SOURCES)
    assert sorted(os.listdir(tmp_path / "b")) == sorted(
        [os.path.basename(paths["image_ops"]),
         os.path.basename(paths["image_ops"])[:-3] + ".log"])


def test_failed_build_raises(tmp_path, monkeypatch):
    """A missing compiler raises, from the library and from everything
    that runs the native ops; nothing falls back to numpy."""
    monkeypatch.setattr(build, "GXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    build.library.cache_clear()
    tnative.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no-such-g"):
            tnative.library()
        img = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
        with pytest.raises(RuntimeError):
            T.PairColorJitter(p=1.0)(img, img, np.random.default_rng(0))
        with pytest.raises(RuntimeError):
            T.PairToArrayNormalize()(img, img)
        with pytest.raises(RuntimeError):
            tpd.make_train_dataset(str(tmp_path), [], img_size=(64, 32),
                                   patch_size=8)
        # a compiler that fails: its output is in the error
        script = tmp_path / "failing-g++"
        script.write_text("#!/bin/sh\necho broken compiler >&2\nexit 1\n")
        script.chmod(0o755)
        monkeypatch.setattr(build, "GXX", str(script))
        with pytest.raises(RuntimeError, match="broken compiler"):
            tnative.library()
        assert not [f for f in os.listdir(tmp_path / "b")
                    if f.endswith(".so")]
        # the plain versions need no build
        T.PairColorJitter(p=1.0, native=False)(img, img,
                                              np.random.default_rng(0))
    finally:
        build.library.cache_clear()
        tnative.library.cache_clear()


def test_opt_out_trains_where_the_build_fails(tmp_path, monkeypatch,
                                             toy_data):  # noqa: F811
    """``PAINTER_TPU_NO_NATIVE=1`` (the JAX package's opt-out) makes
    ``train.main`` train on the numpy versions on a host whose compiler
    is missing, building nothing; with the variable unset the same run
    raises, as a failed build always does."""
    root, jp = toy_data
    monkeypatch.setattr(build, "GXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    build.library.cache_clear()
    tnative.library.cache_clear()
    try:
        monkeypatch.delenv("PAINTER_TPU_NO_NATIVE", raising=False)
        assert tnative.enabled()
        with pytest.raises(RuntimeError, match="no-such-g"):
            ttrain.main(_cli_args(root, jp, str(tmp_path / "native")))
        monkeypatch.setenv("PAINTER_TPU_NO_NATIVE", "1")
        assert not tnative.enabled()
        out_dir = str(tmp_path / "numpy")
        state = ttrain.main(_cli_args(root, jp, out_dir))
        # 16 samples / (batch 4 x accum 2) = 2 updates per epoch, 2 epochs
        assert state["step"] == 4
        assert next(state["model"].parameters()).device.type == "cpu"
        with open(os.path.join(out_dir, "log.txt")) as f:
            assert np.isfinite(json.loads(f.readline())["train_loss"])
        assert not [f for f in os.listdir(tmp_path / "b")
                    if f.endswith(".so")]
        # an explicit native=True still builds, and raises
        with pytest.raises(RuntimeError, match="no-such-g"):
            tpd.make_train_dataset(root, [jp], img_size=(64, 32),
                                   patch_size=8, native=True)
    finally:
        build.library.cache_clear()
        tnative.library.cache_clear()


@pytest.mark.parametrize("order,factors", JITTERS)
def test_color_jitter_matches_jax_and_numpy(order, factors):
    arr = np.random.RandomState(0).rand(37, 23, 3).astype(np.float32)
    got = tnative.color_jitter_inplace(arr.copy(), order, factors)
    ref = jnative.color_jitter_inplace(arr.copy(), order, factors)
    np.testing.assert_array_equal(got, ref)
    plain = arr.copy()
    fns = (T.adjust_brightness, T.adjust_contrast, T.adjust_saturation,
           T.adjust_hue)
    for o, f in zip(order, factors):
        if not np.isnan(f):
            plain = fns[o](plain, float(f))
    np.testing.assert_allclose(got, plain, atol=2e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_matches_jax_and_numpy(dtype):
    rng = np.random.RandomState(1)
    x = (rng.randint(0, 256, (19, 31, 3)).astype(np.uint8)
         if dtype == np.uint8 else rng.rand(19, 31, 3).astype(np.float32))
    got = tnative.normalize(x, MEAN, STD)
    np.testing.assert_array_equal(got, jnative.normalize(x, MEAN, STD))
    x01 = x.astype(np.float32) / 255.0 if dtype == np.uint8 else x
    np.testing.assert_allclose(got, (x01 - MEAN) / STD, atol=1e-6)


@pytest.mark.parametrize("mode,out_hw", RESIZES)
def test_resize_matches_jax_and_dense_matmul(mode, out_hw):
    x = np.random.RandomState(2).rand(29, 21, 3).astype(np.float32)
    got = tnative.resize_hwc(x, out_hw, mode)
    np.testing.assert_array_equal(got, jnative.resize_hwc(x, out_hw, mode))
    if mode == "nearest":
        ref = x[nearest_indices(29, out_hw[0])][:,
                                                nearest_indices(21, out_hw[1])]
    else:
        m = {"bicubic": "cubic", "bilinear": "linear"}[mode]
        wh = resize_weights(29, out_hw[0], m).astype(np.float32)
        ww = resize_weights(21, out_hw[1], m).astype(np.float32)
        y = np.tensordot(wh, x, axes=(1, 0))
        ref = np.tensordot(ww, y, axes=(1, 1)).transpose(1, 0, 2)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_resize_at_the_seccrop_shape_matches_jax():
    """A stitched 896x448 canvas crop back to 896x448, bicubic and
    nearest, as the workers run it."""
    x = np.random.RandomState(3).randn(700, 300, 3).astype(np.float32)
    for mode in ("bicubic", "nearest"):
        np.testing.assert_array_equal(
            tnative.resize_hwc(x, (896, 448), mode),
            jnative.resize_hwc(x, (896, 448), mode))


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="unknown mode"):
        tnative.resize_hwc(np.zeros((4, 4, 3), np.float32), (2, 2), "area")
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        tnative.normalize(np.zeros((4, 4), np.uint8), MEAN, STD)
    with pytest.raises(ValueError, match="4 slots"):
        tnative.color_jitter_inplace(np.zeros((4, 4, 3), np.float32),
                                     [0, 1], [1.0, 1.0])


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_color_jitter_transform_same_draws(seed):
    """PairColorJitter with the same seed: the same draws (the generator
    ends in the same state) and an image within one uint8 step, through
    the native and numpy versions."""
    img = Image.fromarray(np.random.RandomState(seed).randint(
        0, 256, (32, 32, 3), np.uint8))
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    a1, _ = T.PairColorJitter(p=1.0)(img, img, r1)
    a2, _ = T.PairColorJitter(p=1.0, native=False)(img, img, r2)
    assert r1.bit_generator.state == r2.bit_generator.state
    d = np.abs(np.asarray(a1, np.int16) - np.asarray(a2, np.int16))
    assert d.max() <= 1


def test_array_rrc_and_normalize_native_match_numpy():
    x = np.random.RandomState(4).rand(64, 48, 3).astype(np.float32)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for interp in (None, "nearest"):
        a1, b1 = T.ArrayRandomResizedCrop((32, 24), scale=(0.5, 1.0))(
            x, x, r1, interp, "nearest")
        a2, b2 = T.ArrayRandomResizedCrop((32, 24), scale=(0.5, 1.0),
                                          native=False)(
            x, x, r2, interp, "nearest")
        np.testing.assert_allclose(a1, a2, atol=1e-5)
        np.testing.assert_array_equal(b1, b2)
    assert r1.bit_generator.state == r2.bit_generator.state
    img = Image.fromarray((x * 255).astype(np.uint8))
    n1 = T.PairToArrayNormalize()(img, img)
    n2 = T.PairToArrayNormalize(native=False)(img, img)
    for g, r in zip(n1, n2):
        np.testing.assert_allclose(g, r, atol=1e-6)
