"""PyTorch port: the in-context engine against the JAX ``InContextModel``
on the CPU (one set of weights), and the port's import hygiene.

Painted outputs: atol 2e-5 on the [0,1] scale (fp32 through the tiny
model, sums in another order); uint8 outputs may differ by one step where
a value sits on a quantization boundary."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from painter_tpu import configs as jcfg
from painter_tpu.infer import engine as je
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.infer import engine as te
from painter_tpu_torch.models import incontext_vit as tm

from torch_port_common import jax_params_np, port_model

ATOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def engines():
    kw = dict(img_size=(64, 32), pretrain_img_size=32, seg_type_tokens=True)
    cfg_j = jcfg.tiny_test_config(**kw)
    cfg_t = tcfg.tiny_test_config(**kw)
    params = jax_params_np(cfg_j, seed=0)
    model = port_model(cfg_t, params)
    return (je.InContextModel(cfg_j, params, attn_impl="xla"),
            te.InContextModel(cfg_t, model, device="cpu"))


def _prompts(res, n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(res, res, 3), rng.rand(res, res, 3)) for _ in range(n)]


@pytest.mark.parametrize("n_prompts", [1, 3])
def test_run_one_image_matches_jax(engines, n_prompts):
    """1 prompt, and 3 prompts padded to the 4-bucket with weights
    [1/3, 1/3, 1/3, 0]."""
    jax_eng, port = engines
    res = port.cfg.img_size[1]
    query = np.random.RandomState(1).rand(res, res, 3)
    img, tgt = te.build_prompt_batch(query, _prompts(res, n_prompts, 2))
    img_j, tgt_j = je.build_prompt_batch(query, _prompts(res, n_prompts, 2))
    np.testing.assert_array_equal(img, img_j)
    np.testing.assert_array_equal(tgt, tgt_j)
    got = port.run_one_image(img, tgt)
    assert got.shape == (res, res, 3)
    np.testing.assert_allclose(got, jax_eng.run_one_image(img, tgt),
                               atol=ATOL)


def test_prompt_bucket_padding_is_exact(engines):
    """The padded 4-bucket ensemble == the unpadded 3-prompt mean."""
    _, port = engines
    exact = te.InContextModel(port.cfg, port.model, pad_prompts=False,
                              device="cpu")
    res = port.cfg.img_size[1]
    img, tgt = te.build_prompt_batch(np.random.RandomState(3).rand(
        res, res, 3), _prompts(res, 3, 4))
    np.testing.assert_allclose(port.run_one_image(img, tgt),
                               exact.run_one_image(img, tgt), atol=1e-5)
    assert [te._prompt_bucket(n) for n in (1, 2, 3, 5, 8)] == \
        [je._prompt_bucket(n) for n in (1, 2, 3, 5, 8)]


def test_run_queries_matches_jax(engines):
    jax_eng, port = engines
    res = port.cfg.img_size[1]
    rng = np.random.RandomState(5)
    img2, tgt2 = rng.rand(res, res, 3), rng.rand(res, res, 3)
    queries = [rng.rand(res, res, 3) for _ in range(3)]
    imgs, tgts = te.build_query_batch(queries, img2, tgt2)
    imgs_j, tgts_j = je.build_query_batch(queries, img2, tgt2)
    np.testing.assert_array_equal(imgs, imgs_j)
    np.testing.assert_array_equal(tgts, tgts_j)
    got = port.run_queries(imgs, tgts, real_count=2)
    assert got.shape == (2, res, res, 3)
    np.testing.assert_allclose(got, jax_eng.run_queries(imgs, tgts)[:2],
                               atol=ATOL)


def test_run_queries_shared_uint8_io_matches_jax(engines):
    jax_eng, port = engines
    res = port.cfg.img_size[1]
    rng = np.random.RandomState(6)
    q_u8 = (rng.rand(3, res, res, 3) * 255).astype(np.uint8)
    img2 = rng.rand(res, res, 3).astype(np.float32)
    tgt2 = rng.rand(res, res, 3).astype(np.float32)
    out_f = port.run_queries_shared((q_u8 / 255.0).astype(np.float32), img2,
                                    tgt2)
    out_f_u8in = port.run_queries_shared(q_u8, img2, tgt2)
    assert out_f_u8in.dtype == np.float32
    assert np.array_equal(out_f, out_f_u8in)  # in-graph /255 bit-exact
    np.testing.assert_allclose(
        out_f, jax_eng.run_queries_shared(q_u8, img2, tgt2), atol=ATOL)
    out_u8 = port.run_queries_shared(q_u8, img2, tgt2, out_dtype=np.uint8)
    assert out_u8.dtype == np.uint8 and out_u8.shape == (3, res, res, 3)
    assert np.array_equal(out_u8, np.clip(out_f * np.float32(255.0), 0,
                                          255).astype(np.uint8))
    ref_u8 = jax_eng.run_queries_shared(q_u8, img2, tgt2,
                                        out_dtype=np.uint8)
    assert np.abs(out_u8.astype(int) - ref_u8.astype(int)).max() <= 1


def test_prompt_cache_invalidated_by_in_place_edit(engines):
    _, port = engines
    res = port.cfg.img_size[1]
    rng = np.random.RandomState(7)
    queries = rng.rand(2, res, res, 3).astype(np.float32)
    img2 = rng.rand(res, res, 3).astype(np.float32)
    tgt2 = rng.rand(res, res, 3).astype(np.float32)
    first = port.run_queries_shared(queries, img2, tgt2)
    dev = port._prompt_dev_cache[3]
    port.run_queries_shared(queries, img2, tgt2)
    assert port._prompt_dev_cache[3] is dev  # same arrays: cache hit
    img2[:] = rng.rand(res, res, 3)          # same identity, new content
    edited = port.run_queries_shared(queries, img2, tgt2)
    assert port._prompt_dev_cache[3] is not dev
    fresh = te.InContextModel(port.cfg, port.model, device="cpu")
    np.testing.assert_array_equal(
        edited, fresh.run_queries_shared(queries, img2.copy(), tgt2))
    assert not np.array_equal(first, edited)
    assert te._array_digest(img2) == je._array_digest(img2)


@pytest.mark.parametrize("task", sorted(je.TASK_SPECS))
def test_scale_and_resize_matches_jax(task):
    out = np.random.RandomState(8).rand(16, 16, 3).astype(np.float32)
    assert vars(te.TASK_SPECS[task]) == vars(je.TASK_SPECS[task])
    np.testing.assert_allclose(
        te.scale_and_resize(out, (20, 12), te.TASK_SPECS[task]),
        je.scale_and_resize(out, (20, 12), je.TASK_SPECS[task]),
        rtol=1e-5, atol=1e-3)  # 0-10000 output scale for depth


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module imports with ``jax`` and ``painter_tpu`` blocked
    as whole module names (``painter_tpu`` is a prefix of the port's own
    name, so a substring check would be wrong); importing them loads
    neither ``cv2`` (the video-file driver imports it when it runs; the
    training-set generators never do), ``gradio`` (the demo UI's) nor
    ``h5py`` (the NYUv2 extractor imports it when it runs)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['painter_tpu'] = None\n"
        "import painter_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    painter_tpu_torch.__path__, 'painter_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]\n"
        "       or m.startswith(('jax.', 'painter_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert 'cv2' not in sys.modules and 'gradio' not in sys.modules\n"
        "assert 'h5py' not in sys.modules\n"
        "print(len(names), *names)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, *names = res.stdout.split()
    assert int(count) >= 63
    assert {"painter_tpu_torch.data.prep", "painter_tpu_torch.data."
            "trainset_gen", "painter_tpu_torch.native",
            "painter_tpu_torch.dryrun"} <= set(names)
    assert {f"painter_tpu_torch.utils.{m}" for m in (
        "torch_oracle", "parity", "profiling", "component_profile",
        "kernel_stage_profile")} <= set(names)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.tiny_test_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.build_model(cfg)
    model = tm.build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.InContextModel(cfg, model)
    from painter_tpu_torch.infer import seggpt_cli
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seggpt_cli.prepare_model(None, "tiny_test", "semantic")
