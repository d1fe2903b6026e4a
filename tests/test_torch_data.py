"""PyTorch port: the training data pipeline and logging utilities against
the JAX package's, on the same files and seeds; samples must agree bit
for bit. Both sides run their numpy paths (the JAX package's native host
ops switched off, the port's transforms built with ``native=False``), or
both their native host ops, built from the same C++ source with the same
flags."""
import json

import numpy as np
import pytest
from PIL import Image

from painter_tpu import native
from painter_tpu.data import masking as jmask
from painter_tpu.data import pairdataset as jpd
from painter_tpu.utils import logging as jlog
from painter_tpu.utils import tb_writer as jtb
from painter_tpu_torch.data import masking as tmask
from painter_tpu_torch.data import pairdataset as tpd
from painter_tpu_torch.utils import logging as tlog
from painter_tpu_torch.utils import tb_writer as ttb


@pytest.fixture
def numpy_paths():
    native.set_enabled(False)
    yield
    native.set_enabled(True)


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """Every type-dependent branch: depth (sync_depth load, bicubic,
    threshold), semantic (nearest target, ignore-black), instance and pose
    (identity crops, no second crop), a plain restoration pair."""
    root = tmp_path_factory.mktemp("toy")
    rng = np.random.RandomState(0)
    json_paths = []
    specs = [("nyuv2_image2depth", "depth"), ("ade20k_image2semantic", "ade"),
             ("coco_image2panoptic_inst", "inst"), ("coco_image2pose", "pose"),
             ("derain_image2derain", "derain")]
    for pair_type, name in specs:
        pairs = []
        for i in range(3):
            ip = f"{name}_img_{i}.png"
            if pair_type == "nyuv2_image2depth":
                tp = f"{name}_sync_depth_{i}.png"
                depth = (rng.rand(48, 40) * 9000).astype(np.uint16)
                Image.fromarray(depth).save(root / tp)
            else:
                tp = f"{name}_tgt_{i}.png"
                arr = (rng.rand(48, 40, 3) * 255).astype(np.uint8)
                if pair_type in ("ade20k_image2semantic", "coco_image2pose"):
                    arr[:24] = 0  # black = ignore / background
                Image.fromarray(arr).save(root / tp)
            Image.fromarray(
                (rng.rand(48, 40, 3) * 255).astype(np.uint8)).save(root / ip)
            pairs.append({"image_path": ip, "target_path": tp,
                          "type": pair_type})
        jp = root / f"{name}.json"
        jp.write_text(json.dumps(pairs))
        json_paths.append(str(jp))
    return str(root), json_paths


def _train_kwargs():
    return dict(img_size=(64, 32), num_mask_patches=4,
                max_mask_patches_per_block=4, min_mask_patches_per_block=1,
                half_mask_ratio=0.3, patch_size=8)


def _assert_same_batches(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("seed,epoch,accum", [(0, 0, 1), (3, 2, 2)])
def test_train_batches_match_jax(numpy_paths, toy_root, seed, epoch, accum):
    root, json_paths = toy_root
    ds_j = jpd.make_train_dataset(root, json_paths, **_train_kwargs())
    ds_t = tpd.make_train_dataset(root, json_paths, native=False,
                                  **_train_kwargs())
    assert ds_t.weights == ds_j.weights
    s_j = jpd.WeightedMixtureSampler(ds_j.weights, seed=seed)
    s_t = tpd.WeightedMixtureSampler(ds_t.weights, seed=seed)
    np.testing.assert_array_equal(s_t.epoch_indices(epoch),
                                  s_j.epoch_indices(epoch))
    ref = list(jpd.data_iterator(ds_j, s_j, 2, epoch, seed=seed,
                                 accum_iter=accum, num_workers=0))
    got = list(tpd.data_iterator(ds_t, s_t, 2, epoch, seed=seed,
                                 accum_iter=accum, num_workers=0))
    _assert_same_batches(got, ref)


def test_val_batches_match_jax(numpy_paths, toy_root):
    root, json_paths = toy_root
    kw = dict(img_size=(64, 32), num_mask_patches=4, patch_size=8)
    ds_j = jpd.make_val_dataset(root, json_paths, **kw)
    ds_t = tpd.make_val_dataset(root, json_paths, native=False, **kw)
    ref = list(jpd.data_iterator(
        ds_j, jpd.WeightedMixtureSampler(ds_j.weights, seed=1), 3, 0,
        seed=1, num_workers=0))
    got = list(tpd.data_iterator(
        ds_t, tpd.WeightedMixtureSampler(ds_t.weights, seed=1), 3, 0,
        seed=1, num_workers=0))
    _assert_same_batches(got, ref)


@pytest.mark.parametrize("workers", [0, 2])
def test_native_train_batches_match_jax_native(toy_root, workers):
    """The port's native pipeline (the default), in the parent and in two
    spawned workers, against the JAX package's native one."""
    assert native.available()
    root, json_paths = toy_root
    ds_j = jpd.make_train_dataset(root, json_paths, **_train_kwargs())
    ds_t = tpd.make_train_dataset(root, json_paths, **_train_kwargs())
    ref = list(jpd.data_iterator(
        ds_j, jpd.WeightedMixtureSampler(ds_j.weights, seed=5), 2, 1,
        seed=5, accum_iter=2, num_workers=0))
    got = list(tpd.data_iterator(
        ds_t, tpd.WeightedMixtureSampler(ds_t.weights, seed=5), 2, 1,
        seed=5, accum_iter=2, num_workers=workers))
    _assert_same_batches(got, ref)


@pytest.mark.parametrize("grid,count,lo,hi", [
    ((56, 28), 784, 16, 392),   # the training recipe at 896x448
    ((8, 4), 9, 1, 4), ((14, 14), 75, 4, None)])
def test_block_masks_match_jax(grid, count, lo, hi):
    gen_j = jmask.BlockMaskingGenerator(grid, count, min_num_patches=lo,
                                        max_num_patches=hi)
    gen_t = tmask.BlockMaskingGenerator(grid, count, min_num_patches=lo,
                                        max_num_patches=hi)
    for seed in range(5):
        got = gen_t(np.random.default_rng(seed))
        np.testing.assert_array_equal(got, gen_j(np.random.default_rng(seed)))
        assert got.sum() == count
    np.testing.assert_array_equal(gen_t.half_mask(), gen_j.half_mask())


def test_sample_panel_and_event_records_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    imgs, tgts = rng.randn(2, 2, 32, 16, 3).astype(np.float32)
    pred = rng.rand(2, 32, 16, 3).astype(np.float32)
    mask = (rng.rand(2, 8) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        tlog.render_sample_panel(imgs, tgts, mask, pred, 8),
        jlog.render_sample_panel(imgs, tgts, mask, pred, 8))
    scalars = {"train/loss": 0.25, "train/lr": 1e-3}
    assert ttb._record(ttb._event(12.5, step=7, scalars=scalars)) == \
        jtb._record(jtb._event(12.5, step=7, scalars=scalars))
    writer = tlog.ScalarWriter(str(tmp_path), tb=False)
    writer.write(3, 1.5, loss=0.5, lr=2e-4)
    writer.close()
    line = json.loads((tmp_path / "scalars.jsonl").read_text())
    assert line == {"step": 3, "epoch_1000x": 1500, "loss": 0.5, "lr": 2e-4}
