"""PyTorch port: ``painter_tpu_torch.data.trainset_gen`` against the JAX
package's ``data/trainset_gen.py`` (which resizes and warps with OpenCV)
on the same synthetic COCO panoptic and keypoint data: the same pair-list
JSON, the painted targets bit for bit, the images within one uint8 step
(torch's float bilinear against OpenCV's sums; the share of values that
differ is printed and bounded), the numpy helpers to 1e-6; the device
rule; and a short training run of the port on a generated set."""
import json
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from painter_tpu.data import trainset_gen as jtg
from painter_tpu_torch.data import trainset_gen as ttg
from torch_raw_data import make_keypoints, make_panoptic, tree

# share of image values one uint8 step off OpenCV's: the bilinear resize
# rounds ~13% of values the other way on noise (0.129 measured from 480x640
# to 717-2048 squares); the warp fewer
IMAGE_STEP_SHARE = 0.2
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    make_panoptic(os.path.join(root, "pan"))
    make_keypoints(os.path.join(root, "kp"))
    return root


def _pan_args(raw):
    pan = os.path.join(raw, "pan")
    return (os.path.join(pan, "panoptic.json"), os.path.join(pan,
                                                             "panoptic"),
            os.path.join(pan, "images"))


def _compare_sets(ref_json, got_json, image_key):
    """Same JSON bytes and file names; targets bitwise; images within one
    step. Returns (pairs, share of image values that differ)."""
    with open(ref_json, "rb") as a, open(got_json, "rb") as b:
        assert a.read() == b.read()
    jroot, troot = os.path.dirname(ref_json), os.path.dirname(got_json)
    ta, tb = tree(jroot), tree(troot)
    assert sorted(ta) == sorted(tb)
    differing = total = 0
    for k in ta:
        if image_key(k):
            a = np.asarray(Image.open(os.path.join(jroot, k)), np.int16)
            b = np.asarray(Image.open(os.path.join(troot, k)), np.int16)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, k
            differing += int((a != b).sum())
            total += a.size
        else:
            assert ta[k] == tb[k], k
    with open(got_json) as f:
        pairs = json.load(f)
    return pairs, differing / max(total, 1)


@pytest.mark.parametrize("kw", [
    dict(num_aug=3, out_size=64, seed=0),
    dict(num_aug=2, out_size=96, seed=7, include_org=False, max_images=2),
    dict(out_size=80, val=True)], ids=["aug3", "aug2-noorg", "val"])
def test_gen_instance_trainset_matches_jax(raw, tmp_path, kw):
    ref = jtg.gen_instance_trainset(*_pan_args(raw), str(tmp_path / "j"),
                                    **kw)
    got = ttg.gen_instance_trainset(*_pan_args(raw), str(tmp_path / "t"),
                                    device="cpu", **kw)
    assert os.path.basename(got) == os.path.basename(ref)
    pairs, share = _compare_sets(ref, got, lambda k: "_image_" in k)
    print(f"instance images: {share:.4f} of values one step off OpenCV's")
    assert share <= IMAGE_STEP_SHARE
    # image 1 has no things: all its copies are skipped
    assert pairs and not any("im1_" in p["image_path"] for p in pairs)


@pytest.mark.parametrize("kw", [
    dict(num_aug=3, seed=0),
    dict(num_aug=2, seed=4, flip_prob=1.0, rot_factor=0.0, max_anns=2),
    dict(num_aug=2, seed=1, flip_prob=0.0, scale_factor=0.0,
         rot_prob=1.0),
    dict(val=True)], ids=["aug3", "flip", "rot", "val"])
def test_gen_pose_trainset_matches_jax(raw, tmp_path, kw):
    args = (os.path.join(raw, "kp", "kp.json"),
            os.path.join(raw, "kp", "images"))
    ref = jtg.gen_pose_trainset(*args, str(tmp_path / "j"), **kw)
    got = ttg.gen_pose_trainset(*args, str(tmp_path / "t"), device="cpu",
                                **kw)
    assert os.path.basename(got) == os.path.basename(ref)
    pairs, share = _compare_sets(ref, got, lambda k: k.endswith(
        "_image.png"))
    print(f"pose crops: {share:.4f} of values one step off OpenCV's")
    assert share <= IMAGE_STEP_SHARE
    n_people = 2 if kw.get("max_anns") == 2 else 3  # crowd / empty out
    assert len(pairs) == n_people * kw.get("num_aug", 1)


@pytest.mark.parametrize("size", [(717, 717), (1024, 1024), (2047, 1300),
                                  (40, 52)])
def test_resize_pair_against_opencv(size):
    """The image within one step of ``cv2.INTER_LINEAR`` at the sizes the
    instance generator reaches (1024 x U(0.7, 2.0)) from a COCO-sized
    image, the masks equal to ``cv2.INTER_NEAREST``."""
    rng = np.random.RandomState(0)
    img = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    masks = rng.rand(2, 480, 640) > 0.5
    got_img, got_masks = ttg._resize_pair(img, masks, size, CPU)
    ref_img = cv2.resize(img, size[::-1], interpolation=cv2.INTER_LINEAR)
    d = np.abs(got_img.astype(np.int16) - ref_img)
    assert d.max() <= 1 and (d > 0).mean() <= IMAGE_STEP_SHARE
    for m, g in zip(masks, got_masks):
        np.testing.assert_array_equal(
            g, cv2.resize(m.astype(np.uint8), size[::-1],
                          interpolation=cv2.INTER_NEAREST).astype(bool))


def test_nearest_indices_match_opencv():
    """OpenCV's nearest index, at every output size the instance
    generator reaches from COCO's image sides (and a few downscales)."""
    for in_size in (427, 480, 500, 612, 640):
        idx = np.arange(in_size, dtype=np.float32)[None].repeat(2, 0)
        for out in [*range(716, 2049), 40, 52, 53, 97]:
            ref = cv2.resize(idx, (out, 2),
                             interpolation=cv2.INTER_NEAREST)[0]
            np.testing.assert_array_equal(ttg.nearest_indices(in_size, out),
                                          ref.astype(np.int64))


@pytest.mark.parametrize("rot,s", [(0.0, 1.3), (17.3, 0.8), (-63.0, 1.0)])
def test_warp_affine_against_opencv(rot, s):
    rng = np.random.RandomState(1)
    img = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    mat = jtg.get_affine_transform(np.array([300.0, 220.0], np.float32),
                                   np.array([1.2 * s, 1.6 * s], np.float32),
                                   rot, (192, 256))
    got = ttg.warp_affine(img[:, ::-1], mat, (192, 256), CPU)
    ref = cv2.warpAffine(np.ascontiguousarray(img[:, ::-1]), mat, (192, 256),
                         flags=cv2.INTER_LINEAR)
    d = np.abs(got.astype(np.int16) - ref)
    assert d.max() <= 1 and (d > 0).mean() <= IMAGE_STEP_SHARE


def test_numpy_helpers_match_jax():
    rng = np.random.RandomState(2)
    for _ in range(8):
        bbox = list(rng.uniform(0, 200, 2)) + list(rng.uniform(5, 150, 2))
        c_j, s_j = jtg.bbox_to_center_scale(bbox)
        c_t, s_t = ttg.bbox_to_center_scale(bbox)
        np.testing.assert_array_equal(c_t, c_j)
        np.testing.assert_array_equal(s_t, s_j)
        rot = float(rng.uniform(-80, 80))
        m_j = jtg.get_affine_transform(c_j, s_j, rot, (192, 256))
        m_t = ttg.get_affine_transform(c_t, s_t, rot, (192, 256))
        np.testing.assert_allclose(m_t, m_j, rtol=0, atol=1e-6)
        pts = rng.uniform(-50, 300, (17, 2)).astype(np.float32)
        np.testing.assert_allclose(ttg.transform_points(pts, m_t),
                                   jtg.transform_points(pts, m_j),
                                   rtol=0, atol=1e-6)
        joints = rng.uniform(-20, 210, (17, 2)).astype(np.float32)
        vis = (rng.rand(17) > 0.2).astype(np.float32)
        maps = []
        for sigma in (1.5, 3.0):
            h_j, w_j = jtg.msra_heatmaps(joints, vis, (256, 192), sigma)
            h_t, w_t = ttg.msra_heatmaps(joints, vis, (256, 192), sigma)
            np.testing.assert_allclose(h_t, h_j, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(w_t, w_j)
            maps.append(h_t * w_t[:, None, None])
        np.testing.assert_array_equal(
            ttg.paint_pose_target(maps[1], maps[0]),
            jtg.paint_pose_target(maps[1], maps[0]))
    assert ttg.COCO_POSE_FLIP_PAIRS == jtg.COCO_POSE_FLIP_PAIRS


def test_generators_run_on_cuda_unless_given_the_cpu(raw, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kp = (os.path.join(raw, "kp", "kp.json"), os.path.join(raw, "kp",
                                                           "images"))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttg.gen_instance_trainset(*_pan_args(raw), str(tmp_path / "i"),
                                      num_aug=1, out_size=32, device=device)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttg.gen_pose_trainset(*kp, str(tmp_path / "p"), num_aug=1,
                                  device=device)
    assert not os.path.exists(tmp_path / "i")
    assert not os.path.exists(tmp_path / "p")
    jp = ttg.gen_pose_trainset(*kp, str(tmp_path / "p"), val=True,
                               device=torch.device("cpu"))
    assert len(json.load(open(jp))) == 3


def test_pose_valset_roundtrip_decodes(raw, tmp_path):
    """An unaugmented painted crop decodes back to its joints through the
    port's pose decoders; the unlabeled joint stays silent."""
    from painter_tpu_torch.evals.pose import (decode_painted_heatmaps,
                                              keypoints_from_heatmaps)
    jp = ttg.gen_pose_trainset(os.path.join(raw, "kp", "kp.json"),
                               os.path.join(raw, "kp", "images"),
                               str(tmp_path), val=True, max_anns=1,
                               device="cpu")
    pair = json.load(open(jp))[0]
    lab = np.asarray(Image.open(os.path.join(tmp_path,
                                             pair["target_path"])),
                     np.float32)
    ann = json.load(open(os.path.join(raw, "kp", "kp.json")))[
        "annotations"][0]
    kpts = np.asarray(ann["keypoints"], np.float32).reshape(17, 3)
    center, scale = ttg.bbox_to_center_scale(ann["bbox"])
    dec, maxvals = keypoints_from_heatmaps(
        decode_painted_heatmaps(lab[None]), center[None], scale[None])
    vis = kpts[:, 2] > 0
    assert np.abs(dec[0][vis] - kpts[vis, :2]).max() < 1.5
    assert (maxvals[0, vis, 0] > 0.9).all() and maxvals[0, 3, 0] < 0.1


def test_generated_trainset_trains(raw, tmp_path):
    """Generate -> PairDataset (native host ops) -> a short training run
    of the port -> the loss drops (as tests/test_trainset_gen.py's)."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.data import pairdataset as pd
    from painter_tpu_torch.models import incontext_vit as tm
    from painter_tpu_torch.train import optim, step as step_lib
    torch.manual_seed(0)
    root = tmp_path / "gen"
    inst_json = ttg.gen_instance_trainset(*_pan_args(raw), str(root),
                                          num_aug=6, out_size=64, seed=0,
                                          device="cpu")
    cfg = configs.tiny_test_config(img_size=(64, 32), patch_size=4,
                                   embed_dim=32, num_heads=2,
                                   pretrain_img_size=16, drop_path_rate=0.0)
    dataset = pd.make_train_dataset(
        str(root), [inst_json], img_size=cfg.img_size,
        num_mask_patches=64, max_mask_patches_per_block=32,
        min_mask_patches_per_block=1, half_mask_ratio=0.3,
        patch_size=cfg.patch_size)
    sampler = pd.WeightedMixtureSampler(dataset.weights, seed=0)
    model = tm.build_model(cfg, device="cpu").train()
    opt = optim.LayerDecayAdamW(model, cfg, optim.OptimConfig(
        lr=4e-3, warmup_epochs=1, epochs=20, steps_per_epoch=4))
    step = step_lib.make_train_step(cfg, opt, remat=False)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for epoch in range(20):
        for i, batch in enumerate(pd.data_iterator(
                dataset, sampler, batch_size=3, epoch=epoch,
                num_workers=1)):
            if i >= 4:
                break
            m = step(model, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, gen)
            losses.append(float(m["loss"]))
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) * 0.7, (
        np.mean(losses[:8]), np.mean(losses[-8:]))
