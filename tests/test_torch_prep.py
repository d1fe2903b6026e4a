"""PyTorch port: ``painter_tpu_torch.data.prep`` against the JAX package's
``data/prep.py`` on the same synthetic raw data (``torch_raw_data``): every
function's files byte for byte, and each of the CLI's nine subcommands
with the same command line (the two generators within one uint8 step on
their images, as ``test_torch_trainset_gen.py`` holds them)."""
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from painter_tpu.data import prep as jprep
from painter_tpu_torch.data import prep as tprep
from torch_raw_data import (make_ade_labels, make_keypoints, make_nyu_mat,
                            make_panoptic, make_sidd, tree)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    make_panoptic(os.path.join(root, "pan"))
    make_keypoints(os.path.join(root, "kp"))
    make_ade_labels(os.path.join(root, "ade"))
    make_sidd(os.path.join(root, "sidd"))
    make_nyu_mat(os.path.join(root, "nyu"))
    # offline person detections for the pose eval crops (PIL takes crop
    # boxes inside the image only): two boxes in image 5 (one under the
    # score threshold), a non-person, one without a score, an unknown
    # image
    dets = [{"image_id": 5, "category_id": 1, "bbox": [40, 30, 30, 30],
             "score": 0.9},
            {"image_id": 5, "category_id": 1, "bbox": [60.5, 25, 20, 40.5],
             "score": 0.3},
            {"image_id": 6, "category_id": 2, "bbox": [1, 1, 5, 5],
             "score": 0.9},
            {"image_id": 6, "category_id": 1, "bbox": [30, 35, 24, 20]},
            {"image_id": 99, "category_id": 1, "bbox": [1, 1, 5, 5]}]
    with open(os.path.join(root, "dets.json"), "w") as f:
        json.dump(dets, f)
    return root


def _same_tree(a, b):
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb) and ta
    for k in ta:
        assert ta[k] == tb[k], k


def test_pair_types_match_jax():
    assert tprep.PAIR_TYPES == jprep.PAIR_TYPES


@pytest.mark.parametrize("task", ["ade20k", "coco_semseg"])
def test_paint_semantic_dir_matches_jax(raw, tmp_path, task):
    lab = os.path.join(raw, "ade")
    ref = jprep.paint_semantic_dir(lab, str(tmp_path / "j"), task)
    got = tprep.paint_semantic_dir(lab, str(tmp_path / "t"), task)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref]
    _same_tree(tmp_path / "j", tmp_path / "t")


def test_semantic_from_panoptic_matches_jax(raw):
    pan = json.load(open(os.path.join(raw, "pan", "panoptic.json")))
    cat_map = {c["id"]: i for i, c in enumerate(pan["categories"])}
    for ann in pan["annotations"]:
        png = np.asarray(Image.open(os.path.join(
            raw, "pan", "panoptic", ann["file_name"])).convert("RGB"))
        ref = jprep.semantic_from_panoptic(png, ann["segments_info"],
                                           cat_map)
        got = tprep.semantic_from_panoptic(png, ann["segments_info"],
                                           cat_map)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("max_images", [-1, 2])
def test_semantic_from_panoptic_dir_matches_jax(raw, tmp_path, max_images):
    args = (os.path.join(raw, "pan", "panoptic.json"),
            os.path.join(raw, "pan", "panoptic"))
    ref = jprep.semantic_from_panoptic_dir(*args, str(tmp_path / "j"),
                                           max_images)
    got = tprep.semantic_from_panoptic_dir(*args, str(tmp_path / "t"),
                                           max_images)
    assert len(got) == len(ref) == (3 if max_images < 0 else 2)
    _same_tree(tmp_path / "j", tmp_path / "t")


@pytest.mark.parametrize("bbox", [[40, 30, 30, 30], [60.5, 25, 20, 40.5],
                                  [30, 35, 24, 20]])
def test_crop_person_and_keypoints_to_crop_match_jax(raw, bbox):
    image = np.asarray(Image.open(os.path.join(raw, "kp", "images",
                                               "p5.jpg")).convert("RGB"))
    ref = jprep.crop_person(image, bbox)
    got = tprep.crop_person(image, bbox)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[0].shape == (256, 192, 3)
    kpts = np.asarray(json.load(open(os.path.join(raw, "kp", "kp.json")))
                      ["annotations"][0]["keypoints"],
                      np.float32).reshape(17, 3)
    np.testing.assert_array_equal(
        tprep.keypoints_to_crop(kpts, got[1], got[2]),
        jprep.keypoints_to_crop(kpts, ref[1], ref[2]))


@pytest.mark.parametrize("thr,flip", [(0.0, True), (0.5, False)])
def test_make_pose_eval_crops_matches_jax(raw, tmp_path, thr, flip):
    args = (os.path.join(raw, "kp", "images"), os.path.join(raw,
                                                            "dets.json"),
            os.path.join(raw, "kp", "kp.json"))
    ref = jprep.make_pose_eval_crops(*args, str(tmp_path / "j"),
                                     det_bbox_thr=thr, with_flip=flip)
    got = tprep.make_pose_eval_crops(*args, str(tmp_path / "t"),
                                     det_bbox_thr=thr, with_flip=flip)
    assert os.path.basename(got) == os.path.basename(ref) == "meta.json"
    _same_tree(tmp_path / "j", tmp_path / "t")


def test_extract_nyu_depth_mat_matches_jax(raw, tmp_path):
    args = (os.path.join(raw, "nyu", "nyu.mat"),
            os.path.join(raw, "nyu", "split.mat"))
    assert jprep.extract_nyu_depth_mat(*args, str(tmp_path / "j")) == 3
    assert tprep.extract_nyu_depth_mat(*args, str(tmp_path / "t")) == 3
    _same_tree(tmp_path / "j", tmp_path / "t")
    assert sorted(os.listdir(tmp_path / "t" / "train")) == ["scene_0"]


def test_gen_sidd_patches_matches_jax(raw, tmp_path):
    src = os.path.join(raw, "sidd")
    assert jprep.gen_sidd_patches(src, str(tmp_path / "j"), 16, 5, 3) == 10
    assert tprep.gen_sidd_patches(src, str(tmp_path / "t"), 16, 5, 3) == 10
    _same_tree(tmp_path / "j", tmp_path / "t")


@pytest.mark.parametrize("root_rel,suffix", [(False, None),
                                             (True, None),
                                             (True, ".png")])
def test_gen_pair_json_and_toy_dataset_match_jax(raw, tmp_path, root_rel,
                                                 suffix):
    """gen_pair_json matches by basename (a missing target skipped); the
    toy dataset copies the first N pairs of each JSON."""
    img_dir = os.path.join(raw, "ade")
    tgt_dir = str(tmp_path / "tgt")
    tprep.paint_semantic_dir(img_dir, tgt_dir)
    os.remove(os.path.join(tgt_dir, "ade_1.png"))
    root = raw if root_rel else ""
    jj, tj = str(tmp_path / "j" / "p.json"), str(tmp_path / "t" / "p.json")
    kw = dict(root=root, target_suffix=suffix)
    n_ref = jprep.gen_pair_json(img_dir, tgt_dir, "ade20k_image2semantic",
                                jj, **kw)
    n_got = tprep.gen_pair_json(img_dir, tgt_dir, "ade20k_image2semantic",
                                tj, **kw)
    assert n_got == n_ref == 1
    with open(jj, "rb") as a, open(tj, "rb") as b:
        assert a.read() == b.read()
    if root_rel:
        ref = jprep.make_toy_dataset([jj], str(tmp_path / "jt"), raw, 1)
        got = tprep.make_toy_dataset([tj], str(tmp_path / "tt"), raw, 1)
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in ref]
        _same_tree(tmp_path / "jt", tmp_path / "tt")


def _cli_args(cmd, raw, out):
    pan, kp = os.path.join(raw, "pan"), os.path.join(raw, "kp")
    return {
        "paint-semantic": ["--label_dir", os.path.join(raw, "ade"),
                           "--out_dir", out, "--task", "coco_semseg"],
        "gen-json": ["--image_dir", os.path.join(raw, "ade"),
                     "--target_dir", os.path.join(raw, "ade"), "--type",
                     "ade20k_image2semantic", "--out_json",
                     os.path.join(out, "p.json"), "--root", raw],
        "toy-dataset": ["--json_paths", os.path.join(raw, "toy.json"),
                        "--out_dir", out, "--root", raw, "--n", "1"],
        "gen-instance-trainset": [
            "--panoptic_json", os.path.join(pan, "panoptic.json"),
            "--panoptic_root", os.path.join(pan, "panoptic"),
            "--image_root", os.path.join(pan, "images"), "--out_dir", out,
            "--num_aug", "2", "--out_size", "48", "--seed", "3"],
        "gen-pose-trainset": [
            "--keypoints_json", os.path.join(kp, "kp.json"),
            "--image_root", os.path.join(kp, "images"), "--out_dir", out,
            "--num_aug", "1", "--max_anns", "2"],
        "semantic-from-panoptic": [
            "--panoptic_json", os.path.join(pan, "panoptic.json"),
            "--panoptic_root", os.path.join(pan, "panoptic"), "--out_dir",
            out, "--max_images", "2"],
        "pose-eval-crops": [
            "--image_dir", os.path.join(kp, "images"), "--det_json",
            os.path.join(raw, "dets.json"), "--coco_images_json",
            os.path.join(kp, "kp.json"), "--out_dir", out,
            "--det_bbox_thr", "0.5", "--no_flip"],
        "extract-nyu-mat": [
            "--h5_path", os.path.join(raw, "nyu", "nyu.mat"), "--split_mat",
            os.path.join(raw, "nyu", "split.mat"), "--out_dir", out,
            "--max_images", "2"],
        "gen-sidd-patches": ["--src_dir", os.path.join(raw, "sidd"),
                             "--out_dir", out, "--patch_size", "8",
                             "--num_patches", "2", "--seed", "1"],
    }[cmd]


CLI_COMMANDS = ("paint-semantic", "gen-json", "toy-dataset",
                "gen-instance-trainset", "gen-pose-trainset",
                "semantic-from-panoptic", "pose-eval-crops",
                "extract-nyu-mat", "gen-sidd-patches")
IMAGE_SUBDIRS = ("train_aug", "train_org", "val_org", "train_256x192")


@pytest.mark.parametrize("cmd", CLI_COMMANDS)
def test_cli_subcommand_matches_jax(raw, tmp_path, monkeypatch, capsys,
                                    cmd):
    """The same command line through both CLIs (the port's generators
    with ``--device cpu``): the same files, byte for byte, but the
    generated images, which may differ by one uint8 step."""
    toy = os.path.join(raw, "toy.json")
    if not os.path.exists(toy):
        with open(toy, "w") as f:
            json.dump([{"image_path": "ade/ade_0.png",
                        "target_path": "ade/ade_1.png",
                        "type": "ade20k_image2semantic"}] * 2, f)
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    monkeypatch.setattr(sys, "argv", ["prep", cmd, *_cli_args(cmd, raw,
                                                               jout)])
    jprep.main()
    extra = (["--device", "cpu"] if cmd.startswith("gen-") and
             cmd.endswith("trainset") else [])
    tprep.main([cmd, *_cli_args(cmd, raw, tout), *extra])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert lines[1] == lines[0].replace(jout, tout)
    ta, tb = tree(jout), tree(tout)
    assert sorted(ta) == sorted(tb) and ta
    for k in ta:
        if k.endswith("image.png") or "_image_" in k:
            a = np.asarray(Image.open(os.path.join(jout, k)), np.int16)
            b = np.asarray(Image.open(os.path.join(tout, k)), np.int16)
            assert np.abs(a - b).max() <= 1, k
        else:
            assert ta[k] == tb[k], k


@pytest.mark.parametrize("cmd", ["gen-instance-trainset",
                                 "gen-pose-trainset"])
def test_cli_generators_default_to_cuda(raw, tmp_path, monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprep.main([cmd, *_cli_args(cmd, raw, str(tmp_path))])
    assert not any(os.scandir(tmp_path))


def test_extract_nyu_without_h5py_raises(raw, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tprep.extract_nyu_depth_mat(os.path.join(raw, "nyu", "nyu.mat"),
                                    os.path.join(raw, "nyu", "split.mat"),
                                    str(tmp_path))
