"""PyTorch port: the dress-rehearsal tool (``evals/rehearsal.py``) end to
end at tiny scale on the CPU, and its two repairs over the JAX package's
(a reuse marker that records every generation parameter, and one random
stream per task)."""
import filecmp
import json
import os

import numpy as np
import pytest
from PIL import Image

from painter_tpu_torch.evals import rehearsal


def test_rehearsal_all_tasks(tmp_path):
    timings = rehearsal.main([
        "--root", str(tmp_path), "--n_images", "2", "--model",
        "tiny_test", "--input_size", "32", "--pano_input_size", "32",
        "--batch_size", "2", "--device", "cpu"])
    # the keys tests/test_rehearsal.py checks of the JAX package's tool
    for key in ("ade20k/paint_s", "ade20k/decode_miou_s", "ade20k/mIoU",
                "pano/paint_inst_s", "pano/paint_semseg_s",
                "pano/decode_fuse_pq_s", "pano/PQ",
                "pose/paint_s", "pose/decode_ap_s", "pose/AP", "total_s"):
        assert key in timings and np.isfinite(timings[key]), key
    assert len(os.listdir(tmp_path / "pose" / "out")) == 4  # + flips


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_changed_parameters_regenerate_into_a_clean_directory(tmp_path):
    root = str(tmp_path / "ade")
    img_dir, *_ = rehearsal.make_ade20k(root, 3, seed=0, hw=(32, 48))
    first = _files(root)
    assert len(os.listdir(img_dir)) == 3
    # the same parameters reuse the data as they are
    before = os.path.getmtime(os.path.join(img_dir, "im0000.jpg"))
    rehearsal.make_ade20k(root, 3, seed=0, hw=(32, 48))
    assert os.path.getmtime(os.path.join(img_dir, "im0000.jpg")) == before
    # another size regenerates
    rehearsal.make_ade20k(root, 3, seed=0, hw=(40, 24))
    assert Image.open(os.path.join(img_dir, "im0000.jpg")).size == (24, 40)
    assert _files(root) == first
    # fewer images leave no stale ones behind
    rehearsal.make_ade20k(root, 2, seed=0, hw=(40, 24))
    assert sorted(os.listdir(img_dir)) == ["im0000.jpg", "im0001.jpg"]
    with open(os.path.join(root, ".generated")) as f:
        assert json.load(f) == {"n": 2, "hw": [40, 24], "seed": 0}
    # panoptic records n_things, and a stale output directory goes too
    proot = str(tmp_path / "pano")
    rehearsal.make_panoptic(proot, 1, seed=0, hw=(96, 96), n_things=2)
    os.makedirs(os.path.join(proot, "out_inst"))
    rehearsal.make_panoptic(proot, 1, seed=0, hw=(96, 96), n_things=3)
    assert not os.path.exists(os.path.join(proot, "out_inst"))
    with open(os.path.join(proot, "panoptic_gt.json")) as f:
        assert len(json.load(f)["annotations"][0]["segments_info"]) == 4


def test_a_directory_without_the_marker_is_left_alone(tmp_path):
    # a dataset the tool did not generate (no marker) is never deleted
    root = tmp_path / "ade"
    os.makedirs(root / "images")
    (root / "images" / "real.jpg").write_bytes(b"not generated")
    with pytest.raises(FileExistsError, match=str(root)):
        rehearsal.make_ade20k(str(root), 2, seed=0, hw=(32, 48))
    assert _files(root) == ["images/real.jpg"]
    # an empty directory is the tool's to fill
    os.makedirs(tmp_path / "empty")
    rehearsal.make_ade20k(str(tmp_path / "empty"), 2, seed=0, hw=(32, 48))
    assert len(os.listdir(tmp_path / "empty" / "images")) == 2


def test_an_interrupted_generation_is_generated_again(tmp_path, monkeypatch):
    root = str(tmp_path / "ade")

    def fail(*_):
        raise KeyboardInterrupt

    monkeypatch.setattr(rehearsal, "_rect_labels", fail)
    with pytest.raises(KeyboardInterrupt):
        rehearsal.make_ade20k(root, 2, seed=0, hw=(32, 48))
    monkeypatch.undo()
    # the marker written before the data matches no parameters
    img_dir, *_ = rehearsal.make_ade20k(root, 2, seed=0, hw=(32, 48))
    assert sorted(os.listdir(img_dir)) == ["im0000.jpg", "im0001.jpg"]
    with open(os.path.join(root, ".generated")) as f:
        assert json.load(f) == {"n": 2, "hw": [32, 48], "seed": 0}


def test_task_data_do_not_depend_on_the_other_tasks(tmp_path):
    alone, after = tmp_path / "alone", tmp_path / "after"
    rehearsal.make_pose(str(alone / "pose"), 2, seed=5)
    rehearsal.make_panoptic(str(alone / "pano"), 1, seed=5, hw=(96, 96))
    rehearsal.make_ade20k(str(after / "ade"), 2, seed=5, hw=(32, 48))
    rehearsal.make_panoptic(str(after / "pano"), 1, seed=5, hw=(96, 96))
    rehearsal.make_pose(str(after / "pose"), 2, seed=5)
    for task in ("pose", "pano"):
        files = _files(alone / task)
        assert files == _files(after / task) and len(files) > 4
        _, mismatch, errors = filecmp.cmpfiles(alone / task, after / task,
                                               files, shallow=False)
        assert not mismatch and not errors, mismatch
    # another seed gives other data
    rehearsal.make_pose(str(tmp_path / "seed6"), 2, seed=6)
    assert not filecmp.cmp(alone / "pose" / "meta.json",
                           tmp_path / "seed6" / "meta.json", shallow=False)
