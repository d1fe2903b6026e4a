"""PyTorch port: the eval drivers (``evals/run_eval.py``,
``run_panoptic.py``, ``run_pose.py``) against the JAX package's on the
CPU, on one reference-named ``.pth`` of random tiny weights.

Phase 1 (painting): both packages serve in bf16, rounding activations in
other places; the painted PNGs are held to 3 uint8 steps
(``test_torch_cli.py``'s bound), and the depth task's mode-"I" PNGs to the
same 3/255 of its 10000 output scale.

Phase 2 (decode + metrics): fed the same PNGs, the metrics are held to
1e-9 relative. (The instance decode sums its maskness exactly in the
port and in fp32 in the JAX package, which can order exactly-tied
candidates differently, ``test_torch_decode_ops.py``; on these PNGs no
such tie reaches the metrics.)
"""
import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from painter_tpu import configs as jcfg
from painter_tpu.data import prep as jprep
from painter_tpu.evals import run_eval as jre
from painter_tpu.evals import run_panoptic as jrp
from painter_tpu.evals import run_pose as jrpose
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.evals import rehearsal as treh
from painter_tpu_torch.evals import run_eval as tre
from painter_tpu_torch.evals import run_panoptic as trp
from painter_tpu_torch.evals import run_pose as trpose
from painter_tpu_torch.models import convert
from painter_tpu_torch.ops.palette import coco_semseg_palette

from torch_port_common import jax_params_np

BF16_PNG_STEPS = 3
DEPTH_STEPS = BF16_PNG_STEPS / 255.0 * 10000.0
METRIC_RTOL = 1e-9

TASKS = ["ade20k_semseg", "coco_semseg", "coco_inst", "depth", "derain",
         "sidd", "lol", "seggpt_semseg", "pose"]


def _rgb(rng, hw):
    return (rng.rand(*hw, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Images, GTs and prompts of every task, plus one ``.pth``."""
    root = tmp_path_factory.mktemp("evaldata")
    rng = np.random.RandomState(0)
    for d in ("images", "gts_sem", "gts_rgb", "images_depth", "gts_depth"):
        (root / d).mkdir()
    for i in range(3):
        Image.fromarray(_rgb(rng, (40, 36))).save(root / "images" /
                                                 f"im{i}.jpg")
        Image.fromarray(rng.randint(0, 151, (40, 36)).astype(
            np.uint8)).save(root / "gts_sem" / f"im{i}.png")
        Image.fromarray(_rgb(rng, (40, 36))).save(root / "gts_rgb" /
                                                 f"im{i}.png")
    for i in range(2):
        Image.fromarray(_rgb(rng, (480, 640))).save(
            root / "images_depth" / f"im{i}.jpg")
        Image.fromarray((rng.rand(480, 640) * 9000).astype(np.int32),
                        mode="I").save(root / "gts_depth" / f"im{i}.png")
    Image.fromarray(_rgb(rng, (40, 36))).save(root / "prompt.jpg")
    Image.fromarray(_rgb(rng, (40, 36))).save(root / "ptarget.png")
    Image.fromarray((rng.rand(480, 640) * 9000).astype(np.int32),
                    mode="I").save(root / "ptarget_depth.png")
    pose_dir, meta, gt, p_img, p_tgt = treh.make_pose(
        str(root / "pose"), 2, seed=0)
    params = jax_params_np(jcfg.get_config("tiny_test"), seed=0)
    sd = convert.state_dict_from_jax_params(params,
                                            tcfg.get_config("tiny_test"))
    torch.save({"model": sd}, root / "tiny.pth")
    return root


def _argv(root, task, out, extra=()):
    image_dir, gt_dir, target = (root / "images", root / "gts_rgb",
                                 root / "ptarget.png")
    if task in ("ade20k_semseg", "coco_semseg"):
        gt_dir = root / "gts_sem"
    elif task == "depth":
        image_dir, gt_dir, target = (root / "images_depth",
                                     root / "gts_depth",
                                     root / "ptarget_depth.png")
    elif task == "pose":
        image_dir, gt_dir, target = (root / "pose" / "crops", None,
                                     root / "pose" / "prompt_tgt.png")
    elif task in ("coco_inst", "seggpt_semseg"):
        gt_dir = None
    argv = ["--task", task, "--model", "tiny_test",
            "--ckpt_path", str(root / "tiny.pth"),
            "--image_dir", str(image_dir),
            "--prompt_image", str(root / "prompt.jpg"),
            "--prompt_target", str(target), "--input_size", "32",
            "--output_dir", str(out), *extra]
    if gt_dir is not None:
        argv += ["--gt_dir", str(gt_dir)]
    return argv


@pytest.fixture(scope="module")
def models(synth):
    """(JAX model, port model) from the one ``.pth``; every task shares
    them (one preset at one size)."""
    argv = _argv(synth, "ade20k_semseg", synth / "unused")
    jax_model = jre.build_model(jre.get_args_parser().parse_args(argv))
    port = tre.build_model(tre.get_args_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert port.cfg.dtype == "bfloat16" and port.cfg.img_size == (64, 32)
    return jax_model, port


@pytest.fixture(scope="module")
def painted(synth, models):
    """task, batch size -> (JAX args, JAX outputs, port args, port
    outputs), painted once."""
    cache = {}

    def paint(task, bs):
        if (task, bs) not in cache:
            extra = ["--batch_size", str(bs)]
            ja = jre.get_args_parser().parse_args(_argv(
                synth, task, synth / f"jax_{task}_{bs}", extra))
            ta = tre.get_args_parser().parse_args(_argv(
                synth, task, synth / f"port_{task}_{bs}",
                extra + ["--device", "cpu"]))
            cache[task, bs] = (ja, jre.paint_predictions(ja, models[0]),
                               ta, tre.paint_predictions(ta, models[1]))
        return cache[task, bs]
    return paint


@pytest.mark.parametrize("bs", [1, 2])
@pytest.mark.parametrize("task", TASKS)
def test_phase1_paints_match_jax(painted, task, bs):
    _, jout, _, tout = painted(task, bs)
    assert [os.path.basename(p) for _, p in tout] == \
        [os.path.basename(p) for _, p in jout] and len(tout) >= 2
    for (_, tp), (_, jp) in zip(tout, jout):
        got, ref = Image.open(tp), Image.open(jp)
        assert got.mode == ref.mode and got.size == ref.size
        diff = np.abs(np.asarray(got, np.int64) - np.asarray(ref, np.int64))
        bound = DEPTH_STEPS if task == "depth" else BF16_PNG_STEPS
        assert diff.max() <= bound, (tp, diff.max())
        if task == "sidd":
            from scipy.io import loadmat
            key = "Idenoised_crop"
            np.testing.assert_allclose(
                loadmat(tp.replace(".png", ".mat"))[key],
                loadmat(jp.replace(".png", ".mat"))[key],
                atol=BF16_PNG_STEPS / 255.0)


def _assert_metrics_equal(got, ref):
    assert set(got) == set(ref), (set(got), set(ref))
    for k, v in ref.items():
        if isinstance(v, dict):
            _assert_metrics_equal(got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=METRIC_RTOL, atol=0,
                                       err_msg=k)


@pytest.mark.parametrize("task", ["ade20k_semseg", "coco_semseg", "depth",
                                  "derain", "sidd", "lol"])
def test_phase2_metrics_on_the_same_pngs_match_jax(painted, task):
    ja, jout, ta, _ = painted(task, 2)
    # --decode_only: recover the JAX package's PNGs, score them in both
    ta.output_dir = ja.output_dir
    outs = tre.recover_outputs(ta)
    assert outs == jre.recover_outputs(ja) == jout
    got = tre.compute_metrics(ta, outs)
    ref = jre.compute_metrics(ja, outs)
    assert np.isfinite(list(ref.values())).all()
    _assert_metrics_equal(got, ref)


class _Echo:
    """A stand-in model that paints each query back: both packages'
    drivers then see the same model outputs, so their host logic is all
    that differs."""
    mesh = None

    def run_queries_shared(self, queries, img2, tgt2, real_count=None,
                           out_dtype=np.float32):
        return np.asarray(queries, np.float32)[:real_count]

    def run_one_image(self, img, tgt):
        return np.clip(img[0, img.shape[1] // 2:] * 0.2 + 0.5, 0, 1)


def test_sidd_mat_and_derain_sweep_match_jax(synth, tmp_path, monkeypatch):
    """With the same model outputs, the drivers' results are equal. The
    JAX package resizes with its native banded kernel where one is built,
    which sums in another order than the numpy resize the port has (the
    native host ops are not ported yet); its numpy path is the port's."""
    from scipy.io import loadmat, savemat
    from painter_tpu import native
    monkeypatch.setattr(native, "_FORCED_OFF", True)
    rng = np.random.RandomState(3)
    gt = (rng.rand(2, 3, 24, 24, 3) * 255).astype(np.float32)
    noisy = np.clip(gt + rng.randn(*gt.shape) * 8, 0, 255).astype(
        np.float32)
    savemat(tmp_path / "noisy.mat", {"ValidationNoisyBlocksSrgb": noisy})
    savemat(tmp_path / "gt.mat", {"ValidationGtBlocksSrgb": gt})
    droot = tmp_path / "derain"
    for dset, n in {"Rain100L": 2, "Test100": 3}.items():
        for sub in ("input", "target"):
            (droot / dset / sub).mkdir(parents=True)
        for i in range(n):
            clean = _rgb(rng, (20, 22))
            rain = np.clip(clean + rng.randn(20, 22, 3) * 20, 0,
                           255).astype(np.uint8)
            Image.fromarray(rain).save(droot / dset / "input" / f"r{i}.jpg")
            Image.fromarray(clean).save(droot / dset / "target" /
                                        f"r{i}.jpg")
    res = {}
    for name, mod, dev in (("jax", jre, []), ("port", tre,
                                              ["--device", "cpu"])):
        args = mod.get_args_parser().parse_args(_argv(
            synth, "sidd", tmp_path / name, ["--batch_size", "4"] + dev))
        args.sidd_mat = str(tmp_path / "noisy.mat")
        args.sidd_gt_mat = str(tmp_path / "gt.mat")
        sidd = mod.run_sidd_mat(args, _Echo())
        args.derain_root = str(droot)
        args.output_dir = str(tmp_path / name / "derain")
        res[name] = (sidd, mod.run_derain_sweep(args, _Echo()), loadmat(
            tmp_path / name / "Idenoised.mat")["Idenoised"])
    _assert_metrics_equal(res["port"][0], res["jax"][0])
    _assert_metrics_equal(res["port"][1], res["jax"][1])
    assert res["port"][1]["num_images"] == 5
    np.testing.assert_array_equal(res["port"][2], res["jax"][2])


@pytest.fixture(scope="module")
def panoptic_pngs(synth, models):
    """A 2-image COCO-panoptic GT (two things and one stuff segment each);
    its instance / semantic PNGs painted by the JAX package (``pred``) and
    painted from the GT itself (``perfect``)."""
    root = synth / "pano"
    hw = (48, 64)
    rng = np.random.RandomState(1)
    categories = [{"id": 1000 + i, "isthing": 1} for i in range(80)] + \
                 [{"id": 2000 + i, "isthing": 0} for i in range(53)]
    pal = coco_semseg_palette()
    for d in ("images", "gt", "perfect_inst", "perfect_sem"):
        (root / d).mkdir(parents=True)
    annotations = []
    for i in range(2):
        name = f"im{i}.png"
        Image.fromarray(_rgb(rng, hw)).save(root / "images" /
                                           f"im{i}.jpg")
        ids = np.full(hw, 3, np.uint32)
        sem = np.full(hw, 80 + i, np.int64)
        segs = [{"id": 3, "category_id": 2000 + i}]
        masks = np.zeros((2,) + hw, np.float32)
        for t, (y0, x0) in enumerate(((4, 6), (24, 30))):
            y0, x0 = y0 + rng.randint(0, 6), x0 + rng.randint(0, 6)
            ids[y0:y0 + 16, x0:x0 + 20] = t + 1
            masks[t, y0:y0 + 16, x0:x0 + 20] = 1
            cat = int(rng.randint(0, 80))
            sem[y0:y0 + 16, x0:x0 + 20] = cat
            segs.append({"id": t + 1, "category_id": 1000 + cat})
        Image.fromarray(np.stack([ids % 256, ids // 256, ids * 0], -1)
                        .astype(np.uint8)).save(root / "gt" / name)
        Image.fromarray(jprep.paint_instances(masks, hw)).save(
            root / "perfect_inst" / name)
        Image.fromarray(pal[sem].astype(np.uint8)).save(
            root / "perfect_sem" / name)
        annotations.append({"file_name": name, "segments_info": segs})
    gt_json = root / "gt.json"
    gt_json.write_text(json.dumps({"categories": categories,
                                   "annotations": annotations}))
    for task, target, out in (("coco_inst", "perfect_inst", "pred_inst"),
                              ("coco_semseg", "perfect_sem", "pred_sem")):
        args = jre.get_args_parser().parse_args([
            "--task", task, "--model", "tiny_test",
            "--image_dir", str(root / "images"),
            "--prompt_image", str(root / "images" / "im0.jpg"),
            "--prompt_target", str(root / target / "im0.png"),
            "--input_size", "32", "--batch_size", "2",
            "--output_dir", str(root / out)])
        jre.paint_predictions(args, models[0])
    return root, str(root / "gt"), str(gt_json)


@pytest.mark.parametrize("extra", [
    [],
    ["--post_type", "minmax"],
    ["--mode", "instance_ap"],
    ["--mode", "instance_ap", "--post_type", "minmax"],
    ["--mode", "instance_ap", "--with_nms", "--nms_type", "matrix"],
    ["--mode", "instance_ap", "--with_nms", "--nms_type", "soft"],
])
@pytest.mark.parametrize("pngs", ["pred", "perfect"])
def test_run_panoptic_matches_jax(panoptic_pngs, extra, pngs):
    root, gt_dir, gt_json = panoptic_pngs
    argv = ["--inst_dir", str(root / f"{pngs}_inst"),
            "--semseg_dir", str(root / f"{pngs}_sem"),
            "--gt_json", gt_json, "--gt_dir", gt_dir,
            "--stuff_area_thresh", "100", *extra]
    got = trp.evaluate(trp.get_args_parser().parse_args(
        argv + ["--device", "cpu"]))
    ref = jrp.evaluate(jrp.get_args_parser().parse_args(argv))
    assert ref["n_images"] == 2
    if pngs == "perfect":
        key = "AP" if "instance_ap" in extra else "PQ_th"
        assert ref[key] == pytest.approx(100.0), ref
    _assert_metrics_equal(got, ref)


def test_run_pose_matches_jax(synth, painted, tmp_path):
    ja, _, _, _ = painted("pose", 2)
    pose = synth / "pose"
    for flip in ([], ["--flip_test"]):
        argv = ["--pred_dir", ja.output_dir, "--meta_json",
                str(pose / "meta.json"), "--gt_json", str(pose / "gt.json"),
                *flip]
        got = trpose.evaluate(trpose.get_args_parser().parse_args(argv))
        ref = jrpose.evaluate(jrpose.get_args_parser().parse_args(argv))
        _assert_metrics_equal(got, ref)
    # a crop painted from its own keypoints scores a non-trivial AP
    rng = np.random.RandomState(0)
    kpts = np.zeros((17, 3), np.float32)
    kpts[:, 0] = rng.uniform(30, 160, 17)
    kpts[:, 1] = rng.uniform(30, 220, 17)
    kpts[:, 2] = 2
    (tmp_path / "pred").mkdir()
    heat = jprep.gaussian_heatmaps(kpts, (256, 192), sigma=8.0)
    Image.fromarray(jprep.paint_pose_crop(heat)).save(
        tmp_path / "pred" / "c0.png")
    (tmp_path / "meta.json").write_text(json.dumps([{
        "key": "c0", "image_id": 1, "center": [96.0, 128.0],
        "scale": [0.96, 1.28], "bbox_score": 0.99}]))
    (tmp_path / "gt.json").write_text(json.dumps({"annotations": [{
        "image_id": 1, "num_keypoints": 17, "area": 192.0 * 256.0,
        "keypoints": kpts.reshape(-1).tolist()}]}))
    argv = ["--pred_dir", str(tmp_path / "pred"), "--meta_json",
            str(tmp_path / "meta.json"), "--gt_json",
            str(tmp_path / "gt.json")]
    got = trpose.evaluate(trpose.get_args_parser().parse_args(argv))
    ref = jrpose.evaluate(jrpose.get_args_parser().parse_args(argv))
    assert ref["AP"] > 95.0
    _assert_metrics_equal(got, ref)


def test_sharding_splits_files_as_jax(synth, tmp_path):
    for shard in (0, 1):
        names = []
        for mod, dev in ((jre, []), (tre, ["--device", "cpu"])):
            args = mod.get_args_parser().parse_args(_argv(
                synth, "lol", tmp_path / f"{mod.__name__}{shard}",
                ["--num_shards", "2", "--shard", str(shard),
                 "--batch_size", "2"] + dev))
            names.append([os.path.basename(p) for p, _ in
                          mod.paint_predictions(args, _Echo())])
        assert names[0] == names[1] and len(names[0]) == 2 - shard


def test_main_writes_the_files_jax_writes(synth, tmp_path, monkeypatch):
    out = {}
    for name, mod, dev in (("jax", jre, []),
                           ("port", tre, ["--device", "cpu"])):
        argv = _argv(synth, "depth", tmp_path / name,
                     ["--batch_size", "2"] + dev)
        monkeypatch.setattr(sys, "argv", [name] + argv)
        mod.main()
        out[name] = sorted(os.listdir(tmp_path / name))
        with open(tmp_path / name / "metrics.json") as f:
            out[name + "_metrics"] = set(json.load(f))
    assert out["port"] == out["jax"]
    assert out["port_metrics"] == out["jax_metrics"] >= {"rmse", "abs_rel"}
    png = Image.open(tmp_path / "port" / "im0.png")
    assert png.size == (640, 480)
    assert png.mode == Image.open(tmp_path / "jax" / "im0.png").mode


def test_refusals(synth, monkeypatch):
    argv = _argv(synth, "ade20k_semseg", synth / "unused")
    # --n_dp above the local card count (one card, as JAX's check)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(SystemExit, match="--n_dp 2 > 1 local devices"):
            tre.build_model(tre.get_args_parser().parse_args(
                argv + ["--n_dp", "2", "--device", "cuda"]))
    # no card here: the default device is cuda, and it raises
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tre.build_model(tre.get_args_parser().parse_args(argv))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tre.build_model(argparse.Namespace(**vars(
            tre.get_args_parser().parse_args(argv))), device="cuda")
    # the other drivers with device state default to cuda as well
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trp.main(["--inst_dir", str(synth), "--semseg_dir", str(synth),
                  "--gt_json", str(synth / "missing.json"), "--gt_dir",
                  str(synth)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        treh.main(["--root", str(synth / "reh"), "--tasks", "pose",
                   "--n_images", "1", "--model", "tiny_test"])
    from painter_tpu_torch.ops.nms import mask_matrix_nms
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mask_matrix_nms(np.ones((2, 4, 4)), np.zeros(2), np.ones(2))


def test_n_dp_paints_what_one_device_paints(synth, painted):
    """``--n_dp 2 --device cpu`` (two replicas, each painting its half of
    every batch of 2, the ragged tail padded) paints the PNGs of
    ``--n_dp 1``, as the JAX run_eval's dp case does; the model's
    ``--batch_size 1`` takes the batched path under a mesh, as in JAX."""
    _, _, ta, outs = painted("ade20k_semseg", 2)
    for bs in ("2", "1"):
        args = tre.get_args_parser().parse_args(_argv(
            synth, "ade20k_semseg", synth / f"port_dp_{bs}",
            ["--batch_size", bs, "--n_dp", "2", "--device", "cpu"]))
        model = tre.build_model(args)
        assert model.n_dp == 2 and model.mesh == [torch.device("cpu")] * 2
        got = tre.paint_predictions(args, model)
        assert len(got) == len(outs) == 3
        for (_, a), (_, b) in zip(got, outs):
            np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                          np.asarray(Image.open(b)))


def test_cli_flags_match_jax():
    """The JAX driver's flags and defaults, plus ``--device``."""
    mine = {a.dest: a.default for a in tre.get_args_parser()._actions}
    theirs = {a.dest: a.default for a in jre.get_args_parser()._actions}
    assert mine.pop("device") == "cuda"
    assert mine == theirs
    mine = {a.dest: a.default for a in trp.get_args_parser()._actions}
    theirs = {a.dest: a.default for a in jrp.get_args_parser()._actions}
    assert mine.pop("device") == "cuda"
    assert mine == theirs
    assert {a.dest: a.default for a in trpose.get_args_parser()._actions} \
        == {a.dest: a.default for a in jrpose.get_args_parser()._actions}


def test_other_input_size_skips_the_rel_pos_tables_as_jax(synth):
    """At another --input_size (560 for COCO panoptic) both packages build
    the rel-pos tables at the new grid, so a checkpoint's tables, sized
    for 448, are skipped and stay at their zero init; the pos-embed is
    interpolated. The port keeps the JAX package's behaviour (ROADMAP,
    Queue 3)."""
    argv = _argv(synth, "coco_inst", synth / "unused")
    argv[argv.index("--input_size") + 1] = "40"
    jax_model = jre.build_model(jre.get_args_parser().parse_args(argv))
    port = tre.build_model(tre.get_args_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert port.cfg.img_size == (80, 40)
    jtab = np.asarray(jax_model.params["blocks"]["attn"]["rel_pos_h"])
    ttab = port.model.blocks[0].attn.rel_pos_h.detach().numpy()
    assert jtab.shape[1:] == ttab.shape == (2 * 10 - 1, 16)
    assert not jtab.any() and not ttab.any()
    sd = torch.load(synth / "tiny.pth", weights_only=False)["model"]
    assert sd["blocks.0.attn.rel_pos_h"].shape[0] == 2 * 8 - 1
    np.testing.assert_array_equal(
        port.model.blocks[0].attn.qkv.weight.detach().numpy(),
        sd["blocks.0.attn.qkv.weight"].numpy())
