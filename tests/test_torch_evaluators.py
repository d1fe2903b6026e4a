"""PyTorch port: the host-side evaluators (``evals/coco_ap.py``,
``pose.py``, ``panoptic.py``, ``depth.py``, ``restoration.py``) and the
five ``data/prep.py`` helpers the eval stack uses, against the JAX
package's on the same inputs. They are numpy in both packages, so every
result must be exactly equal, but for the decayed scores of the
class-wise matrix NMS: it runs through each package's ``ops/nms.py``,
whose ``exp`` may differ in the last bits, so those are held to 1e-6
relative (as in ``test_torch_decode_ops.py``).
"""
import types

import numpy as np
import pytest

from painter_tpu.data import prep as jprep
from painter_tpu.evals import coco_ap as jap
from painter_tpu.evals import depth as jdepth
from painter_tpu.evals import panoptic as jpan
from painter_tpu.evals import pose as jpose
from painter_tpu.evals import restoration as jrest
from painter_tpu_torch.data import prep as tprep
from painter_tpu_torch.evals import coco_ap as tap
from painter_tpu_torch.evals import depth as tdepth
from painter_tpu_torch.evals import panoptic as tpan
from painter_tpu_torch.evals import pose as tpose
from painter_tpu_torch.evals import restoration as trest

JAX = types.SimpleNamespace(ap=jap, depth=jdepth, pan=jpan, pose=jpose,
                            rest=jrest, prep=jprep, port=False)
PORT = types.SimpleNamespace(ap=tap, depth=tdepth, pan=tpan, pose=tpose,
                             rest=trest, prep=tprep, port=True)


def _blobs(rng, n, hw, lo=4, hi=14):
    h, w = hw
    masks = np.zeros((n, h, w), np.float32)
    for i in range(n):
        y0, x0 = rng.randint(0, h - hi), rng.randint(0, w - hi)
        masks[i, y0:y0 + rng.randint(lo, hi), x0:x0 + rng.randint(lo, hi)] = 1
    return masks


def case_coco_ap(m):
    rng = np.random.RandomState(0)
    hw = (40, 44)
    gts_masks = _blobs(rng, 5, hw)
    ev = m.ap.InstanceAPEvaluator()
    out = {}
    for img in range(3):
        dets_masks = np.concatenate([gts_masks[:4],
                                     _blobs(rng, 3, hw)]) > 0
        scores = rng.rand(7).astype(np.float32)
        labels = rng.randint(0, 3, 7)
        kw = {"device": "cpu"} if m.port else {}
        nms = m.ap.classwise_nms(dets_masks.astype(np.float32), labels,
                                 scores, "matrix", 0.6, **kw)
        soft = m.ap.classwise_nms(dets_masks.astype(np.float32), labels,
                                  scores, "soft", 0.6)
        out[f"nms{img}"] = (nms[0], nms[1])
        out[f"nms_scores{img}"] = nms[2]
        out[f"soft{img}"] = soft
        out[f"boxes{img}"] = m.ap.masks_to_boxes(dets_masks)
        out[f"iou{img}"] = m.ap.mask_iou_matrix(dets_masks, gts_masks,
                                                [False, True, False, False,
                                                 False])
        dets = [{"mask": d, "score": float(s), "category": int(c)}
                for d, s, c in zip(nms[0], nms[2], nms[1])]
        gts = [{"mask": g > 0, "category": int(c), "iscrowd": int(i == 1),
                "area": float(g.sum())}
               for i, (g, c) in enumerate(zip(gts_masks,
                                              rng.randint(0, 3, 5)))]
        ev.add_image(dets, gts)
    out["ap"] = ev.evaluate()
    return out


def case_pose(m):
    rng = np.random.RandomState(1)
    kpts = np.zeros((17, 3), np.float32)
    kpts[:, 0] = rng.uniform(20, 170, 17)
    kpts[:, 1] = rng.uniform(20, 230, 17)
    kpts[:, 2] = 2
    kpts[3, 2] = 0
    crops = []
    for _ in range(2):
        heat = m.prep.gaussian_heatmaps(kpts + rng.uniform(-4, 4, (17, 3)) *
                                        [1, 1, 0], (256, 192), sigma=8.0)
        crops.append(m.prep.paint_pose_crop(heat).astype(np.float32))
    heat = m.pose.decode_painted_heatmaps(np.stack(crops))
    merged = m.pose.merge_flip_test(heat[:1], heat[1:])
    center = np.asarray([[96.0, 128.0]], np.float32)
    scale = np.asarray([[0.96, 1.28]], np.float32)
    preds, maxvals = m.pose.keypoints_from_heatmaps(merged, center, scale)
    kp = np.concatenate([preds[0], maxvals[0]], -1)
    poses = [{"keypoints": kp + rng.uniform(-3, 3, kp.shape) * [1, 1, 0],
              "score": float(rng.rand()), "area": 192.0 * 256.0}
             for _ in range(4)]
    kept = m.pose.oks_nms(poses, thr=0.9)
    ev = m.pose.KeypointAPEvaluator()
    ev.add_image(kept, [{"keypoints": kpts, "area": 192.0 * 256.0}])
    oks = m.pose.compute_oks(kp[:, :2], kpts[:, :2], kpts[:, 2],
                             192.0 * 256.0)
    return {"heat": heat, "merged": merged, "preds": preds,
            "maxvals": maxvals, "kept": kept, "oks": oks,
            "ap": ev.evaluate()}


def case_panoptic(m):
    rng = np.random.RandomState(2)
    hw = (48, 56)
    masks = _blobs(rng, 6, hw, 8, 20)
    scores = rng.uniform(0.4, 1.0, 6).astype(np.float32)
    classes = rng.randint(0, 4, 6).astype(np.int32)
    sem = rng.randint(80, 84, hw).astype(np.int64)
    sem[rng.rand(*hw) < 0.3] = rng.randint(0, 4)
    pan, segs = m.pan.combine_semantic_and_instance(
        masks, scores, classes, sem, 0.5, 100, 0.55, 80)
    gt_ids = np.full(hw, 9, np.int64)
    gt_segs = [{"id": 9, "category_id": 81, "isthing": False}]
    for i in range(4):
        gt_ids[masks[i] > 0] = i + 1
        gt_segs.append({"id": i + 1, "category_id": int(classes[i]),
                        "isthing": True})
    stat = m.pan.PQStat()
    stat.process_image(pan, segs, gt_ids, gt_segs)
    dist = rng.rand(*hw, 133).astype(np.float32)
    return {"pan": pan, "segs": segs, "pq": stat.evaluate(),
            "vote": m.pan.vote_instance_classes(masks, dist, 80)}


def case_depth(m):
    rng = np.random.RandomState(3)
    ev = m.depth.DepthEvaluator(min_depth=1e-3, max_depth=10.0,
                                eigen_crop=True)
    for _ in range(2):
        gt = rng.uniform(0.5, 9.0, (480, 640))
        gt[rng.rand(480, 640) < 0.1] = 0.0
        ev.process(gt * rng.uniform(0.8, 1.2, gt.shape), gt)
    png = (rng.rand(20, 24) * 9000).astype(np.int32)
    gt = rng.uniform(0.5, 9.0, 50)
    return {"eval": ev.evaluate(),
            "errors": m.depth.compute_errors(gt, gt * 1.1),
            "meters": m.depth.depth_png_to_meters(png)}


def case_restoration(m):
    rng = np.random.RandomState(4)
    ev = m.rest.RestorationEvaluator(data_range=1.0)
    for _ in range(2):
        gt = rng.rand(30, 34, 3)
        pred = np.clip(gt + rng.randn(*gt.shape) * 0.05, 0, 1)
        ev.process(pred, gt)
    return {"eval": ev.evaluate(), "psnr": m.rest.psnr(pred, gt),
            "ssim": m.rest.ssim(pred, gt)}


def case_prep(m):
    rng = np.random.RandomState(5)
    masks = _blobs(rng, 5, (60, 80))
    masks[2] = 0  # an empty mask is skipped
    kpts = np.concatenate([rng.uniform(10, 180, (17, 2)),
                           rng.randint(0, 3, (17, 1))], -1)
    heat = m.prep.gaussian_heatmaps(kpts, (256, 192), sigma=6.0)
    png = rng.randint(0, 256, (7, 9, 3)).astype(np.uint8)
    return {"ids": m.prep.panoptic_png_to_ids(png),
            "center": m.prep.mass_center(masks[0]),
            "inst": m.prep.paint_instances(masks, (60, 80)),
            "heat": heat, "pose": m.prep.paint_pose_crop(heat)}


@pytest.mark.parametrize("case", [case_coco_ap, case_pose, case_panoptic,
                                  case_depth, case_restoration, case_prep],
                         ids=lambda f: f.__name__[5:])
def test_host_evaluators_equal_jax(case):
    got, ref = case(PORT), case(JAX)
    for key in [k for k in ref if k.startswith("nms_scores")]:
        np.testing.assert_allclose(got.pop(key), ref.pop(key), rtol=1e-6,
                                   atol=0)
    np.testing.assert_equal(got, ref)

