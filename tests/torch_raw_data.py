"""Small synthetic raw datasets in their own formats, for the PyTorch
port's data-front-end tests (``test_torch_prep.py``,
``test_torch_trainset_gen.py``): COCO panoptic, COCO person keypoints,
ADE20K label PNGs, SIDD pairs and an NYUv2 labeled ``.mat``. Each is made
from a seed with numpy; sizes are cut for CPU time, formats are not."""
import json
import os

import numpy as np
from PIL import Image


def _smooth_image(rng, h, w):
    small = (rng.rand(max(h // 8, 2), max(w // 8, 2), 3) * 255).astype(
        np.uint8)
    return np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC))


def make_panoptic(root, hw=(48, 64), seed=0):
    """images/*.jpg, panoptic/*.png and panoptic.json: image 0 with two
    things, a crowd thing and a stuff band; image 1 with stuff only (no
    things, so every copy of it is skipped); image 2 with a thing on the
    border. Ids span the G channel (id >= 256)."""
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "panoptic"))
    rng = np.random.RandomState(seed)
    h, w = hw
    images, annotations = [], []
    layouts = ((("thing", 6, 4, 18, 26), ("thing", 22, 32, 18, 26),
                ("crowd", 30, 2, 10, 12)), (), (("thing", 0, 40, 20, 24),))
    for i, things in enumerate(layouts):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8) if i != 2 \
            else _smooth_image(rng, h, w)
        Image.fromarray(img).save(os.path.join(root, "images",
                                               f"im{i}.jpg"))
        ids = np.zeros((h, w), np.uint32)
        segs = []
        seg_id = 300 + 7 * i
        for kind, y0, x0, sh, sw in things:
            ids[y0:y0 + sh, x0:x0 + sw] = seg_id
            segs.append({"id": seg_id, "category_id": 1 + len(segs),
                         "iscrowd": int(kind == "crowd")})
            seg_id += 1
        ids[:4, :] = seg_id  # stuff band
        segs.append({"id": seg_id, "category_id": 200, "iscrowd": 0})
        png = np.stack([ids % 256, (ids // 256) % 256, ids // 256 ** 2],
                       -1).astype(np.uint8)
        Image.fromarray(png).save(os.path.join(root, "panoptic",
                                               f"im{i}.png"))
        annotations.append({"image_id": 10 + i, "file_name": f"im{i}.png",
                            "segments_info": segs})
        images.append({"id": 10 + i, "file_name": f"im{i}.jpg"})
    categories = [{"id": c, "isthing": 1} for c in (1, 2, 3)] + \
        [{"id": 200, "isthing": 0}]
    with open(os.path.join(root, "panoptic.json"), "w") as f:
        json.dump({"annotations": annotations, "images": images,
                   "categories": categories}, f)
    return root


def make_keypoints(root, hw=(96, 128), seed=1):
    """images/*.jpg and kp.json: two people in image 5 (one with an
    unlabeled joint), a crowd box and a box with no keypoints (both
    filtered), one person in image 6."""
    os.makedirs(os.path.join(root, "images"))
    rng = np.random.RandomState(seed)
    h, w = hw
    images, anns = [], []
    for img_id in (5, 6):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"p{img_id}.jpg"))
        images.append({"id": img_id, "file_name": f"p{img_id}.jpg"})

    def person(ann_id, img_id, box, unlabeled=()):
        x, y, bw, bh = box
        k = np.zeros((17, 3), np.float32)
        k[:, 0] = rng.uniform(x + 2, x + bw - 2, 17)
        k[:, 1] = rng.uniform(y + 2, y + bh - 2, 17)
        k[:, 2] = 2
        for j in unlabeled:
            k[j] = 0
        return {"id": ann_id, "image_id": img_id, "iscrowd": 0,
                "area": float(bw * bh), "num_keypoints": int((k[:, 2] > 0)
                                                             .sum()),
                "bbox": [float(v) for v in box],
                "keypoints": k.ravel().tolist()}
    anns.append(person(11, 5, (25, 15, 70, 60), unlabeled=(3,)))
    anns.append(person(12, 5, (60, 30, 40, 50)))
    anns.append({"id": 13, "image_id": 5, "iscrowd": 1, "area": 99,
                 "num_keypoints": 0, "bbox": [0, 0, 10, 10],
                 "keypoints": [0] * 51})
    anns.append({"id": 14, "image_id": 6, "iscrowd": 0, "area": 40,
                 "num_keypoints": 0, "bbox": [5, 5, 8, 5],
                 "keypoints": [0] * 51})
    anns.append(person(15, 6, (10, 20, 50, 70)))
    with open(os.path.join(root, "kp.json"), "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    return root


def make_ade_labels(root, n=2, hw=(24, 30), seed=2):
    """ADE20K-style 1-based label PNGs (0 = ignore)."""
    os.makedirs(root)
    rng = np.random.RandomState(seed)
    for i in range(n):
        lab = rng.randint(0, 151, hw).astype(np.uint8)
        Image.fromarray(lab).save(os.path.join(root, f"ade_{i}.png"))
    return root


def make_sidd(root, n=2, hw=(40, 52), seed=3):
    """SIDD_Medium_Srgb layout: <scene>/{GT,NOISY}_SRGB_010.PNG."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        scene = os.path.join(root, f"000{i + 1}_scene")
        os.makedirs(scene)
        clean = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        noisy = np.clip(clean + rng.randn(*hw, 3) * 10, 0, 255).astype(
            np.uint8)
        Image.fromarray(clean).save(os.path.join(scene, "GT_SRGB_010.PNG"))
        Image.fromarray(noisy).save(os.path.join(scene,
                                                 "NOISY_SRGB_010.PNG"))
    return root


def make_nyu_mat(root, n=3, seed=4):
    """nyu.mat (HDF5, stored transposed as the official file) and
    split.mat (1-based train / test indexes)."""
    import h5py
    from scipy.io import savemat
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    h5p = os.path.join(root, "nyu.mat")
    with h5py.File(h5p, "w") as f:
        f["rawDepths"] = rng.rand(n, 640, 480).astype(np.float32) * 8
        f["images"] = (rng.rand(n, 3, 640, 480) * 255).astype(np.uint8)
        refs = []
        for i in range(n):
            s = f"scene_{i % 2}"
            d = f.create_dataset(f"#refs#/s{i}", data=np.array(
                [[ord(c)] for c in s], np.uint16))
            refs.append(d.ref)
        f["sceneTypes"] = np.array([refs], dtype=h5py.ref_dtype)
    split = os.path.join(root, "split.mat")
    savemat(split, {"trainNdxs": np.array([[1], [3]]),
                    "testNdxs": np.array([[2]])})
    return h5p, split


def tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out
