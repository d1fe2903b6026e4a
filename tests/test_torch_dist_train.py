"""PyTorch port: the training CLI as two processes over gloo on the CPU
(the port's counterpart of ``tests/test_distributed_multiprocess.py``).

Two ranks of ``python -m painter_tpu_torch.train.train --distributed
--platform cpu`` (single-threaded, a ``file://`` store in ``tmp_path``)
train the tiny model with ``--n_fsdp 2``: both print their rendezvous
line, only rank 0 prints the epoch stats and writes ``log.txt``,
``scalars.jsonl`` and the checkpoints, and the meters are summed over the
ranks. A second run, data-parallel (fsdp 1), auto-resumes from the
fsdp-2 checkpoint and takes no step. Then the checkpoint exports to a
reference ``.pth``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.models import incontext_vit as tm
from painter_tpu_torch.parallel.mesh import param_dim
from painter_tpu_torch.train import checkpoint as tckpt
from painter_tpu_torch.train import optim as toptim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def toy_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_toydata")
    rng = np.random.RandomState(0)
    pairs = []
    for i in range(16):
        ip, tp = f"img_{i}.png", f"tgt_{i}.png"
        for p in (ip, tp):
            Image.fromarray(
                (rng.rand(40, 36, 3) * 255).astype(np.uint8)).save(root / p)
        pairs.append({"image_path": ip, "target_path": tp,
                      "type": "derain_image2derain"})
    jp = root / "train.json"
    jp.write_text(json.dumps(pairs))
    return str(root), str(jp)


def _run(root, jp, out_dir, store, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "painter_tpu_torch.train.train",
         "--distributed", "--platform", "cpu",
         "--coordinator", f"file://{store}", "--num_processes", "2",
         "--process_id", str(r), "--data_path", root, "--json_path", jp,
         "--val_json_path", jp, "--output_dir", out_dir,
         "--model", "tiny_test", "--input_size", "64", "32",
         "--batch_size", "1", "--accum_iter", "2", "--epochs", "2",
         "--warmup_epochs", "1", "--num_mask_patches", "4",
         "--max_mask_patches_per_block", "4",
         "--min_mask_patches_per_block", "1", "--dtype", "float32",
         "--max_steps_per_epoch", "2", "--save_freq", "1",
         "--num_workers", "0", "--print_freq", "1", *extra],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def two_process_run(toy_data, tmp_path_factory):
    root, jp = toy_data
    tmp = tmp_path_factory.mktemp("dist_run")
    out_dir = str(tmp / "run")
    first = _run(root, jp, out_dir, tmp / "store1", "--n_fsdp", "2")
    second = _run(root, jp, out_dir, tmp / "store2")
    return out_dir, first, second


def test_two_process_training(two_process_run):
    out_dir, outs, _ = two_process_run
    assert "process 0/2 (cpu)" in outs[0]
    assert "process 1/2 (cpu)" in outs[1]
    assert "mesh: {'dp': 1, 'fsdp': 2}" in outs[0]
    # non-master print is silenced: the epoch stats only on rank 0
    assert "train_loss" in outs[0]
    assert "train_loss" not in outs[1]
    # 16 samples / (1 per rank x 2 ranks x accum 2) = 4, capped at 2
    assert "effective batch 4, 2 updates/epoch" in outs[0]
    lines = [json.loads(x) for x in open(os.path.join(out_dir, "log.txt"))]
    assert len(lines) == 2
    scalars = [json.loads(x)
               for x in open(os.path.join(out_dir, "scalars.jsonl"))]
    assert [s["step"] for s in scalars] == [0, 1, 2, 3]
    # each rank logged the same global losses; the summed meters keep
    # their mean
    for epoch, line in enumerate(lines):
        losses = [s["loss"] for s in scalars[2 * epoch:2 * epoch + 2]]
        assert np.isfinite(line["train_loss"])
        np.testing.assert_allclose(line["train_loss"], np.mean(losses),
                                   rtol=1e-6)
        assert np.isfinite(line["val_loss"])
    ckpts = sorted(os.listdir(os.path.join(out_dir, "checkpoints")))
    assert ckpts == ["checkpoint-2.pth", "checkpoint-4.pth"]


def test_two_process_auto_resume_at_another_fsdp_size(two_process_run):
    """The fsdp-2 checkpoint holds the whole optimizer state, so the
    data-parallel run resumes from it and takes no new step."""
    out_dir, _, outs = two_process_run
    assert "auto-resumed from step 4" in outs[0]
    assert "auto-resumed" not in outs[1]  # silenced, not skipped
    assert "mesh: {'dp': 2, 'fsdp': 1}" in outs[0]
    lines = [json.loads(x) for x in open(os.path.join(out_dir, "log.txt"))]
    assert len(lines) == 2
    # the moments in the checkpoint are whole, also where fsdp 2 sharded
    state = torch.load(os.path.join(out_dir, "checkpoints",
                                    "checkpoint-4.pth"), weights_only=False)
    cfg = tcfg.get_config("tiny_test", img_size=(64, 32))
    model = tm.build_model(cfg, device="cpu")
    params = [(n, p) for g in toptim.param_groups(model, cfg, 0.1, 0.8)
              for n, p in zip(g["names"], g["params"])]
    st = state["optimizer"]["adamw"]["state"]
    assert sorted(st) == list(range(len(params)))
    for i, (name, p) in enumerate(params):
        assert st[i]["exp_avg"].shape == p.shape, name
    assert any(param_dim(n, p.shape, 2) is not None for n, p in params)


def test_export_torch_checkpoint(two_process_run, tmp_path):
    out_dir, _, _ = two_process_run
    out = str(tmp_path / "export.pth")
    tckpt._export_cli(["--ckpt_dir", os.path.join(out_dir, "checkpoints"),
                       "--out", out])
    sd = torch.load(out, weights_only=False)
    assert set(sd) == {"model"}
    cfg = tcfg.get_config("tiny_test", img_size=(64, 32))
    model = tm.build_model(cfg, device="cpu")
    assert tckpt.load_torch_params(out, model) == []
    state = torch.load(os.path.join(out_dir, "checkpoints",
                                    "checkpoint-4.pth"), weights_only=False)
    for name, v in model.state_dict().items():
        assert torch.equal(v, state["model"][name]), name
    with pytest.raises(SystemExit, match="no checkpoint 7"):
        tckpt._export_cli(["--ckpt_dir", os.path.join(out_dir,
                                                      "checkpoints"),
                           "--step", "7", "--out", out])
