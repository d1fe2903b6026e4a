"""PyTorch port: ``python -m painter_tpu_torch.dryrun 2 --procs 2
--device cpu`` (the counterpart of ``__graft_entry__.py --dryrun``): two
gloo ranks on the host (single-threaded, killed on a timeout) take a
sharded train step, sync their meters, serve a ragged batch over a dp
mesh and plan the flagship's fsdp shards on the ``meta`` device. Its
refusals: no card without ``--device cpu``, ``--procs`` other than N."""
import os
import re
import subprocess
import sys

import pytest
import torch

from painter_tpu_torch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def two_ranks():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "painter_tpu_torch.dryrun", "2", "--procs",
         "2", "--device", "cpu"], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    return out


def test_sharded_step_and_meter_sync(two_ranks):
    step = re.search(r"dryrun\(2\) rank 0: mesh \{'dp': 1, 'fsdp': 2\} on "
                     r"cpu, loss=(\S+) grad_norm=(\S+) step=1, (\d+) "
                     r"parameters' moments sharded", two_ranks)
    assert step, two_ranks
    loss = float(step.group(1))
    assert loss > 0 and float(step.group(2)) > 0 and int(step.group(3)) > 0
    sync = re.search(r"2-process meter sync ok \(mean=(\S+)\)", two_ranks)
    assert sync and abs(float(sync.group(1)) - (loss + 0.5)) < 1e-3


def test_dp_serving_and_flagship_plan(two_ranks):
    assert "dp-sharded serving batch (3, 80, 80, 3) finite, the same on " \
        "all 2 processes" in two_ranks
    plan = re.search(r"flagship ViT-L 896x448 on mesh \{'dp': 1, 'fsdp': "
                     r"2\}: (\d+) of (\d+) parameters sharded over fsdp 2; "
                     r"per rank (\S+) GB of fp32 parameters \(whole\), "
                     r"(\S+) GB of fsdp slices, (\S+) GB of AdamW moments",
                     two_ranks)
    assert plan, two_ranks
    sharded, total = int(plan.group(1)), int(plan.group(2))
    whole, slices, moments = map(float, plan.group(3, 4, 5))
    assert 0 < sharded < total
    # ViT-L: ~0.37 G parameters; most of them in sharded tensors, whose
    # slices are half their size and whose moments are sharded
    assert 1.3 < whole < 1.6 and 0.4 * whole < slices < 0.5 * whole
    assert 1.0 * whole < moments < 1.1 * whole
    assert two_ranks.rstrip().endswith(
        "dryrun(2): 2 real processes over gloo on cpu, cpu: rendezvous, "
        "sharded step, meter sync, dp serving and the flagship plan all ok")


def test_refusals(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["2"])
    with pytest.raises(ValueError, match="--procs must be 2"):
        dryrun.main(["2", "--procs", "1", "--device", "cpu"])
    assert dryrun.rank_placement(3, "cpu") == ("gloo", ["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cards, want in ((1, ("gloo", ["cuda:0", "cuda:0"])),
                        (2, ("nccl", ["cuda:0", "cuda:1"])),
                        (4, ("nccl", ["cuda:0", "cuda:1"]))):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        assert dryrun.rank_placement(2) == want
