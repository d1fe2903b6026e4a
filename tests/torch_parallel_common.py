"""Shared pieces of the port's two-rank CPU tests
(``test_torch_parallel.py``, ``test_torch_parallel_jax.py``): the inputs,
the fixture that runs ``torch_dist_worker.py`` as two gloo ranks, and the
port's one-process update they are held to."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from painter_tpu import configs as jcfg
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD
from painter_tpu_torch.infer import engine as te
from painter_tpu_torch.models import convert
from painter_tpu_torch.train import optim as toptim
from painter_tpu_torch.train import step as tstep

from torch_port_common import jax_params_np, port_model, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Adam's eps 1e-5 keeps every element out of its sign-like regime, where a
# rounding difference in a near-zero gradient would move its update by lr
OC = dict(lr=1e-3, min_lr=1e-5, weight_decay=0.1, layer_decay=0.8,
          clip_grad=0.05, eps=1e-5, warmup_epochs=0.0, epochs=2.0,
          steps_per_epoch=2)


def _global_batches(cfg, seed):
    """Two updates of (accum 2, global batch 2) leaves. Rank 0 holds
    sample 0 of each micro-batch, rank 1 sample 1; the masks differ in
    size, and rank 1's first sample has a black target outside its mask
    (the near-black check zeroes it), so the ranks' masked counts differ."""
    rng = np.random.RandomState(seed)
    h, w = cfg.img_size
    length = cfg.num_patches
    black = ((0.0 - np.asarray(IMAGENET_MEAN)) /
             np.asarray(IMAGENET_STD)).astype(np.float32)
    batches = []
    for _ in range(2):
        imgs = rng.randn(2, 2, h, w, 3).astype(np.float32)
        tgts = rng.randn(2, 2, h, w, 3).astype(np.float32)
        mask = np.zeros((2, 2, length), np.float32)
        for a in range(2):
            for s, n in enumerate((length // 2, length // 4)):
                mask[a, s, rng.permutation(length)[:n]] = 1.0
        valid = np.ones_like(tgts)
        valid[:, :, :4] = 0.0
        batches.append({"imgs": imgs, "tgts": tgts, "mask": mask,
                        "valid": valid})
    batches[0]["tgts"][0, 1] = black
    return batches


def _serve_inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    res = cfg.img_size[1]
    img2 = rng.rand(res, res, 3).astype(np.float32)
    tgt2 = rng.rand(res, res, 3).astype(np.float32)
    queries = [rng.rand(res, res, 3) for _ in range(3)]  # ragged vs dp 2
    imgs, tgts = te.build_query_batch(queries, img2, tgt2)
    return {"imgs": imgs, "tgts": tgts, "real": 3,
            "queries": np.stack(queries).astype(np.float32),
            "queries_u8": (rng.rand(3, res, res, 3) * 255).astype(np.uint8),
            "img2": img2, "tgt2": tgt2}


SERVE_KW = dict(seg_type_tokens=True)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Spawns the two ranks once; returns (inputs, [rank 0, rank 1])."""
    root = tmp_path_factory.mktemp("two_ranks")
    cfg_j = jcfg.tiny_test_config()
    params = jax_params_np(cfg_j, seed=31)
    serve_params = jax_params_np(jcfg.tiny_test_config(**SERVE_KW), seed=32)
    cfg_t = tcfg.tiny_test_config()
    inputs = {
        "params": params, "oc": OC, "gen_seed": 3,
        "state_dict": convert.state_dict_from_jax_params(params, cfg_t),
        "batches": [{k: t(v) for k, v in b.items()}
                    for b in _global_batches(cfg_t, seed=33)],
        "serve": {**_serve_inputs(tcfg.tiny_test_config(**SERVE_KW), 34),
                  "cfg_kw": SERVE_KW, "state_dict":
                  convert.state_dict_from_jax_params(
                      serve_params, tcfg.tiny_test_config(**SERVE_KW))},
        "serve_params": serve_params}
    torch.save({k: v for k, v in inputs.items()
                if k not in ("params", "serve_params")},
               os.path.join(root, "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "2",
                               str(root)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
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
    return inputs, [torch.load(os.path.join(root, f"rank{r}.pt"),
                               weights_only=False) for r in range(2)]


def one_process(inputs, drop_path):
    """The port's one-process update at the global batch."""
    cfg = tcfg.tiny_test_config(drop_path_rate=drop_path)
    model = port_model(cfg, inputs["params"]).train()
    opt = toptim.LayerDecayAdamW(model, cfg, toptim.OptimConfig(**OC))
    step = tstep.make_train_step(cfg, opt, accum_iter=2)
    gen = torch.Generator().manual_seed(inputs["gen_seed"])
    metrics = [{k: float(v) for k, v in step(model, b, gen).items()}
               for b in inputs["batches"]]
    return model, opt, metrics


def close(got, ref, rtol, what):
    """max |got - ref| <= rtol x max |ref|."""
    err = (got - ref).abs().max().item()
    scale = max(ref.abs().max().item(), 1e-30)
    assert err <= rtol * scale, (what, err, scale)
