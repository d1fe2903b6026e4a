"""PyTorch port: the tools of ``painter_tpu_torch/utils`` against their
JAX counterparts, on the CPU.

- ``parity``: the CLI passes on a tiny model and fails at tolerance 0,
  restores the TF32 switches, loads a ``.pth`` and needs a card unless
  asked for the CPU;
- ``component_profile``: the JAX tool's keys (``tests/test_utils.py``'s
  smoke sets), finite, on a tiny model at n1=1, n2=2, reps=1;
- ``profiling``: ``StepTimer`` gives a rate exactly where JAX's does,
  ``device_memory_stats(["cpu"])`` one entry with no keys, ``trace``
  writes a trace;
- ``kernel_stage_profile``: every stage variant's edits apply to the
  current K1 / K2 sources (checked without ``nvcc``), and the stage lists
  are JAX's.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.kernels import build
from painter_tpu_torch.models import incontext_vit as tm
from painter_tpu_torch.utils import component_profile as cp
from painter_tpu_torch.utils import kernel_stage_profile as ksp
from painter_tpu_torch.utils import kernel_variants as kv
from painter_tpu_torch.utils import parity, profiling

TINY = ["--model", "tiny_test", "--device", "cpu", "--attn_impl", "plain"]


def _parity(capsys, *argv):
    with pytest.raises(SystemExit) as exc:
        parity.main([*TINY, *argv])
    return exc.value.code, capsys.readouterr().out


def test_parity_cli_passes_and_fails_at_zero_tolerance(capsys):
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        code, out = _parity(capsys)
        assert code == 0, out
        lines = out.strip().splitlines()
        assert lines[0].startswith("painted-output max abs err: ")
        assert lines[1].startswith("loss abs err: ")
        assert lines[-1] == "PARITY OK"
        assert float(lines[0].split()[-1]) < 1e-4
        # the switches the check turned off are back as they were
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        code, out = _parity(capsys, "--tolerance", "0")
        assert code == 1 and out.strip().splitlines()[-1] == "PARITY FAILED"
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def test_parity_cli_loads_a_checkpoint_and_the_kernel_route(tmp_path,
                                                            capsys):
    cfg = tcfg.tiny_test_config(dtype="float32")
    model = tm.build_model(cfg, torch.Generator().manual_seed(7),
                           device="cpu")
    path = str(tmp_path / "tiny.pth")
    torch.save({"model": model.state_dict()}, path)
    code, out = _parity(capsys, "--ckpt_path", path, "--batch", "2")
    assert code == 0 and f"loaded {path}" in out, out
    # on the CPU the kernel route is K1's plain version
    with pytest.raises(SystemExit) as exc:
        parity.main(["--model", "tiny_test", "--device", "cpu"])
    assert exc.value.code == 0


def test_parity_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parity.main(["--model", "tiny_test"])


# the key sets tests/test_utils.py::test_component_profile_smoke asserts
# of the JAX tool
FWD_KEYS = {"block_ms", "mlp_ms", "ln_ms", "qkv_proj_ms"}
BWD_KEYS = {"block_ms", "attn_sub_ms", "mlp_sub_ms", "decoder_ms",
            "loss_ms", "patch_embed_ms"}


@pytest.mark.parametrize("attn_impl,extra_fwd,extra_bwd", [
    ("plain", set(), set()),
    ("kernel", {"flash_kernel_ms"}, {"kernel_ms"})])
def test_component_profile_keys(attn_impl, extra_fwd, extra_bwd):
    cfg = tcfg.tiny_test_config()
    fwd = cp.profile_forward(cfg, batch=2, attn_impl=attn_impl, n1=1, n2=2,
                             reps=1, device="cpu")
    assert set(fwd) == FWD_KEYS | extra_fwd
    assert all(np.isfinite(v) for v in fwd.values())
    bwd = cp.profile_backward(cfg, batch=2, attn_impl=attn_impl, n1=1,
                              n2=2, reps=1, device="cpu")
    assert set(bwd) == BWD_KEYS | extra_bwd
    assert all(np.isfinite(v) for v in bwd.values())


def test_component_profile_cli_and_its_checks(capsys):
    res = cp.main(["--preset", "tiny_test", "--batch", "2", "--dtype",
                   "float32", "--n1", "1", "--n2", "2", "--reps", "1",
                   "--device", "cpu", "--remat_policy", "none",
                   "--attn_impl", "plain"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "PROFILE " + json.dumps(res)
    assert any(x.startswith("FWD ") for x in lines)
    assert any(x.startswith("BWD ") for x in lines)
    assert set(res["fwd"]) == FWD_KEYS and set(res["bwd"]) == BWD_KEYS
    cfg = tcfg.tiny_test_config()
    with pytest.raises(ValueError, match="remat_policy"):
        cp.profile_backward(cfg, remat_policy="save_everything",
                            device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        cp.profile_forward(cfg, attn_impl="pallas", device="cpu")


def test_component_profile_timing_primitives():
    """The chain's slope and the gradient chain's fetch: each layer of
    the chain is its own copy, and every gradient is computed."""
    lin = torch.nn.Linear(4, 4)
    x = torch.randn(2, 4)
    assert np.isfinite(cp.chain_slope_ms(lambda c, m: torch.tanh(m(c)), x,
                                         lin, n1=1, n2=3, reps=1))
    seen = []

    def body(c, layer):
        seen.append(id(layer))
        return torch.tanh(layer(c))

    cp.grad_chain_time(body, x, lin, n=3, reps=1)
    assert len(set(seen)) == 3 and id(lin) not in seen
    g = cp.global_norm([torch.full((2,), 3.0), torch.full((1,), 4.0)])
    assert torch.isclose(g, torch.tensor(float(np.sqrt(34.0))))
    with pytest.raises(FloatingPointError):
        cp.grad_chain_time(lambda c, m: m(c) * float("nan"), x, lin, n=1,
                           reps=1)


def test_step_timer_matches_jax():
    from painter_tpu.utils.profiling import StepTimer as JaxStepTimer
    ours, theirs = profiling.StepTimer(sync_every=2), JaxStepTimer(2)
    got = [ours.step(torch.ones(1)) for _ in range(6)]
    want = [theirs.step(None) for _ in range(6)]
    assert [r is None for r in got] == [r is None for r in want]
    assert [r is None for r in got] == [True, False] * 3
    assert all(r > 0 for r in got if r is not None)
    assert ours.rate == got[-1]


def test_device_memory_stats():
    assert profiling.device_memory_stats(["cpu"]) == {"cpu": {}}
    from painter_tpu.utils.profiling import device_memory_stats
    for stats in device_memory_stats().values():
        assert set(stats) <= {"bytes_in_use", "peak_bytes_in_use",
                              "bytes_limit"}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert prof is not None
    files = glob.glob(str(tmp_path / "tr" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


def test_stage_variants_apply_to_the_sources(tmp_path):
    """Every K1 / K2 stage variant's edits find each string they edit
    exactly once, in order, in the current sources."""
    from painter_tpu.utils import kernel_stage_profile as jksp
    assert ksp.FWD_STAGES == jksp.FWD_STAGES
    assert ksp.BWD_STAGES == jksp.BWD_STAGES
    variants = ksp.variants()
    assert set(variants) == ({f"fwd_{s}" for s in ksp.FWD_STAGES}
                             | {f"bwd_{s}" for s in ksp.BWD_STAGES})
    for name, (source, edits) in variants.items():
        dst = tmp_path / name
        kv.apply_edits(edits, str(dst))
        (fname, pairs), = edits.items()
        assert fname == f"{source}.cu"
        text = (dst / fname).read_text()
        with open(os.path.join(build.CSRC, fname)) as f:
            real = f.read()
        assert (text == real) == (name.endswith("_full")), name
    # the backward's stages drop cumulatively, the forward's one each
    for a, b in zip(ksp.BWD_STAGES, ksp.BWD_STAGES[1:]):
        assert ksp.BWD_EDITS[b][:len(ksp.BWD_EDITS[a])] == ksp.BWD_EDITS[a]
    assert all(len(ksp.FWD_EDITS[s]) for s in ksp.FWD_STAGES[1:])


def test_stage_profile_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ksp.profile(qh=8, qw=8, batch=1, heads=1)
