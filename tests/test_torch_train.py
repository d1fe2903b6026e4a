"""PyTorch port: the training slice against the JAX package on the CPU.

One set of weights (numpy, from a seed) goes through both packages. fp32;
tolerances: loss 1e-5 relative, each gradient 1e-4 x its own max abs
(sums in another order than XLA's over 6 blocks, forward and backward),
params after two optimizer updates 1e-5 absolute.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from painter_tpu import configs as jcfg
from painter_tpu.models import incontext_vit as jm
from painter_tpu.train import checkpoint as jckpt
from painter_tpu.train import optim as joptim
from painter_tpu.train import step as jstep
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.kernels import flash_relpos as fr
from painter_tpu_torch.models import convert
from painter_tpu_torch.models import incontext_vit as tm
from painter_tpu_torch.train import checkpoint as tckpt
from painter_tpu_torch.train import optim as toptim
from painter_tpu_torch.train import step as tstep
from painter_tpu_torch.train import train as ttrain

from torch_port_common import jax_params_np, port_model, stitched_batch, t

GRAD_RTOL = 1e-4


def _by_name(tree_np, cfg_t):
    """A JAX-structured tree (params or grads) under the port's names."""
    return {k: v.numpy() for k, v in
            convert.state_dict_from_jax_params(tree_np, cfg_t).items()}


def _grads_close(model, ref_by_name, rtol=GRAD_RTOL):
    for name, p in model.named_parameters():
        ref = ref_by_name[name]
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= rtol * max(np.abs(ref).max(), 1e-30), (name, err)


def _batch(cfg, n, seed, accum=1):
    imgs, tgts, mask = stitched_batch(cfg, n * accum, seed)
    valid = np.ones_like(tgts)
    valid[:, :4] = 0.0  # a few invalid rows: the loss reads valid
    batch = {"imgs": imgs, "tgts": tgts, "mask": mask, "valid": valid}
    if accum > 1:
        batch = {k: v.reshape((accum, n) + v.shape[1:])
                 for k, v in batch.items()}
    return batch


@pytest.mark.parametrize("variant", ["painter", "seggpt"])
def test_training_loss_and_grads_match_jax(variant):
    """(loss, every parameter's gradient) of forward(train=True) with
    drop-path 0 == jax.value_and_grad of the JAX model's."""
    kw = dict(seg_type_tokens=True) if variant == "seggpt" else {}
    cfg_j, cfg_t = jcfg.tiny_test_config(**kw), tcfg.tiny_test_config(**kw)
    params = jax_params_np(cfg_j, seed=3)
    b = _batch(cfg_j, 2, seed=4)
    st = np.asarray([[0], [1]], np.int32)

    def loss_fn(p):
        return jm.forward(p, cfg_j, b["imgs"], b["tgts"], b["mask"],
                          b["valid"], seg_type=st, train=True,
                          rng=jax.random.PRNGKey(0), attn_impl="xla")[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = port_model(cfg_t, params).train()
    loss_t, _, _ = tm.forward(
        model, t(b["imgs"]), t(b["tgts"]), t(b["mask"]), t(b["valid"]),
        seg_type=t(st, torch.long), train=True,
        generator=torch.Generator().manual_seed(0), remat=True)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    _grads_close(model, _by_name(jax.tree_util.tree_map(np.asarray, grads_j),
                                 cfg_t))


def _counting_plain_fwd(monkeypatch):
    calls = [0]
    plain = fr.flash_attention_relpos_reference

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(fr, "flash_attention_relpos_reference", counted)
    return calls


@pytest.mark.parametrize("remat,policy,fwd_calls", [
    (False, "save_kernel", 6), (True, "full", 12), (True, "save_kernel", 6)])
def test_remat_policies_same_grads_and_attention_calls(monkeypatch, remat,
                                                       policy, fwd_calls):
    """With drop-path on, full and save_kernel remat give the gradients of
    no remat (the masks are drawn outside each checkpointed block); the
    attention forward runs once per block under save_kernel and twice
    under full."""
    cfg = tcfg.tiny_test_config(drop_path_rate=0.5)
    params = jax_params_np(jcfg.tiny_test_config(), seed=5)
    b = _batch(cfg, 2, seed=6)

    def grads(remat_, policy_):
        model = port_model(cfg, params).train()
        loss, _, _ = tm.forward(
            model, t(b["imgs"]), t(b["tgts"]), t(b["mask"]), t(b["valid"]),
            train=True, generator=torch.Generator().manual_seed(9),
            remat=remat_, remat_policy=policy_)
        loss.backward()
        return (float(loss.detach()),
                {n: p.grad for n, p in model.named_parameters()})

    base_loss, base = grads(False, "full")
    calls = _counting_plain_fwd(monkeypatch)
    loss, got = grads(remat, policy)
    assert calls[0] == fwd_calls
    assert loss == base_loss
    for name in base:
        assert torch.equal(got[name], base[name]), name
    # drop-path was on: another generator seed gives another loss
    model = port_model(cfg, params).train()
    other, _, _ = tm.forward(model, t(b["imgs"]), t(b["tgts"]),
                             t(b["mask"]), t(b["valid"]), train=True,
                             generator=torch.Generator().manual_seed(10))
    assert float(other.detach()) != base_loss


def test_unported_remat_policy_raises():
    cfg = tcfg.tiny_test_config()
    oc = toptim.OptimConfig()
    opt = toptim.LayerDecayAdamW(tm.build_model(cfg, device="cpu"), cfg, oc)
    with pytest.raises(ValueError, match="not ported"):
        tstep.make_train_step(cfg, opt, remat_policy="save_dots")


def _oc(module, **kw):
    base = dict(lr=1e-3, min_lr=1e-5, weight_decay=0.1, layer_decay=0.8,
                clip_grad=0.05, eps=1e-5, warmup_epochs=0.0, epochs=2.0,
                steps_per_epoch=2)
    base.update(kw)
    return module.OptimConfig(**base)


def test_train_step_accum_two_updates_match_jax():
    """make_train_step with accum_iter=2, two updates: loss, grad_norm and
    the params match the JAX step + optax chain from the same params.
    The clip (0.05) is active; Adam's eps is 1e-5, far above the
    gradients' rounding differences, so that no element sits in Adam's
    sign-like regime, where a 1e-9 difference in a near-zero gradient
    would move its update by up to lr."""
    cfg_j, cfg_t = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    params = jax_params_np(cfg_j, seed=7)
    batches = [_batch(cfg_j, 2, seed=8 + i, accum=2) for i in range(2)]

    oc_j = _oc(joptim)
    optimizer_j = joptim.make_optimizer(params, cfg_j, oc_j)
    state = jstep.init_train_state(params, optimizer_j)
    step_j = jax.jit(jstep.make_train_step(cfg_j, optimizer_j, accum_iter=2))
    metrics_j = []
    for i, b in enumerate(batches):
        state, m = step_j(state, b, jax.random.PRNGKey(i))
        metrics_j.append({k: float(v) for k, v in m.items()})

    model = port_model(cfg_t, params).train()
    optimizer_t = toptim.LayerDecayAdamW(model, cfg_t, _oc(toptim))
    step_t = tstep.make_train_step(cfg_t, optimizer_t, accum_iter=2)
    for b, mj in zip(batches, metrics_j):
        mt = step_t(model, {k: t(v) for k, v in b.items()},
                    torch.Generator().manual_seed(0))
        np.testing.assert_allclose(float(mt["loss"]), mj["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]), mj["grad_norm"],
                                   rtol=1e-5)
    assert optimizer_t.count == 2 and int(state["step"]) == 2
    assert metrics_j[0]["grad_norm"] > oc_j.clip_grad
    ref = _by_name(jax.tree_util.tree_map(np.asarray, state["params"]),
                   cfg_t)
    start = _by_name(params, cfg_t)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=1e-5,
                                   err_msg=name)
        # the update itself, not only the params it moved
        moved = ref[name] - start[name]
        err = np.abs(p.detach().numpy() - start[name] - moved).max()
        ulps = 4 * np.spacing(np.abs(start[name]).max())
        assert err <= 1e-3 * np.abs(moved).max() + ulps, name


def test_train_step_fused_decoder_two_updates_match_jax():
    """make_train_step(decoder_impl="fused"): two AdamW updates through
    the fused decoder tail (its plain versions on the CPU) against the
    JAX step with decoder_impl="fused" (the Pallas tail in interpret
    mode), and against the port's own stock-tail step: loss and
    grad_norm 1e-5 relative, params 1e-5 absolute."""
    cfg_j, cfg_t = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    params = jax_params_np(cfg_j, seed=17)
    batches = [_batch(cfg_j, 2, seed=18 + i) for i in range(2)]

    optimizer_j = joptim.make_optimizer(params, cfg_j, _oc(joptim))
    state = jstep.init_train_state(params, optimizer_j)
    step_j = jax.jit(jstep.make_train_step(cfg_j, optimizer_j,
                                           decoder_impl="fused"))
    metrics_j = []
    for i, b in enumerate(batches):
        state, m = step_j(state, b, jax.random.PRNGKey(i))
        metrics_j.append({k: float(v) for k, v in m.items()})
    ref = _by_name(jax.tree_util.tree_map(np.asarray, state["params"]),
                   cfg_t)

    results = {}
    for impl in ("fused", "auto"):
        model = port_model(cfg_t, params).train()
        opt = toptim.LayerDecayAdamW(model, cfg_t, _oc(toptim))
        step_t = tstep.make_train_step(cfg_t, opt, decoder_impl=impl)
        results[impl] = [
            step_t(model, {k: t(v) for k, v in b.items()},
                   torch.Generator().manual_seed(0)) for b in batches], model
    for impl, (metrics_t, model) in results.items():
        for mt, mj in zip(metrics_t, metrics_j):
            np.testing.assert_allclose(float(mt["loss"]), mj["loss"],
                                       rtol=1e-5)
            np.testing.assert_allclose(float(mt["grad_norm"]),
                                       mj["grad_norm"], rtol=1e-5)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name],
                                       atol=1e-5, err_msg=f"{impl} {name}")


def test_fused_decoder_calls_its_plain_versions(monkeypatch):
    """forward(decoder_impl="fused") runs the tail through the autograd
    Function: on the CPU its plain forward once per forward and its plain
    backward once per backward; the stock tail calls neither."""
    from painter_tpu_torch.kernels import decoder_head as dh
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "fused_decoder_tail_reference"),
                      ("bwd", "fused_decoder_tail_bwd_reference")):
        real = getattr(dh, name)

        def counted(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)

        monkeypatch.setattr(dh, name, counted)
    cfg = tcfg.tiny_test_config()
    b = _batch(cfg, 2, seed=20)
    model = port_model(cfg, jax_params_np(jcfg.tiny_test_config(), seed=21))
    for impl, want in (("xla", 0), ("fused", 1)):
        loss, _, _ = tm.forward(model, t(b["imgs"]), t(b["tgts"]),
                                t(b["mask"]), t(b["valid"]), train=True,
                                remat=True, decoder_impl=impl)
        loss.backward()
        assert calls == {"fwd": want, "bwd": want}, (impl, calls)


def test_schedule_matches_jax():
    for kw in (dict(warmup_epochs=1.0, epochs=15.0, steps_per_epoch=100),
               dict(warmup_epochs=0.5, epochs=3.0, steps_per_epoch=7)):
        sched_j = joptim.cosine_warmup_schedule(_oc(joptim, **kw))
        sched_t = toptim.cosine_warmup_schedule(_oc(toptim, **kw))
        total = int(kw["epochs"] * kw["steps_per_epoch"])
        for step in range(0, total + 1, max(total // 17, 1)):
            np.testing.assert_allclose(sched_t(step), float(sched_j(step)),
                                       rtol=1e-6, atol=1e-12)
    assert toptim.cosine_warmup_schedule(_oc(toptim, warmup_epochs=1.0))(
        0) == 0.0


def test_param_groups_match_decay_mask_and_layer_scales():
    """Each parameter's weight decay and lr scale == JAX's decay_mask and
    layer_lr_scales, carried to the port's names (tokens, pos_embed,
    residual blocks and decoder included)."""
    kw = dict(seg_type_tokens=True, residual_block_indexes=(2,))
    cfg_j, cfg_t = jcfg.tiny_test_config(**kw), tcfg.tiny_test_config(**kw)
    params = jax_params_np(cfg_j)
    decay = jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, float(m), np.float32),
        joptim.decay_mask(params), params)
    scales = jax.tree_util.tree_map(
        lambda s, p: np.broadcast_to(np.asarray(s, np.float32),
                                     p.shape).copy(),
        joptim.layer_lr_scales(params, cfg_j, 0.8), params)
    decay, scales = _by_name(decay, cfg_t), _by_name(scales, cfg_t)
    model = port_model(cfg_t, params)
    groups = toptim.param_groups(model, cfg_t, weight_decay=0.1,
                                 layer_decay=0.8)
    seen = set()
    for g in groups:
        for name in g["names"]:
            seen.add(name)
            assert np.all(decay[name] == float(g["weight_decay"] > 0)), name
            np.testing.assert_allclose(scales[name], g["lr_scale"],
                                       rtol=1e-6, err_msg=name)
    assert seen == {n for n, _ in model.named_parameters()}


def test_pth_finetune_surgery_matches_jax(tmp_path):
    """A .pth whose pos_embed is another size (and which carries an
    unknown key and a shape-mismatched entry) loads like the JAX
    package's load_torch_params: pos_embed bicubic-resized, the rest
    skipped."""
    cfg_j = jcfg.tiny_test_config(pretrain_img_size=48)
    cfg_t = tcfg.tiny_test_config(pretrain_img_size=48)
    src = jckpt.params_to_torch_state_dict(
        jax_params_np(jcfg.tiny_test_config(), seed=11),
        jcfg.tiny_test_config())
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in src.items()}
    sd["decoder_embed.weight"] = torch.zeros(5, 7)
    sd["head.weight"] = torch.zeros(3)
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model": sd}, path)

    init = jax_params_np(cfg_j, seed=12)
    ref = _by_name(jckpt.load_torch_params(path, cfg_j, init=init), cfg_t)
    model = port_model(cfg_t, init)
    skipped = tckpt.load_torch_params(path, model)
    assert {s[0] for s in skipped} == {"decoder_embed.weight", "head.weight"}
    assert tuple(sd["pos_embed"].shape) != tuple(model.pos_embed.shape)
    for name, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[name], atol=1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("toydata")
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


def _cli_args(root, jp, out_dir, *extra):
    return ttrain.get_args_parser().parse_args([
        "--data_path", root, "--json_path", jp, "--val_json_path", jp,
        "--output_dir", out_dir, "--model", "tiny_test",
        "--input_size", "64", "32", "--batch_size", "4",
        "--accum_iter", "2", "--epochs", "2", "--warmup_epochs", "1",
        "--num_mask_patches", "4", "--max_mask_patches_per_block", "4",
        "--min_mask_patches_per_block", "1", "--dtype", "float32",
        "--max_steps_per_epoch", "2", "--save_freq", "1",
        "--panel_freq", "1", "--platform", "cpu", "--num_workers", "0",
        *extra])


def test_toy_training_run(toy_data, tmp_path):
    root, jp = toy_data
    out_dir = str(tmp_path / "run")
    args = _cli_args(root, jp, out_dir)
    state = ttrain.main(args)
    # 16 samples / (batch 4 x accum 2) = 2 updates per epoch, 2 epochs
    assert state["step"] == 4
    lines = [json.loads(x) for x in open(os.path.join(out_dir, "log.txt"))]
    assert len(lines) == 2
    assert "train_loss" in lines[0] and "val_loss" in lines[0]
    assert np.isfinite(lines[-1]["train_loss"])
    ckpts = os.listdir(os.path.join(out_dir, "checkpoints"))
    assert sorted(ckpts) == ["checkpoint-2.pth", "checkpoint-4.pth"]
    scalars = [json.loads(x)
               for x in open(os.path.join(out_dir, "scalars.jsonl"))]
    assert [s["step"] for s in scalars] == [0, 1, 2, 3]
    assert {"step", "epoch_1000x", "loss", "grad_norm", "lr"} <= \
        set(scalars[0])
    assert scalars[0]["lr"] == 0  # per-update warmup starts at 0
    assert scalars[-1]["lr"] > 0
    assert any(f.startswith("events.out.tfevents") for f in
               os.listdir(out_dir))
    arr = np.asarray(Image.open(os.path.join(out_dir, "panels",
                                             "panel_step0.png")))
    assert arr.shape[1] == 4 * 32 and arr.shape[0] % 64 == 0

    # auto-resume: the run is done, a second one adds no step
    before = {k: v.clone() for k, v in state["model"].state_dict().items()}
    state2 = ttrain.main(args)
    assert state2["step"] == 4
    for k, v in state2["model"].state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("flags,match", [
    (("--n_fsdp", "2"), "multi-GPU"),
    (("--distributed",), "multi-GPU"),
    (("--remat_policy", "save_attn"), "remat_policy"),
])
def test_unported_options_raise(toy_data, tmp_path, flags, match):
    root, jp = toy_data
    with pytest.raises(NotImplementedError, match=match):
        ttrain.main(_cli_args(root, jp, str(tmp_path / "run"), *flags))
    assert not os.path.exists(tmp_path / "run")


def test_toy_training_run_fused_decoder(toy_data, tmp_path):
    """``--decoder_impl fused`` trains on the CPU through the fused tail's
    plain versions: the same losses as the stock tail (fp32, 1e-5
    relative), and the validation runs the stock tail."""
    root, jp = toy_data
    losses = {}
    for impl in ("fused", "xla"):
        out_dir = str(tmp_path / impl)
        args = _cli_args(root, jp, out_dir, "--decoder_impl", impl,
                         "--epochs", "1", "--panel_freq", "0")
        assert args.decoder_impl == impl
        state = ttrain.main(args)
        assert state["step"] == 2
        scalars = [json.loads(x)
                   for x in open(os.path.join(out_dir, "scalars.jsonl"))]
        log = json.loads(open(os.path.join(out_dir, "log.txt")).readline())
        losses[impl] = [s["loss"] for s in scalars] + [log["val_loss"]]
    assert all(np.isfinite(losses["fused"]))
    np.testing.assert_allclose(losses["fused"], losses["xla"], rtol=1e-5)


def test_cli_defaults_to_cuda(toy_data, tmp_path, monkeypatch):
    root, jp = toy_data
    args = _cli_args(root, jp, str(tmp_path / "run"))
    args.platform = None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ttrain.main(args)
