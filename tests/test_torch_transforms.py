"""PyTorch port: ``PairRandomErasing`` and ``PairGaussianBlur`` against
the JAX package's, bit for bit, from the same ``np.random.Generator``
state (the generators end in the same state too)."""
import numpy as np
import pytest
from PIL import Image

from painter_tpu.data import transforms as J
from painter_tpu_torch.data import transforms as T


def _inputs(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "pil":
        return Image.fromarray(rng.randint(0, 256, (24, 36, 3), np.uint8))
    return rng.randn(24, 36, 3).astype(np.float32)


def _equal(got, ref):
    assert type(got) is type(ref)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("kind", ["pil", "array"])
@pytest.mark.parametrize("kw", [
    dict(p=1.0), dict(p=0.5), dict(p=1.0, value="random"),
    dict(p=1.0, value=0.7, scale=(0.3, 0.6), ratio=(0.5, 2.0)),
    dict(p=1.0, scale=(0.9, 0.99))],
    ids=["zero", "p0.5", "random", "value", "large"])
def test_random_erasing_matches_jax(kind, kw):
    for seed in range(6):
        img, tgt = _inputs(kind, seed), _inputs(kind, seed + 100)
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        ref = J.PairRandomErasing(**kw)(img, tgt, rj)
        got = T.PairRandomErasing(**kw)(img, tgt, rt)
        _equal(got[0], ref[0])
        assert got[1] is tgt and ref[1] is tgt  # the target untouched
        assert rt.bit_generator.state == rj.bit_generator.state


@pytest.mark.parametrize("sigma", [(0.1, 2.0), (0.5, 0.5), (1.5, 4.0)])
def test_gaussian_blur_matches_jax(sigma):
    for seed in range(4):
        img, tgt = _inputs("pil", seed), _inputs("pil", seed + 100)
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        ref = J.PairGaussianBlur(sigma)(img, tgt, rj)
        got = T.PairGaussianBlur(sigma)(img, tgt, rt)
        _equal(got[0], ref[0])
        assert got[1] is tgt
        assert rt.bit_generator.state == rj.bit_generator.state


def test_composed_with_the_recipe_matches_jax():
    """Blur and erasing inside a stack with the recipe's transforms (both
    sides on their numpy paths): the same arrays."""
    from painter_tpu import native
    img, tgt = _inputs("pil", 1), _inputs("pil", 2)

    def stack(M, **kw):
        return M.PairCompose([
            M.PairRandomResizedCrop(16, scale=(0.5, 1.0)),
            M.PairColorJitter(p=1.0, **kw), M.PairGaussianBlur(),
            M.PairRandomHorizontalFlip(), M.PairToArrayNormalize(**kw),
            M.PairRandomErasing(p=1.0, value="random")])
    native.set_enabled(False)
    try:
        ref = stack(J)(img, tgt, np.random.default_rng(3))
    finally:
        native.set_enabled(True)
    got = stack(T, native=False)(img, tgt, np.random.default_rng(3))
    for g, r in zip(got, ref):
        _equal(g, r)
