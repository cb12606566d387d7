"""The port's host-side training data against the JAX package's: the
synthetic terrain sampler (the same numpy draws; the port's OpenCV-semantics
resizes in place of cv2's, rtol 1e-5), the batch augmentation and the
TensorBoard colour map (equal), and the prefetch thread."""

import numpy as np
import pytest

from moonsuperresolution_tpu.data import sampler as js
from moonsuperresolution_tpu.utils.colorize import colorize as j_colorize
from moonsuperresolution_tpu_torch.data.sampler import (
    BatchPrefetcher,
    SyntheticSampler,
    augment_batch,
)
from moonsuperresolution_tpu_torch.utils.colorize import colorize


@pytest.mark.parametrize("hw,seed", [(64, 0), (256, 7)])
def test_synthetic_sampler_matches_jax(hw, seed):
    """The JAX sampler resizes with cv2 (INTER_CUBIC up from 4-32 px,
    INTER_AREA down by 16).  Values near zero, where rtol means nothing,
    are held to 1e-6 of the [-0.5, 0.5] range (measured: 5.4e-7)."""
    assert js.cv2 is not None          # the oracle runs the cv2 branch
    want = list(js.SyntheticSampler(hw=hw, seed=seed).batches(2, 2))
    got = list(SyntheticSampler(hw=hw, seed=seed).batches(2, 2))
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape == wx.shape == (2, hw, hw, 2) and gx.dtype == wx.dtype
        assert gy.shape == wy.shape == (2, hw, hw, 1)
        np.testing.assert_allclose(gx, wx, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gy, wy, rtol=1e-5, atol=1e-6)


def test_augment_batch_matches_jax(rng):
    x = rng.standard_normal((5, 16, 16, 2)).astype(np.float32)
    y = rng.standard_normal((5, 16, 16, 1)).astype(np.float32)
    got = augment_batch(x, y, np.random.default_rng(3))
    want = js.augment_batch(x, y, np.random.default_rng(3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(x, x.copy())    # inputs left as they were


@pytest.mark.parametrize("shape", [(16, 16), (16, 16, 1), (2, 8, 8, 1)])
def test_colorize_matches_jax(rng, shape):
    v = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(colorize(v), j_colorize(v))
    np.testing.assert_array_equal(colorize(v, -1.0, 1.0),
                                  j_colorize(v, -1.0, 1.0))


def test_prefetcher_order_and_errors():
    assert list(BatchPrefetcher(iter(range(10)), depth=2)) == list(range(10))

    def broken():
        yield 1
        raise ValueError("producer failed")

    it = iter(BatchPrefetcher(broken(), depth=2))
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        next(it)
