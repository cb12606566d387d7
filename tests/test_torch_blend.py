"""Parity of the port's Gaussian-weighted fold with the JAX package.

``gaussian_blend_kernel`` and ``extract_patches`` move values without
arithmetic and must match exactly.  The folds sum overlapping patches in
another order than JAX's congruence-class adds, so they match to rtol 1e-5
(float32 sums of up to (P/stride)^2 = 16 terms here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonsuperresolution_tpu.ops import blend as jb
from moonsuperresolution_tpu_torch.ops import blend as tb

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-5


@pytest.mark.parametrize("size,purge", [(64, None), (48, 0), (512, None)])
def test_gaussian_blend_kernel(size, purge):
    np.testing.assert_array_equal(tb.gaussian_blend_kernel(size, purge=purge),
                                  jb.gaussian_blend_kernel(size, purge=purge))


@pytest.mark.parametrize("grid,stride,size", [((5, 5), 8, 32), ((4, 6), 16, 40),
                                              ((3, 3), 12, 24)])
def test_extract_patches(rng, grid, stride, size):
    h = (grid[0] - 1) * stride + size + 3
    w = (grid[1] - 1) * stride + size + 5
    plane = rng.standard_normal((h, w)).astype(np.float32)
    want = jb.extract_patches(jnp.asarray(plane), grid, stride, size)
    got = tb.extract_patches(torch.from_numpy(plane), grid, stride, size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("channels", [False, True])
def test_fold_add(rng, channels):
    shape = (2, 4, 5, 24, 24) if channels else (4, 5, 24, 24)
    patches = rng.standard_normal(shape).astype(np.float32)
    want = jb.fold_add(jnp.asarray(patches), 8)
    got = tb.fold_add(torch.from_numpy(patches), 8)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_fold_weighted_moments_partly_invalid(rng):
    gy = gx = 6
    p, stride = 28, 8
    values = (rng.standard_normal((gy, gx, p, p)) * 20 + 1500).astype(
        np.float32)
    valid = np.ones((gy, gx), np.float32)
    valid[:2, :3] = 0          # a block of invalid patches: uncovered pixels
    valid[4, 5] = 0
    weight = jb.gaussian_blend_kernel(32, purge=2)
    want = jb.fold_weighted_moments(jnp.asarray(values), jnp.asarray(valid),
                                    jnp.asarray(weight), stride)
    got = tb.fold_weighted_moments(torch.from_numpy(values),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(weight), stride)
    mean, std, w_sum, good = (np.asarray(a) for a in want)
    assert 0 < good.mean() < 1
    np.testing.assert_array_equal(got[3].numpy(), good)
    assert got[3].dtype == torch.uint8
    for g, w in ((got[0], mean), (got[1], std), (got[2], w_sum)):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
