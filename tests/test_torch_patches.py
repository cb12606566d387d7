"""Parity of the port's fused patch preparation with the JAX package.

The plain PyTorch version (what the CPU runs) is held against the Pallas
kernel in interpret mode and against its pure-XLA reference; the CUDA kernel
is held against the plain version on the card in test_torch_kernels.py
(which imports no JAX, so that it runs there).  Validity must match exactly;
the normalised patches and the DEM statistics to 1e-6 (both sides divide in
IEEE float32, so differences are last-bit rounding at most).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonsuperresolution_tpu.ops.pallas.patches import (
    extract_normalize_patches as j_kernel,
)
from moonsuperresolution_tpu.ops.pallas.patches import (
    extract_normalize_patches_reference as j_reference,
)
from moonsuperresolution_tpu_torch.ops import patches as tp

torch.set_num_threads(2)

NO_VALUE = -32768.0


def _slabs(rng, stride, size, tile):
    L = tile + 2 * (size - stride)
    img = (rng.standard_normal((L, L)) * 30 + 128).astype(np.float32)
    dem = (rng.standard_normal((L, L)) * 50 + 1500).astype(np.float32)
    dem[10:13, 20:23] = NO_VALUE
    return img, dem, tile // stride + size // stride - 1


def _assert_same(got, want):
    gx, gv, gmin, gmax = (np.asarray(a) for a in got)
    wx, wv, wmin, wmax = (np.asarray(a) for a in want)
    assert gx.shape == wx.shape
    np.testing.assert_array_equal(gv, wv)
    assert (1 - wv).sum() > 0  # the nodata hole rejects patches
    np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gmin, wmin, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gmax, wmax, rtol=0, atol=1e-6)


@pytest.mark.parametrize("stride,size,tile", [(8, 32, 64), (16, 64, 128)])
def test_plain_matches_pallas_interpret(rng, stride, size, tile):
    img, dem, g = _slabs(rng, stride, size, tile)
    want = j_kernel(jnp.asarray(img), jnp.asarray(dem), (g, g), stride, size,
                    NO_VALUE, interpret=True)
    got = tp.extract_normalize_patches(torch.from_numpy(img),
                                       torch.from_numpy(dem), (g, g), stride,
                                       size, NO_VALUE)
    _assert_same(got, want)


@pytest.mark.parametrize("stride,size,tile",
                         [(8, 32, 64), (16, 64, 128), (12, 48, 96)])
def test_plain_matches_reference(rng, stride, size, tile):
    """Stride 12 is no multiple of 8: the Pallas kernel refuses it, the
    reference and the port take it."""
    img, dem, g = _slabs(rng, stride, size, tile)
    want = j_reference(jnp.asarray(img), jnp.asarray(dem), (g, g), stride,
                       size, NO_VALUE)
    got = tp.extract_normalize_patches(torch.from_numpy(img),
                                       torch.from_numpy(dem), (g, g), stride,
                                       size, NO_VALUE)
    _assert_same(got, want)


def test_layout_is_a_view_of_nchw(rng):
    img, dem, g = _slabs(rng, 16, 64, 128)
    x, *_ = tp.extract_normalize_patches(torch.from_numpy(img),
                                         torch.from_numpy(dem), (g, g), 16,
                                         64, NO_VALUE)
    assert x.shape == (g * g, 64, 64, 2)
    assert x.permute(0, 3, 1, 2).is_contiguous()


@pytest.mark.parametrize("bad", ["dtype", "shape", "overrun", "contiguity"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    img = torch.zeros((64, 64))
    dem = torch.zeros((64, 64))
    grid, stride, size = (5, 5), 8, 32
    if bad == "dtype":
        img = img.double()
    elif bad == "shape":
        img = torch.zeros((64, 65))
    elif bad == "overrun":
        grid = (6, 6)
    else:
        img = torch.zeros((64, 128))[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        tp.extract_normalize_patches(img, dem, grid, stride, size, NO_VALUE)
