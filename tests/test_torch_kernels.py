"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so that it also runs on a machine with a card and
no JAX (``python -m pytest --noconftest tests/test_torch_kernels.py``; the
repository's conftest imports JAX).  The cases marked ``gpu`` launch the
kernels and skip where there is no card; the others hold the plain version,
which the CPU runs, against a per-patch numpy loop.  Validity must match
exactly; the rest to 1e-6 (IEEE float32 division on both sides).
"""

import numpy as np
import pytest
import torch

from moonsuperresolution_tpu_torch.ops import patches as tp

torch.set_num_threads(2)

NO_VALUE = -32768.0
SHAPES = [(8, 32, 64), (16, 64, 128), (12, 48, 96), (64, 512, 1024)]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    """The card, for the tests marked ``gpu``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _slabs(rng, stride, size, tile):
    L = tile + 2 * (size - stride)
    img = (rng.standard_normal((L, L)) * 30 + 128).astype(np.float32)
    dem = (rng.standard_normal((L, L)) * 50 + 1500).astype(np.float32)
    dem[10:13, 20:23] = NO_VALUE
    dem[L // 2 : L // 2 + size // 4, 3 * L // 4 :] = NO_VALUE
    return img, dem, tile // stride + size // stride - 1


def _numpy_loop(img, dem, g, stride, size):
    n = g * g
    x = np.zeros((n, size, size, 2), np.float32)
    valid, dmin, dmax = (np.zeros(n, np.float32) for _ in range(3))
    for k in range(n):
        r, c = (k // g) * stride, (k % g) * stride
        for ch, slab in enumerate((img, dem)):
            p = slab[r : r + size, c : c + size]
            lo, hi = p.min(), p.max()
            x[k, :, :, ch] = (p - lo) / np.maximum(hi - lo, np.float32(1e-12)) \
                - np.float32(0.5)
        pd = dem[r : r + size, c : c + size]
        valid[k] = float(img[r : r + size, c : c + size].min() > NO_VALUE
                         and pd.min() > NO_VALUE)
        dmin[k], dmax[k] = pd.min(), pd.max()
    return x, valid, dmin, dmax


def _assert_same(got, want):
    gx, gv, gmin, gmax = (np.asarray(a) for a in got)
    wx, wv, wmin, wmax = (np.asarray(a) for a in want)
    assert gx.shape == wx.shape
    np.testing.assert_array_equal(gv, wv)
    assert 0 < wv.sum() < wv.size
    for a, b in ((gx, wx), (gmin, wmin), (gmax, wmax)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("stride,size,tile", SHAPES[:3])
def test_plain_matches_numpy_loop(rng, stride, size, tile):
    img, dem, g = _slabs(rng, stride, size, tile)
    got = tp.extract_normalize_patches(torch.from_numpy(img),
                                       torch.from_numpy(dem), (g, g), stride,
                                       size, NO_VALUE)
    _assert_same(got, _numpy_loop(img, dem, g, stride, size))


@pytest.mark.gpu
@pytest.mark.parametrize("stride,size,tile", SHAPES)
def test_patches_kernel_matches_plain(cuda, rng, stride, size, tile):
    img, dem, g = _slabs(rng, stride, size, tile)
    img_d = torch.from_numpy(img).to(cuda)
    dem_d = torch.from_numpy(dem).to(cuda)
    before = tp.extract_normalize_patches.launches
    got = tp.extract_normalize_patches(img_d, dem_d, (g, g), stride, size,
                                       NO_VALUE)
    torch.cuda.synchronize()
    assert tp.extract_normalize_patches.launches == before + 1
    assert got[0].permute(0, 3, 1, 2).is_contiguous()
    want = tp.extract_normalize_patches_plain(img_d, dem_d, (g, g), stride,
                                              size, NO_VALUE)
    _assert_same([a.cpu() for a in got], [a.cpu() for a in want])


@pytest.mark.gpu
def test_patches_kernel_refuses_cpu_fallback(cuda):
    """A CUDA tensor goes through the kernel or the call raises."""
    img = torch.zeros((64, 64), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        tp.extract_normalize_patches(img, img, (5, 5), 8, 32, NO_VALUE)
