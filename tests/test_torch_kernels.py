"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so that it also runs on a machine with a card and
no JAX (``python -m pytest --noconftest tests/test_torch_kernels.py``; the
repository's conftest imports JAX).  The cases marked ``gpu`` launch the
kernels and skip where there is no card; the others hold the plain
versions, which the CPU runs, against numpy loops.

Patch prep: validity must match exactly; the rest to 1e-6 (IEEE float32
division on both sides).  The int8 conv: equal bit for bit, kernel and plain
version alike (an exact integer sum, then the same float32 roundings in the
same order).
"""

import numpy as np
import pytest
import torch

from moonsuperresolution_tpu_torch.ops import patches as tp
from moonsuperresolution_tpu_torch.ops import qconv as qc

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


# ----------------------------------------------------------- the int8 conv

# (B, H, W, C, Cout): narrow channels (C = 16 and 32 fill a fraction of the
# kernel's 128-channel K step), images that are not a whole number of pixel
# boxes, partial N tiles, two N tiles, block 0 of the generator at full
# width (conv, and gamma/beta: a box spanning two images), W over 128 with
# a partial channel slice (C = 48) and an s8 row of N % 16 != 0 bytes, and
# N = 8.
QCONV_SHAPES = [(2, 12, 12, 16, 24), (3, 9, 7, 32, 40), (2, 16, 16, 128, 256),
                (16, 8, 8, 1024, 1024), (16, 8, 8, 128, 2048),
                (2, 33, 130, 48, 136), (1, 20, 20, 64, 8)]
# mode -> (acc dtype, out dtype, requantize to s8)
QCONV_MODES = {
    "int32-f32": (torch.int32, torch.float32, False),
    "int32-bf16": (torch.int32, torch.bfloat16, False),
    "bf16acc-bf16": (torch.bfloat16, torch.bfloat16, False),
    "bf16acc-s8": (torch.bfloat16, torch.bfloat16, True),
}


def _qconv_inputs(rng, shape, requant):
    """Uniform s8 codes; scales that make y about N(0, 1) (a product of two
    uniform codes has a standard deviation of about 5418); an inverse scale
    that clips beyond 3 sigma."""
    b, h, w, c, n = shape
    x = rng.integers(-127, 128, (b, h, w, c)).astype(np.int8)
    wt = rng.integers(-127, 128, (n, 3, 3, c)).astype(np.int8)
    s_x = np.float32(0.0123)
    w_scale = (rng.uniform(0.5, 1.5, n) / (s_x * 5418 * np.sqrt(9 * c))
               ).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    inv = np.full(n, 127 / 3, np.float32) if requant else None
    return x, wt, s_x, w_scale, bias, inv


def _as_torch(args, dev="cpu"):
    x, wt, s_x, w_scale, bias, inv = args
    t = [torch.from_numpy(a).to(dev) for a in (x, wt)]
    t.append(torch.tensor(s_x, device=dev))
    t += [torch.from_numpy(a).to(dev) for a in (w_scale, bias)]
    t.append(None if inv is None else torch.from_numpy(inv).to(dev))
    return t


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _qconv_numpy(args, acc_dtype, out_dtype):
    """The int8 conv as an int64 numpy sum over the 9 taps, then the
    epilogue in numpy float32 -> NHWC."""
    x, wt, s_x, w_scale, bias, inv = args
    b, h, w, c = x.shape
    xp = np.zeros((b, h + 2, w + 2, c), np.int64)
    xp[:, 1:-1, 1:-1] = x
    acc = np.zeros((b, h, w, wt.shape[0]), np.int64)
    for r in range(3):
        for s in range(3):
            acc += np.einsum("bhwc,nc->bhwn", xp[:, r : r + h, s : s + w],
                             wt[:, r, s].astype(np.int64))
    y = acc.astype(np.float32)
    if acc_dtype == torch.bfloat16:
        y = _bf16(y)
    y = y * (s_x * w_scale) + bias
    if inv is not None:
        return np.clip(np.rint(y * inv), -127, 127).astype(np.int8)
    return _bf16(y) if out_dtype == torch.bfloat16 else y


def _nhwc(t):
    assert t.is_contiguous(memory_format=torch.channels_last)
    t = t.permute(0, 2, 3, 1).cpu()
    return t.numpy() if t.dtype == torch.int8 else t.float().numpy()


@pytest.mark.parametrize("mode", list(QCONV_MODES))
def test_qconv_plain_matches_numpy(rng, mode):
    acc, out, requant = QCONV_MODES[mode]
    for shape in QCONV_SHAPES[:3]:
        args = _qconv_inputs(rng, shape, requant)
        got = qc.qconv(*_as_torch(args)[:5], acc, out, _as_torch(args)[5])
        want = _qconv_numpy(args, acc, out)
        assert got.dtype == (torch.int8 if requant else out)
        np.testing.assert_array_equal(_nhwc(got), want)
        if requant:
            assert (np.abs(want) == 127).any() and (np.abs(want) < 127).any()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(QCONV_MODES))
@pytest.mark.parametrize("shape", QCONV_SHAPES)
def test_qconv_kernel_matches_plain(cuda, rng, shape, mode):
    acc, out, requant = QCONV_MODES[mode]
    args = _as_torch(_qconv_inputs(rng, shape, requant), cuda)
    before = qc.qconv.launches
    got = qc.qconv(*args[:5], acc, out, args[5])
    torch.cuda.synchronize()
    assert qc.qconv.launches == before + 1
    want = qc.qconv_plain(*args[:5], acc, out, args[5])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_nhwc(got), _nhwc(want))


def _plan_shapes():
    """The 18 distinct shapes of the int8 generator's main path, phase 2's
    small width and the shapes above, as (B, H, W, C, Cout)."""
    from chip_smoke import SMALL_QCONV, generator_qconvs

    main = sorted({(b, s, s, c, n) for _, b, s, c, n in generator_qconvs()})
    assert len(main) == 18
    b, s, c, n = SMALL_QCONV
    return main + [(b, s, s, c, n)] + QCONV_SHAPES


@pytest.mark.parametrize("shape", _plan_shapes(), ids=str)
def test_qconv_tile_plan_covers_each_pixel_and_k_step_once(shape):
    """``pixel_box``'s box, tiled as csrc/qconv.cu tiles it, covers every
    output pixel and channel exactly once, and the kernel's K steps (9 taps
    of 128-channel slices) every k of 9 C exactly once.  The walk below is
    an explicit mirror of the kernel's formulas: the grid and tile count of
    ``qconv3x3_s8`` and the decoding of ``tile_at`` (N tiles fastest)."""
    b, h, w, c, n = shape
    bb, bh, bw = qc.pixel_box(h, w)
    assert bb * bh * bw == qc.BOX_PIXELS and max(bb, bh, bw) <= 256
    bn = bk = 128                                      # kBN, kBK
    grid_h, grid_w, n_tiles = -(-h // bh), -(-w // bw), -(-n // bn)
    tiles = -(-b // bb) * grid_h * grid_w * n_tiles
    cover = np.zeros((b, h, w), np.int32)
    cols = np.zeros(n, np.int32)
    for t in range(tiles):
        m = t // n_tiles
        n0 = (t - m * n_tiles) * bn
        w0 = m % grid_w * bw
        h0 = m // grid_w % grid_h * bh
        b0 = m // (grid_w * grid_h) * bb
        if n0 == 0:
            cover[b0 : b0 + bb, h0 : h0 + bh, w0 : w0 + bw] += 1
        if m == 0:
            cols[n0 : n0 + bn] += 1
    assert (cover == 1).all() and (cols == 1).all()
    k = np.zeros(9 * c, np.int32)
    for tap in range(9):
        for c0 in range(0, c, bk):
            k[tap * c + c0 : tap * c + min(c0 + bk, c)] += 1
    assert (k == 1).all()


def test_qconv_bf16_rounding_identity():
    """csrc/qconv.cu rounds float(acc) to bf16 on the integer pipe:
    (u + 0x7FFF + (u >> 16 & 1)) & 0xFFFF0000 on the float's bits.  Equal
    to PyTorch's round-to-nearest-even cast for every int32 sum the kernel
    can hold (|acc| <= 9 * 1024 * 127^2 < 2^28), ties included."""
    rng = np.random.default_rng(1)
    acc = np.concatenate([
        rng.integers(-(2 ** 28), 2 ** 28, 1 << 20),
        np.arange(-70000, 70000),                     # every small sum
        (rng.integers(1, 2 ** 12, 4096) << 16) + 0x8000,  # bf16 ties
    ]).astype(np.int32)
    a = acc.astype(np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    got = (((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
           .view(np.float32))
    want = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_qconv_requantize_identity():
    """csrc/qconv.cu requantizes as the low byte of the bits of
    clip(y * inv, -127, 127) + 1.5 * 2^23 (float32 round to nearest even):
    equal to clip(rint(y * inv), -127, 127) as int8, halves and the clip's
    edges included."""
    rng = np.random.default_rng(2)
    v = np.concatenate([
        rng.standard_normal(1 << 20).astype(np.float32) * 60,
        np.arange(-300, 300, 0.5, dtype=np.float32),   # every tie
        np.float32([127.49, 127.5, -127.5, -127.51, 1e9, -1e9]),
    ]).astype(np.float32)
    bits = (np.clip(v, -127, 127) + np.float32(12582912.0)).view(np.uint32)
    got = (bits & 0xFF).astype(np.uint8).view(np.int8)
    want = np.clip(np.rint(v), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_qconv_kernel_refuses_what_it_does_not_take(cuda, rng):
    """A CUDA tensor goes through the kernel or the call raises: a width
    that is not a multiple of 16, or operands on two devices."""
    args = _as_torch(_qconv_inputs(rng, (1, 4, 4, 8, 8), False), cuda)
    with pytest.raises(ValueError, match="C % 16"):
        qc.qconv(*args[:5], torch.int32, torch.float32)
    args = _as_torch(_qconv_inputs(rng, (1, 4, 4, 16, 8), False), cuda)
    args[1] = args[1].cpu()
    with pytest.raises(ValueError, match="one device"):
        qc.qconv(*args[:5], torch.int32, torch.float32)
