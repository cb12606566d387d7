"""The port's OpenCV-free resizes, hole labelling and hole fill against
cv2 and the JAX package.

- Area /4 (``area_downscale4``) against ``cv2.resize(fx=0.25, INTER_AREA)``
  for every residue of height and width mod 4, with NaNs: same shapes, same
  NaN masks, and the same values bit for bit (it sums in cv2's order; the
  bound the streaming synthesis needs is rtol 2e-6).
- Cubic up (``resize_cubic``, the banded row then column resample) against
  ``cv2.resize(INTER_CUBIC)``: same NaN masks, values to rtol 1e-5 (cv2
  resamples columns first and rounds its taps otherwise); in bands of rows
  it equals one whole pass bit for bit.
- The banded cubic helpers equal the JAX package's bit for bit (same taps,
  same float32 accumulation order).
- ``label_holes`` equals ``cv2.connectedComponents`` label for label.
- The fills equal the JAX fills exactly: the same scipy ``griddata`` calls
  on the same points in the same order.
"""

import numpy as np
import pytest
import torch

from moonsuperresolution_tpu.infer import fill as jfill
from moonsuperresolution_tpu.ops import resize as jresize
from moonsuperresolution_tpu_torch.infer import fill
from moonsuperresolution_tpu_torch.ops import resize

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

NODATA = -32768.0


def _noisy(rng, h, w, nan_share=0.0):
    x = (rng.standard_normal((h, w)) * 100 + 1500).astype(np.float32)
    x[rng.random((h, w)) < nan_share] = np.nan
    return x


@pytest.mark.parametrize("h,w", [(64, 64), (65, 66), (66, 67), (67, 65),
                                 (130, 131), (6, 7), (11, 10)])
def test_area_downscale4_is_cv2_inter_area(rng, h, w):
    x = _noisy(rng, h, w, nan_share=0.01)
    x[h - 1, 1] = np.nan          # in a box clipped at the bottom, if any
    want = cv2.resize(x, (0, 0), fx=0.25, fy=0.25,
                      interpolation=cv2.INTER_AREA)
    got = resize.area_downscale4(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (resize.quarter_size(h),
                                       resize.quarter_size(w))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(got, want)  # tolerance 0: cv2's order


def test_area_downscale4_clipped_tail_group(rng):
    """A band of fewer than 4 rows gives one row of boxes clipped in height
    when asked for (the streaming synthesis's last group); cv2 gives it as
    the last row of the whole raster's resize."""
    x = _noisy(rng, 11, 42, nan_share=0.02)       # 11 rows -> 3 output rows
    want = cv2.resize(x, (0, 0), fx=0.25, fy=0.25,
                      interpolation=cv2.INTER_AREA)
    assert want.shape == (3, 10)
    got = resize.area_downscale4(torch.from_numpy(x[8:]), (1, want.shape[1]))
    np.testing.assert_array_equal(got.numpy(), want[2:])
    with pytest.raises(ValueError, match="cannot give"):
        resize.area_downscale4(torch.from_numpy(x), (4, 11))


@pytest.mark.parametrize("h,w", [(300, 420), (296, 420), (120, 420),
                                 (140, 250), (301, 419)])
def test_resize_cubic_is_cv2_inter_cubic(rng, h, w):
    """Sizes of the /16 synthesis (tests/test_engine.py::_lr_dem), the
    120-row one with a partial tail group, with NaN holes."""
    x = _noisy(rng, h, w)
    lo = cv2.resize(x, (0, 0), fx=0.25, fy=0.25, interpolation=cv2.INTER_AREA)
    lo = cv2.resize(lo, (0, 0), fx=0.25, fy=0.25,
                    interpolation=cv2.INTER_AREA)
    lo[rng.random(lo.shape) < 0.05] = np.nan
    lo[2, 3] = np.nan
    want = cv2.resize(lo, (w, h), interpolation=cv2.INTER_CUBIC)
    src = torch.from_numpy(lo)
    got = resize.resize_cubic(src, (h, w)).numpy()
    differ = np.argwhere(np.isnan(got) != np.isnan(want))
    assert differ.size == 0, f"NaN masks differ at {differ[:10].tolist()}"
    ok = ~np.isnan(want)
    assert 0.2 < ok.mean() < 1
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5)
    bands = [resize.resize_cubic(src, (h, w), a, min(h, a + 37)).numpy()
             for a in range(0, h, 37)]
    np.testing.assert_array_equal(np.concatenate(bands), got)


def test_banded_cubic_helpers_equal_jax(rng):
    src = _noisy(rng, 19, 27, nan_share=0.03)
    for args in ((19, 300), (27, 420), (8, 120)):
        for j, t in zip(jresize.cubic_taps(*args), resize.cubic_taps(*args)):
            np.testing.assert_array_equal(j, t)
    for a0, a1 in ((0, 300), (37, 161), (290, 300)):
        want = jresize.resample_rows_banded(src, 300, a0, a1)
        got = resize.resample_rows_banded(torch.from_numpy(src), 300, a0, a1)
        np.testing.assert_array_equal(got.numpy(), want)
    want = jresize.resample_cols_banded(src, 420)
    got = resize.resample_cols_banded(torch.from_numpy(src), 420)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,density", [(1024, 1024, 0.002),
                                         (1023, 517, 0.02),
                                         (256, 256, 0.05), (64, 63, 0.3)])
def test_label_holes_is_cv2_connected_components(rng, h, w, density):
    mask = rng.random((h, w)) < density
    # grow some seeds into blobs of a few pixels
    mask |= np.roll(mask, 1, 0) & (rng.random((h, w)) < 0.5)
    _, want = cv2.connectedComponents(mask.astype(np.uint8) * 255)
    np.testing.assert_array_equal(fill.label_holes(mask), want)


def _holed_terrain(rng, h=256, w=256, n_small=30):
    base = cv2.resize(rng.standard_normal((8, 8)).astype(np.float32), (w, h),
                      interpolation=cv2.INTER_CUBIC) * 120 + 1500
    detail = cv2.resize(rng.standard_normal((64, 64)).astype(np.float32),
                        (w, h), interpolation=cv2.INTER_CUBIC) * 6
    dem = (base + detail).astype(np.float32)
    for _ in range(n_small):   # small blobs, some touching each other
        y, x = rng.integers(2, h - 6), rng.integers(2, w - 6)
        dy, dx = rng.integers(1, 4, 2)
        dem[y : y + dy, x : x + dx] = NODATA
    dem[h // 3 : h // 3 + 40, w // 2 : w // 2 + 40] = NODATA  # stays
    return dem


@pytest.mark.parametrize("method", ["fast", "reference"])
def test_interpolate_missing_values_equals_jax(rng, method):
    h = 256 if method == "fast" else 96
    dem = _holed_terrain(rng, h, h, n_small=30 if method == "fast" else 6)
    want = jfill.interpolate_missing_values(dem.copy(), NODATA,
                                            max_fill_area=24, method=method)
    got = fill.interpolate_missing_values(dem.copy(), NODATA,
                                          max_fill_area=24, method=method)
    assert (want > NODATA).sum() > (dem > NODATA).sum()  # something filled
    assert (want <= NODATA).any()                         # the big hole
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("workers", [1, 2])
def test_fill_nodata_equals_jax(rng, workers):
    """The bordered tile sweep (4 holed 256-px tiles at border 32); with 2
    workers the port fills them in a forkserver process pool."""
    dem = _holed_terrain(rng, 300, 330, n_small=40)
    kw = dict(tile_size=256, border=32, max_fill_area=24, method="fast")
    want = jfill.fill_nodata(dem, NODATA, workers=1, **kw)
    got = fill.fill_nodata(dem, NODATA, workers=workers, **kw)
    np.testing.assert_array_equal(got, want)


def test_fill_nodata_window_equals_jax(rng):
    dem = _holed_terrain(rng, 300, 330, n_small=40)
    kw = dict(tile_size=128, border=16, max_fill_area=24, method="fast",
              workers=1)
    full = jfill.fill_nodata(dem, NODATA, **{**kw, "workers": 1})
    for a, b in ((0, 40), (57, 190), (250, 300)):
        want = jfill.fill_nodata_window(lambda y0, y1: dem[y0:y1], dem.shape,
                                        a, b, NODATA, **kw)
        got = fill.fill_nodata_window(lambda y0, y1: dem[y0:y1], dem.shape,
                                      a, b, NODATA, **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, full[a:b])
