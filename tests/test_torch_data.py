"""The port's host-side training data against the JAX package's: the
synthetic terrain sampler (the same numpy draws; the port's OpenCV-semantics
resizes in place of cv2's, rtol 1e-5), the batch augmentation and the
TensorBoard colour map (equal), the prefetch thread, the INTER_AREA and
INTER_LINEAR resizes against cv2, and the HDF5 TileSampler against the JAX
one on the same h5py-written store."""

import contextlib
import pickle

import cv2
import h5py
import numpy as np
import pytest
import torch

from moonsuperresolution_tpu.data import sampler as js
from moonsuperresolution_tpu.data.h5_builder import tile_pair
from moonsuperresolution_tpu.utils.colorize import colorize as j_colorize
from moonsuperresolution_tpu_torch.data.sampler import (
    BatchPrefetcher,
    SyntheticSampler,
    TileSampler,
    augment_batch,
)
from moonsuperresolution_tpu_torch.ops.resize import (
    resize_area,
    resize_linear,
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


# ------------------------------------------- INTER_AREA and INTER_LINEAR

RESIZE_CASES = {  # name -> (source shape, output shape)
    "0.845": ((400, 600), (338, 507)),
    "0.5": ((400, 600), (200, 300)),
    "0.5, ragged rows": ((8, 602), (4, 301)),    # cv2's scalar tail
    "0.37": ((397, 601), (147, 222)),
    "32x48 up": ((32, 48), (64, 96)),
    "500 -> 256": ((500, 500), (256, 256)),
    "997 -> 256": ((997, 997), (256, 256)),
    "mixed": ((40, 60), (50, 30)),              # enlarge rows, shrink cols
}


@contextlib.contextmanager
def _ipp(on):
    """cv2's Intel IPP switch, process-wide: restored on the way out."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(on)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def _ulps(got, want):
    return np.abs(got.astype(np.float64) - want) / np.spacing(
        np.abs(want).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
@pytest.mark.parametrize("inter", ["area", "linear"])
def test_resize_matches_cv2(rng, inter, case, dtype):
    """float32 within 2 ulps (measured: equal), uint8 exact, of cv2's own
    algorithm (IPP off).  With IPP on (cv2's default on x86), IPP takes
    float32 INTER_LINEAR, whose coefficients differ from OpenCV's: held to
    5e-5 of the data's range there (measured: 3.0e-5); area and uint8 are
    OpenCV's own either way and held as above."""
    (h, w), out = RESIZE_CASES[case]
    x = (rng.random((h, w)) * 255).astype(dtype)
    fn, flag = {"area": (resize_area, cv2.INTER_AREA),
                "linear": (resize_linear, cv2.INTER_LINEAR)}[inter]
    got = fn(torch.from_numpy(x), out).numpy()
    for ipp in (False, True):
        with _ipp(ipp):
            want = cv2.resize(x, out[::-1], interpolation=flag)
        assert got.shape == want.shape and got.dtype == want.dtype
        if dtype == "uint8":
            np.testing.assert_array_equal(got, want)
        elif ipp and inter == "linear":
            np.testing.assert_allclose(got, want, rtol=0, atol=5e-5 * 255)
        else:
            assert _ulps(got, want).max() <= 2


def test_resize_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or uint8"):
        resize_area(torch.zeros(8, 8, dtype=torch.float64), (4, 4))


# ------------------------------------------------------------ TileSampler


@pytest.fixture(scope="module")
def tiny_store(tmp_path_factory):
    """tests/test_data.py's tiny_dataset: a 2000 x 3000 pair through the
    JAX ``tile_pair`` into an h5py-written store, 3 x 5 tiles of 1000 px."""
    rng = np.random.default_rng(0)
    td = tmp_path_factory.mktemp("store")
    h5_path, pkl_path, dct = str(td / "tiles.hdf5"), str(td / "keys.pkl"), {}
    ort = (rng.random((2000, 3000)) * 255).astype(np.float32)
    dem = (rng.random((2000, 3000)) * 4000 - 2000).astype(np.float32)
    with h5py.File(h5_path, "w") as h5:
        tile_pair(ort, dem, "R", h5, dct)
    with open(pkl_path, "wb") as f:
        pickle.dump(dct, f)
    return h5_path, pkl_path


def _record_keys(sampler):
    seen, sample = [], sampler.sample

    def recording(key):
        seen.append(key)
        return sample(key)
    sampler.sample = recording
    return seen


# Samples lie in [-0.5, 0.5]; measured largest differences: cubic 3.0e-7,
# linear 2.1e-7, area 1.8e-7.  Linear's bound is looser: cv2's IPP
# coefficients (test_resize_matches_cv2).
SAMPLER_ATOL = {"cubic": 1e-6, "area": 1e-6, "linear": 1e-5}


@pytest.mark.parametrize("interpolation", ["cubic", "linear", "area"])
def test_tile_sampler_matches_jax(tiny_store, interpolation):
    """The same seed on the same store: the epoch's key order, every
    augmented batch (rtol 1e-5 and the atol above), the dropped
    remainder."""
    kw = dict(hw=128, upscaling=16, seed=3, interpolation=interpolation)
    want_s, got_s = js.TileSampler(*tiny_store, **kw), TileSampler(
        *tiny_store, **kw)
    want_keys, got_keys = _record_keys(want_s), _record_keys(got_s)
    want = list(want_s.batches(4, augment=True))
    got = list(got_s.batches(4, augment=True))
    got_s.close()
    assert got_keys == want_keys and len(set(got_keys)) == 15
    assert len(got) == len(want) == 15 // 4
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape == (4, 128, 128, 2) and gx.dtype == np.float32
        assert gy.shape == (4, 128, 128, 1) and gy.dtype == np.float32
        for g, w in ((gx, wx), (gy, wy)):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=SAMPLER_ATOL[interpolation])


@pytest.mark.parametrize("index,count", [(0, 1), (1, 3), (2, 4)])
def test_tile_sampler_process_slices_match_jax(tiny_store, index, count):
    """Each process's slice of the keys, its count and the global count;
    its first sample at the same seed."""
    kw = dict(hw=64, seed=5, process_index=index, process_count=count)
    want, got = js.TileSampler(*tiny_store, **kw), TileSampler(*tiny_store,
                                                               **kw)
    assert got.keys == want.keys
    assert (got.num_samples, got.global_num_samples, got.process_count) == (
        want.num_samples, want.global_num_samples, want.process_count)
    (gs, gt), (ws, wt) = next(got.epoch()), next(want.epoch())
    got.close()
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt, wt, rtol=1e-5, atol=1e-6)


def test_tile_sampler_keeps_a_ragged_batch_when_asked(tiny_store):
    s = TileSampler(*tiny_store, hw=64, seed=0)
    sizes = [x.shape[0] for x, _ in s.batches(4, drop_remainder=False)]
    s.close()
    assert sizes == [4, 4, 4, 3]
    with pytest.raises(ValueError, match="interpolation"):
        TileSampler(*tiny_store, interpolation="nearest")
