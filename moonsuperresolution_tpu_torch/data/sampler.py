"""Host-side training data (counterpart of moonsuperresolution_tpu/data/
sampler.py): the HDF5 tile-store sampler, the synthetic terrain sampler,
the batch augmentation and a background-thread prefetcher, all host numpy
in float32.

Both samplers make the numbers of the JAX ones: the same
``np.random.default_rng(seed)`` calls in the same order.  The JAX samplers
resize with OpenCV and read the store with h5py, which the port does not
have: it reads the store with its own HDF5 reader (``data/hdf5.py``) and
resizes with its OpenCV-semantics resizes (``ops/resize.py``):
``resize_cubic`` for ``INTER_CUBIC`` at any ratio, ``resize_linear`` and
``resize_area`` for the crop's other interpolations, and the
integer-factor box mean ``area_downscale`` for ``INTER_AREA`` down by 16.

``TileSampler``'s per-sample recipe (the reference's sampler.py:40-59): a
random square crop of 500..997 px of a 1000-px tile pair, the DEM min-max
normalised, both resized to ``hw``, a random planar tilt added to the DEM
and renormalised to [-0.5, 0.5], the low-res DEM made by area /16 and cubic
back up, the ortho / 255 - 0.5; source = (ortho, low-res DEM), target =
DEM.
"""

from __future__ import annotations

import pickle
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from moonsuperresolution_tpu_torch.data.hdf5 import H5Reader
from moonsuperresolution_tpu_torch.ops.resize import (
    area_downscale,
    resize_area,
    resize_cubic,
    resize_linear,
)

_RESIZES = {"cubic": resize_cubic, "linear": resize_linear,
            "area": resize_area}


def _resize(x: np.ndarray, hw: int, interpolation: str = "cubic"
            ) -> np.ndarray:
    """``cv2.resize(x, (hw, hw), interpolation=...)`` of a float32 plane."""
    return _RESIZES[interpolation](torch.from_numpy(x), (hw, hw)).numpy()


def _cubic(x: np.ndarray, hw: int) -> np.ndarray:
    return _resize(x, hw, "cubic")


class TileSampler:
    """(source, target) training pairs from the HDF5 tile store and its
    pickled key dict (the reference's MoonORTO2DEM.hdf5 and
    MoonORTO2DEM_{train,val}.pkl, make_h5.py:70-93), so that existing
    datasets drop in unchanged.  ``process_index / process_count`` give each
    process a disjoint slice of the keys; ``global_num_samples`` counts all
    of them."""

    def __init__(self, h5_path: str, pkl_path: str, hw: int = 256,
                 upscaling: int = 16, interpolation: str = "cubic",
                 seed: Optional[int] = None, process_index: int = 0,
                 process_count: int = 1):
        if interpolation not in _RESIZES:
            raise ValueError(f"interpolation {interpolation!r}: one of "
                             f"{sorted(_RESIZES)}")
        self.hw = hw
        self.us = upscaling
        self.interpolation = interpolation
        with open(pkl_path, "rb") as f:
            self.dataset = pickle.load(f)
        self.keys = list(self.dataset.keys())
        self.global_num_samples = len(self.keys)
        self.process_count = process_count
        if process_count > 1:
            self.keys = self.keys[process_index::process_count]
        self.num_samples = len(self.keys)
        self.h5 = H5Reader(h5_path)
        self.rng = np.random.default_rng(seed)

    def sample(self, key: str) -> tuple[np.ndarray, np.ndarray]:
        dem_key, ort_key = self.dataset[key]
        hw_crop = 500 + int(self.rng.random() * 498)
        res = 1000 - hw_crop
        plx = int(self.rng.random() * res)
        ply = int(self.rng.random() * res)
        sl = np.s_[plx : plx + hw_crop, ply : ply + hw_crop]
        raw_ort = np.array(self.h5[ort_key][sl], dtype=np.float32)
        raw_dem = np.array(self.h5[dem_key][sl], dtype=np.float32)

        rng_span = raw_dem.max() - raw_dem.min()
        raw_dem = (raw_dem - raw_dem.min()) / max(rng_span, 1e-12)
        raw_ort = _resize(raw_ort, self.hw, self.interpolation)
        raw_dem = _resize(raw_dem, self.hw, self.interpolation)

        # Random planar tilt: random x and y ramps (sampler.py:51-52).
        ramp = np.arange(self.hw, dtype=np.float32) / (self.hw / 2.0)
        raw_dem = raw_dem + self.rng.random() * ramp[:, None]
        raw_dem = raw_dem + self.rng.random() * ramp[None, :]
        span = raw_dem.max() - raw_dem.min()
        raw_dem = (raw_dem - raw_dem.min()) / max(span, 1e-12) - 0.5

        lo = area_downscale(torch.from_numpy(
            np.ascontiguousarray(raw_dem, np.float32)), self.us).numpy()
        smt_dem = _cubic(lo, self.hw)
        raw_ort = raw_ort / 255.0 - 0.5

        source = np.stack([raw_ort, smt_dem], axis=-1)
        target = raw_dem[:, :, None]
        if np.isnan(source).any() or np.isnan(target).any():
            raise ValueError(f"sample {key!r} has NaN values")
        return source.astype(np.float32), target.astype(np.float32)

    def epoch(self, shuffle: bool = True
              ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        keys = list(self.keys)
        if shuffle:
            self.rng.shuffle(keys)
        for key in keys:
            yield self.sample(key)

    def batches(self, batch_size: int, shuffle: bool = True,
                augment: bool = False, drop_remainder: bool = True
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Batched (source [B, H, W, 2], target [B, H, W, 1]) numpy arrays;
        a ragged last batch is dropped, as the reference does
        (train_spade_256.py:73-74)."""
        srcs, tgts = [], []
        for s, t in self.epoch(shuffle):
            srcs.append(s)
            tgts.append(t)
            if len(srcs) == batch_size:
                x, y = np.stack(srcs), np.stack(tgts)
                if augment:
                    x, y = augment_batch(x, y, self.rng)
                yield x, y
                srcs, tgts = [], []
        if srcs and not drop_remainder:
            yield np.stack(srcs), np.stack(tgts)

    def close(self) -> None:
        self.h5.close()


class SyntheticSampler:
    """Synthetic fractal terrain with the I/O contract of ``TileSampler``:
    (source [H, W, 2] = (ortho, low-res DEM), target [H, W, 1]), float32,
    without a dataset on disk."""

    def __init__(self, hw: int = 256, upscaling: int = 16, seed: int = 0):
        self.hw = hw
        self.us = upscaling
        self.rng = np.random.default_rng(seed)

    def _terrain(self) -> np.ndarray:
        hw = self.hw
        out = np.zeros((hw, hw), np.float32)
        for scale in (4, 8, 16, 32):
            bumps = self.rng.standard_normal((scale, scale)).astype(np.float32)
            out += _cubic(bumps, hw) / scale
        return out

    def sample(self) -> tuple[np.ndarray, np.ndarray]:
        dem = self._terrain()
        span = dem.max() - dem.min()
        dem = (dem - dem.min()) / max(span, 1e-12) - 0.5
        # Shaded-relief style fake ortho: gradient-lit terrain + noise.
        gy, gx = np.gradient(dem)
        ort = np.clip(0.5 + 3.0 * gx + 0.05 * self.rng.standard_normal(dem.shape),
                      0, 1).astype(np.float32) - 0.5
        lo = area_downscale(torch.from_numpy(dem), self.us).numpy()
        smt = _cubic(lo, self.hw)
        src = np.stack([ort, smt], -1).astype(np.float32)
        return src, dem[:, :, None].astype(np.float32)

    def batches(self, batch_size: int, num_batches: int):
        for _ in range(num_batches):
            pairs = [self.sample() for _ in range(batch_size)]
            yield (np.stack([p[0] for p in pairs]),
                   np.stack([p[1] for p in pairs]))


def augment_batch(x: np.ndarray, y: np.ndarray, rng: np.random.Generator):
    """The reference's per-sample augmentation (sampler.py:63-93): a random
    k * 90 degree rotation, random left-right and up-down flips, and a
    brightness/contrast jitter of the ortho channel only."""
    b = x.shape[0]
    xo = np.empty_like(x)
    yo = np.empty_like(y)
    for i in range(b):
        xi, yi = x[i], y[i]
        k = int(rng.integers(0, 4))
        xi = np.rot90(xi, k, axes=(0, 1))
        yi = np.rot90(yi, k, axes=(0, 1))
        if rng.random() > 0.5:
            xi = xi[:, ::-1]
            yi = yi[:, ::-1]
        if rng.random() > 0.5:
            xi = xi[::-1]
            yi = yi[::-1]
        alpha = rng.random() * 0.2 - 0.1
        beta = rng.random() * 0.3 - 0.15
        xi = xi.copy()
        xi[:, :, 0] = xi[:, :, 0] * (1 + alpha) + beta
        xo[i] = xi
        yo[i] = yi
    return xo, yo


class BatchPrefetcher:
    """Background-thread prefetcher: the host makes the next batches while
    the card trains on this one (the reference's tf.data prefetch,
    train_spade_256.py:40-43).  An error in the producer is raised in the
    consumer."""

    _DONE = object()

    def __init__(self, iterator, depth: int = 4):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.error: Exception | None = None
        self.thread = threading.Thread(target=self._worker, args=(iterator,),
                                       daemon=True)
        self.thread.start()

    def _worker(self, iterator):
        try:
            for item in iterator:
                self.q.put(item)
        except Exception as e:  # handed to the consumer below
            self.error = e
        finally:
            self.q.put(self._DONE)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._DONE:
                self.thread.join()
                if self.error is not None:
                    raise self.error
                return
            yield item
