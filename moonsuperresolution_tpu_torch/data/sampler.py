"""Host-side training data (counterpart of moonsuperresolution_tpu/data/
sampler.py): the synthetic terrain sampler, the batch augmentation and a
background-thread prefetcher, all host numpy.

``SyntheticSampler`` makes the numbers of the JAX one: the same
``np.random.default_rng(seed)`` calls in the same order.  The JAX sampler
resizes with OpenCV, which the port does not have, so the port uses its
own OpenCV-semantics resizes: ``ops/resize.py::resize_cubic`` for
``INTER_CUBIC`` up, and the integer-factor box mean ``area_downscale`` for
``INTER_AREA`` down by 16 (on the CPU, in float32).

The HDF5 ``TileSampler`` (sampler.py:50-150) waits for its own slice: its
crops resize at arbitrary ratios with ``cv2.INTER_CUBIC`` and need a port
of those semantics, and the machine with the card has no h5py.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from moonsuperresolution_tpu_torch.ops.resize import (
    area_downscale,
    resize_cubic,
)


def _cubic(x: np.ndarray, hw: int) -> np.ndarray:
    """``cv2.resize(x, (hw, hw), interpolation=cv2.INTER_CUBIC)``."""
    return resize_cubic(torch.from_numpy(x), (hw, hw)).numpy()


class SyntheticSampler:
    """Synthetic fractal terrain with the I/O contract of the HDF5 sampler:
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
