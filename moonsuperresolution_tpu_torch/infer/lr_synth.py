"""Incremental /16 low-res DEM synthesis for the streaming engine
(counterpart of moonsuperresolution_tpu/infer/lr_synth.py).

A *producer thread* publishes ``s16`` (the /16 DEM) rows as soon as they are
final, so tile-row bands start processing while the tail of the raster is
still being read:

- raw DEM rows stream in chunks; each chunk's /4 INTER_AREA quarter rows are
  appended (integer box mean, so chunked == full-raster bitwise);
- the quarter-res nodata fill is the same bordered 256-px tile sweep as
  ``fill_nodata`` (every fill tile reads *raw* quarter rows, exactly like the
  full-raster sweep, so per-tile results are bit-exact); a fill-tile row at
  ``y`` runs as soon as quarter rows ``< y + 256`` are loaded;
- a quarter row is final once no pending fill tile can still write it
  (pending head ``y_next`` first writes at ``y_next + border``); final rows
  convert to s16 rows in aligned 4-row groups; the possibly-partial last
  group (2 or 3 rows) gives one row of boxes clipped in height.

Both area resizes are ``ops/resize.py::area_downscale4`` (cv2's INTER_AREA
at fx = 0.25, bit for bit), run on ``device``.

``wait_rows(q)`` blocks until s16 rows ``[0, q)`` are published (re-raising
any producer error); rows beyond the watermark are undefined.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from moonsuperresolution_tpu_torch.infer.fill import fill_tiles
from moonsuperresolution_tpu_torch.ops.resize import (
    area_downscale4,
    quarter_size,
)


class IncrementalLrSynth:
    """Producer-thread /16 DEM synthesizer, bit-exact with the sequential
    build (area /4, ``fill_nodata``, area /4 over the whole raster)."""

    TILE = 256
    BORDER = 32
    MAX_FILL_AREA = 24

    def __init__(self, dem_reader, h: int, w: int, no_value: float,
                 fill_method: str = "fast", workers: int = 1,
                 chunk_rows: int = 4096, device="cpu"):
        if h % 4 or w % 4 or chunk_rows % 4:
            raise ValueError(f"raster {h}x{w} and chunk {chunk_rows} rows "
                             "must divide by 4")
        self.h, self.w = h, w
        self.hq, self.wq = h // 4, w // 4
        self.h16 = quarter_size(self.hq)
        self.w16 = quarter_size(self.wq)
        self.no_value = no_value
        self.fill_method = fill_method
        self.workers = workers
        self.chunk_rows = chunk_rows
        self.device = torch.device(device)
        self._dem_reader = dem_reader

        # raw quarter (fill-tile inputs) and filled quarter (s16 source)
        self._q_raw = np.empty((self.hq, self.wq), np.float32)
        self._q_out = np.empty((self.hq, self.wq), np.float32)
        self.s16 = np.empty((self.h16, self.w16), np.float32)

        self._cond = threading.Condition()
        self._ready16 = 0          # published s16 rows
        self._error = None
        stride = self.TILE - 2 * self.BORDER
        self._fill_rows = list(range(0, self.hq, stride))  # pending tile rows
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    # ---------------------------------------------------------------- public

    def wait_rows(self, q1: int) -> None:
        """Block until s16 rows [0, min(q1, h16)) are published."""
        q1 = min(q1, self.h16)
        with self._cond:
            while self._ready16 < q1 and self._error is None:
                self._cond.wait(timeout=1.0)
            if self._error is not None:
                raise self._error

    def join(self) -> None:
        self._thread.join()
        with self._cond:
            if self._error is not None:
                raise self._error

    # -------------------------------------------------------------- producer

    def _produce(self) -> None:
        try:
            self._produce_inner()
        except BaseException as e:  # re-raised in the consumer thread
            with self._cond:
                self._error = e
                self._cond.notify_all()

    def _area(self, rows: np.ndarray, out_hw=None) -> np.ndarray:
        """Area /4 of host rows on the device, nodata -> NaN in, NaN out."""
        t = torch.from_numpy(rows).to(self.device)
        t = torch.where(t <= self.no_value, torch.nan, t)
        return area_downscale4(t, out_hw).cpu().numpy()

    def _produce_inner(self) -> None:
        nv = self.no_value
        for y in range(0, self.h, self.chunk_rows):
            y1 = min(self.h, y + self.chunk_rows)
            raw = np.ascontiguousarray(self._dem_reader.read_rows(y, y1),
                                       np.float32)
            q = self._area(raw)
            q[np.isnan(q)] = nv
            self._q_raw[y // 4 : y1 // 4] = q
            self._q_out[y // 4 : y1 // 4] = q
            self._step(loaded_q=y1 // 4, final=y1 == self.h)

    def _step(self, loaded_q: int, final: bool) -> None:
        """Run runnable fill tiles, then publish newly-final s16 rows."""
        t, b = self.TILE, self.BORDER
        stride = t - 2 * b
        jobs = []
        while self._fill_rows and (
            final or self._fill_rows[0] + t <= loaded_q
        ):
            y = self._fill_rows.pop(0)
            ymax = min(y + t - b, self.hq - b)
            for x in range(0, self.wq, stride):
                xmax = min(x + t - b, self.wq - b)
                tile = self._q_raw[y : y + t, x : x + t]
                if (tile <= self.no_value).any():
                    jobs.append((y, ymax, x, xmax, tile.copy()))
        if jobs:
            filled = fill_tiles([j[-1] for j in jobs], self.no_value,
                                self.MAX_FILL_AREA, self.fill_method,
                                self.workers)
            for (y, ymax, x, xmax, _), ftile in zip(jobs, filled):
                self._q_out[y + b : ymax, x + b : xmax] = ftile[
                    b : b + max(0, ymax - y - b),
                    b : b + max(0, xmax - x - b),
                ]
        if self._fill_rows:
            final_q = min(self._fill_rows[0] + b, loaded_q)
        else:
            final_q = self.hq if final else min(loaded_q, self.hq)
        self._publish(final_q, flush=final)

    def _publish(self, final_q: int, flush: bool) -> None:
        """Convert final quarter rows to s16 rows on 4-aligned row bands:
        the boxes (the clipped right-hand one included) are those of one
        area /4 over the whole quarter raster.  A partial tail group (hq % 4
        of 2 or 3 when h16 rounds up) is emitted on flush as one row of
        boxes clipped in height."""
        q1 = final_q // 4          # publishable *full* output rows
        a = self._ready16
        if q1 > a:
            self.s16[a:q1] = self._area(self._q_out[4 * a : 4 * q1],
                                        (q1 - a, self.w16))
            with self._cond:
                self._ready16 = q1
                self._cond.notify_all()
        if flush and self.h16 > self._ready16:
            a = self._ready16
            self.s16[a:] = self._area(self._q_out[4 * a :],
                                      (self.h16 - a, self.w16))
            with self._cond:
                self._ready16 = self.h16
                self._cond.notify_all()
