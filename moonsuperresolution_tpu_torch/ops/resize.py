"""Resizes of the inference and training paths (counterpart of
moonsuperresolution_tpu/ops/resize.py, and of the OpenCV resizes of the JAX
package's full-map preprocessing, infer/engine.py:216-244 and
infer/lr_synth.py, and of its synthetic training data, data/sampler.py).
``area_downscale`` is the integer-factor box mean of the consistency loss.

The port has no OpenCV.  The two cv2 resizes of the low-res DEM synthesis
are reproduced with their OpenCV semantics:

- ``area_downscale4``: ``cv2.resize(x, (0, 0), fx=0.25, fy=0.25,
  interpolation=cv2.INTER_AREA)``.  Output size ``cvRound(n * 0.25)``
  (round half to even), 4x4 box means summed in OpenCV's order, boxes
  clipped at the far edge divided by the count they cover, NaN spreading.
- ``resize_cubic``: ``cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)``
  upward, one band of output rows at a time.  Keys kernel with a = -0.75,
  half-pixel centres, replicated borders, all four taps summed, zero-weight
  ones included, so that ``0 * NaN`` spreads a hole exactly as cv2 does.
  It is the banded row resample followed by the banded column resample
  (``cubic_taps``, the JAX package's taps and float32 accumulation order):
  every output element is the same sum whatever the band, so the in-RAM
  and the streaming map get the same DEM bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    # floor((i + 0.5) * n_in / n_out) in float64, as the reference's numpy
    # index computation does.
    pos = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) \
        * (n_in / n_out)
    return pos.floor().to(torch.int64).clamp_(max=n_in - 1)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Half-pixel-centre nearest-neighbour resize of ``[..., H, W]``.

    Matches ``tf.image.resize(method="nearest")`` and the JAX
    ``resize_nearest`` (half_pixel_centers=True).  Torch's
    ``mode="nearest"`` uses floor(i * H / oh) instead and picks other rows,
    so the rows and columns are gathered explicitly.
    """
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    x = x.index_select(-2, _nearest_index(h, oh, x.device))
    return x.index_select(-1, _nearest_index(w, ow, x.device))


# ------------------------------------------------------------- INTER_AREA


def quarter_size(n: int) -> int:
    """cv2's output size at fx = 0.25: cvRound(n * 0.25), half to even."""
    return int(round(n * 0.25))


def _mean_of(total: torch.Tensor, count: int) -> torch.Tensor:
    """``total / count``, rounded as one IEEE division on every device.  A
    Python-number divisor would let CUDA multiply by its reciprocal
    instead, one ulp off cv2 for counts that are not powers of two."""
    return total / total.new_full((), float(count))


def _seq_sum(block: torch.Tensor) -> torch.Tensor:
    """Sum of ``block[..., r, c]`` over its last two axes, one term at a
    time in row-major order (cv2's clipped-box loop)."""
    rows, cols = block.shape[-2:]
    s = block[..., 0, 0]
    for r in range(rows):
        for c in range(cols):
            if r or c:
                s = s + block[..., r, c]
    return s


def area_downscale4(x: torch.Tensor,
                    out_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """``cv2.resize(x, (0, 0), fx=0.25, fy=0.25, cv2.INTER_AREA)`` of a
    ``[H, W]`` float32 tensor, bit for bit (cv2's area-fast path, which a
    scale of exactly 4 takes).

    ``out_hw`` (default ``(cvRound(H / 4), cvRound(W / 4))``) may ask for
    one more clipped box per axis, up to ``ceil(n / 4)``: the last group of
    a band of fewer than 4 rows.

    Full 4x4 boxes sum each row's four values left to right, add the row
    sums in order and multiply by 1/16; a box clipped at the far edge sums
    its values one by one and divides by their count.  A NaN anywhere in a
    box makes its output NaN.
    """
    h, w = x.shape
    oh, ow = out_hw or (quarter_size(h), quarter_size(w))
    if not (0 <= oh <= -(-h // 4) and 0 <= ow <= -(-w // 4)):
        raise ValueError(f"area /4 of {h}x{w} cannot give {oh}x{ow}")
    nh, nw = min(oh, h // 4), min(ow, w // 4)  # full boxes per axis
    out = x.new_empty((oh, ow))
    if nh and nw:
        b = x[: 4 * nh, : 4 * nw].reshape(nh, 4, nw, 4)
        rs = ((b[..., 0] + b[..., 1]) + b[..., 2]) + b[..., 3]  # [nh, 4, nw]
        out[:nh, :nw] = (((rs[:, 0] + rs[:, 1]) + rs[:, 2]) + rs[:, 3]) \
            * 0.0625
    if ow > nw and nh:  # right-hand boxes, clipped in width
        cw = w - 4 * nw
        b = x[: 4 * nh, 4 * nw :].reshape(nh, 4, cw)
        out[:nh, nw] = _mean_of(_seq_sum(b), 4 * cw)
    if oh > nh:  # the bottom row of boxes, clipped in height
        rh = h - 4 * nh
        tail = x[4 * nh :]
        if nw:
            b = tail[:, : 4 * nw].reshape(rh, nw, 4).permute(1, 0, 2)
            out[nh, :nw] = _mean_of(_seq_sum(b), rh * 4)
        if ow > nw:
            b = tail[:, 4 * nw :]
            out[nh, nw] = _mean_of(_seq_sum(b), b.numel())
    return out


def area_downscale(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor box mean of ``[..., H, W]`` (H and W multiples of
    ``factor``): the JAX package's reshape-mean (its ops/resize.py:199-208),
    used by the consistency loss, and ``cv2.INTER_AREA`` at an integer ratio
    up to float32 summation order."""
    *lead, h, w = x.shape
    if h % factor or w % factor:
        raise ValueError(f"{h} x {w} is not a multiple of {factor}")
    y = x.reshape(*lead, h // factor, factor, w // factor, factor)
    return y.mean((-3, -1))


# ------------------------------------------------------------ INTER_CUBIC


def resize_cubic(x: torch.Tensor, out_hw: tuple[int, int], a0: int = 0,
                 a1: int | None = None) -> torch.Tensor:
    """Output rows ``[a0, a1)`` (default all) of the cv2.INTER_CUBIC resize
    of a ``[H, W]`` float32 tensor to ``out_hw``.

    The rows are resampled first, then the columns, each output element
    summing its four taps in order: cv2's taps and NaN spreading, values
    within rtol 1e-5 of cv2's (which resamples columns first).  The dense
    resample matrix of the JAX package (its ``_resample_matrix``) must not
    be used here: its zero entries carry a NaN across a whole output row.
    """
    oh, ow = out_hw
    return resample_cols_banded(
        resample_rows_banded(x, oh, a0, oh if a1 is None else a1), ow)


def _cubic_kernel(t: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic-convolution kernel. OpenCV uses a=-0.75."""
    t = np.abs(t)
    t2 = t * t
    t3 = t2 * t
    return np.where(
        t <= 1.0,
        (a + 2.0) * t3 - (a + 3.0) * t2 + 1.0,
        np.where(t < 2.0, a * t3 - 5.0 * a * t2 + 8.0 * a * t - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def cubic_taps(in_size: int, out_size: int, a: float = -0.75):
    """Per-output-pixel cubic taps: (idx[out,4], w[out,4]) int32/float32.

    Half-pixel centres, clamped borders, row-normalised; the 4 in-support
    taps stay explicit, zero-weight ones included, so IEEE ``0*nan``
    propagates NaN exactly like cv2's in-support accumulation.
    """
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    idx = base[:, None] + np.arange(-1, 3)[None, :]
    w = _cubic_kernel(src[:, None] - idx, a)
    idx = np.clip(idx, 0, in_size - 1)
    w = w / w.sum(axis=1, keepdims=True)
    return idx.astype(np.int32), w.astype(np.float32)


def _taps(in_size, out_size, a, device, sl=slice(None)):
    idx, w = cubic_taps(in_size, out_size, a)
    return (torch.from_numpy(idx[sl]).to(device, torch.int64),
            torch.from_numpy(w[sl]).to(device))


def resample_rows_banded(src: torch.Tensor, out_size: int, a0: int, a1: int,
                         a: float = -0.75) -> torch.Tensor:
    """Rows [a0, a1) of a full cubic row-resample ``in_h -> out_size`` of
    ``src`` ([in_h, W]), NaN-propagating, float32 accumulation in the tap
    order of the JAX function."""
    idx, w = _taps(src.shape[0], out_size, a, src.device, slice(a0, a1))
    out = torch.zeros((a1 - a0, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    for t in range(idx.shape[1]):
        out += w[:, t : t + 1] * src[idx[:, t]]
    return out


def resample_cols_banded(src: torch.Tensor, out_size: int,
                         a: float = -0.75) -> torch.Tensor:
    """Full cubic column-resample of a row band ([H, in_w] -> [H,
    out_size]), NaN-propagating, float32 accumulation."""
    idx, w = _taps(src.shape[1], out_size, a, src.device)
    out = torch.zeros((src.shape[0], out_size), dtype=torch.float32,
                      device=src.device)
    for t in range(idx.shape[1]):
        out += src[:, idx[:, t]] * w[None, :, t]
    return out
