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


# ------------------------------------- INTER_AREA and INTER_LINEAR, any ratio
#
# OpenCV's resize (imgproc/src/resize.cpp) at any ratio, for the training
# data's host resizes (data/sampler.py, data/h5_builder.py).  A scale is
# ``1 / (out / in)`` in double, as cv2 takes it.  INTER_AREA shrinking in
# both axes sums fractional-area taps (``computeResizeAreaTab``) along each
# source row, then those row sums down the columns; at an integer ratio cv2
# takes its box-mean fast path instead.  Any other INTER_AREA (enlarging in an axis) is cv2's
# linear resize with area coefficients, and INTER_LINEAR is the same with
# half-pixel coefficients (at exactly 1/2 in both axes cv2 turns it into the
# area fast path).  float32 data is summed in float32 in cv2's order; uint8
# data follows cv2's fixed-point linear path (11-bit coefficients) and
# rounds half to even, saturating, where cv2 casts back.

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"cv2-semantics resize of {x.dtype}: float32 or "
                        "uint8 only")


def _cv_scale(n_in: int, n_out: int) -> float:
    return 1.0 / (n_out / n_in)


def _saturate(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """cv2's ``saturate_cast`` from float32 (or int32) to ``dtype``."""
    if dtype.is_floating_point:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    if x.dtype.is_floating_point:
        x = torch.round(x)
    return x.clamp_(info.min, info.max).to(dtype)


@functools.lru_cache(maxsize=64)
def area_taps(n_in: int, n_out: int):
    """cv2's ``computeResizeAreaTab`` (shrinking) as (idx[out, T], w[out, T])
    int64 / float32, each output's taps in cv2's order; shorter rows are
    padded with weight 0 on their last tap."""
    scale = _cv_scale(n_in, n_out)
    rows = []
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx2 = min(int(np.floor(fsx2)), n_in - 1)
        sx1 = min(int(np.ceil(fsx1)), sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, (sx1 - fsx1) / cell))
        taps += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        rows.append(taps)
    t = max(len(r) for r in rows)
    idx = np.array([[i for i, _ in r] + [r[-1][0]] * (t - len(r))
                    for r in rows], np.int64)
    w = np.array([[a for _, a in r] + [0.0] * (t - len(r)) for r in rows],
                 np.float32)
    return idx, w


def _tap_sum(x: torch.Tensor, idx: np.ndarray, w: np.ndarray,
             dim: int) -> torch.Tensor:
    """sum_t x[idx[:, t]] * w[:, t] along ``dim`` of a float32 tensor,
    one tap at a time in order."""
    it = torch.from_numpy(idx).to(x.device)
    wt = torch.from_numpy(w).to(x.device)
    shape = [1, 1]
    shape[dim] = -1
    out = None
    for t in range(idx.shape[1]):
        term = x.index_select(dim, it[:, t]) * wt[:, t].reshape(shape)
        out = term if out is None else out + term
    return out


def _area_shrink(x: torch.Tensor, oh: int, ow: int,
                 band: int = 1024) -> torch.Tensor:
    """cv2's ``resizeArea_``: each source row's column taps summed into a
    float32 buffer, then the rows' buffers summed with their row weights.
    Runs ``band`` output rows at a time, so a whole region's ortho needs
    only a band's buffer."""
    h, w = x.shape
    xi, xw = area_taps(w, ow)
    yi, yw = area_taps(h, oh)
    out = x.new_empty((oh, ow))
    for a in range(0, oh, band):
        rows = yi[a : a + band]
        lo, hi = int(rows.min()), int(rows.max()) + 1
        buf = _tap_sum(x[lo:hi].to(torch.float32), xi, xw, dim=1)
        out[a : a + band] = _saturate(
            _tap_sum(buf, rows - lo, yw[a : a + band], dim=0), x.dtype)
    return out


def _area_fast(x: torch.Tensor, r: int, c: int) -> torch.Tensor:
    """cv2's ``resizeAreaFast_`` at integer ratios (r rows, c columns per
    box; the source is a whole number of boxes): the box summed in row-major
    order, four terms at a time, times 1 / area.  At 2 x 2 cv2's SIMD code
    rounds uint8 as ``(sum + 2) >> 2`` (half up) in every column, and sums
    float32 boxes as two pairs except in the last ``ow % 4`` columns of each
    row, its scalar tail."""
    h, w = x.shape
    oh, ow = h // r, w // c
    fixed = x.dtype == torch.uint8
    b = x.to(torch.int32 if fixed else torch.float32).reshape(
        oh, r, ow, c).permute(0, 2, 1, 3).reshape(oh, ow, r * c)
    if r == c == 2 and fixed:
        return _saturate((b.sum(-1) + 2) >> 2, x.dtype)
    area = r * c
    total = None
    for k in range(0, area - area % 4, 4):
        term = ((b[..., k] + b[..., k + 1]) + b[..., k + 2]) + b[..., k + 3]
        total = term if total is None else total + term
    for k in range(area - area % 4, area):
        total = b[..., k] if total is None else total + b[..., k]
    out = total.to(torch.float32) * np.float32(1.0 / area)
    if r == c == 2:
        body = ow - ow % 4
        s = (b[:, :body, 0] + b[:, :body, 1]) + (b[:, :body, 2]
                                                 + b[:, :body, 3])
        out[:, :body] = s * np.float32(0.25)
    return _saturate(out, x.dtype)


def _linear_coeffs(n_in: int, n_out: int, area: bool):
    """Per output: the source index s (unclamped in the row direction) and
    the float32 weight f of s + 1, as cv2's ``resize`` sets them, and which
    outputs take the row edge's ``S[last] * ONE``."""
    scale = _cv_scale(n_in, n_out)
    inv = n_out / n_in
    d = np.arange(n_out, dtype=np.float64)
    if area:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(
            np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = (f - s.astype(np.float32)).astype(np.float32)
    return s, f


def _linear(x: torch.Tensor, oh: int, ow: int, area: bool) -> torch.Tensor:
    """cv2's ``resizeGeneric_`` with the 2-tap linear kernel: the column
    pass (``HResizeLinear``) with clamped taps and the right edge's
    ``S[last] * ONE``, then the row pass (``VResizeLinear``) over the two
    clamped source rows of each output row."""
    h, w = x.shape
    dev = x.device
    fixed = not x.dtype.is_floating_point
    sx, fx = _linear_coeffs(w, ow, area)
    left = sx < 0
    fx[left], sx[left] = 0, 0
    edge = sx >= w - 1
    fx[edge], sx[edge] = 0, w - 1
    sy, fy = _linear_coeffs(h, oh, area)
    cx = np.stack([np.float32(1) - fx, fx], 1)
    cy = np.stack([np.float32(1) - fy, fy], 1)
    if fixed:
        cx = np.round(cx * np.float32(_COEF_SCALE)).astype(np.int32)
        cy = np.round(cy * np.float32(_COEF_SCALE)).astype(np.int32)
        one = _COEF_SCALE
        src = x.to(torch.int32)
    else:
        one = 1.0
        src = x.to(torch.float32)
    ix0 = torch.from_numpy(sx).to(dev)
    ix1 = torch.from_numpy(np.minimum(sx + 1, w - 1)).to(dev)
    a = torch.from_numpy(cx).to(dev)
    hor = src[:, ix0] * a[:, 0] + src[:, ix1] * a[:, 1]
    e = torch.from_numpy(edge).to(dev)
    hor = torch.where(e, src[:, ix0] * one, hor)
    r0 = torch.from_numpy(np.clip(sy, 0, h - 1)).to(dev)
    r1 = torch.from_numpy(np.clip(sy + 1, 0, h - 1)).to(dev)
    b = torch.from_numpy(cy).to(dev)
    s0, s1 = hor[r0], hor[r1]
    if fixed:
        v = (((b[:, :1] * (s0 >> 4)) >> 16) + ((b[:, 1:] * (s1 >> 4)) >> 16)
             + 2) >> 2
        return _saturate(v, x.dtype)
    return _saturate(s0 * b[:, :1] + s1 * b[:, 1:], x.dtype)


def _fast_ratio(n_in: int, n_out: int):
    """cv2's integer ratio (``is_area_fast``), or None."""
    scale = _cv_scale(n_in, n_out)
    i = int(np.floor(scale + 0.5))
    return i if abs(scale - i) < np.finfo(np.float64).eps else None


def resize_area(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(x, (w, h), interpolation=cv2.INTER_AREA)`` of a
    ``[H, W]`` float32 or uint8 tensor."""
    _check_dtype(x)
    (h, w), (oh, ow) = x.shape, out_hw
    if oh <= h and ow <= w:
        r, c = _fast_ratio(h, oh), _fast_ratio(w, ow)
        if r and c:
            return _area_fast(x, r, c)
        return _area_shrink(x, oh, ow)
    return _linear(x, oh, ow, area=True)


def resize_linear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(x, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    ``[H, W]`` float32 or uint8 tensor.  x86 builds of cv2 hand float32
    linear resizes to Intel IPP by default, whose coefficients differ from
    OpenCV's own by about 1e-6 (the tests hold it to both)."""
    _check_dtype(x)
    (h, w), (oh, ow) = x.shape, out_hw
    if _fast_ratio(h, oh) == 2 and _fast_ratio(w, ow) == 2:
        return _area_fast(x, 2, 2)
    return _linear(x, oh, ow, area=False)
