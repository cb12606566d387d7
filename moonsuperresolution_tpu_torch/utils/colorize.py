"""Colormap visualisation for the TensorBoard image summaries (counterpart of
moonsuperresolution_tpu/utils/colorize.py; reference: sampler.py:95-135):
min-max normalise, quantise to 256 levels, look up the colour.

The machine with the card has no matplotlib, so the port carries the
segment data of matplotlib's ``jet`` and builds its 256-entry table as
``LinearSegmentedColormap`` does (``colors._create_lookup_table``).
"""

from __future__ import annotations

import functools

import numpy as np

# matplotlib/_cm.py, _jet_data: per channel, rows (x, y below x, y above x).
_JET = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
              (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.00, 0, 0)),
}


def _channel(data, n: int) -> np.ndarray:
    """One channel of the table: piecewise-linear in float64, clipped."""
    a = np.array(data, dtype=np.float64)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


@functools.lru_cache(maxsize=1)
def jet_lut(n: int = 256) -> np.ndarray:
    """[n, 3] float32 RGB table of ``jet``."""
    return np.stack([_channel(_JET[c], n) for c in ("red", "green", "blue")],
                    -1).astype(np.float32)


def colorize(value: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """[H, W], [H, W, 1] or [B, H, W, 1] -> RGB [..., H, W, 3] in ``jet``."""
    value = np.asarray(value, dtype=np.float32)
    if value.ndim >= 3 and value.shape[-1] == 1:
        value = value[..., 0]
    lo = value.min() if vmin is None else vmin
    hi = value.max() if vmax is None else vmax
    norm = (value - lo) / max(hi - lo, 1e-12)
    idx = np.clip(np.round(norm * 255), 0, 255).astype(np.int32)
    return jet_lut()[idx]
