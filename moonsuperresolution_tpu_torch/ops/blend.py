"""Gaussian-weighted overlap blending with uncertainty (counterpart of
moonsuperresolution_tpu/ops/blend.py).

The weighted mean and spread over the overlapping generations of a patch
grid are two fold (overlap-add) passes:

    mean = sum(w_i x_i) / sum(w_i)
    S    = sum(w_i (x_i - mean)^2),     std = sqrt(S / sum(w_i))

The second pass is centred on the first pass's mean, which keeps the
variance free of the cancellation a one-pass E[x^2] - E[x]^2 suffers.  In
PyTorch the fold is ``F.fold`` and the patch grid a strided view.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def gaussian_blend_kernel(
    image_size: int, sigma_div: float = 5.0, purge: int | None = None
) -> np.ndarray:
    """Normalized 2-D Gaussian blending window (reference:
    process_full_tiles.py:527-541): sigma = image_size / sigma_div, min-max
    normalized to [0, 1], plus 1e-7, then cropped by ``purge`` pixels per
    side (default image_size // 16, process_full_tiles.py:572-573).
    """
    n = image_size
    x = np.linspace(-n / 2, n / 2, n)
    xx, yy = np.meshgrid(x, x)
    s = n / sigma_div
    k = 1.0 / (2.0 * np.pi * s * s) * np.exp(-(xx**2 + yy**2) / (2.0 * s * s))
    k = (k - k.min()) / (k.max() - k.min())
    k = k + 1e-7
    if purge is None:
        purge = image_size // 16
    if purge:
        k = k[purge:-purge, purge:-purge]
    return k.astype(np.float32)


def fold_add(patches: torch.Tensor, stride: int) -> torch.Tensor:
    """Overlap-add of a regular patch grid.

    Args:
      patches: ``[Gy, Gx, P, P]`` or ``[C, Gy, Gx, P, P]``; patch (i, j)
        covers output rows ``i*stride : i*stride+P`` and the same columns.
        A leading channel axis folds several accumulators in one call.
      stride: grid stride in pixels.

    Returns:
      ``[(Gy-1)*stride + P, (Gx-1)*stride + P]`` sums, with the leading
      channel axis kept if present.
    """
    squeeze = patches.ndim == 4
    if squeeze:
        patches = patches[None]
    c, gy, gx, p, _ = patches.shape
    cols = patches.reshape(c, gy * gx, p * p).transpose(1, 2)
    out = F.fold(cols, ((gy - 1) * stride + p, (gx - 1) * stride + p),
                 kernel_size=p, stride=stride)[:, 0]
    return out[0] if squeeze else out


def extract_patches(plane: torch.Tensor, grid_hw: tuple[int, int],
                    stride: int, size: int) -> torch.Tensor:
    """The regular ``[Gy, Gx, size, size]`` patch grid of a plane, as a
    strided view (no copy).  The plane must hold the whole grid."""
    gy, gx = grid_hw
    win = plane.unfold(0, size, stride).unfold(1, size, stride)
    if win.shape[0] < gy or win.shape[1] < gx:
        raise ValueError(f"plane {tuple(plane.shape)} too small for grid "
                         f"{grid_hw} at stride {stride}, size {size}")
    return win[:gy, :gx]


def fold_weighted_moments(values: torch.Tensor, valid: torch.Tensor,
                          weight: torch.Tensor, stride: int):
    """Gaussian-weighted mean / std / coverage over overlapping generations.

    Args:
      values: ``[Gy, Gx, P, P]`` denormalized patches (purge-cropped).
      valid: ``[Gy, Gx]`` 0/1 mask; invalid patches get zero weight.
      weight: ``[P, P]`` blending window (``gaussian_blend_kernel``).
      stride: grid stride.

    Returns:
      ``(mean, std, w_sum, good)`` planes of shape
      ``[(Gy-1)*stride+P, (Gx-1)*stride+P]``; ``good`` is uint8 coverage.
    """
    gy, gx, p, _ = values.shape
    f32 = torch.float32
    w_eff = weight.to(f32)[None, None] * valid.to(f32)[:, :, None, None]
    x = values.to(f32)

    both = fold_add(torch.stack([w_eff.expand_as(x), w_eff * x]), stride)
    w_sum, wx_sum = both[0], both[1]
    safe_w = torch.where(w_sum > 0, w_sum, torch.ones_like(w_sum))
    mean = wx_sum / safe_w

    mean_p = extract_patches(mean, (gy, gx), stride, p)
    m2 = fold_add(w_eff * (x - mean_p) ** 2, stride)
    std = torch.sqrt(torch.clamp(m2, min=0.0) / safe_w)

    good = (w_sum > 0).to(torch.uint8)
    return mean, std, w_sum, good
