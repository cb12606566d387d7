"""Resizes the inference path needs (counterpart of
moonsuperresolution_tpu/ops/resize.py)."""

from __future__ import annotations

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
