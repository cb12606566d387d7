"""Finite-difference image gradients with TensorFlow semantics (counterpart
of moonsuperresolution_tpu/ops/gradients.py): ``tf.image.image_gradients``,
which the reference's gradient and surface-normal losses use
(spade/losses.py:11-23)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def image_gradients(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dy, dx)`` of an NCHW batch: forward differences along H and W,
    with a zero last row (dy) and a zero last column (dx), so that both keep
    the input's shape."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    dy = F.pad(x[:, :, 1:] - x[:, :, :-1], (0, 0, 0, 1))
    dx = F.pad(x[:, :, :, 1:] - x[:, :, :, :-1], (0, 1))
    return dy, dx
