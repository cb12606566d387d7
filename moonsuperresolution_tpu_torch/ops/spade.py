"""SPADE's normalisation chain on the bf16 serving path: moments' sums, then
normalisation, modulation and LeakyReLU in one pass (``csrc/spade.cu``).

``spade_sums`` and ``spade_modulate`` launch the hand-written CUDA kernel
for CUDA tensors and run their plain PyTorch versions, ``spade_sums_plain``
and ``spade_modulate_plain``, for CPU tensors.  There is no fallback from
the one to the other: a CUDA tensor either goes through the kernel or the
call raises.  The plain versions are the unfused chain of
``models/layers.py`` op for op, so on the CPU the fused path computes what
the unfused one does; given the same moments the kernel's
``spade_modulate`` equals its plain version bit for bit, and its sums
agree with torch's to rounding (another summation order).

``normed`` takes a tensor's sums and makes its moments by torch ops on the
small [C] (or [B, C]) vectors, in ``spade_moments``' order; the SPADE
layers use it on the fused path (``SpadeResidualBlock.fused``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from moonsuperresolution_tpu_torch import build
from moonsuperresolution_tpu_torch.parallel.collectives import (
    ONE,
    Axis,
    all_reduce_sum,
)

SPADE_EPSILON = 1e-5
STATS = ("batch", "instance")


def _dims(stats: str) -> tuple[int, ...]:
    if stats not in STATS:
        raise ValueError(f"stats must be one of {STATS}, got {stats!r}")
    return (0, 2, 3) if stats == "batch" else (2, 3)


def moments_from_sums(s1, s2, n: int, stats: str = "batch",
                      data_axis: Axis = ONE):
    """Mean and variance from the float32 sums ``s1``, ``s2`` of ``n``
    values each; "batch" sums are summed over ``data_axis`` first (each
    process holds the same number of rows).  The variance is clamped at
    0."""
    if stats == "batch" and data_axis.group is not None:
        s1, s2 = all_reduce_sum(torch.cat([s1, s2]), data_axis).chunk(2)
        n *= data_axis.size
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return mean, var


def inv_std(var: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.sqrt(var + SPADE_EPSILON)


class Normed(NamedTuple):
    """A SPADE input ready for ``spade_modulate``: ``x`` (bf16 NCHW, read
    2x nearest-upsampled when ``up``), the float32 ``mean`` and ``r`` (1 /
    std) of its moments, [1, C, 1, 1] ("batch") or [B, C, 1, 1]."""

    x: torch.Tensor
    mean: torch.Tensor
    r: torch.Tensor
    up: bool = False

    @property
    def hw(self) -> tuple[int, int]:
        """The feature resolution the input is read at."""
        k = 2 if self.up else 1
        return self.x.shape[2] * k, self.x.shape[3] * k


def normed(x: torch.Tensor, stats: str, data_axis: Axis = ONE,
           up: bool = False) -> Normed:
    """``x``'s SPADE moments (``spade_sums``, then ``moments_from_sums``)
    as a ``Normed``; a 2x nearest upsample repeats every element 4 times,
    so with ``up`` they are the upsampled tensor's moments too."""
    dims = _dims(stats)
    s1, s2 = spade_sums(x, stats)
    mean, var = moments_from_sums(s1, s2, math.prod(x.shape[d] for d in dims),
                                  stats, data_axis)
    return Normed(x, mean, inv_std(var), up)


def _check_x(x) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.ndim != 4 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty [B, C, H, W], got "
                         f"{tuple(x.shape)}")


def spade_sums_plain(x: torch.Tensor, stats: str):
    """Plain PyTorch version of ``spade_sums``: ``spade_moments``' sums."""
    _check_x(x)
    dims = _dims(stats)
    xs = x.to(torch.float32)
    return (xs.sum(dims, keepdim=True, dtype=torch.float32),
            (xs * xs).sum(dims, keepdim=True, dtype=torch.float32))


def _modulate_shapes(x, gb, mean, r, up) -> tuple[int, int, int, int]:
    _check_x(x)
    b, c, h, w = x.shape
    if up:
        h, w = 2 * h, 2 * w
    if gb.dtype != torch.bfloat16 or tuple(gb.shape) != (b, 2 * c, h, w):
        raise ValueError(f"gb must be bfloat16 [{b}, {2 * c}, {h}, {w}], got "
                         f"{gb.dtype} {tuple(gb.shape)}")
    for t in (mean, r):
        if t.dtype != torch.float32 or t.numel() not in (c, b * c):
            raise ValueError(f"mean and r must be float32 with {c} or "
                             f"{b * c} values, got {t.dtype} {tuple(t.shape)}")
    if mean.shape != r.shape:
        raise ValueError("mean and r differ in shape")
    return b, c, h, w


def spade_modulate_plain(x, gb, mean, r, alpha: float, up: bool = False):
    """Plain PyTorch version of ``spade_modulate``: the unfused chain of
    ``spade_normalize``, ``SPADE.forward`` and the block's ``leaky_relu``
    (and, with ``up``, the generator's upsample of the normalised input)."""
    b, c, _, _ = _modulate_shapes(x, gb, mean, r, up)
    shape = (1, c, 1, 1) if mean.numel() == c else (b, c, 1, 1)
    n = ((x.to(torch.float32) - mean.view(shape)) * r.view(shape)).to(
        torch.bfloat16)
    if up:
        n = F.interpolate(n, scale_factor=2, mode="nearest")
    return F.leaky_relu(gb[:, :c] * n + gb[:, c:], alpha)


def _lib():
    lib = build.load("spade")
    if lib.spade_sums.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spade_sums_scratch.argtypes = [i, i, i, i]
        lib.spade_sums_scratch.restype = ctypes.c_int64
        lib.spade_sums.argtypes = [p, i, i, i, i, p, p, p, p]
        lib.spade_sums.restype = ctypes.c_int
        lib.spade_modulate.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                       ctypes.c_float, p]
        lib.spade_modulate.restype = ctypes.c_int
    return lib


def _on_card(*ts) -> bool:
    """True for CUDA tensors, False for CPU ones; raises for anything
    else or a mix of devices."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("the tensors lie on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if any(t.numel() >= 2 ** 31 for t in ts):
        raise ValueError("the kernel takes tensors of fewer than 2^31 values")
    return True


def spade_sums(x: torch.Tensor, stats: str):
    """Float32 ``(sum x, sum x^2)`` of a bf16 NCHW ``x``, per channel over
    (B, H, W) for "batch" ([1, C, 1, 1] each) or per (b, c) over (H, W)
    for "instance" ([B, C, 1, 1])."""
    if not _on_card(x):
        return spade_sums_plain(x, stats)
    _check_x(x)
    instance = _dims(stats) == (2, 3)
    lib = _lib()
    b, c, h, w = x.shape
    shape = (b, c, 1, 1) if instance else (1, c, 1, 1)
    out = torch.empty((2, math.prod(shape)), dtype=torch.float32,
                      device=x.device)
    scratch = torch.empty(lib.spade_sums_scratch(b, c, h * w, instance),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.spade_sums(
            x.data_ptr(), b, c, h * w, instance, scratch.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"spade_sums: CUDA error {err}")
    spade_sums.launches += 1
    return out[0].view(shape), out[1].view(shape)


def spade_modulate(x, gb, mean, r, alpha: float, up: bool = False):
    """``leaky_relu(gamma * bf16((x - mean) * r) + beta, alpha)`` in bf16.

    Args:
      x: bf16 [B, C, H, W], or with ``up`` the pre-upsample [B, C, H/2,
        W/2], read 2x nearest-upsampled.
      gb: bf16 [B, 2C, H, W], the gamma/beta conv's output: gamma is its
        first C channels, beta the rest (read in place).
      mean, r: float32 mean and 1 / std, C values ("batch") or B * C
        ("instance"), any shape.
      alpha: LeakyReLU's negative slope.

    Returns:
      bf16 [B, C, H, W].
    """
    if not _on_card(x, gb, mean, r):
        return spade_modulate_plain(x, gb, mean, r, alpha, up)
    b, c, h, w = _modulate_shapes(x, gb, mean, r, up)
    out = torch.empty((b, c, h, w), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.spade_modulate(
            x.data_ptr(), gb.data_ptr(), mean.data_ptr(), r.data_ptr(),
            out.data_ptr(), b, c, h, w, up, mean.numel() != c, alpha,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"spade_modulate: CUDA error {err}")
    spade_modulate.launches += 1
    return out


spade_sums.launches = 0
spade_modulate.launches = 0
