"""SPADE's normalisation chain on the bf16 serving path: moments' sums, then
normalisation, modulation and LeakyReLU in one pass, and the residual
block's closing sum (``csrc/spade.cu``), in NCHW or channels_last memory.
The convs whose outputs these kernels read run without their bias, and the
kernels add it (``x_bias``, ``gb_bias``, ``bias``, ``res_bias``) where the
conv's own bias pass would have, rounding to bf16 as that pass does.

``spade_sums``, ``spade_modulate`` and ``spade_residual`` launch the
hand-written CUDA kernel for CUDA tensors and run their plain PyTorch
versions (``*_plain``) for CPU tensors.  There is no fallback from the one
to the other: a CUDA tensor either goes through the kernel or the call
raises.  The plain versions are the unfused chain of ``models/layers.py``
op for op, bias passes included, so on the CPU the fused path computes what
the unfused one does; given the same moments the kernels' modulation and
residual equal their plain versions bit for bit, and the sums agree with
torch's to rounding (another summation order).

``normed`` takes a tensor's sums and makes its moments by torch ops on the
small [C] (or [B, C]) vectors, in ``spade_moments``' order; the SPADE
layers use it on the fused path (``SpadeResidualBlock.fused``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

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
    """A SPADE input ready for ``spade_modulate``: ``x`` (bf16 [B, C, H,
    W], NCHW or channels_last, read 2x nearest-upsampled when ``up``), the
    float32 ``mean`` and ``r`` (1 / std) of its moments, [1, C, 1, 1]
    ("batch") or [B, C, 1, 1], and ``bias``, the bf16 [C] bias of the conv
    that made ``x`` when that conv ran without it (x is then read as
    bf16(x + bias)), or None."""

    x: torch.Tensor
    mean: torch.Tensor
    r: torch.Tensor
    up: bool = False
    bias: Optional[torch.Tensor] = None

    @property
    def hw(self) -> tuple[int, int]:
        """The feature resolution the input is read at."""
        k = 2 if self.up else 1
        return self.x.shape[2] * k, self.x.shape[3] * k


def normed(x: torch.Tensor, stats: str, data_axis: Axis = ONE,
           up: bool = False, bias: Optional[torch.Tensor] = None) -> Normed:
    """``x``'s SPADE moments (``spade_sums``, then ``moments_from_sums``)
    as a ``Normed``; a 2x nearest upsample repeats every element 4 times,
    so with ``up`` they are the upsampled tensor's moments too.  With
    ``bias`` they are the moments of bf16(x + bias)."""
    dims = _dims(stats)
    s1, s2 = spade_sums(x, stats, bias)
    mean, var = moments_from_sums(s1, s2, math.prod(x.shape[d] for d in dims),
                                  stats, data_axis)
    return Normed(x, mean, inv_std(var), up, bias)


def alike(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels can read it beside ``ref`` (both
    contiguous NCHW, or both channels_last), else a copy of ``t`` in
    ``ref``'s layout: the fused path's tensors follow the layout of the
    model's conv weights."""
    for fmt in (torch.contiguous_format, torch.channels_last):
        if ref.is_contiguous(memory_format=fmt) \
                and t.is_contiguous(memory_format=fmt):
            return t
    cl = ref.is_contiguous(memory_format=torch.channels_last)
    return t.contiguous(memory_format=torch.channels_last if cl
                        else torch.contiguous_format)


def _check_x(x, name: str = "x") -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
    if x.ndim != 4 or x.numel() == 0:
        raise ValueError(f"{name} must be a non-empty [B, C, H, W], got "
                         f"{tuple(x.shape)}")


def _check_bias(bias, n: int, name: str) -> None:
    if bias is not None and (bias.dtype != torch.bfloat16
                             or tuple(bias.shape) != (n,)):
        raise ValueError(f"{name} must be bfloat16 [{n}], got {bias.dtype} "
                         f"{tuple(bias.shape)}")


def _biased(x: torch.Tensor, bias) -> torch.Tensor:
    """A conv's separate bias pass: ``x + bias`` over the channels in bf16,
    or ``x`` itself."""
    return x if bias is None else x + bias.view(1, -1, 1, 1)


def spade_sums_plain(x: torch.Tensor, stats: str, bias=None):
    """Plain PyTorch version of ``spade_sums``: ``spade_moments``' sums (of
    ``x`` after its conv's bias pass, with ``bias``)."""
    _check_x(x)
    _check_bias(bias, x.shape[1], "bias")
    dims = _dims(stats)
    xs = _biased(x, bias).to(torch.float32)
    return (xs.sum(dims, keepdim=True, dtype=torch.float32),
            (xs * xs).sum(dims, keepdim=True, dtype=torch.float32))


def _modulate_shapes(x, gb, mean, r, up, x_bias,
                     gb_bias) -> tuple[int, int, int, int]:
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
    _check_bias(x_bias, c, "x_bias")
    _check_bias(gb_bias, 2 * c, "gb_bias")
    return b, c, h, w


def spade_modulate_plain(x, gb, mean, r, alpha: float, up: bool = False,
                         x_bias=None, gb_bias=None):
    """Plain PyTorch version of ``spade_modulate``: the unfused chain of
    the convs' bias passes (``x_bias`` on x, ``gb_bias`` on the gamma/beta
    conv's output), ``spade_normalize``, ``SPADE.forward`` and the block's
    ``leaky_relu`` (and, with ``up``, the generator's upsample of the
    normalised input)."""
    b, c, _, _ = _modulate_shapes(x, gb, mean, r, up, x_bias, gb_bias)
    x, gb = _biased(x, x_bias), _biased(gb, gb_bias)
    shape = (1, c, 1, 1) if mean.numel() == c else (b, c, 1, 1)
    n = ((x.to(torch.float32) - mean.view(shape)) * r.view(shape)).to(
        torch.bfloat16)
    if up:
        n = F.interpolate(n, scale_factor=2, mode="nearest")
    return F.leaky_relu(gb[:, :c] * n + gb[:, c:], alpha)


def _residual_shapes(h, bias, res, res_bias, up) -> tuple[int, int, int, int]:
    _check_x(h, "h")
    _check_x(res, "res")
    b, c, hh, w = h.shape
    want = (b, c, hh // 2, w // 2) if up else (b, c, hh, w)
    if tuple(res.shape) != want or (up and (hh % 2 or w % 2)):
        raise ValueError(f"res must be {list(want)}, got {tuple(res.shape)}")
    if bias is None:
        raise ValueError("bias is required: the block's last conv has one")
    _check_bias(bias, c, "bias")
    _check_bias(res_bias, c, "res_bias")
    return b, c, hh, w


def spade_residual_plain(h, bias, res, res_bias=None, up: bool = False):
    """Plain PyTorch version of ``spade_residual``: the block's last conv's
    bias pass on ``h``, then ``res + h``, where ``res`` is the learned
    skip's conv output after its own bias pass (``res_bias``) or the block
    input, 2x nearest-upsampled with ``up``."""
    _residual_shapes(h, bias, res, res_bias, up)
    res = _biased(res, res_bias)
    if up:
        res = F.interpolate(res, scale_factor=2, mode="nearest")
    # h first: the sum takes h's layout (one add, either order, rounds
    # alike).
    return _biased(h, bias) + res


def _lib():
    lib = build.load("spade")
    if lib.spade_sums.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spade_sums_scratch.argtypes = [i, i, i, i, i]
        lib.spade_sums_scratch.restype = ctypes.c_int64
        lib.spade_sums.argtypes = [p, p, i, i, i, i, i, p, p, p, p]
        lib.spade_sums.restype = ctypes.c_int
        lib.spade_modulate.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                       i, ctypes.c_float, p]
        lib.spade_modulate.restype = ctypes.c_int
        lib.spade_residual.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.spade_residual.restype = ctypes.c_int
    return lib


def _on_card(*ts) -> bool:
    """True for CUDA tensors, False for CPU ones; raises for anything
    else, a mix of devices, or a layout the kernels do not take (a 4-D
    tensor neither contiguous NCHW nor channels_last, a vector not
    contiguous).  None stands for an absent bias."""
    ts = [t for t in ts if t is not None]
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("the tensors lie on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t in ts:
        if not (t.is_contiguous() or (t.ndim == 4 and t.is_contiguous(
                memory_format=torch.channels_last))):
            raise ValueError("the kernel takes contiguous NCHW or "
                             "channels_last tensors")
    if any(t.numel() >= 2 ** 31 for t in ts):
        raise ValueError("the kernel takes tensors of fewer than 2^31 values")
    return True


def _nhwc(*ts) -> bool:
    """Whether the kernel reads the 4-D tensors ``ts`` as NHWC (all
    channels_last) or NCHW (all contiguous).  A tensor dense in both (C or
    H * W of 1) goes either way; a mix of layouts raises."""
    if all(t.is_contiguous() for t in ts):
        return False
    if all(t.is_contiguous(memory_format=torch.channels_last) for t in ts):
        return True
    raise ValueError("the tensors mix NCHW and channels_last layouts")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def spade_sums(x: torch.Tensor, stats: str, bias=None):
    """Float32 ``(sum x, sum x^2)`` of a bf16 ``x`` (NCHW or
    channels_last), per channel over (B, H, W) for "batch" ([1, C, 1, 1]
    each) or per (b, c) over (H, W) for "instance" ([B, C, 1, 1]).  With
    ``bias`` (bf16 [C]) ``x`` is read as bf16(x + bias), the bias pass of
    the conv that made it."""
    if not _on_card(x, bias):
        return spade_sums_plain(x, stats, bias)
    _check_x(x)
    _check_bias(bias, x.shape[1], "bias")
    instance = _dims(stats) == (2, 3)
    nhwc = _nhwc(x)
    lib = _lib()
    b, c, h, w = x.shape
    shape = (b, c, 1, 1) if instance else (1, c, 1, 1)
    out = torch.empty((2, math.prod(shape)), dtype=torch.float32,
                      device=x.device)
    scratch = torch.empty(lib.spade_sums_scratch(b, c, h * w, instance, nhwc),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.spade_sums(
            x.data_ptr(), _ptr(bias), b, c, h * w, instance, nhwc,
            scratch.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            _stream(x))
    if err:
        raise RuntimeError(f"spade_sums: CUDA error {err}")
    spade_sums.launches += 1
    return out[0].view(shape), out[1].view(shape)


def spade_modulate(x, gb, mean, r, alpha: float, up: bool = False,
                   x_bias=None, gb_bias=None):
    """``leaky_relu(gamma * bf16((x - mean) * r) + beta, alpha)`` in bf16.

    Args:
      x: bf16 [B, C, H, W], or with ``up`` the pre-upsample [B, C, H/2,
        W/2], read 2x nearest-upsampled.
      gb: bf16 [B, 2C, H, W], the gamma/beta conv's output: gamma is its
        first C channels, beta the rest (read in place).
      mean, r: float32 mean and 1 / std, C values ("batch") or B * C
        ("instance"), any shape.
      alpha: LeakyReLU's negative slope.
      x_bias, gb_bias: bf16 [C] and [2C], or None: the bias passes of the
        convs that made ``x`` and ``gb``, each value read as bf16(v +
        bias) (gamma and beta rounded so before the product).

    ``x``, ``gb`` and the result are all NCHW or all channels_last.

    Returns:
      bf16 [B, C, H, W].
    """
    if not _on_card(x, gb, mean, r, x_bias, gb_bias):
        return spade_modulate_plain(x, gb, mean, r, alpha, up, x_bias,
                                    gb_bias)
    b, c, h, w = _modulate_shapes(x, gb, mean, r, up, x_bias, gb_bias)
    nhwc = _nhwc(x, gb)
    out = torch.empty((b, c, h, w), dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last if nhwc
                      else torch.contiguous_format)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.spade_modulate(
            x.data_ptr(), _ptr(x_bias), gb.data_ptr(), _ptr(gb_bias),
            mean.data_ptr(), r.data_ptr(), out.data_ptr(), b, c, h, w, up,
            mean.numel() != c, nhwc, alpha, _stream(x))
    if err:
        raise RuntimeError(f"spade_modulate: CUDA error {err}")
    spade_modulate.launches += 1
    return out


def spade_residual(h, bias, res, res_bias=None, up: bool = False):
    """A SPADE residual block's output: ``bf16(res' + bf16(h + bias))``.

    Args:
      h: bf16 [B, C, H, W], the block's last conv's output before its bias.
      bias: bf16 [C], that conv's bias.
      res: bf16 [B, C, H, W], or with ``up`` [B, C, H/2, W/2] read 2x
        nearest-upsampled: the learned skip's conv output before its bias
        (``res_bias``, bf16 [C]; res' = bf16(res + res_bias)), or the block
        input (``res_bias`` None; res' = res).

    ``h``, ``res`` and the result are all NCHW or all channels_last.

    Returns:
      bf16 [B, C, H, W].
    """
    if not _on_card(h, bias, res, res_bias):
        return spade_residual_plain(h, bias, res, res_bias, up)
    b, c, hh, w = _residual_shapes(h, bias, res, res_bias, up)
    nhwc = _nhwc(h, res)
    out = torch.empty((b, c, hh, w), dtype=torch.bfloat16, device=h.device,
                      memory_format=torch.channels_last if nhwc
                      else torch.contiguous_format)
    lib = _lib()
    with torch.cuda.device(h.device):
        err = lib.spade_residual(
            h.data_ptr(), bias.data_ptr(), res.data_ptr(), _ptr(res_bias),
            out.data_ptr(), b, c, hh, w, up, nhwc, _stream(h))
    if err:
        raise RuntimeError(f"spade_residual: CUDA error {err}")
    spade_residual.launches += 1
    return out


spade_sums.launches = 0
spade_modulate.launches = 0
spade_residual.launches = 0
