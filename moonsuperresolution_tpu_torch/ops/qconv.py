"""int8 3x3 convolution with the dequantize / requantize epilogue of the
quantized generator (counterpart of the conv in
moonsuperresolution_tpu/models/quant.py::_qconv).

``qconv`` launches the hand-written CUDA kernel ``csrc/qconv.cu`` (s8 x s8
implicit GEMM on Hopper's wgmma tensor cores, operands gathered by TMA
through a warp-specialised ring, a persistent grid, exact int32
accumulation, fused epilogue) for CUDA tensors and runs its plain PyTorch
version, ``qconv_plain``, for CPU tensors.  There is no fallback from the
one to the other: a CUDA tensor either goes through the kernel or the call
raises.

The kernel takes any C that is a multiple of 16 (a tensor map's row stride
is a multiple of 16 bytes; channels past C in the kernel's 128-channel K
step are zero-filled) and any Cout that is a multiple of 8; ``qconv``
raises on anything else for a CUDA tensor.  The plain version takes any
width.  The generator's full widths (C = 128 to 1024) are multiples of 128.

``pixel_box`` chooses the box of 128 output pixels that one tile of the
kernel covers; the kernel derives its grid of tiles from it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from moonsuperresolution_tpu_torch import build

ACC_DTYPES = (torch.int32, torch.bfloat16)
OUT_DTYPES = (torch.float32, torch.bfloat16)
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

BOX_PIXELS = 128   # output pixels per tile: two m64 wgmma rows


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def pixel_box(h: int, w: int) -> tuple[int, int, int]:
    """The box ``(bB, bH, bW)`` of 128 output pixels that one kernel tile
    covers in an output of ``h x w`` images: as wide as W allows (up to 128), then
    as tall as H allows, then over as many images as the rest (1 x 1 x 128
    for W >= 128, ..., 2 x 8 x 8 for 8 x 8 maps).  csrc/qconv.cu tiles each
    image with it from the corner (pixels of a box past the image are
    computed on zeros and masked), 128 channels a tile."""
    bw = min(BOX_PIXELS, _pow2_at_least(w))
    bh = min(BOX_PIXELS // bw, _pow2_at_least(h))
    return BOX_PIXELS // (bw * bh), bh, bw


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check(x, w, scale_x, w_scale, bias, acc_dtype, out_dtype,
           out_scale_inv) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"x and w must be int8, got {x.dtype}, {w.dtype}")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[1:3]) != (3, 3):
        raise ValueError(f"need x [B, H, W, C] and w [Cout, 3, 3, C], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    c, n = x.shape[3], w.shape[0]
    if w.shape[3] != c:
        raise ValueError(f"x has {c} channels, w expects {w.shape[3]}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous (NHWC, [Cout, 3, 3, C])")
    if scale_x.dtype != torch.float32 or scale_x.ndim != 0:
        raise ValueError("scale_x must be a 0-d float32 tensor")
    vecs = [w_scale, bias] + ([] if out_scale_inv is None else [out_scale_inv])
    for v in vecs:
        if v.dtype != torch.float32 or tuple(v.shape) != (n,) \
                or not v.is_contiguous():
            raise ValueError(f"per-channel scales and bias must be float32 "
                             f"[{n}], contiguous")
    if acc_dtype not in ACC_DTYPES:
        raise ValueError(f"acc_dtype {acc_dtype} not in {ACC_DTYPES}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype} not in {OUT_DTYPES}")
    if any(t.device != x.device for t in [w, scale_x, *vecs]):
        raise ValueError("all operands must be on one device")


def qconv_plain(x, w, scale_x, w_scale, bias, acc_dtype, out_dtype,
                out_scale_inv=None):
    """Plain PyTorch version of the kernel, same contract (see ``qconv``).

    The conv runs in float64 and is rounded back to int32: exact, since
    every product and partial sum is an integer below 9 * 1024 * 127^2 <
    1.5e8, far under 2^53.  The epilogue is the kernel's, one torch op per
    rounding, in the kernel's order."""
    _check(x, w, scale_x, w_scale, bias, acc_dtype, out_dtype, out_scale_inv)
    xd = x.permute(0, 3, 1, 2).to(torch.float64)
    wd = w.permute(0, 3, 1, 2).to(torch.float64)
    acc = torch.round(F.conv2d(xd, wd, padding=1)).to(torch.int32)
    y = acc.to(torch.float32)
    if acc_dtype == torch.bfloat16:
        y = y.to(torch.bfloat16).to(torch.float32)
    y = y * (scale_x * w_scale)[:, None, None]
    y = y + bias[:, None, None]
    if out_scale_inv is not None:
        y = torch.clamp(torch.round(y * out_scale_inv[:, None, None]),
                        -127, 127).to(torch.int8)
    else:
        y = y.to(out_dtype)
    return y.contiguous(memory_format=torch.channels_last)


def _lib():
    lib = build.load("qconv")
    fn = lib.qconv3x3_s8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, *[i] * 11, p]
        fn.restype = ctypes.c_int
    return lib


def qconv(x_s8_nhwc, w_s8, scale_x, w_scale, bias, acc_dtype, out_dtype,
          out_scale_inv=None):
    """int8 3x3 SAME conv with the fused dequantize epilogue.

    Args:
      x_s8_nhwc: ``[B, H, W, C]`` int8, contiguous.
      w_s8: ``[Cout, 3, 3, C]`` int8, contiguous.
      scale_x: 0-d float32 tensor, the activation scale (read on the device:
        no host sync).
      w_scale, bias: ``[Cout]`` float32.
      acc_dtype: ``torch.int32`` (exact) or ``torch.bfloat16`` (the sum
        rounded once to bf16 before the epilogue).
      out_dtype: ``torch.float32`` or ``torch.bfloat16``.
      out_scale_inv: optional ``[Cout]`` float32 inverse scale: the result
        is then requantized to int8, ``clip(rint(y * inv), -127, 127)``.

    Returns:
      ``[B, Cout, H, W]`` in ``channels_last`` memory (NHWC storage):
      ``acc * (scale_x * w_scale) + bias`` per channel, as ``out_dtype`` or,
      with ``out_scale_inv``, int8.
    """
    if x_s8_nhwc.device.type == "cpu":
        return qconv_plain(x_s8_nhwc, w_s8, scale_x, w_scale, bias, acc_dtype,
                           out_dtype, out_scale_inv)
    if x_s8_nhwc.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_s8_nhwc.device}")
    _check(x_s8_nhwc, w_s8, scale_x, w_scale, bias, acc_dtype, out_dtype,
           out_scale_inv)
    b, h, wd, c = x_s8_nhwc.shape
    n = w_s8.shape[0]
    if c % 16 or n % 8:
        raise ValueError(f"the kernel needs C % 16 == 0 and Cout % 8 == 0, "
                         f"got C = {c}, Cout = {n}")
    if b * h * wd >= 2 ** 31:
        raise ValueError(f"{tuple(x_s8_nhwc.shape)}: B*H*W must be < 2^31")
    if x_s8_nhwc.data_ptr() % 16 or w_s8.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    lib = _lib()
    kind = torch.int8 if out_scale_inv is not None else out_dtype
    dev = x_s8_nhwc.device
    out = torch.empty((b, h, wd, n), dtype=kind, device=dev)
    box = pixel_box(h, wd)
    with torch.cuda.device(dev):
        err = lib.qconv3x3_s8(
            x_s8_nhwc.data_ptr(), w_s8.data_ptr(), scale_x.data_ptr(),
            w_scale.data_ptr(), bias.data_ptr(),
            None if out_scale_inv is None else out_scale_inv.data_ptr(),
            out.data_ptr(), b, h, wd, c, n, int(acc_dtype == torch.bfloat16),
            _OUT_KIND[kind], *box, _sm_count(dev),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"qconv: error {err} (a cudaError_t; 90001 a pixel box the "
            f"kernel refuses, 90002 no tensor-map encoder in the driver, "
            f"91000 + a CUresult a refused tensor map) for x "
            f"{tuple(x_s8_nhwc.shape)}, Cout {n}, pixel box {box}")
    qconv.launches += 1
    return out.permute(0, 3, 1, 2)


qconv.launches = 0
