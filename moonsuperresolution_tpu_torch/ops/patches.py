"""Fused patch preparation: grid extraction + validity + min-max
normalisation (counterpart of moonsuperresolution_tpu/ops/pallas/patches.py).

``extract_normalize_patches`` launches the hand-written CUDA kernel
``csrc/patches.cu`` for CUDA tensors and runs its plain PyTorch version,
``extract_normalize_patches_plain``, for CPU tensors.  There is no fallback
from the one to the other: a CUDA tensor either goes through the kernel or
the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from moonsuperresolution_tpu_torch import build


def _check(img_slab, dem_slab, grid_hw, stride, size) -> None:
    for t in (img_slab, dem_slab):
        if t.dtype != torch.float32:
            raise TypeError(f"slabs must be float32, got {t.dtype}")
        if t.ndim != 2 or t.shape[0] != t.shape[1]:
            raise ValueError(f"slabs must be square [L, L], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("slabs must be contiguous")
    if img_slab.shape != dem_slab.shape or img_slab.device != dem_slab.device:
        raise ValueError("ortho and DEM slabs differ in shape or device")
    gy, gx = grid_hw
    if min(gy, gx, stride, size) < 1:
        raise ValueError(f"bad geometry grid={grid_hw} stride={stride} "
                         f"size={size}")
    if (max(gy, gx) - 1) * stride + size > img_slab.shape[0]:
        raise ValueError(f"grid {grid_hw} at stride {stride} with patch "
                         f"{size} overruns the {img_slab.shape[0]}-px slab")


def extract_normalize_patches_plain(img_slab, dem_slab, grid_hw, stride,
                                    size, no_value):
    """Plain PyTorch version of the kernel, same contract (see
    ``extract_normalize_patches``)."""
    _check(img_slab, dem_slab, grid_hw, stride, size)
    gy, gx = grid_hw
    n = gy * gx

    def grid(slab):
        win = slab.unfold(0, size, stride).unfold(1, size, stride)
        return win[:gy, :gx].reshape(n, size, size)

    pi, pd = grid(img_slab), grid(dem_slab)
    imin, imax = pi.amin((1, 2), keepdim=True), pi.amax((1, 2), keepdim=True)
    dmin, dmax = pd.amin((1, 2), keepdim=True), pd.amax((1, 2), keepdim=True)
    x = torch.stack([
        (pi - imin) / torch.clamp(imax - imin, min=1e-12) - 0.5,
        (pd - dmin) / torch.clamp(dmax - dmin, min=1e-12) - 0.5,
    ], dim=1)
    valid = ((imin > no_value) & (dmin > no_value)).to(torch.float32)
    return (x.permute(0, 2, 3, 1), valid.reshape(n), dmin.reshape(n),
            dmax.reshape(n))


def _lib():
    lib = build.load("patches")
    fn = lib.extract_normalize_patches
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, ctypes.c_float, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.extract_normalize_patches_scratch.argtypes = [i, i, i, i]
        lib.extract_normalize_patches_scratch.restype = ctypes.c_int64
    return lib


def extract_normalize_patches(img_slab, dem_slab, grid_hw, stride, size,
                              no_value):
    """Fused patch preparation.

    Args:
      img_slab, dem_slab: ``[L, L]`` float32 contiguous slabs (ortho, DEM).
      grid_hw: (Gy, Gx) patch grid; patch (i, j) starts at (i*stride,
        j*stride).
      stride, size: window geometry.
      no_value: nodata sentinel.

    Returns:
      ``(x [N, size, size, 2], valid [N] float32 0/1, dmin [N], dmax [N])``
      with N = Gy*Gx, the JAX function's layout.  ``x`` is a permuted view
      of a contiguous ``[N, 2, size, size]`` tensor: ``x.permute(0, 3, 1,
      2)`` gives the NCHW patches back without a copy.
    """
    if img_slab.device.type == "cpu":
        return extract_normalize_patches_plain(img_slab, dem_slab, grid_hw,
                                               stride, size, no_value)
    if img_slab.device.type != "cuda":
        raise ValueError(f"no kernel for device {img_slab.device}")
    _check(img_slab, dem_slab, grid_hw, stride, size)
    lib = _lib()
    gy, gx = grid_hw
    n = gy * gx
    dev = img_slab.device
    out = torch.empty((n, 2, size, size), dtype=torch.float32, device=dev)
    stats = torch.empty((3, n), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        lib.extract_normalize_patches_scratch(gy, gx, stride, size),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.extract_normalize_patches(
            img_slab.data_ptr(), dem_slab.data_ptr(), img_slab.shape[0], gy,
            gx, stride, size, no_value, scratch.data_ptr(), out.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"extract_normalize_patches: CUDA error {err}")
    extract_normalize_patches.launches += 1
    return out.permute(0, 2, 3, 1), stats[0], stats[1], stats[2]


extract_normalize_patches.launches = 0
