"""Device choice and float32 precision, in one place.

Every entry point of the package takes ``device=None``, which means the
first CUDA card.  With no card it raises instead of running on the CPU; the
CPU is used only when a caller passes ``device="cpu"`` (the tests do).

TF32 is switched OFF for convolutions and matrix products alike: a float32
run of the port is a float32 computation, as the JAX reference's is, and the
float32 parity checks need that.  The production path computes in bf16,
which TF32 does not touch, so the choice costs it nothing.
"""

from __future__ import annotations

import torch


def set_float32_precision() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        set_float32_precision()
    return dev
