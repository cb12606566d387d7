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

import os

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


def process_device(device=None, process_index: int = 0) -> torch.device:
    """The device of one process of a multi-process run: ``cuda:{local
    rank}``, the local rank being ``LOCAL_RANK`` or else ``process_index``
    modulo the number of cards; the CPU when ``device`` says "cpu".  A
    ``device`` with an index is taken as it is.  Raises as
    ``resolve_device`` does without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local else process_index % torch.cuda.device_count()
    return torch.device("cuda", index)
