"""``trace``: a ``torch.profiler`` trace of a block of work, written as a
Chrome trace (counterpart of the JAX package's ``jax.profiler.trace`` of
one tile and one training step)."""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile

# Tiny kernels that open a profile on the card, ahead of the block.  A
# trace loses the first kernels of its block, and how many grows with every
# profile the process has taken before (a few for each profile of tens of
# thousands of kernels, whatever the time the lead takes): a late trace of a
# long run lost more than 32, the tile's patch kernels among them.  The
# lead kernels are what it loses instead; ``lead_kernels_lost`` counts them.
LEAD_KERNELS = 1024
LEAD_KERNEL_NAME = "CUDAFunctorOnSelf_add"


@contextlib.contextmanager
def trace(profile_dir: str, name: str, device):
    """Profiles the block (host and, on a card, device activity, waited
    for at its end) and writes ``<profile_dir>/<name>.json``.  On a card
    the trace opens with up to ``LEAD_KERNELS`` tiny ``add_`` kernels of
    its own (``LEAD_KERNEL_NAME``)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(profile_dir, exist_ok=True)
    lead = torch.zeros(1, device=device) if cuda else None
    with profile(activities=acts) as prof:
        if cuda:
            for _ in range(LEAD_KERNELS):
                lead.add_(1)
            torch.cuda.synchronize(device)
        yield
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))


def lead_kernels_lost(events) -> int:
    """How many of ``trace``'s lead kernels a card trace lost: its
    ``traceEvents`` open with the run of lead kernels that survived."""
    names = [e["name"] for e in sorted(
        (e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])]
    seen = next((i for i, n in enumerate(names)
                 if LEAD_KERNEL_NAME not in n), len(names))
    return LEAD_KERNELS - seen
