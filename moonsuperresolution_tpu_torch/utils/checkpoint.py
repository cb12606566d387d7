"""Training checkpoints with ``torch.save`` (counterpart of the Orbax part of
moonsuperresolution_tpu/utils/checkpoint.py).

``save_checkpoint`` writes a trainer's whole state, so that a run resumes
where it stopped (the reference saves weights only and restarts at epoch
0): the three modules' weights, both Adam states, the micro-step count and
``grad_accum``'s partial sums, and, when given, the state of the loop's
``torch.Generator``.  ``save_params`` writes the weights alone (the loop's
per-epoch models).  Orbax checkpoints are not read; the Keras importer
(checkpoint.py:186-320) is a later slice of the port.
"""

from __future__ import annotations

import os

import torch
from torch import nn


def _save(obj, path: str) -> None:
    """``torch.save`` to a temporary file renamed over ``path``: a run cut
    while saving leaves the previous checkpoint whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, trainer, generator: torch.Generator | None
                    = None) -> None:
    state = {"nets": trainer.nets.state_dict(),
             "gen_opt": trainer.gen_opt.state_dict(),
             "disc_opt": (trainer.disc_opt.state_dict()
                          if trainer.disc_opt is not None else None),
             "step": trainer.step,
             "accum": dict(trainer.accum)}
    if generator is not None:
        state["generator"] = generator.get_state()
    _save(state, path)


def restore_checkpoint(path: str, trainer, generator: torch.Generator | None
                       = None) -> int:
    """Loads the state of ``save_checkpoint`` into ``trainer`` (and
    ``generator``) in place; returns the step."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    trainer.nets.load_state_dict(state["nets"], strict=True)
    trainer.gen_opt.load_state_dict(state["gen_opt"])
    if trainer.disc_opt is not None:
        trainer.disc_opt.load_state_dict(state["disc_opt"])
    trainer.step = state["step"]
    trainer.accum = {k: v.to(trainer.device) for k, v in state["accum"].items()}
    if generator is not None:
        generator.set_state(state["generator"])
    return trainer.step


def save_params(path: str, module: nn.Module) -> None:
    _save(module.state_dict(), path)


def restore_params(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)
