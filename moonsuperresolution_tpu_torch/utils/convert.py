"""Carry the JAX package's weights across to the port.

Input: a flax parameter tree as numpy arrays (``jax.device_get`` of it), or
a flat ``.npz`` whose keys are the tree paths joined with "/" (``save_npz``
writes one).  The tree of ``GauGANTrainer.init(...).params`` (``encoder``,
``generator``, ``discriminator``) loads into the port trainer's ``nets``,
its ``encoder`` and ``generator`` alone into a ``GauGAN`` (``load_params``'
``subtrees``), and a VGG19 tree
({``block1_conv1``: ...}) into ``models/vgg.py::VGG19Features``.  The
port's modules carry the JAX names, so the mapping is by name:

- conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in], both
  renamed ``kernel`` -> ``weight``;
- ``bias`` and InstanceNorm ``scale`` unchanged;
- SPADE's ``conv_gamma`` and ``conv_beta`` stay two parameters.

The Dense layers' NHWC flatten and reshape are done in the forward pass
(models/networks.py), so no Dense weight is permuted here.

``export_params`` is the exact inverse of ``convert_params``: a model's
weights (the discriminator's too) back to the flat "/"-keyed JAX layout
(OIHW -> HWIO, ``[out, in]`` -> ``[in, out]``, ``weight`` -> ``kernel``),
float32, ready for ``save_npz``.  With it a model built in the port (seeded random weights, say)
travels through the same ``.npz`` a JAX checkpoint does.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested mapping -> {"a/b/c": array}; a flat "/"-keyed dict passes
    through unchanged."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def save_npz(path: str, tree) -> None:
    np.savez(path, **flatten_tree(tree))


def convert_params(params) -> dict[str, torch.Tensor]:
    """JAX parameter tree (nested, flat, or a path to an ``.npz``) -> the
    port's float32 state dict."""
    if isinstance(params, (str, os.PathLike)):
        with np.load(params) as f:
            params = {k: f[k] for k in f.files}
    state = {}
    for key, v in flatten_tree(params).items():
        *path, leaf = key.split("/")
        if leaf == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            leaf = "weight"
        elif leaf not in ("bias", "scale"):
            raise ValueError(f"unknown parameter {key}")
        state[".".join(path + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(v, dtype=np.float32))
    return state


def export_params(model: nn.Module) -> dict[str, np.ndarray]:
    """The model's weights as the flat JAX tree ``convert_params`` reads:
    ``convert_params(export_params(m))`` is ``m.state_dict()`` in float32."""
    flat = {}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        v = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
            leaf = "kernel"
        elif leaf not in ("bias", "scale"):
            raise ValueError(f"unknown parameter {key}")
        flat["/".join(path + [leaf])] = np.ascontiguousarray(v)
    return flat


def load_params(model: nn.Module, params, subtrees=None) -> nn.Module:
    """Load converted weights with ``strict=True``: every parameter of the
    model is filled and no converted key is left over.  ``subtrees`` names
    the top-level subtrees to take, the rest of the tree is left out first
    (a GauGAN takes ``encoder`` and ``generator`` from a training run's
    tree, which holds the ``discriminator`` too); strictness holds inside
    them."""
    state = convert_params(params)
    if subtrees is not None:
        state = {k: v for k, v in state.items()
                 if k.split(".")[0] in subtrees}
    model.load_state_dict(state, strict=True)
    return model
