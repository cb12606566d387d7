"""Training checkpoints with ``torch.save`` (counterpart of the Orbax part of
moonsuperresolution_tpu/utils/checkpoint.py).

``save_checkpoint`` writes a trainer's whole state, so that a run resumes
where it stopped (the reference saves weights only and restarts at epoch
0): every network's weights (a GauGAN trainer's three, a pix2pix
trainer's two), both Adam states, the micro-step count and
``grad_accum``'s partial sums, and, when given, the state of the loop's
``torch.Generator``.  ``save_params`` writes the weights alone (the loop's
per-epoch models).  Orbax checkpoints are not read.

The Keras / TF SavedModel import (counterpart of checkpoint.py:60-320)
turns the reference's own weights into the JAX parameter tree, as numpy:
``encoder_/generator_/discriminator_params_from_weights`` for the GauGAN
family, ``pix2pix_generator_/pix2pix_discriminator_params_from_weights``,
and ``import_tf_savedmodel`` for a checkpoint directory.  The tree reaches
a torch module through ``utils.convert.load_params`` (or ``save_npz`` and
``moonsr-torch-process --model_path``).  The mapping is order- and
shape-driven: Keras creates variables in layer-creation order, so it keys
on that order and the tensors' ranks, with a guard on Keras' auto-numbered
layer names (``_WeightStream``).  TensorFlow is imported only inside
``_savedmodel_ordered_weights``.
"""

from __future__ import annotations

import os
import re

import numpy as np
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


# ---------------------------------------------------------------------------
# Keras/TF weight import (order- and shape-driven)
# ---------------------------------------------------------------------------


class _WeightStream:
    """Sequential reader over (name, value) pairs in creation order.

    Two guards make mis-mapped imports fail loudly instead of silently:

    - ``take``'s shape predicate (a Dense where a conv was expected, etc.);
    - a *creation-order* check on Keras auto-generated layer names: TF
      numbers same-type layers in creation order (``conv2d``, ``conv2d_1``,
      ...), so within one SavedModel the per-family index must never
      decrease.  Any permutation of same-shape tensors (e.g. a resblock's
      conv_1 and conv_2, both [3,3,1024,1024] — undetectable by shape)
      trips this check.  Streams with uninformative names (no layer path)
      skip the guard; order+shape remain the contract there.
    """

    def __init__(self, names, values):
        self.items = list(zip(names, values))
        self.pos = 0
        self._family_idx: dict = {}

    @staticmethod
    def _layer_family(name):
        """('conv2d', 3) from 'model/conv2d_3/kernel:0'; None if the name
        carries no layer path."""
        if not isinstance(name, str) or "/" not in name:
            return None
        layer = name.split("/")[-2]
        if not layer:
            return None
        m = re.fullmatch(r"(.*?)(?:_(\d+))?", layer)
        base, idx = m.group(1), m.group(2)
        if not base:
            return None
        return base, int(idx) if idx is not None else 0

    def _check_order(self, name):
        fam = self._layer_family(name)
        if fam is None:
            return
        base, idx = fam
        prev = self._family_idx.get(base)
        if prev is not None and idx < prev:
            raise ValueError(
                f"weight stream out of creation order at #{self.pos}: "
                f"layer '{base}_{idx}' after '{base}_{prev}' — the "
                f"SavedModel's variable order does not match the reference "
                f"builders' creation order; refusing to import (same-shape "
                f"tensors would be silently mis-mapped)"
            )
        self._family_idx[base] = max(idx, prev if prev is not None else idx)

    def take(self, pred, what: str):
        """Pop the next item matching ``pred`` (skipping non-matches is NOT
        allowed — order is the contract)."""
        if self.pos >= len(self.items):
            raise ValueError(f"weight stream exhausted looking for {what}")
        name, val = self.items[self.pos]
        if not pred(name, val):
            raise ValueError(
                f"unexpected weight at #{self.pos} ({name}, shape "
                f"{np.shape(val)}) while looking for {what}"
            )
        self._check_order(name)
        self.pos += 1
        return np.asarray(val)

    def skip(self, n: int):
        """Skip n items (e.g. BatchNorm moving statistics, which the
        batch-stat norm never uses)."""
        self.pos += n

    def done(self) -> bool:
        return self.pos >= len(self.items)


def _is_kernel4(name, v):
    return np.ndim(v) == 4


def _is_kernel2(name, v):
    return np.ndim(v) == 2


def _is_vec(name, v):
    return np.ndim(v) == 1


def _as_numpy(tree):
    """Every leaf of a nested dict as a numpy array (the JAX builders'
    ``tree_map(np.asarray, ...)``)."""
    return {k: _as_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _conv(stream, bias=True, what="conv"):
    k = stream.take(_is_kernel4, f"{what}.kernel")
    if bias:
        b = stream.take(_is_vec, f"{what}.bias")
        return {"kernel": k, "bias": b}
    return {"kernel": k}


def _norm(stream, what="norm"):
    g = stream.take(_is_vec, f"{what}.gamma")
    b = stream.take(_is_vec, f"{what}.beta")
    return {"scale": g.reshape(-1), "bias": b.reshape(-1)}


def _dense(stream, what="dense"):
    k = stream.take(_is_kernel2, f"{what}.kernel")
    b = stream.take(_is_vec, f"{what}.bias")
    return {"kernel": k, "bias": b}


def _spade(stream, what="spade"):
    """One SPADE layer = conv(128) + conv_gamma + conv_beta, created in that
    order (spade/models/spade.py:8-11)."""
    return {
        "conv": _conv(stream, what=f"{what}.conv"),
        "conv_gamma": _conv(stream, what=f"{what}.conv_gamma"),
        "conv_beta": _conv(stream, what=f"{what}.conv_beta"),
    }


def encoder_params_from_weights(names, values):
    """Reference encoder (networks.py:8-34): 5 downsample blocks (conv
    without bias; instance norm on blocks 1-4) then mean/variance Dense
    heads.  Creation order: block convs+norms, then the two heads."""
    s = _WeightStream(names, values)
    params = {}
    for i in range(5):
        block = {"conv": _conv(s, bias=False, what=f"down_{i}.conv")}
        if i > 0:
            block["norm"] = _norm(s, what=f"down_{i}.norm")
        params[f"down_{i}"] = block
    params["mean"] = _dense(s, "mean")
    params["variance"] = _dense(s, "variance")
    return _as_numpy(params)


def generator_params_from_weights(names, values):
    """Reference SPADE generator (networks.py:37-57).  Creation order:
    Dense, then per resblock (blocks.py:14-27): spade_1, spade_2, conv_1,
    conv_2, [spade_3, conv_3 when channels change], then the 4x4 head.
    The channel plan is the reference's full width, as in the JAX
    builder."""
    s = _WeightStream(names, values)
    params = {"dense": _dense(s, "latent dense")}
    plan_in = [1024, 1024, 1024, 1024, 512, 256]
    plan_out = [1024, 1024, 1024, 512, 256, 128]
    for b in range(6):
        has_skip = plan_in[b] != plan_out[b]
        block = {
            "spade_1": _spade(s, f"rb{b}.spade_1"),
            "spade_2": _spade(s, f"rb{b}.spade_2"),
            "conv_1": _conv(s, what=f"rb{b}.conv_1"),
            "conv_2": _conv(s, what=f"rb{b}.conv_2"),
        }
        if has_skip:
            block["spade_3"] = _spade(s, f"rb{b}.spade_3")
            block["conv_3"] = _conv(s, what=f"rb{b}.conv_3")
        params[f"resblock_{b}"] = block
    params["head"] = _conv(s, what="head")
    return _as_numpy(params)


def discriminator_params_from_weights(names, values):
    """Reference multi-scale discriminator (networks.py:60-76): 4 downsample
    blocks (conv no-bias; norm on blocks 1-3) + biased 4x4 head conv."""
    s = _WeightStream(names, values)
    params = {}
    for i in range(4):
        block = {"conv": _conv(s, bias=False, what=f"down_{i}.conv")}
        if i > 0:
            block["norm"] = _norm(s, what=f"down_{i}.norm")
        params[f"down_{i}"] = block
    params["head"] = _conv(s, what="head")
    return _as_numpy(params)


def _bn(stream, what="bn"):
    """Keras BatchNormalization: gamma, beta, moving_mean, moving_variance —
    the moving stats are dropped (the reference only ever runs BN in
    training mode, pix2pix.py:146-148, so the norm is batch-stat-only)."""
    g = stream.take(_is_vec, f"{what}.gamma")
    b = stream.take(_is_vec, f"{what}.beta")
    stream.skip(2)
    return {"scale": g.reshape(-1), "bias": b.reshape(-1)}


def pix2pix_generator_params_from_weights(names, values, depth: int = 8):
    """Reference pix2pix U-Net (pix2pix.py:88-108).  Creation order: the
    down stack (conv [+ BN]), the up stack (deconv + BN), then the tanh
    head deconv (kernel layout (kh, kw, out, in), which ``convert_params``
    turns into ``nn.ConvTranspose2d``'s (in, out, kh, kw))."""
    s = _WeightStream(names, values)
    params = {}
    for i in range(depth):
        block = {"conv": _conv(s, bias=False, what=f"down_{i}.conv")}
        if i > 0:
            block["bn"] = _bn(s, f"down_{i}.bn")
        params[f"down_{i}"] = block
    for i in range(depth - 1):
        params[f"up_{i}"] = {
            "deconv": _conv(s, bias=False, what=f"up_{i}.deconv"),
            "bn": _bn(s, f"up_{i}.bn"),
        }
    params["head"] = _conv(s, what="head")
    return _as_numpy(params)


def pix2pix_discriminator_params_from_weights(names, values):
    """Reference pix2pix PatchGAN (pix2pix.py:118-135): 3 downsample blocks,
    conv(512)+BN, conv(1)."""
    s = _WeightStream(names, values)
    params = {}
    for i in range(3):
        block = {"conv": _conv(s, bias=False, what=f"down_{i}.conv")}
        if i > 0:
            block["bn"] = _bn(s, f"down_{i}.bn")
        params[f"down_{i}"] = block
    params["conv"] = _conv(s, bias=False, what="conv512")
    params["bn"] = _bn(s, "bn")
    params["head"] = _conv(s, what="head")
    return _as_numpy(params)


def _keras_ordered_weights(keras_model):
    """(names, values) for a live Keras model, in creation order."""
    names = [getattr(w, "path", None) or w.name for w in keras_model.weights]
    values = [np.asarray(w) for w in keras_model.weights]
    return names, values


def _savedmodel_ordered_weights(savedmodel_dir: str):
    """(names, values) from a TF SavedModel directory (checkpoint order =
    creation order for the reference's builders).  TensorFlow is imported
    here only."""
    import tensorflow as tf

    loaded = tf.saved_model.load(savedmodel_dir)
    names = [v.name for v in loaded.variables]
    values = [v.numpy() for v in loaded.variables]
    return names, values


def import_tf_savedmodel(checkpoint_dir: str,
                         with_discriminator: bool = True) -> dict:
    """Import a full reference checkpoint directory (generator/
    discriminator/ encoder/ SavedModels, model.py:569-605) into the JAX
    parameter tree layout, as numpy: ``{"generator", "encoder"[,
    "discriminator"]}``.  ``utils.convert.load_params(model, tree,
    subtrees=...)`` loads it into the port's modules."""
    n, v = _savedmodel_ordered_weights(os.path.join(checkpoint_dir,
                                                    "generator"))
    params = {"generator": generator_params_from_weights(n, v)}
    n, v = _savedmodel_ordered_weights(os.path.join(checkpoint_dir, "encoder"))
    params["encoder"] = encoder_params_from_weights(n, v)
    disc_dir = os.path.join(checkpoint_dir, "discriminator")
    if with_discriminator and os.path.isdir(disc_dir):
        n, v = _savedmodel_ordered_weights(disc_dir)
        params["discriminator"] = discriminator_params_from_weights(n, v)
    return params
