"""VGG19 perceptual features for the VGG feature-matching loss (counterpart
of moonsuperresolution_tpu/models/vgg.py; reference: spade/losses.py:56-80).

The reference compares the MAE of the five ``block{i}_conv1`` activations
(after ReLU) of Keras' imagenet VGG19, weighted 1/32, 1/16, 1/8, 1/4 and 1,
after caffe preprocessing.  Pretrained weights come from a Keras ``.h5`` or
from the ``.npz`` that the JAX package's ``save_vgg19_npz`` writes
(``cli/convert_vgg.py``); nothing is downloaded.  Without weights the
trainer falls back to fixed-seed random features, loudly.  The network runs
in float32, as the JAX module does, whatever the generator's compute dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from moonsuperresolution_tpu_torch.losses import mae_loss
from moonsuperresolution_tpu_torch.utils.convert import load_params

# (convs per block, channels per block) of VGG19's feature trunk.
_BLOCKS = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))
FEATURE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
# Caffe-mode BGR means of keras.applications.vgg19.preprocess_input.
_BGR_MEANS = (103.939, 116.779, 123.68)


def layer_names():
    return [f"block{b + 1}_conv{c + 1}"
            for b, (n, _) in enumerate(_BLOCKS) for c in range(n)]


def _widths():
    return [ch for n, ch in _BLOCKS for _ in range(n)]


def vgg_preprocess(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1]-scaled RGB (NCHW) -> caffe-preprocessed BGR
    (losses.py:72-74): x 127.5 after + 1, channels reversed, minus the
    means."""
    x = 127.5 * (x + 1.0)
    means = torch.tensor(_BGR_MEANS, dtype=x.dtype, device=x.device)
    return x.flip(1) - means[None, :, None, None]


class VGG19Features(nn.Module):
    """The five post-ReLU ``block{i}_conv1`` maps, 2x2 max pools between the
    blocks.  It holds all sixteen convs (the weight files do), but stops at
    ``block5_conv1``: the convs after it feed no feature."""

    def __init__(self):
        super().__init__()
        cin = 3
        for b, (n, ch) in enumerate(_BLOCKS):
            for c in range(n):
                self.add_module(f"block{b + 1}_conv{c + 1}",
                                nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x):
        feats = []
        for b, (n, _) in enumerate(_BLOCKS):
            if b:
                x = F.max_pool2d(x, 2)
            x = F.relu(getattr(self, f"block{b + 1}_conv1")(x))
            feats.append(x)
            if b + 1 < len(_BLOCKS):
                for c in range(2, n + 1):
                    x = F.relu(getattr(self, f"block{b + 1}_conv{c}")(x))
        return feats


def frozen(model: VGG19Features) -> VGG19Features:
    return model.requires_grad_(False).eval()


def init_vgg(generator: torch.Generator | None = None) -> VGG19Features:
    """Random VGG19 (the fallback when no weights are given), as flax
    initialises an ``nn.Conv``: lecun normal kernels (a normal truncated at
    two standard deviations, variance 1 / fan_in), zero biases.  Draws from
    ``generator`` (a CPU generator gives the same weights on every device);
    they differ from the JAX fallback's."""
    model = VGG19Features()
    with torch.no_grad():
        for m in model.children():
            fan_in = m.weight.shape[1] * 9
            nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            m.weight.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)
            m.bias.zero_()
    return frozen(model)


def vgg_from_params(params) -> VGG19Features:
    """A frozen VGG19 from a flat JAX-layout tree ({layer: {kernel HWIO,
    bias}}), loaded with ``strict=True``."""
    return frozen(load_params(VGG19Features(), params))


def load_vgg19_npz(npz_path: str) -> dict:
    """The tree of an ``.npz`` written by the JAX ``save_vgg19_npz``
    (``layer/kernel``, ``layer/bias``), output widths checked."""
    with np.load(npz_path) as f:
        params = {}
        for name, ch in zip(layer_names(), _widths()):
            kernel = f[f"{name}/kernel"]
            if kernel.shape[-1] != ch:
                raise ValueError(f"{name}: expected {ch} output channels, "
                                 f"got {kernel.shape}")
            params[name] = {"kernel": kernel, "bias": f[f"{name}/bias"]}
    return params


def load_keras_vgg19_weights(h5_path: str) -> dict:
    """The tree of a Keras VGG19 ``.h5`` weight file (as distributed for
    ``keras.applications.VGG19(include_top=False)``)."""
    import h5py

    params = {}
    with h5py.File(h5_path, "r") as f:
        grp = f["model_weights"] if "model_weights" in f else f
        for name in layer_names():
            layer = grp[name]
            # Keras nests the weights one level deeper under the layer name.
            inner = layer[name] if name in layer else layer
            params[name] = {"kernel": np.array(inner["kernel:0"]),
                            "bias": np.array(inner["bias:0"])}
    return params


def load_vgg19(path: str) -> VGG19Features:
    """A frozen pretrained VGG19 from a Keras ``.h5`` or a converted
    ``.npz``."""
    load = load_vgg19_npz if path.endswith(".npz") \
        else load_keras_vgg19_weights
    return vgg_from_params(load(path))


def vgg_feature_matching_loss(vgg: VGG19Features, y_true: torch.Tensor,
                              y_pred: torch.Tensor) -> torch.Tensor:
    """Weighted MAE of the VGG19 features of caffe-preprocessed 3-channel
    inputs (losses.py:76-80).  ``y_true`` is a constant (the target), so its
    features are taken without autograd."""
    with torch.no_grad():
        rf = vgg(vgg_preprocess(y_true))
    ff = vgg(vgg_preprocess(y_pred))
    loss = 0.0
    for w, a, b in zip(FEATURE_WEIGHTS, rf, ff):
        loss = loss + w * mae_loss(a, b)
    return loss


def repeat3(x: torch.Tensor) -> torch.Tensor:
    """1 channel -> 3 (the reference's tf.repeat(target, 3, -1))."""
    return x.repeat(1, 3, 1, 1)
