"""Convert pretrained VGG19 weights into the ``.npz`` that ``--vgg_weights``
reads (counterpart of moonsuperresolution_tpu/cli/convert_vgg.py).

The reference trains its perceptual loss against Keras' imagenet VGG19
(spade/losses.py:56-80).  Nothing is downloaded: bring the weights as a
file, convert them here and pass the output to ``moonsr-torch-train
--vgg_weights`` (``TrainConfig.vgg_weights_path``).  The ``.npz`` holds
``{layer}/kernel`` (HWIO) and ``{layer}/bias`` for the 16 conv layers,
the file the JAX package's ``save_vgg19_npz`` writes, so either package
reads the other's.

Accepted inputs:
- Keras ``.h5`` weight files (keras.applications.VGG19; only the conv
  trunk is read; h5py is imported when one is given);
- torchvision ``vgg19`` state dicts (``.pth``/``.pt``), OIHW -> HWIO.
  torchvision's VGG19 expects [0, 1] RGB normalised with the imagenet
  mean and std, not caffe preprocessing: its features differ from the
  Keras weights the reference used, so prefer the ``.h5``.

    python -m moonsuperresolution_tpu_torch.cli.convert_vgg \\
        --input vgg19_weights.h5 --output vgg19.npz

It runs on the host and takes no ``--device``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from moonsuperresolution_tpu_torch.models import vgg as vggmod
from moonsuperresolution_tpu_torch.utils.convert import save_npz


def convert_torch_vgg19(pth_path: str) -> dict:
    """torchvision vgg19 state dict -> the JAX-layout tree (OIHW -> HWIO)."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    # torchvision indexes features sequentially: a conv and a ReLU per
    # layer, one max-pool per block.
    params = {}
    idx = 0
    for b, (n_convs, _ch) in enumerate(vggmod._BLOCKS):
        for c in range(n_convs):
            w = sd[f"features.{idx}.weight"].numpy()  # OIHW
            params[f"block{b + 1}_conv{c + 1}"] = {
                "kernel": np.transpose(w, (2, 3, 1, 0)),  # -> HWIO
                "bias": sd[f"features.{idx}.bias"].numpy(),
            }
            idx += 2  # conv + relu
        idx += 1  # maxpool
    return params


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True,
                   help=".h5 (Keras) or .pth/.pt (torchvision) weights")
    p.add_argument("--output", required=True, help="output .npz path")
    return p.parse_args(argv)


def run(argv=None) -> dict:
    """Converts as the command line says; returns the tree written."""
    a = parse(argv)
    if a.input.endswith((".pth", ".pt")):
        params = convert_torch_vgg19(a.input)
    else:
        params = vggmod.load_keras_vgg19_weights(a.input)
    save_npz(a.output, params)
    n = sum(p["kernel"].size + p["bias"].size for p in params.values())
    print(f"wrote {a.output}: {len(params)} conv layers, {n:,} parameters")
    return params


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
