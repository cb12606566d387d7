"""Training CLI of the port (counterpart of moonsuperresolution_tpu/cli/
train.py): one command for the reference's training scripts.

    python -m moonsuperresolution_tpu_torch.cli.train --recipe spade_256 \\
        --path_h5 MoonORTO2DEM.hdf5 --path_trn MoonORTO2DEM_train.pkl \\
        --path_val MoonORTO2DEM_val.pkl --output_path exp_spade

The store and its key pickles are the reference's (``moonsr-torch-make-h5``
builds them); ``--synthetic`` trains on generated terrain instead.  From
the store an epoch is the whole training set and the whole validation set;
``--max_steps_per_epoch`` then sets only the logging interval and the epoch
a resume starts from.  Recipes (config.py RECIPES): spade_256, spade_512,
spade_no_kl_512, cnn_256 and cnn_512; pix2pix is a later slice of the port,
and so are multi-device runs (``--mesh``, ``--distributed``).  Runs on the
first CUDA card; ``--device cpu`` runs on the CPU, where ``--small`` (the
recipe's variant and losses at image 64, latent 16, channel plan
64-64-32-32-16-8, encoder and discriminator width 8) trains in seconds.
TensorBoard files need tensorboardX, and the run raises without it unless
``--no_log``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

# --small: the model the CPU trains in seconds.
SMALL_MODEL = dict(image_size=64, latent_dim=16,
                   channel_plan=(64, 64, 32, 32, 16, 8), encoder_filters=8,
                   disc_filters=8)


def parse(argv=None):
    p = argparse.ArgumentParser("moonsuperresolution_tpu_torch trainer")
    p.add_argument("--recipe", type=str, default="spade_256")
    p.add_argument("--path_h5", type=str, default="",
                   help="the HDF5 tile store (MoonORTO2DEM.hdf5)")
    p.add_argument("--path_trn", type=str, default="",
                   help="the pickled training keys")
    p.add_argument("--path_val", type=str, default="",
                   help="the pickled validation keys")
    p.add_argument("--output_path", type=str, default=".")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated terrain (no dataset needed)")
    p.add_argument("--vgg_weights", type=str, default=None,
                   help="VGG19 weights: a Keras .h5 or a converted .npz")
    p.add_argument("--max_steps_per_epoch", type=int, default=None,
                   help="steps of a synthetic epoch; from the store, an "
                        "epoch is the whole training set and this sets only "
                        "the logging interval and a resume's epoch")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv/matmul compute (params stay float32)")
    p.add_argument("--grad_accum", type=int, default=None,
                   help="micro-steps per optimizer update (effective batch "
                        "= grad_accum * batch_size)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the first CUDA card by default")
    p.add_argument("--no_log", action="store_true",
                   help="write no TensorBoard files (they need tensorboardX)")
    p.add_argument("--small", action="store_true",
                   help="a small model of the recipe's variant, for runs on "
                        "the CPU: image 64, latent 16, channel plan "
                        "64-64-32-32-16-8, widths 8")
    return p.parse_args(argv)


def config(args):
    from moonsuperresolution_tpu_torch.config import RECIPES

    cfg = RECIPES[args.recipe]
    model = dict(SMALL_MODEL) if args.small else {}
    if args.bf16:
        model["compute_dtype"] = "bfloat16"
    run = {k: getattr(args, k) for k in ("epochs", "batch_size",
                                         "grad_accum")
           if getattr(args, k) is not None}
    if args.vgg_weights:
        run["vgg_weights_path"] = args.vgg_weights
    data = dataclasses.replace(cfg.data, h5_path=args.path_h5,
                               train_pkl=args.path_trn, val_pkl=args.path_val)
    return dataclasses.replace(
        cfg, output_path=args.output_path, seed=args.seed, data=data,
        model=dataclasses.replace(cfg.model, **model), **run)


def run(argv=None):
    """Trains as the command line says; returns ``train``'s (trainer,
    history)."""
    from moonsuperresolution_tpu_torch.train.loop import train

    args = parse(argv)
    return train(config(args), resume=args.resume, synthetic=args.synthetic,
                 max_steps_per_epoch=args.max_steps_per_epoch,
                 log=not args.no_log, device=args.device)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
