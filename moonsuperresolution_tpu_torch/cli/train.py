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
spade_no_kl_512, cnn_256, cnn_512 and pix2pix.  Runs on the first CUDA
card; ``--device cpu`` runs on the CPU, where ``--small`` (the
recipe's variant and losses at image 64; GauGAN: latent 16, channel plan
64-64-32-32-16-8, encoder and discriminator width 8; pix2pix: U-Net depth
6) trains in seconds.  ``--bf16`` changes nothing for pix2pix, which
trains in float32 as the JAX modules (no ``dtype``) do.  TensorBoard
files need tensorboardX, and the run raises without it unless
``--no_log``.

A multi-process run starts one process per place of the mesh, each with
``--distributed --coordinator HOST:PORT --num_processes N --process_id I``
(or the MOONSR_* variables) and the same ``--mesh DATA,MODEL``:
``DATA`` processes split each global batch, ``MODEL`` processes split the
SPADE generator's 1024-channel kernels (Megatron TP).  Each drives
``cuda:{LOCAL_RANK}`` (NCCL), or the CPU with ``--device cpu`` (gloo);
``--backend gloo`` lets two processes share one card.  Two processes on
the CPU:

    for i in 0 1; do
      python -m moonsuperresolution_tpu_torch.cli.train --recipe spade_256 \\
          --synthetic --small --device cpu --no_log --distributed \\
          --coordinator localhost:29500 --num_processes 2 --process_id $i \\
          --mesh 2,1 --batch_size 4 --epochs 1 --max_steps_per_epoch 2 \\
          --output_path exp &
    done; wait

``--profile_dir D`` writes a ``torch.profiler`` trace of the first
epoch's second step.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

# --small: the model the CPU trains in seconds (pix2pix reads only the
# image size and the depth, the GauGAN family all but the depth).
SMALL_MODEL = dict(image_size=64, latent_dim=16,
                   channel_plan=(64, 64, 32, 32, 16, 8), encoder_filters=8,
                   disc_filters=8, pix2pix_depth=6)


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
                   help="bfloat16 conv/matmul compute (params stay "
                        "float32); pix2pix trains in float32 regardless")
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
                        "64-64-32-32-16-8, widths 8; pix2pix depth 6")
    p.add_argument("--mesh", type=mesh_shape, default=None,
                   help="mesh shape 'DATA,MODEL' of a multi-process run, "
                        "e.g. '4,2'")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of step 1 here")
    add_distributed_flags(p)
    return p.parse_args(argv)


def mesh_shape(text: str) -> tuple[int, int]:
    """'DATA,MODEL' -> (DATA, MODEL), both positive."""
    try:
        shape = tuple(int(v) for v in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise argparse.ArgumentTypeError(
            f"mesh {text!r} is not DATA,MODEL (two positive integers)")
    return shape


def add_distributed_flags(p) -> None:
    """The flags of a multi-process run, shared with the map CLI."""
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-process run (--coordinator, "
                        "--num_processes, --process_id or the MOONSR_* "
                        "variables)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of the run's rendezvous (process 0 "
                        "serves it)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="collectives' backend: nccl on cards, gloo on the "
                        "CPU by default; gloo lets processes share a card")


def join(args):
    """Joins the process group when the flags ask for it; returns the
    process's device (``args.device`` otherwise)."""
    if not (args.distributed or args.coordinator):
        return args.device
    from moonsuperresolution_tpu_torch.parallel.distributed import initialize

    return initialize(args.coordinator, args.num_processes, args.process_id,
                      device=args.device, backend=args.backend)


def config(args):
    from moonsuperresolution_tpu_torch.config import RECIPES

    cfg = RECIPES[args.recipe]
    model = dict(SMALL_MODEL) if args.small else {}
    if args.bf16:
        model["compute_dtype"] = "bfloat16"
    run = {k: getattr(args, k) for k in ("epochs", "batch_size",
                                         "grad_accum")
           if getattr(args, k) is not None}
    if args.mesh:
        run["mesh_shape"] = args.mesh
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
    device = join(args)
    return train(config(args), resume=args.resume, synthetic=args.synthetic,
                 max_steps_per_epoch=args.max_steps_per_epoch,
                 log=not args.no_log, device=device,
                 profile_dir=args.profile_dir)


def main(argv=None) -> int:
    from moonsuperresolution_tpu_torch.parallel.distributed import shutdown

    run(argv)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
