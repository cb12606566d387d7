"""Tile-store build CLI of the port (counterpart of moonsuperresolution_tpu/
cli/make_h5.py; reference: make_h5.py).

    python -m moonsuperresolution_tpu_torch.cli.make_h5 --data_path data \\
        --output_path .

Reads the six region pairs from ``--data_path`` (the WAC ``.npy`` of
``moonsr-torch-tile-wac`` and the SLDEM2015 ``.img``) and writes
``MoonORTO2DEM.hdf5`` and ``MoonORTO2DEM_{train,val}.pkl``.  Host numpy
only: no card, no h5py, no OpenCV.
"""

from __future__ import annotations

import argparse
import sys


def parse(argv=None):
    p = argparse.ArgumentParser("HDF5 tile-store builder")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--output_path", type=str, default=".")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the train/val split")
    return p.parse_args(argv)


def run(argv=None):
    """Builds the store; returns (store path, train and val tile counts)."""
    from moonsuperresolution_tpu_torch.data.h5_builder import (
        build_h5_dataset,
    )

    a = parse(argv)
    out = build_h5_dataset(a.data_path, a.output_path, seed=a.seed)
    print(f"wrote {out[0]}: {out[1]} train / {out[2]} val tiles")
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
