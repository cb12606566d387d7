#!/usr/bin/env python3
"""Export the JAX package's parameter checkpoint to the flat ``.npz`` that
the PyTorch port loads.

    python scripts/export_params_npz.py CHECKPOINT OUT.npz

CHECKPOINT is an Orbax parameter checkpoint (``utils/checkpoint.py::
save_params``; a training run's per-epoch ``params``).  OUT.npz holds the
tree's leaves under their "/"-joined paths
(``moonsuperresolution_tpu_torch/utils/convert.py::save_npz``), which
``moonsuperresolution_tpu_torch.infer.engine.load_model_fn`` and the port's
``cli/process_full_tiles.py --model_path`` read.  This script imports the
JAX package; the port itself never does.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export(checkpoint: str, out: str) -> int:
    """Write ``out`` from ``checkpoint``; returns the number of arrays."""
    import jax

    from moonsuperresolution_tpu.utils.checkpoint import restore_params
    from moonsuperresolution_tpu_torch.utils.convert import (
        flatten_tree,
        save_npz,
    )

    tree = jax.device_get(restore_params(checkpoint))
    save_npz(out, tree)
    return len(flatten_tree(tree))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", help="Orbax parameter checkpoint directory")
    p.add_argument("out", help="output .npz path")
    a = p.parse_args(argv)
    n = export(a.checkpoint, a.out)
    print(f"wrote {n} arrays to {a.out}")


if __name__ == "__main__":
    main()
