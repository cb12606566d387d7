"""WAC mosaic tiler CLI of the port (counterpart of moonsuperresolution_tpu/
cli/tile_wac.py): the reference's missing tile_WAC_MOS.py step
(README.md:117).

    python -m moonsuperresolution_tpu_torch.cli.tile_wac \\
        --mosaic data/Lunar_LRO_LROC-WAC_Mosaic_global_100m_June2013.tif \\
        --output_path data

Host numpy only: no card.
"""

from __future__ import annotations

import argparse
import sys


def parse(argv=None):
    p = argparse.ArgumentParser("WAC global mosaic -> 6 regional .npy arrays")
    p.add_argument("--mosaic", type=str, required=True)
    p.add_argument("--output_path", type=str, default=".")
    return p.parse_args(argv)


def run(argv=None) -> list[str]:
    """Tiles the mosaic; returns the written paths."""
    from moonsuperresolution_tpu_torch.data.wac_tiler import tile_wac_mosaic

    a = parse(argv)
    paths = tile_wac_mosaic(a.mosaic, a.output_path)
    for path in paths:
        print("wrote", path)
    return paths


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
