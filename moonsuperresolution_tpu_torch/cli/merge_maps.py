"""Merge sharded inference outputs into the final map triple (counterpart
of moonsuperresolution_tpu/cli/merge_maps.py).

    # shard 0..N-1 each ran:
    #   python -m moonsuperresolution_tpu_torch.cli.process_full_tiles ... \\
    #       --shard_index i --num_shards N
    python -m moonsuperresolution_tpu_torch.cli.merge_maps \\
        --save_path out/ --map_name site1 --num_shards N

Reassembles the per-tile dumps listed in the shard manifests (or, with
``--streaming``, the streaming shards' band TIFFs) into
``<map>_{mean,std,good}.tiff``: the reference's ``rebuildMap`` step
(process_full_tiles.py:533-566) as a standalone tool.  The merge is numpy
on the host and needs no card, so unlike the map CLI it takes no
``--device``.
"""

from __future__ import annotations

import argparse
import sys


def parse(argv=None):
    p = argparse.ArgumentParser("merge sharded SR outputs into one map")
    p.add_argument("--save_path", type=str, required=True,
                   help="directory holding tile_<x>_<y>/ dumps + manifests")
    p.add_argument("--map_name", type=str, required=True)
    p.add_argument("--num_shards", type=int, default=None,
                   help="expected shard count (error if incomplete)")
    p.add_argument("--keep_tiles", action="store_true",
                   help="keep per-tile dumps after merging")
    p.add_argument("--streaming", action="store_true",
                   help="merge streaming-shard band TIFFs "
                        "(<map>_sshard*of*) instead of per-tile dumps")
    return p.parse_args(argv)


def run(argv=None) -> dict:
    """Merges the shards; prints and returns what the merge reports."""
    import glob
    import os
    import shutil

    from moonsuperresolution_tpu_torch.infer.merge import (
        merge_shards,
        merge_shards_streaming,
    )

    a = parse(argv)
    if a.streaming:
        out = merge_shards_streaming(a.save_path, a.map_name,
                                     expect_shards=a.num_shards)
    else:
        out = merge_shards(a.save_path, a.map_name,
                           expect_shards=a.num_shards)
        if not a.keep_tiles:
            for d in glob.glob(os.path.join(a.save_path, "tile_*_*")):
                if os.path.isdir(d):
                    shutil.rmtree(d)
    print(out)
    return out


def main(argv=None) -> int:
    """The console script: 0 once the run is done."""
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
