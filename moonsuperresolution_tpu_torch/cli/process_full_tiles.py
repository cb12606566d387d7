"""Large-raster super-resolution CLI of the port (counterpart of
moonsuperresolution_tpu/cli/process_full_tiles.py).

    python -m moonsuperresolution_tpu_torch.cli.process_full_tiles \\
        --source_folder_path maps/ --map_name site1 --save_path out/ \\
        --model_path weights.npz --image_size 512 --stride 64 \\
        --batch_size 16

Reads ``<source>/run-DRG.tif`` and ``<source>/run-DEM.tif`` and writes
``<save_path>/<map>_{mean,std,good}.tiff``.  ``--model_path`` is an ``.npz``
of the JAX parameter tree (``scripts/export_params_npz.py`` makes one from
an Orbax checkpoint) or an ``epoch_N.pt`` of the port's training loop;
leave it unset for the identity-model pipeline check.
Runs on the first CUDA card; ``--device cpu`` runs on the CPU.
``--quantize int8|int8_static`` runs the int8 generator, quantized from the
same weights at load time.  ``--streaming`` bounds host memory for rasters
larger than RAM; ``--shard_index/--num_shards`` split the map across jobs,
merged afterwards by ``moonsuperresolution_tpu_torch.cli.merge_maps``.
With ``--distributed`` (and ``--coordinator``, ``--num_processes``,
``--process_id``, or the MOONSR_* variables) the processes of one run
join a process group, each on ``cuda:{LOCAL_RANK}`` (or ``--device cpu``),
and, with ``--num_shards 1``, each takes the tile-list shard of its
process index:

    for i in 0 1; do
      python -m moonsuperresolution_tpu_torch.cli.process_full_tiles \\
          --source_folder_path maps/ --map_name m --save_path out \\
          --device cpu --distributed --coordinator localhost:29500 \\
          --num_processes 2 --process_id $i &
    done; wait
    python -m moonsuperresolution_tpu_torch.cli.merge_maps \\
        --save_path out --map_name m --num_shards 2

``--backend gloo`` lets processes share one card (NCCL refuses two ranks
on one device); the map itself needs no collective.
"""

from __future__ import annotations

import argparse
import sys

from moonsuperresolution_tpu_torch.cli.train import (
    add_distributed_flags,
    join,
)


def parse(argv=None):
    p = argparse.ArgumentParser("DEM super-resolution over large rasters")
    p.add_argument("--source_folder_path", type=str, required=True)
    p.add_argument("--map_name", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--ortho_image_name", type=str, default="run-DRG.tif")
    p.add_argument("--dem_name", type=str, default="run-DEM.tif")
    p.add_argument("--model_path", type=str, default=None,
                   help=".npz of the JAX parameter tree or a training run's "
                        "epoch_N.pt; omit for identity processing")
    p.add_argument("--model_kind", type=str, default="gaugan",
                   choices=["gaugan", "cnn_spade"])
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--stride", type=int, default=32,
                   help="window displacement; image_size/8 recommended")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--tile_size", type=int, default=1024)
    p.add_argument("--no_value", type=float, default=-32768.0)
    p.add_argument("--upsample_factor", type=float, default=1.0,
                   choices=[1.0],
                   help="accepted for the JAX CLI's command lines; the map "
                        "keeps the DEM's resolution")
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8", "int8_static"],
                   help="int8: the generator's convs in int8 with "
                        "per-conv activation scales taken at run time; "
                        "int8_static: with calibrated activation scales. "
                        "Both deviate a little from the float model; their "
                        "speed against bf16 is in PERF.md")
    p.add_argument("--fill_method", type=str, default="fast",
                   choices=["fast", "reference"],
                   help="nodata interpolation: 'reference' is the exact "
                        "whole-tile cubic griddata (slow); 'fast' restricts "
                        "to hole neighbourhoods")
    p.add_argument("--fill_workers", type=int, default=0,
                   help="process pool for hole filling (0 = one per CPU)")
    p.add_argument("--streaming", action="store_true",
                   help="bounded-memory row-band pipeline for rasters too "
                        "large for host RAM (dims must divide by 4)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the process's CUDA card by default, "
                        "'cpu' runs without one")
    add_distributed_flags(p)
    return p.parse_args(argv)


def run(argv=None) -> dict:
    """Runs one map (or one shard of it); prints and returns the stats."""
    from moonsuperresolution_tpu_torch.config import DSRConfig
    from moonsuperresolution_tpu_torch.device import resolve_device
    from moonsuperresolution_tpu_torch.infer.engine import (
        DEMSuperResolution,
        load_model_fn,
    )

    a = parse(argv)
    device = resolve_device(join(a))
    if a.distributed or a.coordinator:
        from moonsuperresolution_tpu_torch.parallel.distributed import (
            process_info,
        )

        if a.num_shards == 1:
            # One tile-list shard per process (merge with cli/merge_maps).
            a.shard_index, a.num_shards = process_info()
    cfg = DSRConfig(
        image_size=a.image_size, stride=a.stride, batch_size=a.batch_size,
        tile_size=a.tile_size, no_value=a.no_value, map_name=a.map_name,
        save_path=a.save_path, source_folder_path=a.source_folder_path,
        ortho_image_name=a.ortho_image_name, dem_name=a.dem_name,
        model_path=a.model_path, model_kind=a.model_kind,
        compute_dtype=a.compute_dtype, quantize=a.quantize,
        fill_workers=a.fill_workers,
    )
    model = load_model_fn(a.model_path, a.model_kind, a.image_size,
                          compute_dtype=a.compute_dtype, quantize=a.quantize,
                          device=device)
    engine = DEMSuperResolution(cfg, model=model, device=device)
    if a.streaming:
        stats = engine.process_map_streaming(fill_method=a.fill_method,
                                             shard_index=a.shard_index,
                                             num_shards=a.num_shards)
    else:
        stats = engine.process_map(shard_index=a.shard_index,
                                   num_shards=a.num_shards,
                                   fill_method=a.fill_method)
    print(stats)
    return stats


def main(argv=None) -> int:
    """The console script: 0 once the run is done."""
    from moonsuperresolution_tpu_torch.parallel.distributed import shutdown

    run(argv)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
