"""Bounded-memory streaming inference over arbitrarily large rasters
(counterpart of moonsuperresolution_tpu/infer/streaming.py).

The in-RAM engine holds both rasters, their padded copies and all three
output maps in host memory at once (~27 GB for the production 15000x70000
pair, process_full_tiles.py:172-175).  This module runs the same pipeline
one tile-row band at a time:

- the ortho raster is read in row bands (``TiffReader.read_rows``) and its
  nodata holes filled with the window-exact band sweep
  (``infer/fill.py::fill_nodata_window``, bit-exact with the in-RAM sweep);
- the /16 low-res conditioning DEM is synthesized incrementally on a
  producer thread (``infer/lr_synth.py``), publishing s16 rows as they
  become final so tile compute starts at once; the final cubic upsample is
  evaluated per row band (``ops/resize.py::resize_cubic``) on the engine's
  device;
- output maps stream to disk through ``geo/tiff.py::TiffStreamWriter``
  (strips compressed as tile rows complete, nothing map-sized in RAM).

Peak host memory is O(tile row) plus the quarter-res DEM, independent of
raster height.

Parity: the same fills, /16 synthesis, cubic upsample, tile programs and
per-tile generators as the in-RAM path, each bit for bit, so the output
files are identical to the in-RAM map's.  Requires raster
dimensions divisible by 4 (integer first-stage area downscale, true of the
production rasters); otherwise use the in-RAM path.
"""

from __future__ import annotations

import concurrent.futures
import os
import time

import numpy as np
import torch

from moonsuperresolution_tpu_torch.geo.tiff import TiffReader, TiffStreamWriter
from moonsuperresolution_tpu_torch.infer.fill import fill_nodata_window
from moonsuperresolution_tpu_torch.infer.lr_synth import IncrementalLrSynth
from moonsuperresolution_tpu_torch.infer.merge import (
    write_streaming_shard_manifest,
)
from moonsuperresolution_tpu_torch.ops.resize import resize_cubic


def process_map_streaming(engine, progress: bool = True,
                          fill_method: str = "fast",
                          shard_index: int = 0,
                          num_shards: int = 1) -> dict:
    """Streaming counterpart of ``DEMSuperResolution.process_map``.  Returns
    the same stats dict; output maps go straight to GeoTIFF (no
    ``engine.result``).

    With ``num_shards > 1`` the tile-row bands are strided across shards
    (band ``k`` belongs to shard ``k % num_shards``).  Each shard streams its
    bands into a stacked per-shard TIFF triple plus a JSON manifest;
    ``infer/merge.py::merge_shards_streaming`` interleaves the bands into the
    final maps without ever holding a full map in RAM.  Bit-exact with a
    single-shard run: tiles are computed independently with per-tile
    generators.
    """
    if not (0 <= shard_index < num_shards):
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    cfg = engine.cfg
    g = engine.geom
    nv = engine.no_value
    t = cfg.tile_size
    t0 = time.perf_counter()

    img_path = os.path.join(cfg.source_folder_path, cfg.ortho_image_name)
    dem_path = os.path.join(cfg.source_folder_path, cfg.dem_name)
    for p in (img_path, dem_path):
        if not os.path.exists(p):
            raise ValueError(f"input raster not found: {p}")

    img_r = TiffReader(img_path)
    dem_r = TiffReader(dem_path)
    h, w = dem_r.height, dem_r.width
    if h % 4 or w % 4:
        img_r.close()
        dem_r.close()
        raise ValueError(
            f"streaming mode needs raster dims divisible by 4, got {h}x{w}; "
            "use the in-RAM path")
    engine.dem_shape = (h, w)
    engine.geo_transform = dem_r.geo_transform
    engine.projection = dem_r.projection

    # The /16 LR-DEM synthesis (streamed /4 -> fill -> /4, reference
    # semantics process_full_tiles.py:226-244) runs on a producer thread
    # that publishes s16 rows as they become final.
    synth = IncrementalLrSynth(
        dem_r, h, w, nv, fill_method=fill_method,
        workers=cfg.fill_workers or (os.cpu_count() or 1),
        device=engine.device,
    )

    # geometry (same formulas as pad_inputs)
    halo = g.halo
    new_w = ((w // t) + 1) * t + halo * 2
    t_pre = time.perf_counter() - t0

    # band assignment (sharded runs stride the tile-row bands)
    bands = list(range(0, h, t))[shard_index::num_shards]
    sharded = num_shards > 1
    shard_h = sum(min(t, h - py) for py in bands)

    writers = {}
    if cfg.save_path:
        os.makedirs(cfg.save_path, exist_ok=True)

        def mk(name, dtype):
            if sharded:
                fname = (f"{cfg.map_name}_sshard{shard_index}"
                         f"of{num_shards}_{name}.tiff")
                height = shard_h
            else:
                fname = f"{cfg.map_name}_{name}.tiff"
                height = h
            return TiffStreamWriter(
                os.path.join(cfg.save_path, fname),
                w, height, dtype, engine.geo_transform, engine.projection,
                nodata=nv, compress="lzw",
            )

        writers = {"mean": mk("mean", np.float32),
                   "std": mk("std", np.float32),
                   "good": mk("good", np.uint16)}

    tiles_x = [px for px in range(0, ((w // t) + 1) * t, t) if px < w]
    n_tiles = 0
    t1 = time.perf_counter()

    def lr_band(a: int, b: int) -> np.ndarray:
        """Synthesized low-res DEM rows [a, b) (full width); blocks until
        the producer has published the s16 rows its cubic taps read."""
        synth.wait_rows(min(synth.h16, -(-(b * synth.h16) // h) + 4))
        s16 = torch.from_numpy(synth.s16).to(engine.device)
        band = resize_cubic(s16, (h, w), a, b)
        return torch.where(band.isnan(), nv, band).cpu().numpy()

    # prep_wall_s: host time inside prep_band on the prefetch thread;
    # prep_exposed_s: time the main loop blocked on it (the only prep cost
    # the device sees when the overlap works); device_busy_s: wall time in
    # run_tiles_serial.
    prep_wall_s = prep_exposed_s = device_busy_s = 0.0

    def prep_band(py: int):
        """Host work for one tile-row band: windowed ortho fill + LR-DEM
        synthesis + padded slab assembly.  Runs one band ahead of the
        device on the prefetch thread."""
        nonlocal prep_wall_s
        tb = time.perf_counter()
        a = max(0, py - halo)
        b = min(h, py + t + halo)
        img_band = fill_nodata_window(
            lambda y0, y1: img_r.read_rows(y0, y1).astype(np.float32),
            (h, w), a, b, nv, tile_size=1024, border=128, max_fill_area=8,
            method=fill_method, workers=cfg.fill_workers,
        )
        dem_band = lr_band(a, b)
        band_img = np.full((g.slab, new_w), nv, np.float32)
        band_dem = np.full((g.slab, new_w), nv, np.float32)
        r0 = a - (py - halo)   # offset of first real row inside the band
        band_img[r0 : r0 + (b - a), halo : halo + w] = img_band
        band_dem[r0 : r0 + (b - a), halo : halo + w] = dem_band
        prep_wall_s += time.perf_counter() - tb
        return band_img, band_dem

    def write_band(mean_row, std_row, good_row, hh):
        writers["mean"].write_rows(mean_row[:hh])
        writers["std"].write_rows(std_row[:hh])
        writers["good"].write_rows(good_row[:hh].astype(np.uint16))

    # Three-stage band pipeline: while the device runs band i's tiles, the
    # prefetch thread preps band i+1 and the writer thread compresses band
    # i-1's strips.  One write in flight keeps strip order and surfaces a
    # failure within a band.
    prep_pool = concurrent.futures.ThreadPoolExecutor(1)
    write_pool = concurrent.futures.ThreadPoolExecutor(1)
    write_fut = None
    try:
        prep_fut = prep_pool.submit(prep_band, bands[0]) if bands else None
        for bi, py in enumerate(bands):
            tw = time.perf_counter()
            band_img, band_dem = prep_fut.result()
            prep_exposed_s += time.perf_counter() - tw
            prep_fut = (prep_pool.submit(prep_band, bands[bi + 1])
                        if bi + 1 < len(bands) else None)

            mean_row = np.full((t, w), nv, np.float32)
            std_row = np.full((t, w), nv, np.float32)
            good_row = np.zeros((t, w), np.uint8)
            hh = min(t, h - py)

            def provider(px, py_real, _img=band_img, _dem=band_dem):
                return (_img[:, px : px + g.slab], _dem[:, px : px + g.slab])

            def commit(px, py_real, out, _m=mean_row, _s=std_row,
                       _g=good_row, _hh=hh):
                mean_t, std_t, good_t = (o.cpu().numpy() for o in out)
                ww = min(t, w - px)
                _m[:_hh, px : px + ww] = mean_t[:_hh, :ww]
                _s[:_hh, px : px + ww] = std_t[:_hh, :ww]
                _g[:_hh, px : px + ww] = good_t[:_hh, :ww]

            tiles = [(px, py) for px in tiles_x]
            td = time.perf_counter()
            engine.run_tiles_serial(tiles, commit, slab_provider=provider)
            device_busy_s += time.perf_counter() - td
            n_tiles += len(tiles)
            if writers:
                if write_fut is not None:
                    write_fut.result()
                write_fut = write_pool.submit(write_band, mean_row, std_row,
                                              good_row, hh)
            if progress:
                print(f"tile row {bi + 1}/{len(bands)} (y={py})", flush=True)
        if write_fut is not None:
            write_fut.result()
            write_fut = None
    except BaseException:
        # Release handles without TiffStreamWriter.close()'s row-count
        # check: a half-written map is expected on error, and raising the
        # "wrote N rows" ValueError here would mask the original exception.
        for wr in writers.values():
            wr.f.close()
        img_r.close()
        dem_r.close()
        raise
    finally:
        prep_pool.shutdown(wait=False, cancel_futures=True)
        write_pool.shutdown(wait=True)

    t_tiles = time.perf_counter() - t1
    t2 = time.perf_counter()
    synth.join()
    for wr in writers.values():
        wr.close()
    img_r.close()
    dem_r.close()
    if sharded and cfg.save_path:
        write_streaming_shard_manifest(
            cfg.save_path, cfg.map_name, shard_index, num_shards, bands,
            (h, w), t, nv, engine.geo_transform, engine.projection,
        )
    t_save = time.perf_counter() - t2

    n_patches = n_tiles * g.grid ** 2
    return {
        "tiles": n_tiles,
        "patches": n_patches,
        "preprocess_s": t_pre,
        "tiles_s": t_tiles,
        "save_s": t_save,
        "patches_per_s": n_patches / max(t_tiles, 1e-9),
        "streaming": True,
        "shard_index": shard_index,
        "num_shards": num_shards,
        "prep_wall_s": prep_wall_s,
        "prep_exposed_s": prep_exposed_s,
        "device_busy_s": device_busy_s,
    }
