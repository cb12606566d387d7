"""Shard-output merging: reassemble a full map from per-tile dumps
(counterpart of moonsuperresolution_tpu/infer/merge.py; numpy only).

The reference distributes the tile list across jobs ("Can be used to
distribute the load", process_full_tiles.py:313-325), has each job write
per-tile ``tile_<x>_<y>/*.tif`` dumps (process_full_tiles.py:416-429), and
reassembles them into the final mean/std/good GeoTIFF triple with
``rebuildMap`` (process_full_tiles.py:533-566).

Here each shard writes the same per-tile layout plus a
``<map>_shard<i>of<n>.json`` manifest carrying the raster geometry and geo
metadata; ``merge_shards`` (CLI: ``moonsr-torch-merge-maps``) unions the
manifests, reloads the tiles, and writes the final triple — bit-exact with
a single-process run because every tile is computed independently.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np

from moonsuperresolution_tpu_torch.geo.tiff import (
    TiffReader,
    TiffStreamWriter,
    write_geotiff,
)


def shard_manifest_path(save_path: str, map_name: str, shard_index: int,
                        num_shards: int) -> str:
    return os.path.join(save_path,
                        f"{map_name}_shard{shard_index}of{num_shards}.json")


def write_shard_manifest(
    save_path: str,
    map_name: str,
    shard_index: int,
    num_shards: int,
    tiles: list,
    dem_shape,
    tile_size: int,
    no_value: float,
    geo_transform,
    projection: str,
) -> str:
    """Per-shard manifest of which tiles this shard produced, plus the raster
    geometry the merge step needs (the reference keeps this implicitly in the
    still-running process; shards are separate processes here)."""
    path = shard_manifest_path(save_path, map_name, shard_index, num_shards)
    os.makedirs(save_path, exist_ok=True)
    with open(path, "w") as f:
        json.dump(
            {
                "map_name": map_name,
                "shard_index": shard_index,
                "num_shards": num_shards,
                "tiles": [[int(x), int(y)] for x, y in tiles],
                "dem_shape": [int(dem_shape[0]), int(dem_shape[1])],
                "tile_size": int(tile_size),
                "no_value": float(no_value),
                "geo_transform": list(geo_transform),
                "projection": projection,
            },
            f,
        )
    return path


def _read_plane(path: str) -> np.ndarray:
    with TiffReader(path) as r:
        return r.read().squeeze()


def merge_shards(save_path: str, map_name: str,
                 expect_shards: Optional[int] = None) -> dict:
    """Assemble the final mean/std/good GeoTIFF triple from per-tile dumps
    (reference: rebuildMap, process_full_tiles.py:533-566).

    Reads every ``<map>_shard*of*.json`` manifest under ``save_path``,
    verifies the shard set is complete and geometrically consistent, loads
    each listed ``tile_<x>_<y>`` dump, and writes
    ``<map>_{mean,std,good}.tiff``.  Returns the output paths and counts.
    """
    manifests = sorted(
        glob.glob(os.path.join(save_path, f"{map_name}_shard*of*.json"))
    )
    if not manifests:
        raise ValueError(
            f"no shard manifests '{map_name}_shard*of*.json' in {save_path}"
        )
    metas = []
    for p in manifests:
        with open(p) as f:
            metas.append(json.load(f))

    num_shards = metas[0]["num_shards"]
    if expect_shards is not None and num_shards != expect_shards:
        raise ValueError(
            f"manifests declare {num_shards} shards, expected {expect_shards}"
        )
    seen = sorted(m["shard_index"] for m in metas)
    if seen != list(range(num_shards)):
        missing = sorted(set(range(num_shards)) - set(seen))
        raise ValueError(f"incomplete shard set: missing shards {missing}")
    for m in metas[1:]:
        for key in ("dem_shape", "tile_size", "no_value", "geo_transform",
                    "projection"):
            if m[key] != metas[0][key]:
                raise ValueError(
                    f"shard {m['shard_index']} manifest disagrees on {key}"
                )

    h, w = metas[0]["dem_shape"]
    t = metas[0]["tile_size"]
    no_value = metas[0]["no_value"]
    geo_transform = tuple(metas[0]["geo_transform"])
    projection = metas[0]["projection"]

    mean_map = np.full((h, w), no_value, np.float32)
    std_map = np.full((h, w), no_value, np.float32)
    good_map = np.zeros((h, w), np.uint16)

    n_tiles = 0
    for m in metas:
        for px, py in m["tiles"]:
            name = f"{px}_{py}"
            tile_dir = os.path.join(save_path, f"tile_{name}")
            hh, ww = min(t, h - py), min(t, w - px)
            mean_t = _read_plane(
                os.path.join(tile_dir, f"tile_{name}_mean.tif"))
            std_t = _read_plane(os.path.join(tile_dir, f"tile_{name}_std.tif"))
            good_t = _read_plane(
                os.path.join(tile_dir, f"tile_{name}_correct.tif"))
            mean_map[py : py + hh, px : px + ww] = mean_t[:hh, :ww]
            std_map[py : py + hh, px : px + ww] = std_t[:hh, :ww]
            good_map[py : py + hh, px : px + ww] = good_t[:hh, :ww].astype(
                np.uint16)
            n_tiles += 1

    out = {}
    for name, data in (("mean", mean_map), ("std", std_map),
                       ("good", good_map)):
        path = os.path.join(save_path, f"{map_name}_{name}.tiff")
        write_geotiff(path, data, geo_transform, projection,
                      nodata=no_value, compress="lzw")
        out[name] = path
    out["tiles"] = n_tiles
    out["shards"] = num_shards
    return out


# ---------------------------------------------------------------------------
# streaming shards: per-shard stacked-band TIFFs merged without full maps in
# RAM (the streaming engine's analog of the per-tile dumps above)
# ---------------------------------------------------------------------------


def streaming_shard_manifest_path(save_path: str, map_name: str,
                                  shard_index: int, num_shards: int) -> str:
    return os.path.join(
        save_path, f"{map_name}_sshard{shard_index}of{num_shards}.json")


def write_streaming_shard_manifest(
    save_path: str,
    map_name: str,
    shard_index: int,
    num_shards: int,
    bands: list,
    dem_shape,
    tile_size: int,
    no_value: float,
    geo_transform,
    projection: str,
) -> str:
    """Manifest for one streaming shard: which tile-row bands (top row ``py``
    of each) its stacked per-shard TIFF triple contains, in stack order."""
    path = streaming_shard_manifest_path(save_path, map_name, shard_index,
                                         num_shards)
    os.makedirs(save_path, exist_ok=True)
    with open(path, "w") as f:
        json.dump(
            {
                "map_name": map_name,
                "shard_index": shard_index,
                "num_shards": num_shards,
                "bands": [int(py) for py in bands],
                "dem_shape": [int(dem_shape[0]), int(dem_shape[1])],
                "tile_size": int(tile_size),
                "no_value": float(no_value),
                "geo_transform": list(geo_transform),
                "projection": projection,
                "streaming": True,
            },
            f,
        )
    return path


def merge_shards_streaming(save_path: str, map_name: str,
                           expect_shards: Optional[int] = None) -> dict:
    """Interleave streaming-shard TIFF triples into the final
    ``<map>_{mean,std,good}.tiff`` maps, row band by row band — bounded
    memory end to end (the merge never holds more than one tile-row band).

    Bit-exact with a single-shard streaming run: each band's rows are copied
    verbatim from the shard that produced them.
    """
    manifests = sorted(
        glob.glob(os.path.join(save_path, f"{map_name}_sshard*of*.json"))
    )
    if not manifests:
        raise ValueError(
            f"no streaming shard manifests '{map_name}_sshard*of*.json' "
            f"in {save_path}"
        )
    metas = []
    for p in manifests:
        with open(p) as f:
            metas.append(json.load(f))

    num_shards = metas[0]["num_shards"]
    if expect_shards is not None and num_shards != expect_shards:
        raise ValueError(
            f"manifests declare {num_shards} shards, expected {expect_shards}"
        )
    seen = sorted(m["shard_index"] for m in metas)
    if seen != list(range(num_shards)):
        missing = sorted(set(range(num_shards)) - set(seen))
        raise ValueError(f"incomplete shard set: missing shards {missing}")
    for m in metas[1:]:
        for key in ("dem_shape", "tile_size", "no_value", "geo_transform",
                    "projection"):
            if m[key] != metas[0][key]:
                raise ValueError(
                    f"shard {m['shard_index']} manifest disagrees on {key}"
                )

    h, w = metas[0]["dem_shape"]
    t = metas[0]["tile_size"]
    no_value = metas[0]["no_value"]
    geo_transform = tuple(metas[0]["geo_transform"])
    projection = metas[0]["projection"]

    # band top-row -> (owning shard, row offset inside that shard's stack)
    band_src = {}
    for m in metas:
        off = 0
        for py in m["bands"]:
            band_src[py] = (m["shard_index"], off)
            off += min(t, h - py)
    expected = list(range(0, h, t))
    missing = [py for py in expected if py not in band_src]
    if missing:
        raise ValueError(f"bands missing from shard set: {missing}")

    planes = (("mean", np.float32), ("std", np.float32), ("good", np.uint16))
    out = {}
    n_bands = 0
    readers = {}
    try:
        for name, dtype in planes:
            readers[name] = {
                m["shard_index"]: TiffReader(os.path.join(
                    save_path,
                    f"{map_name}_sshard{m['shard_index']}"
                    f"of{num_shards}_{name}.tiff"))
                for m in metas
            }
        writers = {
            name: TiffStreamWriter(
                os.path.join(save_path, f"{map_name}_{name}.tiff"),
                w, h, dtype, geo_transform, projection,
                nodata=no_value, compress="lzw",
            )
            for name, dtype in planes
        }
        try:
            for py in expected:
                si, off = band_src[py]
                hh = min(t, h - py)
                for name, _ in planes:
                    rows = readers[name][si].read_rows(off, off + hh)
                    writers[name].write_rows(rows)
                n_bands += 1
            for name, _ in planes:
                writers[name].close()
        except BaseException:
            for wr in writers.values():
                wr.f.close()
            raise
    finally:
        for per_shard in readers.values():
            for r in per_shard.values():
                r.close()
    for name, _ in planes:
        out[name] = os.path.join(save_path, f"{map_name}_{name}.tiff")
    out["bands"] = n_bands
    out["shards"] = num_shards
    return out
