"""HDF5 tile-store builder (counterpart of moonsuperresolution_tpu/data/
h5_builder.py; reference: make_h5.py).

Cuts the six (WAC ortho ``.npy``, SLDEM2015 float ``.img``) region pairs
into one HDF5 of 50 %-overlapping 1000-px tiles plus the train/val key-dict
pickles, in the reference's artifact format: a store built here, one built
by the JAX package through h5py and the reference's own are
interchangeable.  The store is written by the port's own HDF5 writer
(``data/hdf5.py``) and the ortho resampled onto the DEM grid by its
OpenCV-semantics ``INTER_AREA`` (``ops/resize.py::resize_area``), so the
build needs neither h5py nor OpenCV.

As in the JAX package (and unlike the reference): DEM tiles are scaled to
65535 before the uint16 cast (the reference's 2**16 overflows each tile's
highest pixel to 0, make_h5.py:54-55), and a flat DEM tile does not divide
by zero.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from moonsuperresolution_tpu_torch.data.hdf5 import H5Writer
from moonsuperresolution_tpu_torch.ops.resize import resize_area

TILE_SIZE = 1000
TILE_OFFSET = 500

REGIONS = [
    "N0-60_W000-120",
    "N0-60_W120-240",
    "N0-60_W240-360",
    "S0-60_W000-120",
    "S0-60_W120-240",
    "S0-60_W240-360",
]

DEM_FILES = {
    "N0-60_W000-120": "sldem2015_256_0n_60n_000_120_float.img",
    "N0-60_W120-240": "sldem2015_256_0n_60n_120_240_float.img",
    "N0-60_W240-360": "sldem2015_256_0n_60n_240_360_float.img",
    "S0-60_W000-120": "sldem2015_256_60s_0s_000_120_float.img",
    "S0-60_W120-240": "sldem2015_256_60s_0s_120_240_float.img",
    "S0-60_W240-360": "sldem2015_256_60s_0s_240_360_float.img",
}

# The reference's .npy names (make_h5.py:18-23).
ORT_FILES = {
    "N0-60_W000-120": "Lunar_LRO_LROC-WAC_Mosaic_global_100m_June2013_0n_60n_0_120.npy",
    "N0-60_W120-240": "Lunar_LRO_LROC-WAC_Mosaic_global_100m_June2013_0n_60n_120_240.npy",
    "N0-60_W240-360": "Lunar_LRO_LROC-WAC_Mosaic_global_100m_June2013_0n_60n_240_360.npy",
    "S0-60_W000-120": "Lunar_LRO_LROC-WAC_Mosaic_global_100m_June2013_0s_60s_0_120.npy",
    "S0-60_W120-240": "Lunar_LRO_LROC-WAC_Mosaic_global_100m_June2013_0s_60s_120_240.npy",
    "S0-60_W240-360": "Lunar_LRO_LROC-WAC_Mosaic_global_100m_June2013_0s_60s_240_360.npy",
}

SLDEM_ROWS = 15360  # SLDEM2015 256 px/deg, 60 degrees of latitude


def load_pair(data_path: str, key: str, dem_rows: int = SLDEM_ROWS):
    """One (ortho, dem) region pair, the ortho resampled onto the DEM grid
    with ``cv2.INTER_AREA``'s semantics (make_h5.py:26-37)."""
    ort = np.load(os.path.join(data_path, ORT_FILES[key]))
    dem = np.fromfile(
        os.path.join(data_path, DEM_FILES[key]), dtype=np.float32
    ).reshape(dem_rows, -1)
    ort = resize_area(torch.from_numpy(ort), dem.shape).numpy()
    return ort, dem


def tile_pair(ort, dem, key, h5, dct, tile_size=TILE_SIZE,
              tile_offset=TILE_OFFSET):
    """Cut a region pair into 50 %-overlapping tiles and store them in
    ``h5`` (anything with ``h5[name] = array``: an ``H5Writer``, or an h5py
    ``File``), keys into ``dct`` (make_h5.py:39-60).  DEM tiles are per-tile
    min-max quantized to uint16."""
    h, w = ort.shape
    htiles = h // tile_offset
    wtiles = w // tile_offset
    for i in range(htiles):
        for j in range(wtiles):
            ys = np.s_[tile_offset * i : tile_offset * i + tile_size]
            xs = np.s_[tile_offset * j : tile_offset * j + tile_size]
            dem_tile = dem[ys, xs]
            if dem_tile.shape != (tile_size, tile_size):
                break
            span = dem_tile.max() - dem_tile.min()
            dem_q = (dem_tile - dem_tile.min()) / max(span, 1e-12) * 65535.0
            dem_q = dem_q.astype(np.uint16)
            ort_tile = ort[ys, xs]
            dem_lbl = f"{key}-dem-{i * tile_offset}-{j * tile_offset}"
            ort_lbl = f"{key}-ort-{i * tile_offset}-{j * tile_offset}"
            h5[dem_lbl] = dem_q
            h5[ort_lbl] = ort_tile
            dct[f"{key}-{i}-{j}"] = [dem_lbl, ort_lbl]
    return h5, dct


def split_train_val(dct, num_anchors=50, run_length=20, seed=None):
    """Validation split: ``num_anchors`` random anchor indices, each
    expanded to ``run_length`` consecutive tiles (make_h5.py:76-87), clamped
    for small datasets as the JAX package does."""
    rng = np.random.default_rng(seed)
    keys = list(dct.keys())
    n = len(keys)
    run_length = max(1, min(run_length, n // 4 or 1))
    pool = max(1, n - 2 * run_length)
    num_anchors = min(num_anchors, pool)
    anchors = rng.choice(pool, size=num_anchors, replace=False)
    val_idx = set()
    for a in anchors:
        val_idx.update(range(a, a + run_length))
    train_dct, val_dct = {}, {}
    for i, k in enumerate(keys):
        (val_dct if i in val_idx else train_dct)[k] = dct[k]
    return train_dct, val_dct


def build_h5_dataset(data_path: str, output_path: str = ".", regions=None,
                     tile_size: int = TILE_SIZE,
                     tile_offset: int = TILE_OFFSET, seed=None,
                     dem_rows: int = SLDEM_ROWS):
    """Region pairs -> MoonORTO2DEM.hdf5 + MoonORTO2DEM_{train,val}.pkl
    (make_h5.py:68-93); returns (store path, training and validation tile
    counts)."""
    regions = regions or REGIONS
    os.makedirs(output_path, exist_ok=True)
    h5_path = os.path.join(output_path, "MoonORTO2DEM.hdf5")
    dct = {}
    with H5Writer(h5_path) as h5:
        for key in regions:
            ort, dem = load_pair(data_path, key, dem_rows=dem_rows)
            tile_pair(ort, dem, key, h5, dct, tile_size, tile_offset)
    train_dct, val_dct = split_train_val(dct, seed=seed)
    with open(os.path.join(output_path, "MoonORTO2DEM_train.pkl"), "wb") as f:
        pickle.dump(train_dct, f)
    with open(os.path.join(output_path, "MoonORTO2DEM_val.pkl"), "wb") as f:
        pickle.dump(val_dct, f)
    return h5_path, len(train_dct), len(val_dct)
