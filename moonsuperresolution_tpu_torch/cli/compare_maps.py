"""Fidelity comparison of two DEM GeoTIFFs (counterpart of
moonsuperresolution_tpu/cli/compare_maps.py).

    python -m moonsuperresolution_tpu_torch.cli.compare_maps \\
        --a ours_mean.tiff --b reference_mean.tiff [--nodata -32768]

Prints one JSON line over the pixels valid in both rasters: rmse,
rmse_pct_of_range (BASELINE.md's < 0.5 % DEM RMSE deviation), bias (mean of
a - b), max_abs, coverage and range_b.  Host numpy only: no card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def compare(a: np.ndarray, b: np.ndarray, nodata: float) -> dict:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    valid = (a > nodata) & (b > nodata) & np.isfinite(a) & np.isfinite(b)
    if not valid.any():
        return {"coverage": 0.0}
    da = a[valid].astype(np.float64)
    db = b[valid].astype(np.float64)
    diff = da - db
    rng = max(db.max() - db.min(), 1e-12)
    rmse = float(np.sqrt((diff ** 2).mean()))
    return {
        "rmse": rmse,
        "rmse_pct_of_range": rmse / rng * 100,
        "bias": float(diff.mean()),
        "max_abs": float(np.abs(diff).max()),
        "coverage": float(valid.mean()),
        "range_b": float(rng),
    }


def parse(argv=None):
    p = argparse.ArgumentParser("DEM map comparison")
    p.add_argument("--a", required=True, help="candidate GeoTIFF")
    p.add_argument("--b", required=True, help="reference GeoTIFF")
    p.add_argument("--nodata", type=float, default=-32768.0)
    return p.parse_args(argv)


def run(argv=None) -> dict:
    """Compares the two rasters; prints and returns the statistics."""
    from moonsuperresolution_tpu_torch.geo.tiff import read_geotiff

    a = parse(argv)
    out = compare(read_geotiff(a.a).data.squeeze(),
                  read_geotiff(a.b).data.squeeze(), a.nodata)
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
