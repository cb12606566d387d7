"""WAC mosaic regional tiler (counterpart of moonsuperresolution_tpu/data/
wac_tiler.py): the step of the reference's README.md:117 whose script,
``tile_WAC_MOS.py``, the reference does not ship.

Cuts the global 100-m LROC WAC mosaic GeoTIFF (get_data.sh:4) into the six
regional ``.npy`` arrays that the store builder reads (make_h5.py:18-23):
60-degree latitude x 120-degree longitude boxes aligned with the SLDEM2015
float tiles, N0-60_W000-120 .. S0-60_W240-360.  Pixel windows come from the
mosaic's geo-transform when it is in degrees (simple cylindrical), else the
raster is taken to span lon [0, 360] x lat [90, -90].  The mosaic is read
``block_rows`` rows at a time through the port's ``geo/tiff.py::
TiffReader``, so the ~10^10-pixel raster never has to fit in memory; the
builder resamples each region onto the SLDEM2015 grid afterwards.
"""

from __future__ import annotations

import os

import numpy as np

from moonsuperresolution_tpu_torch.geo.tiff import TiffReader

# (label, lat_top, lat_bottom, lon_left, lon_right) in degrees.
REGION_BOXES = [
    ("N0-60_W000-120", 60.0, 0.0, 0.0, 120.0),
    ("N0-60_W120-240", 60.0, 0.0, 120.0, 240.0),
    ("N0-60_W240-360", 60.0, 0.0, 240.0, 360.0),
    ("S0-60_W000-120", 0.0, -60.0, 0.0, 120.0),
    ("S0-60_W120-240", 0.0, -60.0, 120.0, 240.0),
    ("S0-60_W240-360", 0.0, -60.0, 240.0, 360.0),
]

_NPY_NAME = "Lunar_LRO_LROC-WAC_Mosaic_global_100m_June2013_{tag}.npy"


def _npy_name(label: str) -> str:
    """A region's ``.npy`` name, as ``h5_builder.ORT_FILES`` reads it."""
    lons = label.split("_W")[1]
    lo, hi = lons.split("-")
    hemi = "0n_60n" if label.startswith("N") else "0s_60s"
    return _NPY_NAME.format(tag=f"{hemi}_{int(lo)}_{int(hi)}")


def _window_from_geo(reader: TiffReader, box) -> tuple[int, int, int, int]:
    """(row0, row1, col0, col1) pixel window of a lat/lon box."""
    _, lat_t, lat_b, lon_l, lon_r = box
    gt = reader.geo_transform
    if gt[1] != 1.0 or gt[5] != -1.0 or gt[0] != 0.0:
        x0, px_w, _, y0, _, px_h = gt
        if abs(px_w) < 1.0 and abs(x0) <= 360.0:  # degrees
            return (int(round((lat_t - y0) / px_h)),
                    int(round((lat_b - y0) / px_h)),
                    int(round((lon_l - x0) / px_w)),
                    int(round((lon_r - x0) / px_w)))
    h, w = reader.height, reader.width
    return (int(round((90.0 - lat_t) / 180.0 * h)),
            int(round((90.0 - lat_b) / 180.0 * h)),
            int(round(lon_l / 360.0 * w)),
            int(round(lon_r / 360.0 * w)))


def tile_wac_mosaic(mosaic_path: str, output_path: str = ".",
                    block_rows: int = 2048, regions=None) -> list[str]:
    """The global mosaic -> one ``.npy`` per region; returns the written
    paths.  Peak memory: the six regions plus one block of rows."""
    os.makedirs(output_path, exist_ok=True)
    written = []
    with TiffReader(mosaic_path) as r:
        boxes = [b for b in REGION_BOXES if regions is None or b[0] in regions]
        windows = {b[0]: _window_from_geo(r, b) for b in boxes}
        buffers = {label: np.empty((r1 - r0, c1 - c0), dtype=r.dtype)
                   for label, (r0, r1, c0, c1) in windows.items()}
        row_lo = min(w[0] for w in windows.values())
        row_hi = max(w[1] for w in windows.values())
        for y in range(row_lo, row_hi, block_rows):
            y1 = min(y + block_rows, row_hi)
            block = r.read_rows(y, y1)
            for label, (r0, r1, c0, c1) in windows.items():
                a, b = max(y, r0), min(y1, r1)
                if a < b:
                    buffers[label][a - r0 : b - r0] = block[a - y : b - y,
                                                            c0:c1]
        for label, arr in buffers.items():
            out = os.path.join(output_path, _npy_name(label))
            np.save(out, arr)
            written.append(out)
    return written
