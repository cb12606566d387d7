"""Nodata hole filling for input rasters (host-side preprocessing;
counterpart of moonsuperresolution_tpu/infer/fill.py, without OpenCV).

Reimplements the reference's small-blob interpolation
(process_full_tiles.py:364-424): connected nodata components below a size
threshold are filled by interpolation from the valid pixels; larger holes are
left as nodata (and later rejected at the patch level).

Two modes:
- ``method="reference"``: cubic griddata over *all* valid points of the tile,
  the reference's exact behavior — accurate but very slow on big tiles.
- ``method="fast"`` (default): interpolation restricted to a dilated
  neighbourhood of each hole, blob after blob.

The JAX package labels holes with ``cv2.connectedComponents`` and grows
their neighbourhoods with ``cv2.dilate``.  Here ``label_holes`` reproduces
cv2's label image with ``scipy.ndimage.label`` (8-connected) and a
renumbering, and the dilation is ``scipy.ndimage.binary_dilation``.  The
numbering matters: the fast mode fills blobs in label order, and each blob
reads what earlier blobs wrote.

The process pools come from a ``forkserver``: the parent holds a CUDA
context and worker threads, so it must not fork itself, and a ``spawn`` pool
re-imports scipy in every worker of every pool, which takes seconds, while
the streaming engine starts pools band after band.  The fork server starts
once, from a fresh interpreter, with scipy and this module preloaded, and
forks its pools' workers from there.  This module imports neither torch nor
the rest of the port.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os

import numpy as np

_EIGHT = np.ones((3, 3), bool)
_PRELOAD = ["scipy.interpolate", "scipy.ndimage", __name__]


def label_holes(invalid: np.ndarray) -> np.ndarray:
    """The label image of ``cv2.connectedComponents(invalid, connectivity=8)``:
    0 on valid pixels, components numbered 1.. in cv2's order.

    scipy gives the same partition but numbers components in raster order.
    cv2's 8-connected labelling scans two rows at a time, so a component's
    number follows its first pixel under the key (y // 2, x, y % 2).
    """
    from scipy import ndimage

    labels, n = ndimage.label(invalid, structure=_EIGHT)
    if n < 2:
        return labels
    ys, xs = np.nonzero(labels)
    key = (ys // 2).astype(np.int64) * (2 * invalid.shape[1]) + 2 * xs + ys % 2
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, labels[ys, xs], key)
    renumber = np.zeros(n + 1, labels.dtype)
    renumber[1 + np.argsort(first[1:])] = np.arange(1, n + 1)
    return renumber[labels]


def interpolate_missing_values(
    data: np.ndarray,
    no_value: float,
    max_fill_area: int = 256,
    method: str = "fast",
) -> np.ndarray:
    """Fill nodata blobs smaller than ``max_fill_area`` px.

    Mirrors process_full_tiles.py:364-392: early-out when there are no
    missing values or no valid values; blobs >= max_fill_area are kept as
    nodata.
    """
    from scipy import interpolate as si
    from scipy import ndimage

    invalid = data <= no_value
    if not invalid.any() or invalid.all():
        return data
    labels = label_holes(invalid)
    ids, counts = np.unique(labels, return_counts=True)
    # Blob id 0 is the valid background; if every hole is too large, skip.
    fill_ids = [i for i, c in zip(ids, counts) if c < max_fill_area and i != 0]
    if not fill_ids:
        return data
    fill_mask = np.isin(labels, fill_ids) & invalid

    if method == "reference":
        yy, xx = np.mgrid[0 : data.shape[0], 0 : data.shape[1]]
        pts = np.stack([xx[~invalid], yy[~invalid]], -1)
        vals = data[~invalid].ravel()
        interp = si.griddata(pts, vals, (xx, yy), method="cubic")
        data = data.copy()
        data[fill_mask] = interp[fill_mask]
        return data

    # fast path: per-hole local interpolation, in label order
    data = data.copy()
    boxes = ndimage.find_objects(labels)
    pad = 8
    for blob_id in fill_ids:
        by, bx = boxes[blob_id - 1]
        y0, x0 = max(0, by.start - pad), max(0, bx.start - pad)
        y1 = min(data.shape[0], by.stop + pad)
        x1 = min(data.shape[1], bx.stop + pad)
        sub = data[y0:y1, x0:x1]
        sub_hole = labels[y0:y1, x0:x1] == blob_id
        sub_valid = ~(sub <= no_value)
        ring = ndimage.binary_dilation(sub_hole, structure=_EIGHT,
                                       iterations=pad)
        src = sub_valid & ring
        if src.sum() < 4:
            continue
        syy, sxx = np.mgrid[0 : sub.shape[0], 0 : sub.shape[1]]
        pts = np.stack([sxx[src], syy[src]], -1)
        try:
            filled = si.griddata(pts, sub[src].ravel(),
                                 (sxx[sub_hole], syy[sub_hole]),
                                 method="cubic")
        except (ValueError, RuntimeError):  # e.g. collinear points (Qhull)
            filled = None
        if filled is None or np.isnan(filled).any():
            filled = si.griddata(pts, sub[src].ravel(),
                                 (sxx[sub_hole], syy[sub_hole]),
                                 method="nearest")
        sub[sub_hole] = filled
    return data


def _fill_one(args):
    tile, no_value, max_fill_area, method = args
    return interpolate_missing_values(
        tile, no_value, max_fill_area=max_fill_area, method=method
    )


def fill_tiles(tiles, no_value: float, max_fill_area: int, method: str,
               workers: int) -> list:
    """``interpolate_missing_values`` of each tile, in order; a process pool
    fills them when ``workers`` > 1 (0 = one per CPU) and there are at least
    two."""
    if workers == 0:
        workers = os.cpu_count() or 1
    jobs = [(t, no_value, max_fill_area, method) for t in tiles]
    if workers <= 1 or len(jobs) < 2:
        return [_fill_one(j) for j in jobs]
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)  # read when the server starts
    with concurrent.futures.ProcessPoolExecutor(
        max_workers=min(workers, len(jobs)), mp_context=ctx,
    ) as pool:
        return list(pool.map(_fill_one, jobs))


def fill_nodata_window(
    read_rows,
    shape: tuple,
    a: int,
    b: int,
    no_value: float,
    tile_size: int = 1024,
    border: int = 128,
    max_fill_area: int = 256,
    method: str = "fast",
    workers: int = 1,
) -> np.ndarray:
    """Rows [a, b) of ``fill_nodata`` applied to a raster streamed via
    ``read_rows(y0, y1) -> [y1-y0, W]`` — bit-exact with the in-RAM sweep.

    The full-raster sweep fills each bordered tile purely from the
    *original* rows, so any band of output rows depends only on the raw
    rows of the fill tiles whose written interiors intersect it.  Rows
    outside every tile interior (the global top/bottom ``border`` rows)
    pass through unchanged, exactly like ``fill_nodata``.
    """
    H, W = shape
    stride = tile_size - border * 2
    tile_ys = [
        y for y in range(0, H, stride)
        if y + border < b and min(y + tile_size - border, H - border) > a
    ]
    ra = min(min(tile_ys), a) if tile_ys else a
    rb = max(max(y + tile_size for y in tile_ys), b) if tile_ys else b
    rb = min(rb, H)
    raw = np.asarray(read_rows(ra, rb))
    out = raw[a - ra : b - ra].copy()

    jobs = []  # holed tiles whose written interior intersects [a, b)
    for y in tile_ys:
        ymax = min(y + tile_size - border, H - border)
        for x in range(0, W, stride):
            xmax = min(x + tile_size - border, W - border)
            # interior rows of this tile, clipped to the requested band
            w0, w1 = max(y + border, a), min(ymax, b)
            if w0 >= w1:
                continue
            tile = raw[y - ra : y - ra + tile_size, x : x + tile_size]
            if not (tile <= no_value).any():
                continue
            jobs.append((y, x, xmax, w0, w1))

    filled = fill_tiles(
        [raw[y - ra : y - ra + tile_size, x : x + tile_size].copy()
         for y, x, _, _, _ in jobs],
        no_value, max_fill_area, method, workers)
    for (y, x, xmax, w0, w1), tile in zip(jobs, filled):
        out[w0 - a : w1 - a, x + border : xmax] = tile[
            w0 - y : w1 - y,
            border : border + max(0, xmax - x - border),
        ]
    return out


def fill_nodata(
    image: np.ndarray,
    no_value: float,
    tile_size: int = 1024,
    border: int = 128,
    max_fill_area: int = 256,
    method: str = "fast",
    workers: int = 0,
) -> np.ndarray:
    """Bordered tile sweep of ``interpolate_missing_values`` over a large
    raster (process_full_tiles.py:394-404): each tile is interpolated with
    ``border`` px of context, only the interior is written back.

    Tiles are independent, so with ``workers`` > 1 (or 0 = one per CPU) the
    holed tiles are filled by a process pool.
    """
    new_image = image.copy()
    stride = tile_size - border * 2

    jobs = []  # (y, x, ymax, xmax) of holed tiles
    for y in range(0, image.shape[0], stride):
        ymax = min(y + tile_size - border, image.shape[0] - border)
        for x in range(0, image.shape[1], stride):
            xmax = min(x + tile_size - border, image.shape[1] - border)
            tile = image[y : y + tile_size, x : x + tile_size]
            if not (tile <= no_value).any():
                continue
            jobs.append((y, x, ymax, xmax))

    filled = fill_tiles(
        [image[y : y + tile_size, x : x + tile_size].copy()
         for y, x, _, _ in jobs],
        no_value, max_fill_area, method, workers)
    for (y, x, ymax, xmax), tile in zip(jobs, filled):
        new_image[y + border : ymax, x + border : xmax] = tile[
            border : border + max(0, ymax - y - border),
            border : border + max(0, xmax - x - border),
        ]
    return new_image
