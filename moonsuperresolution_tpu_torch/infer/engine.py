"""Large-raster DEM super-resolution engine: the full-map pipeline, the
tile loop and the per-tile program (counterpart of
moonsuperresolution_tpu/infer/engine.py).

``process_map`` runs a whole map: read the ortho and DEM GeoTIFF pair, fill
small nodata holes, synthesise the /16 low-res conditioning DEM, run every
tile, and write the mean, std and good LZW GeoTIFFs with the georeferencing
kept.  ``process_map_streaming`` (infer/streaming.py) does the same in
bounded host memory, and ``shard_index / num_shards`` spread one map over
several jobs (merged by infer/merge.py).

The raster is cut into ``tile_size`` tiles with an ``image_size - stride``
halo.  For each tile, everything between the slab and the blended mean,
std and coverage planes runs on the card:

    fused patch prep (csrc/patches.cu) -> valid-patch packing -> chunked
    encoder + generator forwards -> denormalisation -> purge crop ->
    Gaussian-weighted two-pass fold (ops/blend.py) -> crop to the tile

The overlapping generations are the Monte-Carlo uncertainty estimate of the
reference: std = sqrt(S / w_sum) over ~64 generations per pixel at stride =
image_size / 8 (process_full_tiles.py:386-414).

Host work that stays on the host: the nodata fill (scipy, infer/fill.py)
and the GeoTIFF codec.  The /16 synthesis's resizes run on the engine's
device (ops/resize.py).

``load_model_fn(quantize="int8" | "int8_static")`` gives the int8 generator
(models/quant.py, its convs on the hand-written s8 kernel csrc/qconv.cu);
``int8_static`` re-calibrates its activation scales once, on real patches of
the first staged slabs, before the first tile (``_maybe_calibrate``).

Not ported yet: the multi-device tile-parallel mode (``process_tile_group``)
and the tile profile (``profile_dir``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from moonsuperresolution_tpu_torch.config import DSRConfig, ModelConfig
from moonsuperresolution_tpu_torch.device import resolve_device
from moonsuperresolution_tpu_torch.geo.tiff import TiffReader, write_geotiff
from moonsuperresolution_tpu_torch.infer.fill import fill_nodata
from moonsuperresolution_tpu_torch.models.gaugan import (
    DTYPES,
    VARIANTS,
    GauGAN,
    QuantizedGauGAN,
    StaticQuantizedGauGAN,
)
from moonsuperresolution_tpu_torch.ops.blend import (
    fold_weighted_moments,
    gaussian_blend_kernel,
)
from moonsuperresolution_tpu_torch.ops.patches import extract_normalize_patches
from moonsuperresolution_tpu_torch.ops.resize import (
    area_downscale4,
    resize_cubic,
)
from moonsuperresolution_tpu_torch.utils.checkpoint import restore_params
from moonsuperresolution_tpu_torch.utils.convert import load_params


QUANTIZE_MODES = ("none", "int8", "int8_static")


def load_model_fn(model_path: Optional[str], kind: str, image_size: int,
                  latent_dim: int = 256, compute_dtype: str = "bfloat16",
                  quantize: str = "none", int8_acc: str = "bfloat16",
                  device=None, **model_kw):
    """The patch-batch model: ``model(source [B, 2, I, I], generator=...) ->
    [B, 1, I, I]`` float32.

    An empty ``model_path`` gives None, the identity model: the tile program
    then emits the low-res DEM channel unchanged, the reference's
    pipeline-fidelity dry run (process_full_tiles.py:139-143).  Otherwise
    ``model_path`` is an ``.npz`` of the JAX parameter tree
    (``utils.convert.save_npz``), or the ``epoch_N.pt`` that the port's
    training loop writes (``trainer.nets``' state dict).  Either way its
    ``encoder`` and ``generator`` load strictly and a ``discriminator`` is
    left out.  ``model_kw`` sets other ModelConfig fields (a smaller
    channel plan, say).

    ``quantize``: "none", or the int8 generator (``quantize_model``):
    "int8" with dynamic activation scales, "int8_static" with calibrated
    ones.  ``int8_acc`` is its conv result type: "bfloat16" (the sum
    rounded once to bf16) or "int32" (exact).

    The engine serves the GauGAN family only, as the JAX engine does (its
    ``GauGANTrainer`` asserts the variant): any other ``kind`` (pix2pix)
    raises a ValueError.
    """
    dev = resolve_device(device)
    if kind not in VARIANTS:
        raise ValueError(f"the map engine serves the GauGAN family "
                         f"{VARIANTS}, not {kind!r}")
    if quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r}; one of "
                         f"{QUANTIZE_MODES}")
    if not model_path:
        return None
    cfg = ModelConfig(variant=kind, image_size=image_size,
                      latent_dim=latent_dim, compute_dtype=compute_dtype,
                      **model_kw)
    model = load_weights(GauGAN(cfg), model_path)
    if quantize != "none":
        return quantize_model(model, quantize, compute_dtype, int8_acc, dev)
    return model.to(device=dev, dtype=DTYPES[compute_dtype]).eval()


_SERVED = ("encoder", "generator")


def load_weights(model: GauGAN, path: str) -> GauGAN:
    """``model``'s weights from a JAX-tree ``.npz`` or a port ``.pt`` state
    dict: the encoder and generator strictly, the rest of a training run's
    weights (its discriminator) left out."""
    if path.endswith(".pt"):
        state = {k: v for k, v in restore_params(path).items()
                 if k.split(".")[0] in _SERVED}
        model.load_state_dict(state, strict=True)
        return model
    return load_params(model, path, subtrees=_SERVED)


def quantize_model(model: GauGAN, quantize: str,
                   compute_dtype: str = "bfloat16", int8_acc: str = "bfloat16",
                   device=None) -> QuantizedGauGAN:
    """A float GauGAN -> its int8 twin on ``device`` (counterpart of the
    JAX ``load_model_fn``'s int8 branch, infer/engine.py:85-147).  The
    generator is quantized from the float weights; a copy of the encoder
    runs in ``compute_dtype``, and ``model`` is left as it was.  "int8_static" bootstraps its
    activation scales on synthetic normalised patches (2 rounds at margin
    1.05); the engine widens them on real patches before the first tile."""
    dev = resolve_device(device)
    if quantize not in QUANTIZE_MODES[1:]:
        raise ValueError(f"quantize {quantize!r} is not an int8 mode")
    cls = StaticQuantizedGauGAN if quantize == "int8_static" \
        else QuantizedGauGAN
    qmodel = cls(model, acc_dtype=int8_acc)
    qmodel.encoder.to(DTYPES[compute_dtype])
    qmodel = qmodel.to(dev).eval()
    if quantize == "int8_static":
        qmodel.bootstrap()
    return qmodel


@dataclasses.dataclass
class TileGeometry:
    image_size: int
    stride: int
    tile_size: int

    def __post_init__(self):
        i, s, t = self.image_size, self.stride, self.tile_size
        if i % s or t % s:
            raise ValueError(
                f"stride {s} must divide image_size {i} and tile_size {t}"
            )
        self.grid = t // s + i // s - 1          # patches per tile side
        self.halo = i - s                         # padding around each tile
        self.slab = t + 2 * self.halo             # on-device slab side
        self.purge = i // 16                      # border purge per patch
        self.patch = i - 2 * self.purge           # folded patch side


class DEMSuperResolution:
    """Tile-by-tile super-resolution with uncertainty.

    ``model(source, generator=...)`` maps a [B, 2, I, I] batch in the
    compute dtype to [B, 1, I, I] or [B, I, I]; None is the identity model.
    """

    # Output rows per device pass of the preprocess's cubic upsample.
    CUBIC_BAND_ROWS = 2048

    def __init__(self, config: DSRConfig, model: Optional[Callable] = None,
                 device=None):
        self.cfg = config
        self.model = model
        self.device = resolve_device(device)
        self.geom = TileGeometry(config.image_size, config.stride,
                                 config.tile_size)
        self.no_value = float(config.no_value)
        self.compute_dtype = DTYPES[config.compute_dtype]
        self.weight = torch.from_numpy(
            gaussian_blend_kernel(config.image_size)).to(self.device)
        self._calibrated = False

    # ------------------------------------------------------------ rasters

    def load_images(self) -> None:
        """Read the DEM + ortho rasters and their geo metadata
        (reference: process_full_tiles.py:158-182)."""
        img_path = os.path.join(self.cfg.source_folder_path,
                                self.cfg.ortho_image_name)
        dem_path = os.path.join(self.cfg.source_folder_path, self.cfg.dem_name)
        for p in (img_path, dem_path):
            if not os.path.exists(p):
                raise ValueError(f"input raster not found: {p}")
        with TiffReader(img_path) as r:
            self.img = r.read().astype(np.float32).squeeze()
        with TiffReader(dem_path) as r:
            self.dem = r.read().astype(np.float32).squeeze()
            self.geo_transform = r.geo_transform
            self.projection = r.projection
        self.dem_shape = self.dem.shape

    def _nodata_to_nan(self, plane: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(plane).to(self.device)
        return torch.where(t <= self.no_value, torch.nan, t)

    def _nan_to_nodata(self, t: torch.Tensor) -> np.ndarray:
        return torch.where(t.isnan(), self.no_value, t).cpu().numpy()

    def preprocess(self, fill_method: str = "fast") -> None:
        """Fill small nodata holes and synthesize the /16 low-res
        conditioning DEM (reference: process_full_tiles.py:226-244).

        The hole fills run on the host (a process pool over holed tiles);
        the area /4, area /4 and cubic-up resizes run on the engine's
        device with cv2's semantics (ops/resize.py), the cubic up in bands
        of ``CUBIC_BAND_ROWS`` rows, the same function the streaming engine
        calls per tile-row band.  The planes come back to the host for
        ``pad_inputs``; the device copies are dropped.
        """
        nv = self.no_value
        workers = self.cfg.fill_workers
        self.img = fill_nodata(self.img, nv, tile_size=1024, border=128,
                               max_fill_area=8, method=fill_method,
                               workers=workers)
        quarter = self._nan_to_nodata(
            area_downscale4(self._nodata_to_nan(self.dem)))
        quarter = fill_nodata(quarter, nv, tile_size=256, border=32,
                              max_fill_area=24, method=fill_method,
                              workers=workers)
        s16 = area_downscale4(self._nodata_to_nan(quarter))
        h = self.dem_shape[0]
        for a in range(0, h, self.CUBIC_BAND_ROWS):
            b = min(h, a + self.CUBIC_BAND_ROWS)
            self.dem[a:b] = self._nan_to_nodata(
                resize_cubic(s16, self.dem_shape, a, b))

    def pad_inputs(self) -> None:
        """Pad to tile_size multiples plus the tile halo, filled with
        no_value (reference: process_full_tiles.py:246-267).  Reads
        ``self.img``, ``self.dem`` and ``self.dem_shape``."""
        g = self.geom
        t = self.cfg.tile_size
        h, w = self.dem_shape
        new_w = ((w // t) + 1) * t + g.halo * 2
        new_h = ((h // t) + 1) * t + g.halo * 2
        self.pad_x = new_w - w - g.halo
        self.pad_y = new_h - h - g.halo
        dem_p = np.full((new_h, new_w), self.no_value, np.float32)
        img_p = np.full((new_h, new_w), self.no_value, np.float32)
        dem_p[g.halo : g.halo + h, g.halo : g.halo + w] = self.dem
        img_p[g.halo : g.halo + h, g.halo : g.halo + w] = self.img
        self.dem_padded, self.img_padded = dem_p, img_p
        self.dem = self.img = None

    def generate_tile_list(self, shard_index: int = 0, num_shards: int = 1):
        """Tile corner list; shardable across processes
        (reference: process_full_tiles.py:313-325)."""
        t = self.cfg.tile_size
        tiles = [
            (xx, yy)
            for yy in range(0, self.dem_shape[0], t)
            for xx in range(0, self.dem_shape[1], t)
        ]
        return tiles[shard_index::num_shards]

    # -------------------------------------------------------- tile program

    @torch.inference_mode()
    def tile_program(self, img_slab: torch.Tensor, dem_slab: torch.Tensor,
                     generator: Optional[torch.Generator] = None):
        """One tile: ``[slab, slab]`` float32 slabs on the engine's device
        -> (mean, std, good) ``[tile, tile]`` planes on the device."""
        g = self.geom
        i_sz, s, t, b = g.image_size, g.stride, g.tile_size, self.cfg.batch_size
        n = g.grid * g.grid
        x, valid, dmin, dmax = extract_normalize_patches(
            img_slab, dem_slab, (g.grid, g.grid), s, i_sz, self.no_value)
        x = x.permute(0, 3, 1, 2)  # the kernel's contiguous [N, 2, I, I]
        valid = valid > 0
        if self.model is None:
            # Identity: the low-res DEM channel (elementwise, no batching).
            preds = x[:, 1]
        else:
            # The reference's batch composition: valid patches only, packed
            # densely in grid order (a stable argsort), the last batch
            # zero-padded to B.  SPADE's moments couple the batch, so the
            # padding patches stay inside it.  Batches past the last valid
            # patch are skipped; invalid patches keep a zero prediction,
            # which the fold weighs by zero.
            order = torch.argsort((~valid).to(torch.uint8), stable=True)
            n_active = int(valid.sum())
            preds = torch.zeros((n, i_sz, i_sz), dtype=torch.float32,
                                device=x.device)
            for c0 in range(0, n_active, b):
                k = min(b, n_active - c0)
                idx = order[c0 : c0 + k]
                xb = torch.zeros((b, 2, i_sz, i_sz), dtype=self.compute_dtype,
                                 device=x.device)
                xb[:k] = x.index_select(0, idx)
                yb = self.model(xb, generator=generator)
                preds.index_copy_(0, idx, yb.reshape(b, i_sz, i_sz)[:k].float())

        # Denormalise: de-centre, then restore the per-patch min-max range
        # (process_full_tiles.py:340, 388).
        vals = (preds + 0.5) * (dmax - dmin)[:, None, None] + dmin[:, None, None]
        p0 = g.purge
        vals = vals[:, p0 : i_sz - p0, p0 : i_sz - p0]
        mean, std, _, good = fold_weighted_moments(
            vals.reshape(g.grid, g.grid, g.patch, g.patch),
            valid.reshape(g.grid, g.grid), self.weight, s)
        # The fold plane starts at +purge in slab coordinates; the tile is
        # slab [halo : halo + T].
        o = g.halo - p0
        good_t = good[o : o + t, o : o + t]
        cover = good_t > 0
        mean_t = torch.where(cover, mean[o : o + t, o : o + t], self.no_value)
        std_t = torch.where(cover, std[o : o + t, o : o + t], self.no_value)
        return mean_t, std_t, good_t

    # ----------------------------------------------------------- tile loop

    def tile_generator(self, px: int, py: int) -> torch.Generator:
        """Deterministic per-tile generator from (config seed, tile corner)."""
        seed = np.random.SeedSequence([self.cfg.seed, px, py]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(self.device).manual_seed(int(seed))

    def _slabs(self, px: int, py: int):
        g = self.geom
        return (self.img_padded[py : py + g.slab, px : px + g.slab],
                self.dem_padded[py : py + g.slab, px : px + g.slab])

    def process_tile(self, px: int, py: int):
        """One tile of the padded rasters -> (mean, std, good) on the
        device."""
        img, dem = (torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                    for a in self._slabs(px, py))
        return self.tile_program(img, dem, self.tile_generator(px, py))

    def _maybe_calibrate(self, img_slab, dem_slab) -> None:
        """One-time int8_static re-calibration on real patches: the loader
        bootstraps the activation scales on synthetic noise, but real
        DEM/ortho activations are structured and can exceed them (silent
        clipping).  The first 8 valid patches, in grid order, of the first
        staged slabs, cut and normalised by the tile program's patch prep,
        go to the model's ``calibrate_on`` as float32 [n, 2, I, I] on the
        engine's device, before any tile is processed."""
        if (self.model is None or not hasattr(self.model, "calibrate_on")
                or self._calibrated):
            return
        self._calibrated = True
        g = self.geom
        x, valid, _, _ = extract_normalize_patches(
            img_slab, dem_slab, (g.grid, g.grid), g.stride, g.image_size,
            self.no_value)
        idx = torch.nonzero(valid > 0).flatten()[:8]
        if not len(idx):
            return  # fully invalid slab: the bootstrap scales remain
        self.model.calibrate_on(x.permute(0, 3, 1, 2).index_select(0, idx))

    def run_tiles_serial(self, tiles, commit, progress: bool = False,
                         slab_provider=None) -> None:
        """Tile loop with staged uploads.  While the card runs tile i, a
        worker thread slices tile i+1's slabs, pins them and copies them up
        on a side CUDA stream; ``commit(px, py, out)`` runs on another
        thread, one tile behind.  The first tile's staged slabs feed the
        one-time int8_static calibration (``_maybe_calibrate``).

        ``slab_provider(px, py) -> (img_slab, dem_slab)`` overrides the
        slicing of the padded rasters: the streaming engine cuts slabs out
        of row bands (column slices, made contiguous here before
        pinning)."""
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        slabs = slab_provider or self._slabs

        def stage(px, py):
            host = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
                    for a in slabs(px, py)]
            if not cuda:
                return host
            with torch.cuda.stream(side):
                staged = [h.pin_memory().to(self.device, non_blocking=True)
                          for h in host]
            side.synchronize()  # the pinned buffers are released on return
            return staged

        pending = None
        commit_fut = None
        with concurrent.futures.ThreadPoolExecutor(1) as up_pool, \
                concurrent.futures.ThreadPoolExecutor(1) as down_pool:
            staged = stage(*tiles[0]) if tiles else None
            if staged is not None:
                self._maybe_calibrate(*staged)
            for idx, (px, py) in enumerate(tiles):
                nxt = (up_pool.submit(stage, *tiles[idx + 1])
                       if idx + 1 < len(tiles) else None)
                if cuda:
                    # Allocated on the side stream, read on this one.
                    for a in staged:
                        a.record_stream(torch.cuda.current_stream(self.device))
                out = self.tile_program(*staged, self.tile_generator(px, py))
                if pending is not None:
                    if commit_fut is not None:
                        commit_fut.result()
                    commit_fut = down_pool.submit(commit, *pending)
                pending = (px, py, out)
                if progress:
                    print(f"tile {idx + 1}/{len(tiles)} at ({px},{py})",
                          flush=True)
                staged = nxt.result() if nxt is not None else None
            if commit_fut is not None:
                commit_fut.result()
        if pending is not None:
            commit(*pending)

    # ------------------------------------------------------------ outputs

    def save_tile(self, mean, std, good, name: str) -> None:
        """Per-tile dumps in the reference's layout
        (process_full_tiles.py:416-429): tile_<x>_<y>/tile_<x>_<y>_{mean,std,
        correct}.tif.  Sharded runs write them for infer/merge.py."""
        tile_dir = os.path.join(self.cfg.save_path, f"tile_{name}")
        os.makedirs(tile_dir, exist_ok=True)
        for plane, kind in ((mean, "mean"), (std, "std"), (good, "correct")):
            write_geotiff(os.path.join(tile_dir, f"tile_{name}_{kind}.tif"),
                          plane, compress="lzw")

    def save_gtiff(self, data: np.ndarray, name: str) -> None:
        """Write one output map as LZW GeoTIFF with geo metadata + nodata
        (reference: process_full_tiles.py:481-531)."""
        os.makedirs(self.cfg.save_path, exist_ok=True)
        path = os.path.join(self.cfg.save_path,
                            f"{self.cfg.map_name}_{name}.tiff")
        write_geotiff(path, data, self.geo_transform, self.projection,
                      nodata=self.no_value, compress="lzw")

    # ---------------------------------------------------------- full maps

    def process_map(self, progress: bool = True, shard_index: int = 0,
                    num_shards: int = 1, fill_method: str = "fast") -> dict:
        """Full pipeline: load -> preprocess -> pad -> tiles -> 3 GeoTIFFs
        (reference: process_full_tiles.py:568-587).  Returns timing stats;
        the maps stay in ``self.result``.

        With ``num_shards > 1`` this process runs every ``num_shards``-th
        tile and writes per-tile dumps plus a manifest instead of the full
        maps (concurrent shards on shared storage must not clobber one
        output path); infer/merge.py::merge_shards reassembles them.
        """
        t0 = time.perf_counter()
        self.load_images()
        self.preprocess(fill_method=fill_method)
        self.pad_inputs()
        t_pre = time.perf_counter() - t0

        h, w = self.dem_shape
        mean_map = np.full((h, w), self.no_value, np.float32)
        std_map = np.full((h, w), self.no_value, np.float32)
        good_map = np.zeros((h, w), np.uint8)

        tiles = self.generate_tile_list(shard_index, num_shards)
        sharded = num_shards > 1

        def commit(px, py, out):
            self._commit_tile((px, py, out), mean_map, std_map, good_map,
                              save_tiles=sharded)

        t1 = time.perf_counter()
        self.run_tiles_serial(tiles, commit, progress=progress)
        t_tiles = time.perf_counter() - t1

        t2 = time.perf_counter()
        if self.cfg.save_path:
            if sharded:
                from moonsuperresolution_tpu_torch.infer.merge import (
                    write_shard_manifest,
                )

                write_shard_manifest(
                    self.cfg.save_path, self.cfg.map_name, shard_index,
                    num_shards, tiles, self.dem_shape, self.cfg.tile_size,
                    self.no_value, self.geo_transform, self.projection,
                )
            else:
                # The three maps are independent: write them concurrently
                # (write_geotiff also compresses its strips on threads).
                with concurrent.futures.ThreadPoolExecutor(3) as pool:
                    futs = [
                        pool.submit(self.save_gtiff, mean_map, "mean"),
                        pool.submit(self.save_gtiff, std_map, "std"),
                        pool.submit(self.save_gtiff,
                                    good_map.astype(np.uint16), "good"),
                    ]
                    for f in futs:
                        f.result()
        t_save = time.perf_counter() - t2

        n_patches = len(tiles) * self.geom.grid ** 2
        self.result = {"mean": mean_map, "std": std_map, "good": good_map}
        return {
            "tiles": len(tiles),
            "patches": n_patches,
            "preprocess_s": t_pre,
            "tiles_s": t_tiles,
            "save_s": t_save,
            "patches_per_s": n_patches / max(t_tiles, 1e-9),
        }

    def process_map_streaming(self, progress: bool = True,
                              fill_method: str = "fast",
                              shard_index: int = 0,
                              num_shards: int = 1) -> dict:
        """Bounded-memory pipeline for rasters too large to hold in host
        RAM: row-band reads, windowed nodata fill, banded /16 LR synthesis,
        and strip-streamed GeoTIFF output (infer/streaming.py).  With
        ``num_shards > 1`` tile-row bands stride across shards; merge with
        ``infer/merge.py::merge_shards_streaming``."""
        from moonsuperresolution_tpu_torch.infer.streaming import (
            process_map_streaming,
        )

        return process_map_streaming(self, progress=progress,
                                     fill_method=fill_method,
                                     shard_index=shard_index,
                                     num_shards=num_shards)

    def _commit_tile(self, pending, mean_map, std_map, good_map,
                     save_tiles: bool = False) -> None:
        """Write one tile's planes into the full maps, clipped at the
        raster's edge; with ``save_tiles`` also dump the whole tile."""
        px, py, out = pending
        mean_t, std_t, good_t = (a.cpu().numpy() for a in out)
        t = self.cfg.tile_size
        h, w = self.dem_shape
        hh = min(t, h - py)
        ww = min(t, w - px)
        mean_map[py : py + hh, px : px + ww] = mean_t[:hh, :ww]
        std_map[py : py + hh, px : px + ww] = std_t[:hh, :ww]
        good_map[py : py + hh, px : px + ww] = good_t[:hh, :ww]
        if save_tiles and self.cfg.save_path:
            self.save_tile(mean_t, std_t, good_t, f"{px}_{py}")
