"""Large-raster DEM super-resolution engine: the per-tile program and the
tile loop (counterpart of moonsuperresolution_tpu/infer/engine.py).

The raster is cut into ``tile_size`` tiles with an ``image_size - stride``
halo.  For each tile, everything between the slab and the blended mean,
std and coverage planes runs on the card:

    fused patch prep (csrc/patches.cu) -> valid-patch packing -> chunked
    encoder + generator forwards -> denormalisation -> purge crop ->
    Gaussian-weighted two-pass fold (ops/blend.py) -> crop to the tile

The overlapping generations are the Monte-Carlo uncertainty estimate of the
reference: std = sqrt(S / w_sum) over ~64 generations per pixel at stride =
image_size / 8 (process_full_tiles.py:386-414).

Not ported yet: GeoTIFF reading and writing, nodata filling and the /16
low-res DEM synthesis (``load_images``, ``preprocess``, ``save_gtiff``,
``process_map``), per-tile dumps, and the int8 generator.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from moonsuperresolution_tpu_torch.config import DSRConfig, ModelConfig
from moonsuperresolution_tpu_torch.device import resolve_device
from moonsuperresolution_tpu_torch.models.gaugan import DTYPES, GauGAN
from moonsuperresolution_tpu_torch.ops.blend import (
    fold_weighted_moments,
    gaussian_blend_kernel,
)
from moonsuperresolution_tpu_torch.ops.patches import extract_normalize_patches
from moonsuperresolution_tpu_torch.utils.convert import load_params


def load_model_fn(model_path: Optional[str], kind: str, image_size: int,
                  latent_dim: int = 256, compute_dtype: str = "bfloat16",
                  quantize: str = "none", device=None,
                  **model_kw) -> Optional[GauGAN]:
    """The patch-batch model: ``model(source [B, 2, I, I], generator=...) ->
    [B, 1, I, I]`` float32.

    An empty ``model_path`` gives None, the identity model: the tile program
    then emits the low-res DEM channel unchanged, the reference's
    pipeline-fidelity dry run (process_full_tiles.py:139-143).  Otherwise
    ``model_path`` is an ``.npz`` of the JAX parameter tree
    (``utils.convert.save_npz``).  ``model_kw`` sets other ModelConfig
    fields (a smaller channel plan, say).
    """
    dev = resolve_device(device)
    if quantize != "none":
        raise ValueError(f"quantize={quantize!r} is not ported; use 'none'")
    if not model_path:
        return None
    cfg = ModelConfig(variant=kind, image_size=image_size,
                      latent_dim=latent_dim, compute_dtype=compute_dtype,
                      **model_kw)
    model = load_params(GauGAN(cfg), model_path)
    return model.to(device=dev, dtype=DTYPES[compute_dtype]).eval()


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

    # ------------------------------------------------------------ rasters

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

    def run_tiles_serial(self, tiles, commit) -> None:
        """Tile loop with staged uploads.  While the card runs tile i, a
        worker thread slices tile i+1's slabs, pins them and copies them up
        on a side CUDA stream; ``commit(px, py, out)`` runs on another
        thread, one tile behind."""
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def stage(px, py):
            host = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
                    for a in self._slabs(px, py)]
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
                staged = nxt.result() if nxt is not None else None
            if commit_fut is not None:
                commit_fut.result()
        if pending is not None:
            commit(*pending)

    def _commit_tile(self, pending, mean_map, std_map, good_map) -> None:
        """Write one tile's planes into the full maps, clipped at the
        raster's edge."""
        px, py, (mean_t, std_t, good_t) = pending
        t = self.cfg.tile_size
        h, w = self.dem_shape
        hh = min(t, h - py)
        ww = min(t, w - px)
        mean_map[py : py + hh, px : px + ww] = mean_t[:hh, :ww].cpu().numpy()
        std_map[py : py + hh, px : px + ww] = std_t[:hh, :ww].cpu().numpy()
        good_map[py : py + hh, px : px + ww] = good_t[:hh, :ww].cpu().numpy()
