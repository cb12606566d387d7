"""Configuration of the port's inference path (counterpart of
moonsuperresolution_tpu/config.py: ``DSRConfig`` and the ``ModelConfig``
fields the inference path reads).

Left out, because nothing in the port reads them: the training, loss,
optimizer and data settings; ``fuse_spade_gb`` (the port always issues the
SPADE gamma/beta convs as one conv); and the TPU-only inference knobs
``use_pallas_patches`` (the port always prepares patches with its fused
kernel on the card) and ``scan_unroll`` (PyTorch runs the chunk loop
eagerly).  ``pack_valid`` is always on: the port packs valid patches as the
reference batches them.  ``upsample_factor`` (read by nothing in the JAX
package either) and ``save_tiles`` are left out too: a sharded in-RAM run
writes per-tile dumps, a whole run does not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    variant: str = "gaugan"  # gaugan | gaugan_no_kl | cnn_spade
    image_size: int = 256
    latent_dim: int = 256
    alpha: float = 0.2
    # "batch": moments over (B, H, W), the reference's tf.nn.moments over
    # (0, 1, 2); "instance": per-sample moments.
    spade_stats: str = "batch"
    channel_plan: tuple = (1024, 1024, 1024, 512, 256, 128)
    encoder_filters: int = 64
    compute_dtype: str = "float32"  # "float32" or "bfloat16"
    stats_dtype: str = "float32"    # SPADE statistics
    # The generator's final upsample + 4x4 head conv as an equivalent
    # subpixel conv at pre-upsample resolution; same parameters either way.
    subpixel_head: bool = True


@dataclasses.dataclass
class DSRConfig:
    """Large-raster inference configuration (reference:
    process_full_tiles.py:53-66)."""

    image_size: int = 256
    stride: int = 32
    batch_size: int = 16
    tile_size: int = 1024
    no_value: float = -32768.0
    map_name: Optional[str] = None
    save_path: Optional[str] = None
    source_folder_path: Optional[str] = None
    ortho_image_name: str = "run-DRG.tif"
    dem_name: str = "run-DEM.tif"
    model_path: Optional[str] = None
    model_kind: str = "gaugan"  # gaugan | gaugan_no_kl | cnn_spade | identity
    compute_dtype: str = "bfloat16"
    # "int8": the int8 generator with dynamic activation scales;
    # "int8_static": with calibrated ones (models/quant.py).
    quantize: str = "none"  # none | int8 | int8_static
    # Process-pool size for nodata hole filling (0 = one per CPU).
    fill_workers: int = 0
    # Seed of the per-tile latent draws (the Monte-Carlo uncertainty source).
    seed: int = 0
