"""Configuration of the port (counterpart of moonsuperresolution_tpu/
config.py): ``ModelConfig``, the training settings and the six recipe
presets, and ``DSRConfig`` for the large-raster inference path.

Left out, because nothing in the port reads them: ``fuse_spade_gb`` (the
port always issues the SPADE gamma/beta convs as one conv);
``TrainConfig``'s ``keep_checkpoints`` (read by nothing in the JAX
package either); the
``DataConfig`` fields of the crops, prefetch and workers, which nothing in
the JAX package reads either (its sampler hard-codes its crops);
and the TPU-only inference knobs ``use_pallas_patches`` (the port always
prepares patches with its fused kernel on the card) and ``scan_unroll``
(PyTorch runs the chunk loop eagerly).  ``pack_valid`` is always on: the
port packs valid patches as the reference batches them.
``upsample_factor`` (read by nothing in the JAX package either) and
``save_tiles`` are left out too: a sharded in-RAM run writes per-tile
dumps, a whole run does not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    variant: str = "gaugan"  # gaugan | gaugan_no_kl | cnn_spade | pix2pix
    image_size: int = 256
    latent_dim: int = 256
    alpha: float = 0.2
    # "batch": moments over (B, H, W), the reference's tf.nn.moments over
    # (0, 1, 2); "instance": per-sample moments.
    spade_stats: str = "batch"
    # Loss coefficients (the recipes set the reference's per-variant ones).
    feature_loss_coeff: float = 10.0
    vgg_feature_loss_coeff: float = 0.1
    kl_divergence_loss_coeff: float = 0.1
    consistency_loss_coeff: float = 2.0
    mse_loss_coeff: float = 1.0
    normal_loss_coeff: float = 1.0
    gradient_loss_coeff: float = 1.0
    l1_lambda: float = 100.0  # pix2pix
    pix2pix_depth: int = 8    # U-Net depth (8 = reference; lower for tests)
    # Box size of the consistency loss (the JAX package standardises on 16).
    upscaling_factor: int = 16
    channel_plan: tuple = (1024, 1024, 1024, 512, 256, 128)
    encoder_filters: int = 64
    disc_filters: int = 64
    # Compute dtype of convs and matmuls ("float32" or "bfloat16"); the
    # parameters may stay float32 (training) or be cast to it (inference).
    compute_dtype: str = "float32"
    stats_dtype: str = "float32"    # SPADE statistics
    # The generator's final upsample + 4x4 head conv as an equivalent
    # subpixel conv at pre-upsample resolution; same parameters either way.
    subpixel_head: bool = True


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Adam with the Keras settings of the reference (model.py:440-445)."""

    gen_lr: float = 1e-4
    disc_lr: float = 5e-5
    beta1: float = 0.0
    beta2: float = 0.999
    eps: float = 1e-7  # Keras' epsilon; torch's default is 1e-8


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The HDF5 tile store and its key pickles (reference: make_h5.py)."""

    h5_path: str = ""
    train_pkl: str = ""
    val_pkl: str = ""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    recipe: str = "spade_256"
    model: ModelConfig = ModelConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    data: DataConfig = DataConfig()
    batch_size: int = 16
    # Optimizer updates apply every ``grad_accum`` micro-steps with
    # mean-accumulated gradients (effective batch grad_accum * batch_size).
    grad_accum: int = 1
    epochs: int = 300
    seed: int = 0
    output_path: str = "."
    log_every_frac: float = 0.1     # TensorBoard every 10 % of an epoch
    checkpoint_every_epochs: int = 1
    vgg_weights_path: Optional[str] = None
    # (data, model): the mesh of a multi-process run, one process per
    # place (train/loop.py); None: no mesh, a one-process run.
    mesh_shape: Optional[tuple] = None


def _preset(recipe: str, **kw) -> TrainConfig:
    return TrainConfig(recipe=recipe, **kw)


RECIPES = {
    # train_spade_256.py:23-24: GauGAN at 256, batch 16, 300 epochs
    "spade_256": _preset(
        "spade_256",
        model=ModelConfig(variant="gaugan", image_size=256),
        batch_size=16, epochs=300,
    ),
    # train_spade_512.py:21-22: GauGAN at 512, batch 2, 300 epochs
    "spade_512": _preset(
        "spade_512",
        model=ModelConfig(variant="gaugan", image_size=512),
        batch_size=2, epochs=300,
    ),
    # train_spade_no_kl_512.py:21-22: GauGAN_no_KL at 512 (feature 5)
    "spade_no_kl_512": _preset(
        "spade_no_kl_512",
        model=ModelConfig(variant="gaugan_no_kl", image_size=512,
                          feature_loss_coeff=5.0),
        batch_size=2, epochs=300,
    ),
    # train_cnn_256.py:21-22: CNNSpade at 256, batch 32, 100 epochs
    "cnn_256": _preset(
        "cnn_256",
        model=ModelConfig(variant="cnn_spade", image_size=256,
                          vgg_feature_loss_coeff=1e-4,
                          normal_loss_coeff=0.5, gradient_loss_coeff=0.5),
        batch_size=32, epochs=100,
    ),
    # train_cnn_512.py:20-21: CNNSpade at 512, batch 2, 100 epochs
    "cnn_512": _preset(
        "cnn_512",
        model=ModelConfig(variant="cnn_spade", image_size=512,
                          vgg_feature_loss_coeff=1e-4,
                          normal_loss_coeff=0.5, gradient_loss_coeff=0.5),
        batch_size=2, epochs=100,
    ),
    # train_pix2pix.py:24-48: pix2pix at 256, batch 64, Adam(2e-4, b1=0.5).
    "pix2pix": _preset(
        "pix2pix",
        model=ModelConfig(variant="pix2pix", image_size=256),
        optimizer=OptimizerConfig(gen_lr=2e-4, disc_lr=2e-4, beta1=0.5),
        batch_size=64, epochs=300,
    ),
}


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
