"""The generating part of the GauGAN family: encoder + generator + the
variant's latent rule (counterpart of moonsuperresolution_tpu/train/
trainers.py::GauGANTrainer._latent and _generate), and its int8 twin (the
JAX engine's ``quantize="int8"`` model, infer/engine.py:85-147).  The
trainer (train/trainers.py) holds a ``GauGAN`` beside the discriminator."""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from moonsuperresolution_tpu_torch.config import ModelConfig
from moonsuperresolution_tpu_torch.models.networks import (
    Encoder,
    SpadeGenerator,
    sample_latent,
)
from moonsuperresolution_tpu_torch.models.quant import QuantizedSpadeGenerator

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VARIANTS = ("gaugan", "gaugan_no_kl", "cnn_spade")


class GauGAN(nn.Module):
    """source [B, 2, H, W] (ortho, low-res DEM) -> fake DEM [B, 1, H, W].

    gaugan samples z = mean + exp(0.5*logvar) * eps; gaugan_no_kl and
    cnn_spade use the deterministic z = mean + logvar (reference:
    model.py:153-154, 727-728).  Build it in float32 and load or initialise
    the weights.  It computes in ``cfg.compute_dtype`` either way: held in
    float32 (training, mixed precision as flax's ``dtype=``), or cast with
    ``.to(dtype)`` for inference, which the modules' casts then leave as it
    is.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.variant not in VARIANTS:
            raise ValueError(f"variant {cfg.variant!r} not in {VARIANTS}")
        self.variant = cfg.variant
        dtype = DTYPES[cfg.compute_dtype]
        self.encoder = Encoder(cfg.image_size, cfg.latent_dim,
                               downsample_factor=cfg.encoder_filters,
                               alpha=cfg.alpha, dtype=dtype)
        self.generator = SpadeGenerator(
            cfg.image_size, cfg.latent_dim, alpha=cfg.alpha,
            stats=cfg.spade_stats, channel_plan=cfg.channel_plan, dtype=dtype,
            stats_dtype=DTYPES[cfg.stats_dtype],
            subpixel_head=cfg.subpixel_head)

    def latent(self, mean, logvar, eps=None, generator=None):
        if self.variant != "gaugan":
            return mean + logvar
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator,
                              dtype=mean.dtype, device=mean.device)
        return sample_latent(mean, logvar, eps)

    def forward(self, source, eps=None, generator=None):
        """``eps`` (standard normal, [B, latent_dim]) or ``generator`` feeds
        the gaugan draw; the other variants need neither."""
        mean, logvar = self.encoder(source)
        return self.generator(self.latent(mean, logvar, eps, generator),
                              source)


class QuantizedGauGAN(nn.Module):
    """The int8 GauGAN (``quantize="int8"``): a copy of the float model's
    encoder, in its compute dtype, and the variant's latent rule, with a
    ``QuantizedSpadeGenerator`` (bf16 compute, dynamic activation scales)
    quantized from the float generator's weights in place of it.  The float
    model is left as it was.  Move this one with ``.to(device)``, never
    cast it (the scales must stay float32); cast ``.encoder`` alone.  Same
    call as ``GauGAN``."""

    def __init__(self, model: GauGAN, acc_dtype: str = "bfloat16"):
        super().__init__()
        gen = model.generator
        self.variant = model.variant
        self.encoder = copy.deepcopy(model.encoder)
        self.generator = QuantizedSpadeGenerator(
            image_size=gen.sw * 2**6, alpha=gen.resblock_0.alpha,
            stats=gen.stats, channel_plan=gen.channel_plan,
            acc_dtype=acc_dtype).quantize(gen)

    # The variant's latent rule and the forward of the float model: they
    # read only ``variant``, ``encoder`` and ``generator``.
    latent = GauGAN.latent
    forward = GauGAN.forward


class StaticQuantizedGauGAN(QuantizedGauGAN):
    """``quantize="int8_static"``: the int8 GauGAN with calibrated static
    activation scales.  ``bootstrap`` calibrates on synthetic normalised
    patches; the engine then widens the scales once on real patches of the
    raster it processes through ``calibrate_on``."""

    @torch.no_grad()
    def calibrate(self, source, seed: int, margin: float = 1.05) -> dict:
        """One calibration forward: encoder -> the variant's latent, drawn
        from ``seed`` -> ``generator.calibrate``.  ``source`` is float32
        [B, 2, I, I]."""
        dev = self.generator.dense_weight.device
        source = source.to(dev, torch.float32)
        mean, logvar = self.encoder(source)
        z = self.latent(mean, logvar,
                        generator=torch.Generator(dev).manual_seed(seed))
        return self.generator.calibrate(z, source, margin=margin)

    def bootstrap(self, rounds: int = 2, batch: int = 8) -> dict:
        """Scales from uniform [-0.5, 0.5] patches (``default_rng(0)``,
        margin 1.05), the range of the engine's min-max normalised
        inputs."""
        size = self.generator.image_size
        rng = np.random.default_rng(0)
        for it in range(rounds):
            src = rng.uniform(-0.5, 0.5,
                              (batch, size, size, 2)).astype(np.float32)
            scales = self.calibrate(torch.from_numpy(src).permute(0, 3, 1, 2),
                                    seed=it)
        return scales

    def calibrate_on(self, src_batch) -> dict:
        """Engine hook: widen the static scales with real normalised patches
        (float32 [n, 2, I, I]) of the raster being processed, margin 1.1."""
        return self.calibrate(src_batch, seed=17, margin=1.1)
