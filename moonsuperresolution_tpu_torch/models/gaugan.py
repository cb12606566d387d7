"""The inference part of the GauGAN family: encoder + generator + the
variant's latent rule (counterpart of moonsuperresolution_tpu/train/
trainers.py::GauGANTrainer._latent and _generate).  Training, losses and the
discriminator belong to a later slice of the port."""

from __future__ import annotations

import torch
from torch import nn

from moonsuperresolution_tpu_torch.config import ModelConfig
from moonsuperresolution_tpu_torch.models.networks import (
    Encoder,
    SpadeGenerator,
    sample_latent,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VARIANTS = ("gaugan", "gaugan_no_kl", "cnn_spade")


class GauGAN(nn.Module):
    """source [B, 2, H, W] (ortho, low-res DEM) -> fake DEM [B, 1, H, W].

    gaugan samples z = mean + exp(0.5*logvar) * eps; gaugan_no_kl and
    cnn_spade use the deterministic z = mean + logvar (reference:
    model.py:153-154, 727-728).  Build it in float32, load or initialise the
    weights, then cast it to the compute dtype with ``.to(dtype)``:
    parameters in the compute dtype are what the JAX modules cast theirs to.
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
