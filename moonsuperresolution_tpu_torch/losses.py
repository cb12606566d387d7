"""Loss library of the DEM super-resolution models (counterpart of
moonsuperresolution_tpu/losses.py; reference: spade/losses.py and
pix2pix.py:110-141), over NCHW tensors.

Reductions follow the Keras conventions the reference relies on: a global
mean for MSE, MAE and the hinge losses, and a *sum* for the KL term
(spade/losses.py:8-9).
"""

from __future__ import annotations

import torch

from moonsuperresolution_tpu_torch.ops.gradients import image_gradients
from moonsuperresolution_tpu_torch.ops.resize import area_downscale


def generator_hinge_loss(disc_logits: torch.Tensor) -> torch.Tensor:
    """``-mean(D(fake))`` (spade/losses.py:5-6)."""
    return -disc_logits.mean()


def discriminator_hinge_loss(disc_logits: torch.Tensor,
                             is_real: bool) -> torch.Tensor:
    """Keras Hinge with +/-1 labels: ``mean(max(1 - label * y, 0))``
    (spade/losses.py:83-90)."""
    label = 1.0 if is_real else -1.0
    return torch.clamp(1.0 - label * disc_logits, min=0.0).mean()


def kl_divergence_loss(mean: torch.Tensor,
                       logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mean, exp(logvar)) || N(0, 1)) summed over batch and latent, as
    the reference's reduce_sum does (spade/losses.py:8-9)."""
    return -0.5 * torch.sum(1.0 + logvar - mean.square() - logvar.exp())


def gradient_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """L1 of forward-difference image gradients (spade/losses.py:11-14)."""
    gy_t, gx_t = image_gradients(y_true)
    gy_p, gx_p = image_gradients(y_pred)
    return ((gx_t - gx_p).abs() + (gy_t - gy_p).abs()).mean()


def normal_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Surface-normal cosine loss (spade/losses.py:16-23): normals
    ``(-gx, -gy, 1)`` concatenated on the channel axis, ``mean(1 - cos)``."""
    gy_t, gx_t = image_gradients(y_true)
    gy_p, gx_p = image_gradients(y_pred)
    one = torch.ones_like(gx_t)
    n_t = torch.cat([-gx_t, -gy_t, one], dim=1)
    n_p = torch.cat([-gx_p, -gy_p, one], dim=1)
    dot = (n_p * n_t).sum(1)
    denom = (n_t * n_t).sum(1).sqrt() * (n_p * n_p).sum(1).sqrt()
    return (1.0 - dot / denom).mean()


def consistency_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                     upscaling: int = 16) -> torch.Tensor:
    """MSE between the ``upscaling`` box means of prediction and target
    (spade/losses.py:25-33), both cropped first to a multiple of
    ``upscaling``, as 'valid' average pooling does."""
    h, w = y_true.shape[-2:]
    hh, ww = h // upscaling * upscaling, w // upscaling * upscaling
    yt = area_downscale(y_true[..., :hh, :ww], upscaling)
    yp = area_downscale(y_pred[..., :hh, :ww], upscaling)
    return (yt - yp).square().mean()


def mse_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Plain MSE (spade/losses.py:35-41)."""
    return (y_true - y_pred).square().mean()


def mae_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return (y_true - y_pred).abs().mean()


def feature_matching_loss(real_feats, fake_feats) -> torch.Tensor:
    """Sum of the MAEs of all discriminator maps but the final logits
    (spade/losses.py:44-53)."""
    loss = 0.0
    for rf, ff in zip(real_feats[:-1], fake_feats[:-1]):
        loss = loss + mae_loss(rf, ff)
    return loss


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits, in the stable form
    ``max(x, 0) - x z + log1p(exp(-|x|))`` (pix2pix.py:33)."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def pix2pix_generator_loss(disc_fake_logits: torch.Tensor,
                           gen_output: torch.Tensor, target: torch.Tensor,
                           l1_lambda: float = 100.0):
    """BCE(ones, D(fake)) + lambda * L1; returns (total, gan, l1)
    (pix2pix.py:110-115)."""
    gan = bce_with_logits(disc_fake_logits, torch.ones_like(disc_fake_logits))
    l1 = mae_loss(target, gen_output)
    return gan + l1_lambda * l1, gan, l1


def pix2pix_discriminator_loss(disc_real_logits: torch.Tensor,
                               disc_fake_logits: torch.Tensor) -> torch.Tensor:
    """BCE(ones, D(real)) + BCE(zeros, D(fake)) (pix2pix.py:137-141)."""
    real = bce_with_logits(disc_real_logits, torch.ones_like(disc_real_logits))
    fake = bce_with_logits(disc_fake_logits,
                           torch.zeros_like(disc_fake_logits))
    return real + fake
