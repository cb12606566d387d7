"""The GauGAN-family trainer (counterpart of moonsuperresolution_tpu/train/
trainers.py::GauGANTrainer and ``make_trainer``; reference: spade/models/
model.py, GauGAN:440-567, GauGAN_no_KL:141-267, CNNSpade:714-791).

One ``train_step`` is the reference's two-phase eager step:

- the discriminator phase first (model.py:451-469): a fake made without
  autograd from its own latent draw, the hinge loss
  ``0.5 * (D(fake) false + D(real) true)``, then the discriminator's Adam;
- then the generator phase (model.py:471-504): a fresh draw, the
  discriminator frozen at its just-updated values (no gradient reaches its
  parameters), the variant's loss stack, the generator+encoder Adam.

gaugan samples z = mean + exp(0.5 logvar) eps; gaugan_no_kl and cnn_spade
use the deterministic mean + logvar (model.py:153-154, 727-728).  The draws
come from ``eps_d``/``eps_g`` when given (the parity tests feed JAX's), else
from the caller's ``torch.Generator``: they never match JAX's threefry keys.

Both optimizers are ``torch.optim.Adam`` with the Keras settings of
``OptimizerConfig`` (eps 1e-7, not torch's 1e-8; beta1 0).  The parameters
stay float32; ``compute_dtype="bfloat16"`` makes the modules compute in bf16
(mixed precision as flax's ``dtype=``).  ``grad_accum = k > 1`` is
``optax.MultiSteps``: the gradients of k micro-steps are mean-accumulated
(Welford's running mean, as optax does), Adam applies on every k-th, and
the parameters do not move in between; ``step`` counts micro-steps.
"""

from __future__ import annotations

import copy
import warnings

import torch
from torch import nn

from moonsuperresolution_tpu_torch import losses as L
from moonsuperresolution_tpu_torch.config import TrainConfig
from moonsuperresolution_tpu_torch.device import resolve_device
from moonsuperresolution_tpu_torch.models import vgg as vggmod
from moonsuperresolution_tpu_torch.models.gaugan import DTYPES, GauGAN
from moonsuperresolution_tpu_torch.models.layers import init_params
from moonsuperresolution_tpu_torch.models.networks import SpadeDiscriminator


class GauGANTrainer:
    """Trainer of the gaugan, gaugan_no_kl and cnn_spade variants.

    ``nets`` holds ``encoder``, ``generator`` and (but for cnn_spade)
    ``discriminator``, under the JAX parameter tree's names, so that
    ``utils.convert.load_params(trainer.nets, jax_state.params)`` carries a
    JAX trainer's weights across with ``strict=True``.  ``vgg`` is the
    perceptual loss's network (``models/vgg.py``); without one the trainer
    loads ``cfg.vgg_weights_path`` or falls back, with a warning, to random
    features seeded from ``cfg.seed``.  Tensors are NCHW on ``device``.
    """

    def __init__(self, cfg: TrainConfig, vgg: nn.Module | None = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        m = cfg.model
        self.variant = m.variant
        self.has_disc = self.variant != "cnn_spade"
        with torch.device(self.device):
            self.model = GauGAN(m)      # raises for any other variant
            nets = {"encoder": self.model.encoder,
                    "generator": self.model.generator}
            if self.has_disc:
                nets["discriminator"] = SpadeDiscriminator(
                    m.disc_filters, m.alpha, DTYPES[m.compute_dtype])
        self.nets = nn.ModuleDict(nets)
        self.discriminator = nets.get("discriminator")
        o = cfg.optimizer
        adam = dict(betas=(o.beta1, o.beta2), eps=o.eps)
        self.gen_opt = torch.optim.Adam(self.gen_params(), lr=o.gen_lr, **adam)
        self.disc_opt = (torch.optim.Adam(self.discriminator.parameters(),
                                          lr=o.disc_lr, **adam)
                         if self.has_disc else None)
        self.step = 0
        # grad_accum > 1: per parameter, the running mean of this cycle's
        # gradients (optax.MultiSteps' acc_grads).
        self.accum: dict[str, torch.Tensor] = {}
        self._vgg = None if vgg is None else vggmod.frozen(
            copy.deepcopy(vgg).to(self.device))

    def gen_params(self):
        return [p for k in ("generator", "encoder")
                for p in self.nets[k].parameters()]

    def init(self, generator: torch.Generator | None = None):
        """Glorot initialisation as the JAX modules' (``init_params``);
        ``generator`` lives on the trainer's device."""
        init_params(self.nets, generator)
        return self

    @property
    def vgg(self) -> nn.Module:
        """Built on first use, as the JAX trainer's ``vgg_params``
        (its trainers.py:116-138): inference-only callers never pay for it,
        and the random fallback warns where it is taken."""
        if self._vgg is None:
            if self.cfg.vgg_weights_path:
                model = vggmod.load_vgg19(self.cfg.vgg_weights_path)
            else:
                warnings.warn(
                    "No VGG19 weights given (TrainConfig.vgg_weights_path / "
                    "--vgg_weights): the perceptual loss will use FIXED-SEED "
                    "RANDOM conv features, a different objective than the "
                    "reference's imagenet-VGG19 (spade/losses.py:56-80). "
                    "Convert real weights with `python -m "
                    "moonsuperresolution_tpu.cli.convert_vgg` and pass the "
                    ".npz (or a Keras .h5).", stacklevel=2)
                model = vggmod.init_vgg(
                    torch.Generator().manual_seed(self.cfg.seed))
            self._vgg = model.to(self.device)
        return self._vgg

    # ------------------------------------------------------------ helpers

    def _generate(self, source, eps=None, generator=None):
        mean, logvar = self.model.encoder(source)
        z = self.model.latent(mean, logvar, eps, generator)
        return self.model.generator(z, source), mean, logvar

    def _disc_loss(self, source, target, fake):
        pred_fake = self.discriminator(source, fake)[-1]
        pred_real = self.discriminator(source, target)[-1]
        return 0.5 * (L.discriminator_hinge_loss(pred_fake, False)
                      + L.discriminator_hinge_loss(pred_real, True))

    def _gen_losses(self, fake, mean, logvar, source, target) -> dict:
        """The generator's loss stack for the variant, in the JAX order
        (trainers.py:188-219)."""
        m = self.cfg.model
        out = {}
        if self.has_disc:
            with torch.no_grad():
                real_feats = self.discriminator(source, target)
            fake_feats = self.discriminator(source, fake)
            out["g_hinge"] = L.generator_hinge_loss(fake_feats[-1])
            out["feat_loss"] = m.feature_loss_coeff * L.feature_matching_loss(
                real_feats, fake_feats)
        out["vgg_loss"] = (m.vgg_feature_loss_coeff
                           * vggmod.vgg_feature_matching_loss(
                               self.vgg, vggmod.repeat3(target),
                               vggmod.repeat3(fake)))
        out["cons_loss"] = m.consistency_loss_coeff * L.consistency_loss(
            fake, target, m.upscaling_factor)
        if self.variant == "gaugan":
            out["kl_loss"] = m.kl_divergence_loss_coeff * L.kl_divergence_loss(
                mean, logvar)
        else:
            out["norm_loss"] = m.normal_loss_coeff * L.normal_loss(target, fake)
            out["grad_loss"] = m.gradient_loss_coeff * L.gradient_loss(
                target, fake)
        if self.variant == "cnn_spade":
            out["mse_loss"] = m.mse_loss_coeff * L.mse_loss(fake, target)
        return out

    def _total_key(self):
        return "total_loss" if self.variant == "cnn_spade" else "gen_loss"

    def _apply(self, opt, params, prefix):
        """Adam on ``params``' gradients, or on their running mean every
        ``grad_accum``-th micro-step (optax.MultiSteps)."""
        k = self.cfg.grad_accum
        if k > 1:
            n = self.step % k
            for i, p in enumerate(params):
                key = f"{prefix}{i}"
                acc = self.accum.get(key)
                acc = p.grad if acc is None else acc + (p.grad - acc) / (n + 1)
                self.accum[key] = acc
                if n == k - 1:
                    p.grad = self.accum.pop(key)
            if n != k - 1:
                return
        opt.step()

    # --------------------------------------------------------- train step

    def train_step(self, source, target, eps_d=None, eps_g=None,
                   generator=None):
        """One micro-step on NCHW float32 ``source`` [B, 2, I, I] and
        ``target`` [B, 1, I, I].  Returns (metrics, fake): the JAX metric
        keys, each a 0-d tensor, and the generator phase's fake."""
        metrics = {}
        if self.has_disc:
            with torch.no_grad():
                fake, _, _ = self._generate(source, eps_d, generator)
            d_loss = self._disc_loss(source, target, fake)
            self.disc_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            self._apply(self.disc_opt, list(self.discriminator.parameters()),
                        "d")
            metrics["disc_loss"] = d_loss.detach()
            self.discriminator.requires_grad_(False)
        try:
            fake, mean, logvar = self._generate(source, eps_g, generator)
            parts = self._gen_losses(fake, mean, logvar, source, target)
            total = sum(parts.values())
            self.gen_opt.zero_grad(set_to_none=True)
            total.backward()
        finally:
            if self.has_disc:
                self.discriminator.requires_grad_(True)
        self._apply(self.gen_opt, self.gen_params(), "g")
        self.step += 1
        metrics[self._total_key()] = total.detach()
        metrics.update({k: v.detach() for k, v in parts.items()})
        return metrics, fake.detach()

    @torch.no_grad()
    def val_step(self, source, target, eps=None, generator=None):
        """The losses without updates (model.py:524-562, 763-787)."""
        fake, mean, logvar = self._generate(source, eps, generator)
        metrics = {}
        if self.has_disc:
            metrics["disc_loss"] = self._disc_loss(source, target, fake)
        parts = self._gen_losses(fake, mean, logvar, source, target)
        metrics[self._total_key()] = sum(parts.values())
        metrics.update(parts)
        return metrics, fake

    @torch.no_grad()
    def forward(self, source, eps=None, generator=None):
        """The inference forward (model.py:564-567, 789-791)."""
        return self._generate(source, eps, generator)[0]


def make_trainer(cfg: TrainConfig, vgg: nn.Module | None = None,
                 device=None) -> GauGANTrainer:
    if cfg.model.variant == "pix2pix":
        raise NotImplementedError(
            "the pix2pix trainer (models/pix2pix.py, Pix2PixTrainer) is a "
            "later slice of the port")
    return GauGANTrainer(cfg, vgg=vgg, device=device)
