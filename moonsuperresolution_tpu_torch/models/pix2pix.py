"""pix2pix U-Net generator and PatchGAN discriminator (counterpart of
moonsuperresolution_tpu/models/pix2pix.py; reference: pix2pix.py:64-135).

source [B, 2, 256, 256] (ortho, low-res DEM) -> DEM [B, 1, 256, 256] under a
tanh head; the discriminator maps (source, target) to a [B, 1, 30, 30]
logit map.  Tensors are NCHW and the modules compute in float32: the flax
modules take no ``dtype``, so JAX trains pix2pix in float32 whatever
``compute_dtype`` says, and so does the port.  Submodule and parameter
names follow the JAX parameter tree (``down_<i>.conv``, ``up_<i>.deconv``,
``bn.scale``, ``head``), so ``utils/convert.py`` maps one onto the other by
name.

Where PyTorch's defaults differ from the reference:
- The BatchNorm always normalises with the batch's statistics (the
  reference runs it with ``training=True`` even in validation and test):
  biased variance over (N, H, W), epsilon 1e-3, no running statistics.
  ``nn.BatchNorm2d`` (running statistics, epsilon 1e-5) is not used.
- LeakyReLU's slope is 0.3 (the Keras default); the init is normal(0.02).
- flax's ``ConvTranspose(4, strides 2, "SAME", transpose_kernel=True)``
  keeps the Keras kernel layout (kh, kw, out, in): it is
  ``F.conv_transpose2d(x, W, stride=2, padding=1)`` with
  ``W = kernel.transpose(3, 2, 0, 1)``, without a spatial flip, which is
  the permutation ``convert_params`` applies to every 4-D kernel.  The 4x4
  stride-2 SAME conv pads 1 on each side at even sizes.
- Dropout cannot draw flax's threefry masks.  The generator takes the
  masks of its three dropout layers (``masks``, 1 where kept), or draws
  Bernoulli(0.5) masks from the caller's ``torch.Generator`` on the
  tensor's device; kept elements are scaled by 1 / 0.5, as flax does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moonsuperresolution_tpu_torch.models.layers import Conv
from moonsuperresolution_tpu_torch.parallel.collectives import (
    ONE,
    all_reduce_sum,
)

BN_EPSILON = 1e-3
LEAKY_SLOPE = 0.3
DROPOUT_RATE = 0.5
DROPOUT_BLOCKS = 3          # the first three up blocks carry dropout
INIT_STD = 0.02
FULL_CHANNELS = (64, 128, 256, 512, 512, 512, 512, 512)
SOURCE_CHANNELS, TARGET_CHANNELS = 2, 1     # (ortho, low-res DEM) -> DEM


class BatchStatNorm(nn.Module):
    """BatchNorm that always uses the batch's statistics (the only mode the
    reference runs): biased moments over (N, H, W), two-pass as JAX's
    ``jnp.var``.  With ``data_axis`` set (parallel/mesh.py) they are the
    global batch's: the sum of x, then the sum of the squared deviations
    from the global mean, each all-reduced over the data group
    (differentiably)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.data_axis = ONE

    def forward(self, x):
        ax = self.data_axis
        if ax.group is None:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0,
                                       keepdim=True)
        else:
            n = x.shape[0] * x.shape[2] * x.shape[3] * ax.size
            mean = all_reduce_sum(x.sum((0, 2, 3), keepdim=True), ax) / n
            var = all_reduce_sum(
                (x - mean).square().sum((0, 2, 3), keepdim=True), ax) / n
        x_hat = (x - mean) * torch.rsqrt(var + BN_EPSILON)
        return x_hat * self.scale[None, :, None, None] \
            + self.bias[None, :, None, None]


class Down(nn.Module):
    """4x4 stride-2 SAME conv without bias, BatchNorm (optional), LeakyReLU
    0.3."""

    def __init__(self, cin: int, filters: int, apply_batchnorm: bool = True):
        super().__init__()
        self.conv = Conv(cin, filters, 4, 2, bias=False)
        self.bn = BatchStatNorm(filters) if apply_batchnorm else None

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.leaky_relu(x, LEAKY_SLOPE)


def transpose_conv(cin: int, cout: int, bias: bool) -> nn.ConvTranspose2d:
    """flax ``ConvTranspose(4, strides 2, "SAME", transpose_kernel=True)``:
    2x the input size."""
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1, bias=bias)


class Up(nn.Module):
    """4x4 stride-2 SAME transposed conv without bias, BatchNorm, dropout
    (``mask``, when given), ReLU."""

    def __init__(self, cin: int, filters: int):
        super().__init__()
        self.deconv = transpose_conv(cin, filters, bias=False)
        self.bn = BatchStatNorm(filters)

    def forward(self, x, mask=None):
        x = self.bn(self.deconv(x))
        if mask is not None:
            x = torch.where(mask, x / (1.0 - DROPOUT_RATE), 0.0)
        return F.relu(x)


class Pix2PixGenerator(nn.Module):
    """The U-Net: ``depth`` Down blocks (channels 64, 128, 256, 512 x 5, cut
    to ``depth``; depth 8 takes 256 px to 1 x 1), ``depth - 1`` Up blocks,
    each followed by the concatenation ``[x, skip]``, and the 4x4 stride-2
    transposed-conv head with bias, then tanh."""

    def __init__(self, depth: int = 8):
        super().__init__()
        self.depth = depth
        ch = FULL_CHANNELS[:depth]
        cin = SOURCE_CHANNELS
        for i, f in enumerate(ch):
            self.add_module(f"down_{i}", Down(cin, f, apply_batchnorm=i > 0))
            cin = f
        # Up block i mirrors down block depth - 2 - i and is concatenated
        # with its output.
        for i in range(depth - 1):
            f = ch[depth - 2 - i]
            self.add_module(f"up_{i}", Up(cin, f))
            cin = 2 * f
        self.head = transpose_conv(cin, TARGET_CHANNELS, bias=True)

    def dropout_shapes(self, batch: int, size: int):
        """NCHW shapes of the dropout masks for a [batch, C, size, size]
        input."""
        return [(batch, FULL_CHANNELS[self.depth - 2 - i],
                 size >> (self.depth - 1 - i), size >> (self.depth - 1 - i))
                for i in range(min(DROPOUT_BLOCKS, self.depth - 1))]

    def draw_masks(self, x, generator=None, batch=None):
        """Bernoulli(1 - rate) keep masks (bool) for the input ``x``, or for
        ``batch`` rows of its size, drawn from ``generator`` on ``x``'s
        device."""
        keep = 1.0 - DROPOUT_RATE
        batch = x.shape[0] if batch is None else batch
        return [torch.rand(s, generator=generator, device=x.device) < keep
                for s in self.dropout_shapes(batch, x.shape[-1])]

    def forward(self, x, train: bool = False, masks=None, generator=None):
        """``train``: dropout on, with ``masks`` (the three up blocks' keep
        masks) or masks drawn from ``generator``; off otherwise."""
        if not train:
            masks = None
        elif masks is None:
            masks = self.draw_masks(x, generator)
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"down_{i}")(x)
            skips.append(x)
        skips = skips[-2::-1]
        for i, skip in enumerate(skips):
            mask = masks[i] if masks is not None and i < len(masks) else None
            x = getattr(self, f"up_{i}")(x, mask)
            x = torch.cat([x, skip], dim=1)
        return torch.tanh(self.head(x))


class Pix2PixDiscriminator(nn.Module):
    """PatchGAN: ``cat[source, target]``, three Down blocks, pad 1, VALID 4x4
    conv(512) without bias, BatchNorm, LeakyReLU 0.3, pad 1, VALID 4x4
    conv(1) head with bias."""

    def __init__(self):
        super().__init__()
        self.down_0 = Down(SOURCE_CHANNELS + TARGET_CHANNELS, 64,
                           apply_batchnorm=False)
        self.down_1 = Down(64, 128)
        self.down_2 = Down(128, 256)
        self.conv = Conv(256, 512, 4, bias=False, padding="VALID")
        self.bn = BatchStatNorm(512)
        self.head = Conv(512, 1, 4, padding="VALID")

    def forward(self, source, target):
        x = torch.cat([source, target], dim=1)
        x = self.down_2(self.down_1(self.down_0(x)))
        x = self.bn(self.conv(F.pad(x, (1, 1, 1, 1))))
        x = F.leaky_relu(x, LEAKY_SLOPE)
        return self.head(F.pad(x, (1, 1, 1, 1)))


def init_pix2pix(model: nn.Module, generator=None) -> nn.Module:
    """The JAX modules' init: every conv kernel normal(0, 0.02), zero biases,
    unit BatchNorm scales.  ``generator`` lives on the parameters'
    device."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                p.normal_(0.0, INIT_STD, generator=generator)
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.zero_()
    return model
