"""The three SPADE-family networks (counterpart of
moonsuperresolution_tpu/models/networks.py; reference:
spade/models/networks.py).

- ``Encoder``           : VAE encoder, 5 downsample blocks -> (mean, logvar)
- ``SpadeGenerator``    : latent -> Dense -> 6x [SPADE resblock + 2x nearest
                          upsample] -> 4x4 conv head
- ``SpadeDiscriminator``: multi-scale PatchGAN returning every intermediate
                          map, for feature matching

Both Dense layers meet an NHWC flatten or reshape in the reference: the
encoder flattens its last feature map as [B, H, W, C] and the generator
reshapes its Dense output as [B, sw, sw, C].  The port keeps the JAX Dense
weights as they are (transposed to [out, in]) and does the flatten and the
reshape in NHWC order in the forward pass: views, for a channels_last
model (the served one, infer/engine.py), whose activations stay
channels_last from the first conv to the head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moonsuperresolution_tpu_torch.models.layers import (
    Conv,
    Dense,
    DownsampleBlock,
    SpadeResidualBlock,
    conv_same,
    spade_normalize,
)
from moonsuperresolution_tpu_torch.ops import spade as spade_ops
from moonsuperresolution_tpu_torch.parallel.collectives import (
    ONE,
    copy_to_model,
    reduce_from_model,
)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Keras UpSampling2D (nearest), 2x on NCHW (by shape; the memory
    layout is kept)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


# For output phase d (0 or 1), the (fine 4x4 tap, coarse 3x3 index) pairs
# that land on the same coarse pixel (JAX collapse_head_kernel).
_HEAD_TAPS = {0: ((0, 0), (1, 1), (2, 1), (3, 2)),
              1: ((0, 1), (1, 1), (2, 2), (3, 2))}


def collapse_head_kernel(k: torch.Tensor) -> torch.Tensor:
    """Fold a 4x4 OIHW kernel over a 2x-nearest-upsampled input into four
    3x3 phase kernels over the pre-upsample input: [O, C, 4, 4] ->
    [4*O, C, 3, 3], phase-major (phase = 2*di + dj).  Taps are summed in
    the kernel's dtype and in the JAX function's order."""
    o, c = k.shape[0], k.shape[1]
    phases = []
    for di in (0, 1):
        for dj in (0, 1):
            acc = torch.zeros((o, c, 3, 3), dtype=k.dtype, device=k.device)
            for ay, by in _HEAD_TAPS[di]:
                for ax, bx in _HEAD_TAPS[dj]:
                    acc[:, :, by, bx] += k[:, :, ay, ax]
            phases.append(acc)
    return torch.cat(phases, dim=0)


def depth_to_space2x(x: torch.Tensor, out_ch: int) -> torch.Tensor:
    """[B, 4*O, H, W] phase-major channels -> [B, O, 2H, 2W]."""
    b, _, h, w = x.shape
    x = x.view(b, 2, 2, out_ch, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, out_ch, 2 * h, 2 * w)


def subpixel_head_conv(x: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """``conv4x4_SAME(upsample2x_nearest(x), kernel) + bias`` computed at
    pre-upsample resolution (see collapse_head_kernel)."""
    return subpixel_conv(x, collapse_head_kernel(kernel), bias)


def subpixel_conv(x: torch.Tensor, phases: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """``subpixel_head_conv`` from the collapsed phase kernels ``phases``
    [4*O, C, 3, 3]."""
    y = F.conv2d(x, phases, padding=1)
    return depth_to_space2x(y, phases.shape[0] // 4) + bias[None, :, None,
                                                            None]


class Encoder(nn.Module):
    """VAE encoder: downsample stack (f, 2f, 4f, 8f, 8f; the first block
    without norm) -> NHWC flatten -> Dense mean / Dense logvar.  The second
    head keeps the reference's name, "variance", and is a log-variance."""

    def __init__(self, image_size: int, latent_dim: int = 256,
                 downsample_factor: int = 64, alpha: float = 0.2,
                 dtype=torch.float32):
        super().__init__()
        f = downsample_factor
        kw = dict(alpha=alpha, dtype=dtype)
        self.down_0 = DownsampleBlock(2, f, 3, apply_norm=False, **kw)
        self.down_1 = DownsampleBlock(f, 2 * f, 3, **kw)
        self.down_2 = DownsampleBlock(2 * f, 4 * f, 3, **kw)
        self.down_3 = DownsampleBlock(4 * f, 8 * f, 3, **kw)
        self.down_4 = DownsampleBlock(8 * f, 8 * f, 3, **kw)
        side = image_size
        for _ in range(5):
            side = -(-side // 2)
        self.mean = Dense(side * side * 8 * f, latent_dim, dtype=dtype)
        self.variance = Dense(side * side * 8 * f, latent_dim, dtype=dtype)

    def forward(self, x):
        for block in (self.down_0, self.down_1, self.down_2, self.down_3,
                      self.down_4):
            x = block(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        # Latent heads in float32: they feed exp() and the KL term.
        return self.mean(x).float(), self.variance(x).float()


class SpadeGenerator(nn.Module):
    """SPADE generator: latent [B, latent_dim] -> Dense(sw*sw*plan[0]) ->
    [B, plan[0], sw, sw] with sw = image_size / 64, then one SPADE residual
    block per entry of the channel plan, each followed by a 2x nearest
    upsample; LeakyReLU(0.2) + 4x4 conv to one channel.

    The SPADE moments and normalised input of each block after the first
    are computed before the upsample (a 2x nearest upsample repeats every
    element 4 times, so they are the same), cast to the compute dtype and
    upsampled.  Where the next block takes the fused path
    (``SpadeResidualBlock.fused``) only the moments are taken: the block
    reads the pre-upsample output through its kernels, and the output is
    upsampled at all: its residual reads it upsampled too.  With
    ``subpixel_head`` the last upsample and the head run as a subpixel conv
    at pre-upsample resolution; with autograd off and the head's weight
    held in the compute dtype (a served model), its collapsed kernel is
    made once per set of weights (``head_phases``).

    Multi-process (parallel/mesh.py): ``data_axis`` makes the moments of
    the between-block normalisation the global batch's; ``model_axis``
    makes the latent ``dense`` row-parallel (this process's slice of the
    latent dim, partial products all-reduced over the model group, the
    bias added once).
    """

    def __init__(self, image_size: int, latent_dim: int, alpha: float = 0.2,
                 stats: str = "batch",
                 channel_plan: tuple = (1024, 1024, 1024, 512, 256, 128),
                 dtype=torch.float32, stats_dtype=torch.float32,
                 subpixel_head: bool = True):
        super().__init__()
        self.sw = image_size // 2**6
        if self.sw < 1:
            raise ValueError(f"image_size {image_size} too small (needs >= 64)")
        self.channel_plan = tuple(channel_plan)
        self.stats = stats
        self.dtype = dtype
        self.stats_dtype = stats_dtype
        self.subpixel_head = subpixel_head
        self.data_axis = ONE
        self.model_axis = ONE
        c0 = self.channel_plan[0]
        self.dense = Dense(latent_dim, self.sw * self.sw * c0, dtype=dtype)
        cin = c0
        for i, ch in enumerate(self.channel_plan):
            self.add_module(f"resblock_{i}", SpadeResidualBlock(
                cin, ch, alpha=alpha, stats=stats, dtype=dtype,
                stats_dtype=stats_dtype))
            cin = ch
        self.head = nn.Conv2d(cin, 1, 4)
        self._head_phases = None      # (key, collapsed kernel)

    def forward(self, latent, source):
        c0 = self.channel_plan[0]
        x = self._dense(latent)
        x = x.view(-1, self.sw, self.sw, c0).permute(0, 3, 1, 2)
        blocks = [getattr(self, f"resblock_{i}")
                  for i in range(len(self.channel_plan))]
        x_hat_up = normed = None
        for block, following in zip(blocks, blocks[1:] + [None]):
            x = block(x, source, input_normalized=x_hat_up, normed=normed)
            if following is None:
                break
            x_hat_up = normed = None
            if following.fused():
                # The next block reads x upsampled inside its kernels, its
                # residual included.
                normed = spade_ops.normed(
                    spade_ops.alike(x, following.conv_1.weight), self.stats,
                    self.data_axis, up=True)
                x = None
                continue
            x_hat = spade_normalize(x, self.stats, self.stats_dtype,
                                    self.data_axis)
            x_hat_up = upsample2x_nearest(x_hat.to(self.dtype))
            x = upsample2x_nearest(x)
        if not self.subpixel_head:
            x = upsample2x_nearest(x)
        x = F.leaky_relu(x, 0.2)
        w, b = self.head.weight.to(self.dtype), self.head.bias.to(self.dtype)
        if self.subpixel_head:
            x = subpixel_conv(x, self.head_phases(), b)
        else:
            x = conv_same(x, w, b)
        # DEM output in float32 for the denormalisation math.
        return x.float()

    def head_phases(self) -> torch.Tensor:
        """``collapse_head_kernel`` of the head's weight in the compute
        dtype, in the weight's memory layout.  With autograd off and the
        weight held in the compute dtype it is kept, keyed on the weight's
        storage and version (an in-place update bumps the version), so a
        served model builds it once per set of weights; otherwise (training,
        a float32-held model's cast) it is built at every call."""
        w = self.head.weight
        if torch.is_grad_enabled() or w.dtype != self.dtype:
            return self._collapse(w.to(self.dtype))
        key = (w.data_ptr(), w._version, w.device, w.dtype)
        if self._head_phases is None or self._head_phases[0] != key:
            self._head_phases = key, self._collapse(w)
        return self._head_phases[1]

    @staticmethod
    def _collapse(w: torch.Tensor) -> torch.Tensor:
        cl = not w.is_contiguous() and w.is_contiguous(
            memory_format=torch.channels_last)
        return collapse_head_kernel(w).contiguous(
            memory_format=torch.channels_last if cl
            else torch.contiguous_format)

    def _dense(self, latent):
        ax = self.model_axis
        if ax.group is None:
            return self.dense(latent)
        d, dt = self.dense, self.dtype
        z = copy_to_model(latent, ax)[:, ax.part(latent.shape[1])]
        y = F.linear(z.to(dt), d.weight.to(dt))
        return reduce_from_model(y, ax) + d.bias.to(dt)


class SpadeDiscriminator(nn.Module):
    """Multi-scale PatchGAN discriminator (networks.py:60-76): source (2
    channels) and target (1) concatenated on the channel axis, four
    downsample blocks (f, 2f, 4f at stride 2, the first without norm; 8f at
    stride 1, whose 4x4 SAME padding is 1 before and 2 after), then a 4x4
    VALID conv to one logit map.  Returns the five maps in float32; the last
    is the adversarial logit map, the others feed feature matching."""

    def __init__(self, downsample_factor: int = 64, alpha: float = 0.2,
                 dtype=torch.float32):
        super().__init__()
        f = downsample_factor
        kw = dict(alpha=alpha, dtype=dtype)
        self.down_0 = DownsampleBlock(3, f, 4, apply_norm=False, **kw)
        self.down_1 = DownsampleBlock(f, 2 * f, 4, **kw)
        self.down_2 = DownsampleBlock(2 * f, 4 * f, 4, **kw)
        self.down_3 = DownsampleBlock(4 * f, 8 * f, 4, strides=1, **kw)
        self.head = Conv(8 * f, 1, 4, dtype=dtype, padding="VALID")

    def forward(self, source, target):
        x = torch.cat([source, target], dim=1)
        feats = []
        for block in (self.down_0, self.down_1, self.down_2, self.down_3,
                      self.head):
            x = block(x)
            feats.append(x)
        return [f.float() for f in feats]


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor,
                  eps: torch.Tensor) -> torch.Tensor:
    """Gaussian reparameterisation z = mean + exp(0.5*logvar) * eps
    (reference: spade/models/sampling.py:5-17).  The caller draws ``eps``
    (standard normal, shape of ``mean``) from its own generator."""
    return mean + torch.exp(0.5 * logvar) * eps
