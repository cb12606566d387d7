"""Core layers of the SPADE model family as torch modules (counterpart of
moonsuperresolution_tpu/models/layers.py).

Tensors are NCHW.  Each module computes in its ``dtype`` and casts its
weights and biases to it where it uses them, as flax's ``dtype=`` does: a
model held in float32 computes its convs and matmuls in bf16 (mixed-precision
training, float32 parameters for Adam), and a model cast as a whole with
``.to(bf16)`` (inference) computes the same, the casts being the identity.
Statistics are taken in float32 or ``stats_dtype`` and cast explicitly, as
the JAX modules do, rather than under autocast.  Submodule and parameter
names follow the JAX parameter tree, so ``utils/convert.py`` maps one onto
the other by name.

Where PyTorch's defaults differ from the reference:
- InstanceNorm's epsilon is 1e-3 (torch's InstanceNorm2d: 1e-5) and
  SPADE's 1e-5; neither keeps running statistics.
- Strided convs pad as XLA's "SAME" does: for a 3x3 stride-2 conv on an
  even size that is 0 before and 1 after, where ``padding=1`` would pad 1
  on both sides (``same_pad``).
- Initializers are glorot (Keras) rather than torch's Kaiming defaults.

Multi-process runs (parallel/mesh.py sets the axes): with ``data_axis``
set, the "batch" SPADE moments are those of the global batch, their sums
all-reduced over the data group (a differentiable all-reduce, as the JAX
moments' contraction over B becomes one under DP).  With ``model_axis``
set, a ``SpadeResidualBlock`` runs Megatron-style: conv_1 and conv_3
column-parallel (their out-channel slice of weight and bias), spade_2 on
the channel-sharded activations with its own slice of gamma and beta (its
moments are per channel, so the model group does not communicate), conv_2
row-parallel (its partial sums all-reduced, its bias added once after),
and conv_3's sharded skip gathered before ``+ h``, so that a block's output
is whole on every process.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from moonsuperresolution_tpu_torch.ops.resize import resize_nearest
from moonsuperresolution_tpu_torch.parallel.collectives import (
    ONE,
    Axis,
    all_reduce_sum,
    copy_to_model,
    gather_from_model,
    reduce_from_model,
)

SPADE_EPSILON = 1e-5


def glorot_uniform_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``glorot_uniform``: U(-l, l) with l = sqrt(6 / (fan_in +
    fan_out)); fans count the receptive field, as flax's do."""
    fan_in, fan_out = _fans(w)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


def glorot_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``glorot_normal``: a normal truncated at two standard deviations,
    rescaled so that the truncated distribution has variance 2 / (fan_in +
    fan_out)."""
    fan_in, fan_out = _fans(w)
    std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w.mul_(std)


def _fans(w: torch.Tensor) -> tuple[int, int]:
    # OIHW conv kernels or [out, in] dense kernels.
    receptive = math.prod(w.shape[2:])
    return w.shape[1] * receptive, w.shape[0] * receptive


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) padding of XLA's "SAME" for size n, kernel k, stride
    s."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias=None,
              stride: int = 1) -> torch.Tensor:
    """2-D conv with XLA's "SAME" padding (asymmetric where XLA's is)."""
    kh, kw = weight.shape[-2:]
    top, bottom = same_pad(x.shape[-2], kh, stride)
    left, right = same_pad(x.shape[-1], kw, stride)
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride, (top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias,
                    stride)


class Conv(nn.Conv2d):
    """flax ``nn.Conv(dtype=...)``: input, kernel and bias cast to ``dtype``,
    XLA "SAME" padding, or none with ``padding="VALID"``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = True, dtype=torch.float32,
                 padding: str = "SAME"):
        super().__init__(cin, cout, kernel, stride, bias=bias)
        self.dtype = dtype
        self.same = padding == "SAME"

    def forward(self, x):
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if self.same:
            return conv_same(x, w, b, self.stride[0])
        return F.conv2d(x, w, b, self.stride[0])


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to
    ``dtype``."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__(cin, cout)
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class InstanceNorm(nn.Module):
    """Per-sample, per-channel spatial normalisation with learned scale and
    offset: tfa InstanceNormalization semantics, epsilon 1e-3.  Moments are
    single-pass in float32; in bf16 the normalisation itself runs in bf16
    arithmetic, as the JAX module's does."""

    def __init__(self, channels: int, epsilon: float = 1e-3,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x32 = x.to(torch.float32)
        n = x.shape[2] * x.shape[3]
        s1 = x32.sum((2, 3), keepdim=True)
        s2 = (x32 * x32).sum((2, 3), keepdim=True)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        r = 1.0 / torch.sqrt(var + self.epsilon)
        gamma = self.scale[None, :, None, None]
        beta = self.bias[None, :, None, None]
        if self.dtype == torch.bfloat16:
            x_hat = (x - mean.to(self.dtype)) * r.to(self.dtype)
            return x_hat * gamma.to(self.dtype) + beta.to(self.dtype)
        x_hat = (x32 - mean) * r
        return (x_hat * gamma + beta).to(self.dtype)


def spade_moments(xs: torch.Tensor, stats: str = "batch",
                  data_axis: Axis = ONE):
    """Single-pass SPADE moments of ``xs`` (already in the stats dtype):
    over (B, H, W) for "batch", the reference's batch-coupled tf.nn.moments,
    or over (H, W) for "instance".  Sums accumulate in float32 and the
    moments are float32, as the JAX ones-matmul reduction's are; the
    variance is clamped at 0.  "batch" sums are summed over ``data_axis``
    too (each process holds the same number of rows), so the moments are
    the global batch's."""
    dims = (0, 2, 3) if stats == "batch" else (2, 3)
    n = math.prod(xs.shape[d] for d in dims)
    s1 = xs.sum(dims, keepdim=True, dtype=torch.float32)
    s2 = (xs * xs).sum(dims, keepdim=True, dtype=torch.float32)
    if stats == "batch" and data_axis.group is not None:
        s1, s2 = all_reduce_sum(torch.cat([s1, s2]), data_axis).chunk(2)
        n *= data_axis.size
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return mean, var


def spade_moments_centered(x: torch.Tensor, stats: str = "batch"):
    """Two-pass SPADE moments that read ``x`` in its own dtype (bf16 in the
    int8 generator): a float32-accumulated mean (bf16 values are exact in
    float32), then the mean of float32 centred squares, all positive, so
    nothing cancels.  The single-pass E[x^2] - E[x]^2 of ``spade_moments``
    needs float32 inputs: with bf16 the rounding of x^2 is amplified
    without bound when the mean is large against the spread."""
    dims = (0, 2, 3) if stats == "batch" else (2, 3)
    n = math.prod(x.shape[d] for d in dims)
    mean = x.sum(dims, keepdim=True, dtype=torch.float32) / n
    xc = x.to(torch.float32) - mean
    var = (xc * xc).mean(dims, keepdim=True)
    return mean, var


def spade_normalize(x: torch.Tensor, stats: str, stats_dtype,
                    data_axis: Axis = ONE) -> torch.Tensor:
    xs = x.to(stats_dtype)
    mean, var = spade_moments(xs, stats, data_axis)
    return (xs - mean) * (1.0 / torch.sqrt(var + SPADE_EPSILON))


class SPADE(nn.Module):
    """Spatially-adaptive denormalisation (reference: spade/models/spade.py).

    The 2-channel conditioning map is resized to the feature resolution
    (half-pixel nearest), passed through a shared 128-channel 3x3 ReLU conv
    and projected to per-pixel gamma and beta.  The gamma and beta convs run
    as one conv over their concatenated kernels; their parameters stay
    separate (``conv_gamma``, ``conv_beta``), as in the JAX tree.

    With ``model_axis`` (a tensor-parallel block's spade_2), ``x`` holds
    this process's slice of the channels and the layer makes only that
    slice of gamma and beta, from its slice of their (replicated) weights;
    the gradients of the replicated weights and of the shared conv's
    output are summed over the model group.
    """

    def __init__(self, filters: int, hidden: int = 128, stats: str = "batch",
                 dtype=torch.float32, stats_dtype=torch.float32):
        super().__init__()
        self.filters = filters
        self.stats = stats
        self.dtype = dtype
        self.stats_dtype = stats_dtype
        self.data_axis = ONE
        self.conv = Conv(2, hidden, 3, dtype=dtype)
        self.conv_gamma = Conv(hidden, filters, 3, dtype=dtype)
        self.conv_beta = Conv(hidden, filters, 3, dtype=dtype)

    def forward(self, x, mask, normalized=None, model_axis: Axis = ONE):
        mask = resize_nearest(mask, (x.shape[2], x.shape[3]))
        h = F.relu(self.conv(mask))
        params = (self.conv_gamma.weight, self.conv_beta.weight,
                  self.conv_gamma.bias, self.conv_beta.bias)
        if model_axis.group is not None:
            sl = model_axis.part(self.filters)
            h = copy_to_model(h, model_axis)
            params = [copy_to_model(t, model_axis)[sl] for t in params]
        wg, wb, bg, bb = params
        c = wg.shape[0]
        gb = F.conv2d(h, torch.cat([wg, wb]).to(self.dtype),
                      torch.cat([bg, bb]).to(self.dtype), padding=1)
        gamma, beta = gb[:, :c], gb[:, c:]
        if normalized is None:
            normalized = spade_normalize(x, self.stats, self.stats_dtype,
                                         self.data_axis)
        return gamma * normalized.to(self.dtype) + beta


class SpadeResidualBlock(nn.Module):
    """SPADE residual block (reference: spade/models/blocks.py:9-38): two
    SPADE -> LeakyReLU -> 3x3 conv passes, with a learned SPADE skip when the
    channel count changes.  spade_1 and spade_3 both normalise the block
    input and share one normalised tensor (``input_normalized``).  With
    ``model_axis`` set the block is tensor-parallel (module docstring)."""

    def __init__(self, in_filters: int, filters: int, alpha: float = 0.2,
                 stats: str = "batch", dtype=torch.float32,
                 stats_dtype=torch.float32):
        super().__init__()
        self.alpha = alpha
        self.stats = stats
        self.stats_dtype = stats_dtype
        self.dtype = dtype
        self.data_axis = ONE
        self.model_axis = ONE
        kw = dict(stats=stats, dtype=dtype, stats_dtype=stats_dtype)
        self.spade_1 = SPADE(in_filters, **kw)
        self.conv_1 = Conv(in_filters, filters, 3, dtype=dtype)
        self.spade_2 = SPADE(filters, **kw)
        self.conv_2 = Conv(filters, filters, 3, dtype=dtype)
        if filters != in_filters:
            self.spade_3 = SPADE(in_filters, **kw)
            self.conv_3 = Conv(in_filters, filters, 3, dtype=dtype)
        else:
            self.spade_3 = self.conv_3 = None

    def forward(self, x, mask, input_normalized=None):
        if input_normalized is None:
            input_normalized = spade_normalize(x, self.stats, self.stats_dtype,
                                               self.data_axis)
        if self.model_axis.group is not None:
            return self._forward_tp(x, mask, input_normalized)
        a = self.alpha
        h = self.spade_1(x, mask, normalized=input_normalized)
        h = self.conv_1(F.leaky_relu(h, a))
        h = self.spade_2(h, mask)
        h = self.conv_2(F.leaky_relu(h, a))
        if self.spade_3 is None:
            return x + h
        skip = self.spade_3(x, mask, normalized=input_normalized)
        return self.conv_3(F.leaky_relu(skip, a)) + h

    def _column(self, conv: Conv, x):
        """Column-parallel: whole input, this process's out-channel slice of
        the weight (held sharded) and of the (replicated) bias."""
        ax = self.model_axis
        b = copy_to_model(conv.bias, ax)[ax.part(conv.bias.shape[0])]
        return conv_same(copy_to_model(x, ax).to(self.dtype),
                         conv.weight.to(self.dtype), b.to(self.dtype))

    def _forward_tp(self, x, mask, input_normalized):
        a, ax = self.alpha, self.model_axis
        h = self.spade_1(x, mask, normalized=input_normalized)
        h = self._column(self.conv_1, F.leaky_relu(h, a))
        h = self.spade_2(h, mask, model_axis=ax)
        # Row-parallel conv_2: this process's in-channels, partial sums
        # reduced over the model group, the bias added once.
        h = conv_same(F.leaky_relu(h, a).to(self.dtype),
                      self.conv_2.weight.to(self.dtype))
        h = reduce_from_model(h, ax) + self.conv_2.bias.to(
            self.dtype)[None, :, None, None]
        if self.spade_3 is None:
            return x + h
        skip = self.spade_3(x, mask, normalized=input_normalized)
        skip = self._column(self.conv_3, F.leaky_relu(skip, a))
        return gather_from_model(skip, ax, 1) + h


class DownsampleBlock(nn.Module):
    """Strided conv (no bias, glorot-normal init) + optional InstanceNorm +
    LeakyReLU (reference: spade/models/blocks.py:41-68; its dropout is never
    enabled by a caller and is not ported)."""

    def __init__(self, cin: int, channels: int, kernel: int, strides: int = 2,
                 apply_norm: bool = True, apply_activation: bool = True,
                 alpha: float = 0.2, dtype=torch.float32):
        super().__init__()
        self.alpha = alpha
        self.apply_activation = apply_activation
        self.conv = Conv(cin, channels, kernel, strides, bias=False,
                         dtype=dtype)
        self.norm = InstanceNorm(channels, dtype=dtype) if apply_norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.apply_activation:
            x = F.leaky_relu(x, self.alpha)
        return x


def init_params(model: nn.Module, generator=None) -> nn.Module:
    """Initialise ``model`` as the JAX modules initialise theirs: glorot
    normal for the downsample convs, glorot uniform for every other conv and
    dense kernel, zero biases, unit InstanceNorm scales.  ``generator``
    makes it reproducible; it must live on the parameters' device."""
    normal = {id(m.conv.weight) for m in model.modules()
              if isinstance(m, DownsampleBlock)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if id(p) in normal:
                glorot_normal_(p, generator)
            elif name.endswith("weight"):
                glorot_uniform_(p, generator)
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.zero_()
    return model
