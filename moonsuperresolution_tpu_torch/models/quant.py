"""Int8 inference path for the SPADE generator (counterpart of
moonsuperresolution_tpu/models/quant.py; same names, same scheme).

- Weights: symmetric per-output-channel int8, quantized once from the
  port's float ``SpadeGenerator`` (``QuantizedSpadeGenerator.quantize``).
- Activations: symmetric per-tensor int8, either dynamic (``max |x| / 127``
  on the device, per conv input) or static (``act_scales``, calibrated by
  ``calibrate``).
- The conv accumulates exactly in int32 (or rounds that sum once to bf16,
  ``acc_dtype="bfloat16"``) and is dequantized as ``acc * (s_x * s_w[c]) +
  bias`` in the epilogue of the hand-written kernel ``ops/qconv.py``; the
  SPADE gamma/beta maps can come out of it requantized to s8.
- What is small or precision-critical stays in the compute dtype: the latent
  Dense, the 2 -> 128 mask convs, the SPADE statistics, the 4x4 head (and,
  in models/gaugan.py, the encoder).

Layout: the generator keeps its activations ``channels_last`` (NCHW shape,
NHWC storage) from the Dense reshape to the head.  The kernel reads and
writes NHWC, so every quantize pass writes the kernel's input layout
itself and no conv result is transposed; the elementwise passes between
the convs all see one layout.

Every scale that divides is a device tensor: CUDA turns a division by a
Python number into a multiplication by its reciprocal, which would not
match the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from moonsuperresolution_tpu_torch.models.layers import (
    SPADE_EPSILON,
    conv_same,
    spade_moments_centered,
)
from moonsuperresolution_tpu_torch.models.networks import (
    subpixel_head_conv,
    upsample2x_nearest,
)
from moonsuperresolution_tpu_torch.ops.qconv import qconv
from moonsuperresolution_tpu_torch.ops.resize import resize_nearest


def _div127(t: torch.Tensor) -> torch.Tensor:
    return t / torch.full((), 127.0, device=t.device)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW view -> contiguous NHWC; free for a channels_last tensor."""
    return t.permute(0, 2, 3, 1).contiguous()


def _copy(t: torch.Tensor, dtype) -> torch.Tensor:
    """A buffer's own copy of a float parameter, in ``dtype``."""
    return t.detach().to(dtype, copy=True)


def _quant_kernel_per_channel(kernel: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of an OIHW kernel.
    Returns (int8 kernel [O, H, W, I], the qconv kernel's layout; float32
    scale [O]).  The amax over (I, H, W) is JAX's over (H, W, I) of HWIO."""
    k = kernel.detach().to(torch.float32).permute(0, 2, 3, 1)
    amax = k.abs().amax(dim=(1, 2, 3))
    scale = _div127(torch.clamp(amax, min=1e-12))
    kq = torch.clamp(torch.round(k / scale[:, None, None, None]), -127, 127)
    return kq.to(torch.int8).contiguous(), scale


def _quant_act_per_tensor(x: torch.Tensor):
    """Dynamic symmetric per-tensor int8 activation quantization; the scale
    is a 0-d device tensor (no host sync)."""
    xf = x.to(torch.float32)
    s = _div127(torch.clamp(xf.abs().amax(), min=1e-12))
    xq = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return xq, s


def _qconv(x, qk, w_scale, bias, out_dtype=torch.bfloat16, s_x=None,
           record=None, site: str = "", acc_dtype=torch.int32,
           x_quantized: bool = False, out_scale=None) -> torch.Tensor:
    """int8 conv: quantize x (dynamic, or with the calibrated static scale
    ``s_x``), s8 x s8 conv, dequantize (ops/qconv.py).

    ``x_quantized=True``: x is already s8 at scale ``s_x`` (the producer
    quantized it in its epilogue, ``_conv_bf16``'s ``out_scale``).
    ``record`` collects the dynamic scale of ``site`` for calibration.
    ``out_scale`` is the PRECOMPUTED INVERSE per-channel scale: the result
    is requantized to s8, ``round(clip(y * out_scale))``."""
    if x_quantized:
        xq = x
    elif s_x is None:
        xq, s_x = _quant_act_per_tensor(x)
        if record is not None:
            prev = record.get(site)
            record[site] = s_x if prev is None else torch.maximum(prev, s_x)
    else:
        xq = torch.clamp(torch.round(x.to(torch.float32) / s_x),
                         -127, 127).to(torch.int8)
    return qconv(_nhwc(xq), qk, s_x, w_scale, bias, acc_dtype, out_dtype,
                 out_scale)


def _conv_bf16(x, kernel, bias, out_scale=None):
    """The SPADE mask conv: conv in x's dtype (+bias), relu and, with
    ``out_scale`` (a 0-d device tensor), the static requantize of
    ``_qconv``'s s_x branch: f32 / scale -> round -> clip -> s8.  The conv
    stays cuDNN; the epilogue is torch ops.  Unlike ``_qconv`` this DIVIDES
    by its scale, as the JAX function does."""
    y = F.relu(conv_same(x, kernel.to(x.dtype))
               + bias.to(x.dtype)[:, None, None])
    if out_scale is not None:
        return torch.clamp(torch.round(y.to(torch.float32) / out_scale),
                           -127, 127).to(torch.int8)
    return y


class QConv(nn.Module):
    """One quantized 3x3 conv: s8 ``kernel`` [O, 3, 3, I], float32 ``scale``
    and ``bias`` [O] (buffers: ``.to(device)`` moves them, a dtype cast
    leaves the int8 kernel alone but would cast the scales, so the model is
    moved, never cast)."""

    def __init__(self, kernel, scale, bias):
        super().__init__()
        self.register_buffer("kernel", kernel)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)


def _quantize_conv(conv) -> QConv:
    kq, s = _quant_kernel_per_channel(conv.weight)
    return QConv(kq, s, _copy(conv.bias, torch.float32))


class QSpade(nn.Module):
    """One SPADE: the mask conv in the compute dtype, the gamma and beta
    convs fused into one int8 ``gb`` conv."""

    def __init__(self, conv_kernel, conv_bias, gb: QConv):
        super().__init__()
        self.register_buffer("conv_kernel", conv_kernel)
        self.register_buffer("conv_bias", conv_bias)
        self.gb = gb


def _quantize_spade(sp, dtype) -> QSpade:
    """The mask conv stays in the compute dtype (2 input channels;
    negligible FLOPs, precision-sensitive)."""
    kq_g, s_g = _quant_kernel_per_channel(sp.conv_gamma.weight)
    kq_b, s_b = _quant_kernel_per_channel(sp.conv_beta.weight)
    gb = QConv(torch.cat([kq_g, kq_b]), torch.cat([s_g, s_b]),
               _copy(torch.cat([sp.conv_gamma.bias, sp.conv_beta.bias]),
                     torch.float32))
    return QSpade(_copy(sp.conv.weight, dtype), _copy(sp.conv.bias, dtype),
                  gb)


class QuantizedSpadeGenerator(nn.Module):
    """Int8 twin of ``models/networks.py::SpadeGenerator``: construct with
    the JAX dataclass's fields, then :meth:`quantize` a float generator.

    ``acc_dtype``: "int32" (exact) or "bfloat16" (the conv sum rounded once
    to bf16).  ``act_scales`` (None: dynamic) holds the calibrated scales,
    device tensors keyed by site.

    The JAX class's defaults are this class's only behaviour: two-pass
    SPADE moments of the activations as they are, the last upsample and
    the 4x4 head as one subpixel conv, and (static scales) the SPADE
    gamma/beta conv results requantized to per-channel s8 in the conv
    epilogue.
    """

    def __init__(self, image_size: int, alpha: float = 0.2,
                 stats: str = "batch",
                 channel_plan: tuple = (1024, 1024, 1024, 512, 256, 128),
                 dtype=torch.bfloat16, acc_dtype: str = "int32"):
        super().__init__()
        if acc_dtype not in ("int32", "bfloat16"):
            raise ValueError(f"acc_dtype {acc_dtype!r}: 'int32' or 'bfloat16'")
        self.image_size = image_size
        self.alpha = alpha
        self.stats = stats
        self.channel_plan = tuple(channel_plan)
        self.dtype = dtype
        self.acc_dtype = acc_dtype
        self.act_scales = None
        self._host_scales = {}

    # ------------------------------------------------------------ quantize

    @torch.no_grad()
    def quantize(self, generator) -> "QuantizedSpadeGenerator":
        """Fill the buffers from a float ``SpadeGenerator`` (its weights in
        any float dtype; quantized from their float32 values).  Returns
        self, with dynamic scales."""
        dt = self.dtype
        for name, t in (("dense_weight", generator.dense.weight),
                        ("dense_bias", generator.dense.bias),
                        ("head_kernel", generator.head.weight),
                        ("head_bias", generator.head.bias)):
            self.register_buffer(name, _copy(t, dt))
        for i in range(len(self.channel_plan)):
            blk = getattr(generator, f"resblock_{i}")
            qb = nn.Module()
            qb.spade_1 = _quantize_spade(blk.spade_1, dt)
            qb.spade_2 = _quantize_spade(blk.spade_2, dt)
            qb.conv_1 = _quantize_conv(blk.conv_1)
            qb.conv_2 = _quantize_conv(blk.conv_2)
            if blk.spade_3 is not None:
                qb.spade_3 = _quantize_spade(blk.spade_3, dt)
                qb.conv_3 = _quantize_conv(blk.conv_3)
            self.add_module(f"resblock_{i}", qb)
        self.act_scales = None
        self._host_scales = {}
        return self

    # ------------------------------------------------------------- forward

    @property
    def _acc(self):
        return torch.bfloat16 if self.acc_dtype == "bfloat16" else torch.int32

    def _normalize(self, x):
        """The normalised tensor: two-pass centred moments of x as it is
        (spade_moments_centered), normalised in the compute dtype with the
        per-channel mean and 1/sqrt rounded once to it."""
        mean, var = spade_moments_centered(x, self.stats)
        r = 1.0 / torch.sqrt(var + SPADE_EPSILON)
        return (x - mean.to(self.dtype)) * r.to(self.dtype)

    def _spade(self, qs, x, mask, normalized=None, scales=None, record=None,
               site: str = ""):
        mask = resize_nearest(mask, (x.shape[2], x.shape[3])).to(
            self.dtype).contiguous(memory_format=torch.channels_last)
        s_in = None if scales is None else scales[site]
        if s_in is not None:
            # Static: the gb conv's input quantize runs in the mask conv's
            # epilogue, so its bf16 input never materialises.
            h8 = _conv_bf16(mask, qs.conv_kernel, qs.conv_bias,
                            out_scale=s_in)
            s_gb = scales[f"{site}.gb"]
            gb = _qconv(h8, qs.gb.kernel, qs.gb.scale, qs.gb.bias,
                        out_dtype=self.dtype, s_x=s_in, x_quantized=True,
                        acc_dtype=self._acc,
                        out_scale=scales[f"{site}.gb_inv"])
        else:
            h = _conv_bf16(mask, qs.conv_kernel, qs.conv_bias)
            gb = _qconv(h, qs.gb.kernel, qs.gb.scale, qs.gb.bias,
                        out_dtype=self.dtype, s_x=None, record=record,
                        site=site, acc_dtype=self._acc)
            if record is not None:
                cur = _div127(gb.to(torch.float32).abs().amax(dim=(0, 2, 3)))
                prev = record.get(f"{site}.gb")
                record[f"{site}.gb"] = (cur if prev is None
                                        else torch.maximum(prev, cur))
        f = gb.shape[1] // 2
        gamma, beta = gb[:, :f], gb[:, f:]
        if normalized is None:
            normalized = self._normalize(x)
        if s_in is not None:
            # Dequantize inline: gamma = gq * s[c], beta = bq * s[c'].
            sg = s_gb[:f].to(self.dtype)[:, None, None]
            sb = s_gb[f:].to(self.dtype)[:, None, None]
            return (gamma.to(self.dtype) * sg * normalized.to(self.dtype)
                    + beta.to(self.dtype) * sb)
        return gamma * normalized.to(self.dtype) + beta

    def _resblock(self, qb, x, mask, input_normalized=None, scales=None,
                  record=None, prefix: str = ""):
        def lrelu(v):
            return F.leaky_relu(v, self.alpha)

        def s(site):
            return None if scales is None else scales[site]

        def conv(h, name):
            qc = getattr(qb, name)
            return _qconv(lrelu(h), qc.kernel, qc.scale, qc.bias,
                          out_dtype=self.dtype, s_x=s(f"{prefix}.{name}"),
                          record=record, site=f"{prefix}.{name}",
                          acc_dtype=self._acc)

        h = self._spade(qb.spade_1, x, mask, normalized=input_normalized,
                        scales=scales, record=record,
                        site=f"{prefix}.spade_1")
        h = conv(h, "conv_1")
        h = self._spade(qb.spade_2, h, mask, scales=scales, record=record,
                        site=f"{prefix}.spade_2")
        h = conv(h, "conv_2")
        if hasattr(qb, "conv_3"):
            skip = self._spade(qb.spade_3, x, mask,
                               normalized=input_normalized, scales=scales,
                               record=record, site=f"{prefix}.spade_3")
            skip = conv(skip, "conv_3")
        else:
            skip = x
        return skip + h

    def _forward(self, latent, source, scales, record):
        sw = self.image_size // 2**6
        c0 = self.channel_plan[0]
        x = F.linear(latent.to(self.dtype), self.dense_weight) \
            + self.dense_bias
        # [B, sw, sw, C] as NCHW: channels_last from here on.
        x = x.view(-1, sw, sw, c0).permute(0, 3, 1, 2)
        source = source.to(self.dtype)
        x_hat_up = None
        n_blocks = len(self.channel_plan)
        for i in range(n_blocks):
            x = self._resblock(getattr(self, f"resblock_{i}"), x, source,
                               input_normalized=x_hat_up, scales=scales,
                               record=record, prefix=f"r{i}")
            if i + 1 == n_blocks:
                break  # the last upsample is the subpixel head's
            # Pre-upsample moments and normalisation, as SpadeGenerator.
            x_hat_up = upsample2x_nearest(self._normalize(x))
            x = upsample2x_nearest(x)
        x = F.leaky_relu(x, 0.2)
        x = subpixel_head_conv(x, self.head_kernel, self.head_bias)
        return x.to(torch.float32)

    def forward(self, latent, source):
        """latent [B, latent_dim], source [B, 2, I, I] -> [B, 1, I, I]
        float32, with the calibrated scales if any, else dynamic ones."""
        return self._forward(latent, source, self.act_scales, None)

    # ---------------------------------------------------------- calibrate

    def calibrate(self, latent, source, margin: float = 1.05) -> dict:
        """One dynamic-scale forward recording each conv input's scale (and
        each gb conv result's per-channel max / 127), merged elementwise
        with the scales already held (un-margined) and widened by
        ``margin``; ``.gb`` sites get their inverse, taken on the host in
        float32.  Sets and returns ``act_scales``.

        The recorded maxima come down in one transfer and the new scales go
        up in one."""
        rec = _calibration_scales(self, latent, source)
        keys = list(rec)
        flat = torch.cat([rec[k].reshape(-1) for k in keys]).cpu().numpy()
        got, at = {}, 0
        for k in keys:
            n = rec[k].numel()
            got[k] = np.asarray(flat[at : at + n].reshape(rec[k].shape),
                                np.float32)
            at += n
        prev = {k: np.asarray(v, np.float32) / margin  # un-margin previous
                for k, v in self._host_scales.items()
                if not k.endswith("_inv")}  # derived below, not merged
        merged = {k: np.maximum(got.get(k, 0.0), prev.get(k, 0.0))
                  for k in set(got) | set(prev)}
        out = {}
        for k, v in merged.items():
            sv = v * margin
            out[k] = np.asarray(sv, np.float32)
            if k.endswith(".gb"):
                # Precomputed inverse for the requant epilogue.
                out[k + "_inv"] = np.asarray(1.0 / sv, np.float32)
        self._host_scales = out
        names = sorted(out)
        dev = self.dense_weight.device
        up = torch.from_numpy(np.concatenate(
            [out[k].reshape(-1) for k in names])).to(dev)
        self.act_scales, at = {}, 0
        for k in names:
            n = out[k].size
            self.act_scales[k] = up[at : at + n].reshape(out[k].shape)
            at += n
        return self.act_scales


@torch.no_grad()
def _calibration_scales(qgen: QuantizedSpadeGenerator, latent, source):
    """One dynamic-scale forward; returns {site: max |x| / 127} as device
    tensors."""
    record = {}
    qgen._forward(latent, source, None, record)
    return record
