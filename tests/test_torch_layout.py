"""The bf16 serving path in channels_last, with the conv biases folded into
SPADE's kernels (ops/spade.py), on the CPU.

The served model is held channels_last (``DEMSuperResolution`` converts a
``GauGAN`` once); its activations stay NHWC from the first conv to the
head.  On the fused path the convs whose outputs SPADE's kernels read run
without their bias pass, and the kernels add the biases where that pass
would, rounding as it does; on the CPU the kernels are their plain
versions, the unfused chain op for op.  So here:
- the fused path equals the unfused one bit for bit, in NCHW and in
  channels_last, block by block and for the whole generator;
- a channels_last model generates what an NCHW one does, within two bf16
  ulps of the output's largest magnitude (``ULPS2``: the convs of the two
  layouts may sum in another order, and a flipped rounding deep in the
  generator moves the output by an ulp), and still matches JAX's bf16
  generate at tests/test_torch_spade.py::test_fused_generate_matches_
  jax_bf16's bound;
- the engine serves its GauGAN channels_last, and its tile planes equal
  those of the same weights served NCHW within that bound carried through
  the denormalisation and the fold;
- the subpixel head's collapsed kernel is made once per set of weights.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from moonsuperresolution_tpu.config import ModelConfig as JModelConfig
from moonsuperresolution_tpu.config import TrainConfig
from moonsuperresolution_tpu.train.trainers import GauGANTrainer
from moonsuperresolution_tpu_torch.config import DSRConfig, ModelConfig
from moonsuperresolution_tpu_torch.infer.engine import (
    DEMSuperResolution,
    TileGeometry,
    quantize_model,
)
from moonsuperresolution_tpu_torch.models import layers as tl
from moonsuperresolution_tpu_torch.models import networks as tn
from moonsuperresolution_tpu_torch.models.gaugan import GauGAN
from moonsuperresolution_tpu_torch.ops import spade as so
from moonsuperresolution_tpu_torch.ops.resize import resize_nearest
from moonsuperresolution_tpu_torch.utils.convert import load_params

torch.set_num_threads(2)

SMALL = dict(image_size=64, latent_dim=16,
             channel_plan=(64, 64, 32, 32, 16, 8), encoder_filters=8)
BF16 = torch.bfloat16
CL = torch.channels_last
LAYOUTS = {"nchw": torch.contiguous_format, "nhwc": CL}
ALPHA = 0.2
NO_VALUE = -32768.0
ULPS2 = 2.0 ** -6     # two bf16 ulps, relative to a magnitude


def near(got, want) -> bool:
    """Within two bf16 ulps of ``want``'s largest magnitude."""
    return float((got - want).abs().max()) <= ULPS2 * float(
        want.abs().max())


def bf16(rng, shape, scale=1.0, shift=0.0, layout="nchw"):
    t = torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                         .astype(np.float32)).to(BF16)
    return t.contiguous(memory_format=LAYOUTS[layout]) if t.ndim == 4 else t


def random_biases(m: torch.nn.Module, seed: int, scale: float = 0.3):
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed)
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * scale)
    return m


def block(cin, ch, stats, layout, seed=0):
    m = tl.SpadeResidualBlock(cin, ch, stats=stats, dtype=BF16)
    tl.init_params(m, torch.Generator().manual_seed(seed))
    return random_biases(m, seed + 1).to(BF16).to(
        memory_format=LAYOUTS[layout])


def model(dtype="bfloat16", stats="batch", seed=0):
    m = GauGAN(ModelConfig(variant="cnn_spade", compute_dtype=dtype,
                           spade_stats=stats, **SMALL))
    tl.init_params(m, torch.Generator().manual_seed(seed))
    return random_biases(m, seed + 1, 0.1).to(getattr(torch, dtype)).eval()


def source(seed=0, b=2, layout="nchw"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-0.5, 0.5, (b, 2, 64, 64)).astype(
        np.float32)).contiguous(memory_format=LAYOUTS[layout])


def is_cl(t):
    return t.is_contiguous(memory_format=CL)


# ------------------------------------------- the plain versions' biases


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("stats", ["batch", "instance"])
def test_sums_with_bias_equal_sums_of_the_biased_conv(stats, layout):
    """``spade_sums(h, stats, b)`` of a conv run without its bias: the
    sums of the conv's own output, bias pass included."""
    rng = np.random.default_rng(0)
    x, w = bf16(rng, (2, 8, 6, 10), layout=layout), bf16(rng, (12, 8, 3, 3))
    b = bf16(rng, (12,), 0.5)
    want = so.spade_sums_plain(tl.conv_same(x, w, b), stats)
    got = so.spade_sums(tl.conv_same(x, w), stats, b)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("up", [False, True])
def test_modulate_with_biases_equals_the_unfused_chain(up, layout):
    """``spade_modulate`` with the gamma/beta conv's bias and the input
    conv's bias against the unfused chain: both biased convs, the
    normalisation (upsampled with ``up``), ``gamma * n + beta``,
    LeakyReLU."""
    rng = np.random.default_rng(1)
    hw = (5, 7) if up else (10, 14)
    src = bf16(rng, (3, 6, *hw), 2.0, layout=layout)
    w = bf16(rng, (8, 6, 3, 3))
    xb = bf16(rng, (8,), 0.5)
    k = 2 if up else 1
    h = bf16(rng, (3, 4, k * hw[0], k * hw[1]), layout=layout)
    wgb, bgb = bf16(rng, (16, 4, 3, 3)), bf16(rng, (16,), 0.5)
    x = tl.conv_same(src, w, xb)
    mean, var = tl.spade_moments(x.float(), "batch")
    n = ((x.float() - mean) * so.inv_std(var)).to(BF16)
    if up:
        n = tn.upsample2x_nearest(n)
    gb = tl.conv_same(h, wgb, bgb)
    want = F.leaky_relu(gb[:, :8] * n + gb[:, 8:], ALPHA)
    s = so.normed(tl.conv_same(src, w), "batch", up=up, bias=xb)
    got = so.spade_modulate(s.x, tl.conv_same(h, wgb), s.mean, s.r, ALPHA,
                            up, s.bias, bgb)
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", ["skip", "input", "input_up"])
def test_residual_equals_the_unfused_sum(case, layout):
    """``spade_residual``: the last conv's bias pass, then ``+`` the skip
    conv's output with its own bias pass, or the block input (read 2x
    nearest-upsampled for ``input_up``), as the unfused block sums them."""
    rng = np.random.default_rng(2)
    x = bf16(rng, (2, 8, 6, 10), layout=layout)
    w2, b2 = bf16(rng, (8, 8, 3, 3)), bf16(rng, (8,), 0.5)
    h = tl.conv_same(x, w2, b2)
    if case == "skip":
        w3, b3 = bf16(rng, (8, 8, 3, 3)), bf16(rng, (8,), 0.5)
        want = tl.conv_same(x, w3, b3) + h
        got = so.spade_residual(tl.conv_same(x, w2), b2,
                                tl.conv_same(x, w3), b3)
    elif case == "input":
        res = bf16(rng, (2, 8, 6, 10), layout=layout)
        want = res + h
        got = so.spade_residual(tl.conv_same(x, w2), b2, res)
    else:
        res = bf16(rng, (2, 8, 3, 5), layout=layout)
        want = tn.upsample2x_nearest(res) + h
        got = so.spade_residual(tl.conv_same(x, w2), b2, res, up=True)
    assert got.dtype == BF16 and torch.equal(got, want)


def test_residual_checks_its_inputs():
    h = torch.zeros((2, 4, 6, 6), dtype=BF16)
    b = torch.zeros(4, dtype=BF16)
    with pytest.raises(ValueError):
        so.spade_residual(h, None, h)
    with pytest.raises(ValueError):
        so.spade_residual(h, b, h[:, :, :3, :3])             # not up
    with pytest.raises(ValueError):
        so.spade_residual(h, b, h, up=True)                  # not half
    with pytest.raises(ValueError):
        so.spade_residual(h, b.float(), h)
    with pytest.raises(ValueError):
        so.spade_residual(h, b, h, torch.zeros(3, dtype=BF16))
    with pytest.raises(TypeError):
        so.spade_residual(h.float(), b, h)


# --------------------------------------------------------- the blocks


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("stats", ["batch", "instance"])
@pytest.mark.parametrize("cin,ch", [(16, 16), (16, 8)], ids=["input", "skip"])
def test_fused_block_equals_unfused_block(cin, ch, stats, layout):
    """A residual block under no_grad (the fused path: biases folded, the
    residual in ``spade_residual``) against the same block under
    enable_grad (the unfused chain), bit for bit; channels_last stays
    channels_last."""
    rng = np.random.default_rng(3)
    m = block(cin, ch, stats, layout)
    x = bf16(rng, (2, cin, 8, 12), 1.5, 0.2, layout)
    mask = bf16(rng, (2, 2, 32, 32), layout=layout)
    with torch.no_grad():
        assert m.fused()
        got = m(x, mask)
    with torch.enable_grad():
        want = m(x, mask)
    assert torch.equal(got, want.detach())
    if layout == "nhwc":
        assert is_cl(got)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("cin,ch", [(8, 8), (8, 4)], ids=["input", "skip"])
def test_fused_block_reads_the_handover_upsampled(cin, ch, layout):
    """The generator's handover: the previous output before its upsample,
    with its moments; the fused block reads it upsampled in its SPADEs and
    in its residual (no upsampled tensor), equal to the unfused block on
    the upsampled input bit for bit."""
    rng = np.random.default_rng(4)
    m = block(cin, ch, "batch", layout, seed=5)
    x = bf16(rng, (2, cin, 4, 6), 2.0, -0.5, layout)
    mask = bf16(rng, (2, 2, 16, 16), layout=layout)
    with torch.enable_grad():
        x_hat = tl.spade_normalize(x, "batch", torch.float32)
        want = m(tn.upsample2x_nearest(x), mask,
                 input_normalized=tn.upsample2x_nearest(x_hat.to(BF16)))
    with torch.no_grad():
        got = m(None, mask, normed=so.normed(x, "batch", up=True))
    assert got.shape == (2, ch, 8, 12)
    assert torch.equal(got, want.detach())


def test_fused_block_launches_nothing_on_the_cpu(monkeypatch):
    """On the CPU the wrappers run their plain versions: 2 sums, 3
    modulations and 1 residual a block with a skip, no launch."""
    calls = {"sums": 0, "modulate": 0, "residual": 0}
    for name in calls:
        fn = getattr(so, f"spade_{name}_plain")

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(so, f"spade_{name}_plain", counted)
    for w in (so.spade_sums, so.spade_modulate, so.spade_residual):
        w.launches = 0
    rng = np.random.default_rng(6)
    m = block(8, 4, "batch", "nhwc")
    with torch.no_grad():
        m(bf16(rng, (2, 8, 8, 8), layout="nhwc"), bf16(rng, (2, 2, 8, 8)))
    assert calls == {"sums": 2, "modulate": 3, "residual": 1}
    assert so.spade_sums.launches == so.spade_modulate.launches == \
        so.spade_residual.launches == 0


@pytest.mark.parametrize("held", ["bf16_nchw", "bf16_nhwc", "float32_nchw"])
def test_fused_path_hands_the_kernels_one_layout(monkeypatch, held):
    """On the card a kernel refuses a mix of NCHW and channels_last
    inputs.  Whatever layout the model is held in (a served bf16 model
    channels_last, an NCHW one, a float32-held model computing in bf16 as
    training's no-grad generation does), and whatever layout its source
    comes in, each modulation and residual of the fused path gets its
    tensors in one layout, that of the model's conv weights."""
    dtype, layout = held.split("_")
    if dtype == "float32":
        m = GauGAN(ModelConfig(variant="cnn_spade", compute_dtype="bfloat16",
                               **SMALL))
        random_biases(tl.init_params(m, torch.Generator().manual_seed(0)), 1)
    else:
        m = model()
    m = m.to(memory_format=LAYOUTS[layout])
    seen = []
    for name, pick in (("spade_modulate_plain", lambda a: (a[0], a[1])),
                       ("spade_residual_plain", lambda a: (a[0], a[2]))):
        fn = getattr(so, name)

        def checked(*a, _fn=fn, _pick=pick, **k):
            seen.append(so._nhwc(*_pick(a)))
            return _fn(*a, **k)
        monkeypatch.setattr(so, name, checked)
    z = torch.randn((2, 16), generator=torch.Generator().manual_seed(0))
    for src_layout in LAYOUTS:
        seen.clear()
        with torch.no_grad():
            assert m.generator.resblock_0.fused()
            m.generator(z, source(layout=src_layout).to(BF16))
        # 15 modulations and 6 residuals, none given a mix (``_nhwc``
        # raises for one); with the source in the weights' layout, each
        # after block 0's three (1 x 1, read either way) in that layout.
        assert len(seen) == 21
        if src_layout == layout:
            assert set(seen[3:]) == {layout == "nhwc"}


# ---------------------------------------------------- the whole model


@pytest.mark.parametrize("stats", ["batch", "instance"])
def test_channels_last_model_fused_equals_unfused(stats):
    """The channels_last bf16 model under inference_mode (fused) equals
    itself under enable_grad (unfused) bit for bit, and keeps NHWC
    activations from the first conv to the head's input."""
    m = model(stats=stats).to(memory_format=CL)
    src = source(layout="nhwc").to(BF16)
    eps = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16)).astype(np.float32))
    seen = []
    hooks = [mod.register_forward_hook(
        lambda mod, a, out: seen.append(is_cl(out)))
        for mod in m.modules() if isinstance(mod, tl.SpadeResidualBlock)]
    with torch.inference_mode():
        fused = m(src, eps=eps)
    for h in hooks:
        h.remove()
    assert seen == [True] * 6
    with torch.enable_grad():
        plain = m(src, eps=eps)
    assert torch.equal(fused, plain.detach())


@pytest.mark.parametrize("stats", ["batch", "instance"])
def test_channels_last_model_generates_what_nchw_does(stats):
    """The same weights served NCHW and channels_last: the same arithmetic
    in another memory order, within two bf16 ulps (``near``)."""
    m = model(stats=stats, seed=2)
    cl = copy.deepcopy(m).to(memory_format=CL)
    assert all(is_cl(p) for p in cl.parameters() if p.ndim == 4)
    src = source(1).to(BF16)
    with torch.inference_mode():
        want = m(src)
        got = cl(src.contiguous(memory_format=CL))
    assert got.shape == want.shape == (2, 1, 64, 64)
    assert near(got, want)


@pytest.fixture(scope="module")
def jax_params():
    """test_torch_spade.py's JAX tree: a gaugan init, biases and scales
    perturbed."""
    tr = GauGANTrainer(TrainConfig(model=JModelConfig(variant="gaugan",
                                                      **SMALL), batch_size=2))
    src = jnp.zeros((1, 64, 64, 2), jnp.float32)
    k_enc, k_gen = jax.random.split(jax.random.PRNGKey(0))
    tree = {"encoder": tr.encoder.init(k_enc, src)["params"],
            "generator": tr.generator.init(
                k_gen, jnp.zeros((1, 16), jnp.float32), src)["params"]}
    rng = np.random.default_rng(1)

    def perturb(t):
        return {k: perturb(v) if isinstance(v, dict) else (
            np.asarray(v) + 0.1 * rng.standard_normal(np.shape(v)).astype(
                np.float32) if k in ("bias", "scale") else np.asarray(v))
            for k, v in t.items()}
    return perturb(jax.device_get(tree))


def _jax_generate(params, src, compute_dtype):
    tr = GauGANTrainer(TrainConfig(model=JModelConfig(
        variant="cnn_spade", compute_dtype=compute_dtype, **SMALL),
        batch_size=2))
    x = jnp.asarray(src)
    if compute_dtype == "bfloat16":
        x = x.astype(jnp.bfloat16)
    return np.asarray(tr._generate(params, x, None)[0])


def test_channels_last_generate_matches_jax_bf16(jax_params):
    """The served layout against JAX's bf16 and float32 ``_generate`` at
    test_fused_generate_matches_jax_bf16's inputs and bound: within 10 %
    (mean 1 %) of the output range of JAX's bf16 output, and no further
    from the float32 output than 1.5x JAX's bf16 output is."""
    src = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 64, 64, 2)) \
        .astype(np.float32)
    want = _jax_generate(jax_params, src, "bfloat16")
    ref = _jax_generate(jax_params, src, "float32")
    m = load_params(GauGAN(ModelConfig(variant="cnn_spade",
                                       compute_dtype="bfloat16", **SMALL)),
                    jax_params).to(BF16).to(memory_format=CL)
    # NHWC storage with NCHW shape: the patch kernel's output, permuted.
    x = torch.from_numpy(src).permute(0, 3, 1, 2)
    assert is_cl(x)
    with torch.inference_mode():
        got = np.moveaxis(m(x.to(BF16)).float().numpy(), 1, -1)
    span = ref.max() - ref.min()
    err = np.abs(got - want)
    assert err.max() < 0.10 * span and err.mean() < 0.01 * span
    assert np.abs(got - ref).mean() < 1.5 * np.abs(want - ref).mean()


def test_resize_nearest_keeps_the_layout():
    """The mask's resize gathers a channels_last tensor in its own storage
    order, and picks the same pixels either way."""
    x = source(3, layout="nhwc")
    got = resize_nearest(x, (24, 40))
    want = resize_nearest(x.contiguous(), (24, 40))
    assert is_cl(got) and want.is_contiguous()
    assert torch.equal(got, want)


# ------------------------------------------------------- the head


def test_head_phases_are_made_once_per_set_of_weights(monkeypatch):
    """With autograd off the collapsed head kernel is
    ``collapse_head_kernel`` of the head's weight, made once and kept
    while the weight stays as it is; an in-place update, a new weight or a
    move makes it anew.  With autograd on it is made at every call."""
    gen = model().generator.to(memory_format=CL)
    made = []
    real = tn.collapse_head_kernel

    def counted(k):
        made.append(1)
        return real(k)
    monkeypatch.setattr(tn, "collapse_head_kernel", counted)
    z = torch.randn((2, 16), generator=torch.Generator().manual_seed(0))
    src = source(4, layout="nhwc").to(BF16)
    with torch.inference_mode():
        first = gen(z, src)
        k = gen.head_phases()
        assert gen(z, src).equal(first) and len(made) == 1
    assert torch.equal(k, real(gen.head.weight)) and is_cl(k)
    assert k.shape == (4, 8, 3, 3)
    with torch.no_grad():
        gen.head.weight.mul_(2.0)                 # in place: a new version
    with torch.inference_mode():
        assert torch.equal(gen.head_phases(), real(gen.head.weight))
    assert len(made) == 2
    gen.head.weight = torch.nn.Parameter(gen.head.weight.detach() * 0.25)
    with torch.inference_mode():
        second = gen(z, src)
        assert torch.equal(gen.head_phases(), real(gen.head.weight))
    assert len(made) == 3 and not torch.equal(first, second)
    with torch.enable_grad():
        gen(z, src)
        gen(z, src)
    assert len(made) == 5


def test_float32_held_model_makes_its_head_phases_every_call(monkeypatch):
    """A model held in float32 that computes in bf16 (training's no-grad
    generation) casts its head weight at every call, so the collapsed
    kernel is made anew each time: nothing is kept."""
    gen = GauGAN(ModelConfig(variant="cnn_spade", compute_dtype="bfloat16",
                             **SMALL)).generator
    made = []
    real = tn.collapse_head_kernel
    monkeypatch.setattr(tn, "collapse_head_kernel",
                        lambda k: made.append(1) or real(k))
    with torch.no_grad():
        gen.head_phases()
        gen.head_phases()
    assert len(made) == 2 and gen._head_phases is None


# ------------------------------------------------------- the engine


GEOM = dict(image_size=64, stride=16, tile_size=128, batch_size=4,
            no_value=NO_VALUE, compute_dtype="bfloat16")


def _slab(seed):
    rng = np.random.default_rng(seed)
    g = TileGeometry(64, 16, 128)
    img = (rng.standard_normal((g.slab, g.slab)) * 30 + 128).astype(np.float32)
    dem = (rng.standard_normal((g.slab, g.slab)) * 40).astype(np.float32)
    dem[60:140, 60:140] = NO_VALUE
    return img, dem


def test_engine_serves_its_model_channels_last():
    """``DEMSuperResolution`` converts a GauGAN's conv weights to
    channels_last in place (shapes and the state dict's keys and values
    unchanged) and hands it channels_last batches.  Against the same
    weights served NCHW (a callable, which the engine leaves as it is):
    the same batches; each generation within two bf16 ulps of the
    outputs' largest magnitude ``m`` (``near``); so the tile's coverage is
    equal and its mean and std planes, weighted means and spreads of
    generations denormalised by each patch's DEM range (at most the
    slab's, ``d``), within 2^-6 * m * d and twice that."""
    m = model(seed=3)
    nchw = copy.deepcopy(m)
    state = {k: v.clone() for k, v in m.state_dict().items()}
    seen = {"nhwc": [], "nchw": []}
    m.register_forward_hook(
        lambda mod, a, out: seen["nhwc"].append((a[0].clone(), out)))
    eng = DEMSuperResolution(DSRConfig(**GEOM), model=m, device="cpu")
    assert eng.model is m
    convs = [p for p in m.parameters() if p.ndim == 4]
    assert convs and all(is_cl(p) and not p.is_contiguous() for p in convs)
    after = m.state_dict()
    assert after.keys() == state.keys()
    assert all(torch.equal(after[k], v) for k, v in state.items())

    def served_nchw(s, generator=None):
        out = nchw(s, generator=generator)
        seen["nchw"].append((s.clone(), out))
        return out

    ref = DEMSuperResolution(DSRConfig(**GEOM), device="cpu",
                             model=served_nchw)
    assert all(p.is_contiguous() for p in nchw.parameters())
    img, dem = _slab(0)
    for e in (eng, ref):
        e.img_padded, e.dem_padded = img, dem
    got = [a.numpy() for a in eng.process_tile(0, 0)]
    want = [a.numpy() for a in ref.process_tile(0, 0)]

    assert len(seen["nhwc"]) == len(seen["nchw"]) > 1
    mag = max(float(o.abs().max()) for _, o in seen["nchw"])
    for (xa, ya), (xb, yb) in zip(seen["nhwc"], seen["nchw"]):
        assert is_cl(xa) and xb.is_contiguous() and torch.equal(xa, xb)
        assert float((ya - yb).abs().max()) <= ULPS2 * mag
    valid = dem[dem > NO_VALUE]
    tol = ULPS2 * mag * float(valid.max() - valid.min())
    np.testing.assert_array_equal(got[2], want[2])
    assert 0 < (want[2] > 0).mean() < 1
    for g, w, k in zip(got[:2], want[:2], (1, 2)):
        assert np.abs(g - w).max() <= k * tol


def test_int8_model_stays_nchw_after_serving_channels_last():
    """The int8 twin of a model that was served channels_last keeps the
    NCHW layouts of its own glue, and the engine hands it NCHW batches."""
    m = model("float32", seed=4)
    DEMSuperResolution(DSRConfig(**{**GEOM, "compute_dtype": "float32"}),
                       model=m, device="cpu")
    q = quantize_model(m, "int8", compute_dtype="float32", device="cpu")
    assert all(t.is_contiguous() for t in list(q.parameters())
               + list(q.buffers()))
    eng = DEMSuperResolution(DSRConfig(**GEOM), model=q, device="cpu")
    assert eng.memory_format == torch.contiguous_format
