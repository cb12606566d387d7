"""The fused SPADE path of the bf16 serving model (ops/spade.py), on the CPU.

Where autograd is off, the compute dtype bf16 and the statistics float32,
each SPADE residual block runs its moments as ``spade_sums`` and each SPADE
with its LeakyReLU as ``spade_modulate``; on the CPU these are the plain
versions, the unfused chain op for op.  So the fused path must equal the
unfused one bit for bit here (the kernels are held to the plain versions
on the card: tests/test_torch_kernels.py), and still match the JAX
generator at the bf16 bound of tests/test_torch_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from moonsuperresolution_tpu.config import ModelConfig as JModelConfig
from moonsuperresolution_tpu.config import TrainConfig
from moonsuperresolution_tpu.models import layers as jl
from moonsuperresolution_tpu.train.trainers import GauGANTrainer
from moonsuperresolution_tpu_torch.config import ModelConfig
from moonsuperresolution_tpu_torch.models import layers as tl
from moonsuperresolution_tpu_torch.models.gaugan import GauGAN
from moonsuperresolution_tpu_torch.models.networks import upsample2x_nearest
from moonsuperresolution_tpu_torch.ops import spade as so
from moonsuperresolution_tpu_torch.parallel.collectives import Axis
from moonsuperresolution_tpu_torch.utils.convert import load_params

torch.set_num_threads(2)

SMALL = dict(image_size=64, latent_dim=16,
             channel_plan=(64, 64, 32, 32, 16, 8), encoder_filters=8)
BF16 = torch.bfloat16
ALPHA = 0.2


def bf16(rng, shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                            .astype(np.float32)).to(BF16)


def spade_layer(c, stats, seed=0):
    """A bf16 SPADE with random weights and biases."""
    m = tl.SPADE(c, stats=stats, dtype=BF16)
    tl.init_params(m, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in (m.conv.bias, m.conv_gamma.bias, m.conv_beta.bias):
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(seed + 1)) * 0.3)
    return m.to(BF16)


class Counted:
    """Counts calls of the plain fused functions (and of the wrappers'
    kernel launches) over a ``with`` block."""

    def __init__(self, monkeypatch):
        self.calls = {"sums": 0, "modulate": 0}
        for name, key in (("spade_sums_plain", "sums"),
                          ("spade_modulate_plain", "modulate")):
            fn = getattr(so, name)

            def counted(*a, _fn=fn, _key=key, **k):
                self.calls[_key] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(so, name, counted)
        so.spade_sums.launches = so.spade_modulate.launches = 0

    @property
    def launches(self):
        return so.spade_sums.launches + so.spade_modulate.launches


# ------------------------------------------------- the plain versions


@pytest.mark.parametrize("stats", ["batch", "instance"])
@pytest.mark.parametrize("hw", [(8, 8), (5, 7)], ids=["8x8", "5x7"])
def test_fused_spade_equals_unfused_chain(stats, hw):
    """spade_1 of a block: ``leaky_relu(SPADE(x))`` with the moments of x,
    fused and unfused, equal bit for bit; odd H*W included."""
    rng = np.random.default_rng(0)
    x = bf16(rng, (3, 16, *hw), 2.0, 0.5)
    mask = bf16(rng, (3, 2, 32, 32))
    m = spade_layer(16, stats)
    with torch.no_grad():
        want = F.leaky_relu(m(x, mask), ALPHA)
        got = m.modulate(so.normed(x, stats), mask, ALPHA)
    assert got.dtype == BF16 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("stats", ["batch", "instance"])
@pytest.mark.parametrize("hw", [(4, 4), (3, 5)], ids=["4x4", "3x5"])
def test_fused_spade_upsampled_read_equals_generator_chain(stats, hw):
    """The generator's handover: moments and normalised tensor taken before
    the 2x nearest upsample, then upsampled; fused, the block reads the
    pre-upsample tensor at (h >> 1, w >> 1)."""
    rng = np.random.default_rng(1)
    x = bf16(rng, (2, 8, *hw), 3.0, -1.0)
    mask = bf16(rng, (2, 2, 16, 16))
    m = spade_layer(8, stats, seed=3)
    with torch.no_grad():
        x_hat = tl.spade_normalize(x, stats, torch.float32)
        want = F.leaky_relu(m(upsample2x_nearest(x), mask,
                              normalized=upsample2x_nearest(x_hat.to(BF16))),
                            ALPHA)
        src = so.normed(x, stats, up=True)
        assert src.hw == (2 * hw[0], 2 * hw[1])
        got = m.modulate(src, mask, ALPHA)
    assert torch.equal(got, want)


@pytest.mark.parametrize("stats", ["batch", "instance"])
def test_sums_and_moments_equal_spade_moments(stats):
    rng = np.random.default_rng(2)
    x = bf16(rng, (4, 6, 7, 9), 1.5, 2.0)
    mean, var = tl.spade_moments(x.to(torch.float32), stats)
    src = so.normed(x, stats)
    assert torch.equal(src.mean, mean)
    assert torch.equal(src.r, 1.0 / torch.sqrt(var + tl.SPADE_EPSILON))
    s1, s2 = so.spade_sums_plain(x, stats)
    want_shape = (1, 6, 1, 1) if stats == "batch" else (4, 6, 1, 1)
    assert s1.shape == s2.shape == want_shape
    assert s1.dtype == s2.dtype == torch.float32


def test_plain_versions_check_their_inputs():
    x = torch.zeros((2, 4, 8, 8), dtype=BF16)
    gb = torch.zeros((2, 8, 8, 8), dtype=BF16)
    m = torch.zeros(4)
    with pytest.raises(TypeError):
        so.spade_sums(x.float(), "batch")
    with pytest.raises(ValueError):
        so.spade_sums(x, "group")
    with pytest.raises(ValueError):
        so.spade_modulate(x, gb[:, :6], m, m, ALPHA)
    with pytest.raises(ValueError):
        so.spade_modulate(x, gb, m, m, ALPHA, up=True)   # gb not 2x
    with pytest.raises(ValueError):
        so.spade_modulate(x, gb, torch.zeros(3), torch.zeros(3), ALPHA)
    with pytest.raises(ValueError):
        so.spade_modulate(x, gb.to("meta"), m, m, ALPHA)


# ------------------------------------------------------ the whole model


def model(dtype="bfloat16", stats="batch", seed=0):
    m = GauGAN(ModelConfig(variant="cnn_spade", compute_dtype=dtype,
                           spade_stats=stats, **SMALL))
    tl.init_params(m, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed + 1)
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return m.to(getattr(torch, dtype)).eval()


def source(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-0.5, 0.5, (b, 2, 64, 64))
                            .astype(np.float32))


@pytest.mark.parametrize("stats", ["batch", "instance"])
def test_gaugan_inference_mode_equals_autograd_path(monkeypatch, stats):
    """GauGAN.forward and SpadeGenerator under inference_mode (the fused
    path: 12 sums and 15 modulates a forward at six blocks, three with a
    learned skip) equal the same calls under enable_grad (the unfused
    path, which calls no fused function) bit for bit."""
    m = model(stats=stats)
    src = source().to(BF16)
    eps = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16)).astype(np.float32))
    z = torch.randn((2, 16), generator=torch.Generator().manual_seed(7))
    c = Counted(monkeypatch)
    with torch.inference_mode():
        fused = m(src, eps=eps)
        fused_gen = m.generator(z, src)
    assert c.calls == {"sums": 24, "modulate": 30}
    with torch.enable_grad():
        plain = m(src, eps=eps)
        plain_gen = m.generator(z, src)
    assert c.calls == {"sums": 24, "modulate": 30} and c.launches == 0
    assert plain.requires_grad
    assert torch.equal(fused, plain.detach())
    assert torch.equal(fused_gen, plain_gen.detach())


def test_generator_without_subpixel_head(monkeypatch):
    gen = model().generator
    gen.subpixel_head = False
    src = source(1).to(BF16)
    z = torch.randn((2, 16), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        fused = gen(z, src)
    with torch.enable_grad():
        plain = gen(z, src)
    assert fused.shape == (2, 1, 64, 64)
    assert torch.equal(fused, plain.detach())


def _jax_generate(params, src, compute_dtype):
    tr = GauGANTrainer(TrainConfig(model=JModelConfig(
        variant="cnn_spade", compute_dtype=compute_dtype, **SMALL),
        batch_size=2))
    x = jnp.asarray(src)
    if compute_dtype == "bfloat16":
        x = x.astype(jnp.bfloat16)
    return np.asarray(tr._generate(params, x, None)[0])


@pytest.fixture(scope="module")
def jax_params():
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


def test_fused_generate_matches_jax_bf16(jax_params):
    """The slice as a whole: the port's bf16 model under inference_mode
    (the fused path) against JAX's bf16 and float32 ``_generate``, at
    tests/test_torch_models.py::test_generate_bf16's bound: within 10 %
    (mean 1 %) of the output range of JAX's bf16 output, and no further
    from the float32 output than 1.5x JAX's bf16 output is."""
    src = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 64, 64, 2)) \
        .astype(np.float32)
    want = _jax_generate(jax_params, src, "bfloat16")
    ref = _jax_generate(jax_params, src, "float32")
    m = load_params(GauGAN(ModelConfig(variant="cnn_spade",
                                       compute_dtype="bfloat16", **SMALL)),
                    jax_params).to(BF16)
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(src, -1, 1)))
    with torch.inference_mode():
        got = np.moveaxis(m(x.to(BF16)).float().numpy(), 1, -1)
    span = ref.max() - ref.min()
    err = np.abs(got - want)
    assert err.max() < 0.10 * span and err.mean() < 0.01 * span
    assert np.abs(got - ref).mean() < 1.5 * np.abs(want - ref).mean()


@pytest.mark.parametrize("up", [False, True])
def test_fused_spade_matches_jax_spade(rng, up):
    """The kernel's module against the JAX layer: JAX's bf16 SPADE (its
    moments, or for ``up`` the generator's upsampled normalised input)
    then LeakyReLU, against ``SPADE.fused``.  The frameworks add the
    gamma/beta bias at other roundings, so the bound is two bf16 ulps
    (2^-6) of the output's magnitude, with the mean error under a tenth of
    that."""
    x = (rng.standard_normal((2, 8, 8, 16)) * 2 + 0.5).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    mask = rng.uniform(-0.5, 0.5, (2, 64, 64, 2)).astype(np.float32)
    jm = jl.SPADE(16, dtype=jnp.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    hw = 16 if up else 8
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((2, hw, hw, 16), jnp.bfloat16),
                                    jnp.asarray(mask))["params"])
    if up:
        xs = xj.astype(jnp.float32)
        mean, var = jl.spade_moments(xs)
        n = ((xs - mean) * jnp.reciprocal(jnp.sqrt(var + 1e-5))).astype(
            jnp.bfloat16)
        n = jnp.repeat(jnp.repeat(n, 2, 1), 2, 2)
        want = jm.apply({"params": params}, jnp.repeat(jnp.repeat(
            xj, 2, 1), 2, 2), jnp.asarray(mask), normalized=n)
    else:
        want = jm.apply({"params": params}, xj, jnp.asarray(mask))
    want = np.asarray(jax.nn.leaky_relu(want, ALPHA).astype(jnp.float32))
    m = load_params(tl.SPADE(16, dtype=BF16), params).to(BF16)
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).to(BF16)
    mt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(mask, -1, 1)))
    with torch.inference_mode():
        got = m.modulate(so.normed(xt, "batch", up=up), mt.to(BF16), ALPHA)
    got = np.moveaxis(got.float().numpy(), 1, -1)
    tol = 2.0 ** -6 * np.maximum(np.abs(want), 1.0)
    err = np.abs(got - want)
    assert (err <= tol).all()
    assert err.mean() < 0.1 * tol.mean()


# ------------------------------------------------------------ dispatch


def test_no_fused_call_with_autograd_on(monkeypatch):
    m = model()
    c = Counted(monkeypatch)
    with torch.enable_grad():
        out = m(source().to(BF16),
                eps=torch.zeros((2, 16)))
    out.float().sum().backward()
    assert c.calls == {"sums": 0, "modulate": 0} and c.launches == 0
    assert all(p.grad is not None for p in m.generator.parameters())


def test_no_fused_call_in_float32(monkeypatch):
    m = model("float32")
    c = Counted(monkeypatch)
    with torch.inference_mode():
        out = m(source(), eps=torch.zeros((2, 16)))
        assert not any(getattr(m.generator, f"resblock_{i}").fused()
                       for i in range(6))
    assert out.dtype == torch.float32
    assert c.calls == {"sums": 0, "modulate": 0} and c.launches == 0


def test_no_fused_call_with_bf16_statistics(monkeypatch):
    m = GauGAN(ModelConfig(variant="cnn_spade", compute_dtype="bfloat16",
                           stats_dtype="bfloat16", **SMALL)).to(BF16).eval()
    c = Counted(monkeypatch)
    with torch.inference_mode():
        m(source().to(BF16), eps=torch.zeros((2, 16)))
    assert c.calls == {"sums": 0, "modulate": 0}


@pytest.fixture
def group_of_one():
    """A gloo process group of this process alone, on a free local port."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield Axis(dist.group.WORLD, 0, 1)
    finally:
        dist.destroy_process_group()


def test_tensor_parallel_block_stays_unfused(monkeypatch, group_of_one):
    """A block with a model axis keeps the unfused TP chain under
    inference_mode, and the generator hands it the unfused normalised
    input; the other blocks stay fused, and the whole equals the unfused
    generator on the same mesh bit for bit."""
    gen = model().generator
    gen.resblock_2.model_axis = group_of_one
    src = source(2).to(BF16)
    z = torch.randn((2, 16), generator=torch.Generator().manual_seed(1))
    with torch.enable_grad():
        want = gen(z, src)
    c = Counted(monkeypatch)
    with torch.inference_mode():
        got = gen(z, src)
        assert not gen.resblock_2.fused() and gen.resblock_3.fused()
    # Five fused blocks: block 2 (a learned skip: three SPADEs) takes
    # neither its moments nor its SPADEs fused, and the generator hands it
    # the unfused normalised input.
    assert c.calls == {"sums": 10, "modulate": 12}
    assert torch.equal(got, want.detach())


def test_data_axis_sums_the_moments(group_of_one):
    """With a data axis the fused path all-reduces the sums (a group of
    one: the same moments)."""
    m = model()
    src = source(3).to(BF16)
    z = torch.randn((2, 16), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want = m.generator(z, src)
        for mod in m.generator.modules():
            if hasattr(mod, "data_axis"):
                mod.data_axis = group_of_one
        got = m.generator(z, src)
    assert torch.equal(got, want)
