"""Parity of the port's int8 generator (models/quant.py, ops/qconv.py)
with the JAX package's (moonsuperresolution_tpu/models/quant.py).  The
loader and the engine's calibration hook are in test_torch_quant_engine.py.

The same numpy inputs and the same float weights go through both sides at
the small config (image 64, latent 16, channel plan 64-64-32-32-16-8,
float32 compute).  The weights are made by the port (seeded glorot init,
biases moved off zero) and handed to JAX as its parameter tree, so no flax
init is compiled.

The JAX generator runs eagerly: under ``jit``, XLA:CPU folds the
``acc_dtype="bfloat16"`` conv result's round trip to float32 away and
dequantizes the exact int32 sum, which the TPU (and the port) round once to
bf16 first.  Op by op, each conv rounds its own result, as on the TPU.

Bounds: the quantized weights and scales are equal; the int32-exact conv is
equal; with real scales the epilogue is within 1 float32 ulp (XLA:CPU may
contract the multiply-add to an FMA); requantized codes differ by at most 1;
whole generators within a relative RMSE of 2e-3 of the output span (the two
sides quantize activations that differ by float ulps, so a few codes flip by
one).  The properties of tests/test_quant.py hold for the port with that
file's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonsuperresolution_tpu.models import quant as jq
from moonsuperresolution_tpu_torch.config import ModelConfig
from moonsuperresolution_tpu_torch.models import layers as tl
from moonsuperresolution_tpu_torch.models import quant as tq
from moonsuperresolution_tpu_torch.models.gaugan import GauGAN
from moonsuperresolution_tpu_torch.ops.qconv import qconv, qconv_plain
from moonsuperresolution_tpu_torch.utils.convert import export_params

torch.set_num_threads(2)

IMG = 64
PLAN = (64, 64, 32, 32, 16, 8)
SMALL = dict(latent_dim=16, channel_plan=PLAN, encoder_filters=8)
REL = 2e-3


def nested(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return tree


def perturb_biases(model, seed=1):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def rel_rmse(got, want, span_of=None):
    ref = want if span_of is None else span_of
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(ref.max() - ref.min(), 1e-9))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _generator(perturb):
    model = tl.init_params(GauGAN(ModelConfig(image_size=IMG, **SMALL)),
                           torch.Generator().manual_seed(0))
    g = (perturb_biases(model) if perturb else model).generator.eval()
    params = nested(export_params(g))
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 16)).astype(np.float32)
    src = (rng.standard_normal((2, IMG, IMG, 2)) * 0.3).astype(np.float32)
    return g, params, z, src


@pytest.fixture(scope="module")
def gen():
    """(port float32 SpadeGenerator, the JAX tree of its weights, z, src),
    biases moved off zero so that a mix-up in the mapping shows."""
    return _generator(perturb=True)


@pytest.fixture(scope="module")
def gen_init():
    """The same, as initialised (zero biases), as tests/test_quant.py's
    generator is: the properties below hold with that file's bounds."""
    return _generator(perturb=False)


def _port_q(g, **kw):
    return tq.QuantizedSpadeGenerator(IMG, channel_plan=PLAN,
                                      dtype=torch.float32, **kw).quantize(g)


def _run(q, z, src):
    with torch.no_grad():
        return nhwc(q(torch.from_numpy(z), nchw(src)))


@pytest.fixture(scope="module")
def jax_qparams(gen):
    """JAX's ``quantize`` of the weights (it does not depend on acc_dtype),
    run eagerly as the JAX loader runs it: under ``jit`` XLA turns its
    division by 127 into a multiplication by the reciprocal."""
    qg = jq.QuantizedSpadeGenerator(image_size=IMG, channel_plan=PLAN,
                                    dtype=jnp.float32)
    with jax.disable_jit():
        return jax.device_get(qg.quantize(gen[1]))


@pytest.fixture(scope="module")
def jax_runs(gen, jax_qparams):
    """JAX QuantizedSpadeGenerator outputs (and calibrated scales), eagerly,
    computed once per (static, acc_dtype)."""
    _, _, z, src = gen
    cache = {}

    def run(static, acc):
        if (static, acc) not in cache:
            qg = jq.QuantizedSpadeGenerator(image_size=IMG, channel_plan=PLAN,
                                            dtype=jnp.float32, acc_dtype=acc)
            with jax.disable_jit():
                qp = jax_qparams
                if static:
                    qp = qg.calibrate(qp, jnp.asarray(z), jnp.asarray(src))
                out = np.asarray(qg.apply(qp, jnp.asarray(z),
                                          jnp.asarray(src)))
            cache[static, acc] = out, jax.device_get(
                qp.get("act_scales", {}))
        return cache[static, acc]

    return run


# ------------------------------------------------------------- (a) weights


def test_quantized_weights_and_scales_equal_jax(gen, jax_qparams):
    want = jax_qparams
    got = _port_q(gen[0])

    def same_conv(qc, w):
        # JAX HWIO -> the kernel's [Cout, 3, 3, Cin].
        np.testing.assert_array_equal(
            qc.kernel.numpy(), np.asarray(w["kernel"]).transpose(3, 0, 1, 2))
        np.testing.assert_array_equal(qc.scale.numpy(), np.asarray(w["scale"]))
        np.testing.assert_array_equal(qc.bias.numpy(), np.asarray(w["bias"]))
        assert qc.kernel.dtype == torch.int8

    for i in range(len(PLAN)):
        qb, wb = getattr(got, f"resblock_{i}"), want[f"resblock_{i}"]
        assert hasattr(qb, "conv_3") == ("conv_3" in wb)
        for name in ("conv_1", "conv_2", "conv_3"):
            if name in wb:
                same_conv(getattr(qb, name), wb[name])
        for name in ("spade_1", "spade_2", "spade_3"):
            if name in wb:
                qs, ws = getattr(qb, name), wb[name]
                same_conv(qs.gb, ws["gb"])
                np.testing.assert_array_equal(
                    qs.conv_kernel.numpy(),
                    np.asarray(ws["conv"]["kernel"]).transpose(3, 2, 0, 1))
                np.testing.assert_array_equal(qs.conv_bias.numpy(),
                                              np.asarray(ws["conv"]["bias"]))
    np.testing.assert_array_equal(got.dense_weight.numpy(),
                                  np.asarray(want["dense"]["kernel"]).T)
    np.testing.assert_array_equal(
        got.head_kernel.numpy(),
        np.asarray(want["head"]["kernel"]).transpose(3, 2, 0, 1))


# ----------------------------------------------------- (b) activation quant


@pytest.mark.parametrize("case", ["golden", "random"])
def test_quant_act_per_tensor_equals_jax(rng, case):
    if case == "golden":  # tests/test_quant.py:41-46
        x = np.asarray([[0.5, -2.0, 1.0]], np.float32)
    else:
        x = (rng.standard_normal((2, 8, 8, 16)) * 3).astype(np.float32)
    with jax.disable_jit():
        wq, ws = jq._quant_act_per_tensor(jnp.asarray(x))
    gq, gs = tq._quant_act_per_tensor(torch.from_numpy(x))
    assert gq.dtype == torch.int8 and gs.ndim == 0
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    assert float(gs) == float(ws)
    if case == "golden":
        np.testing.assert_array_equal(gq.numpy(), [[32, -127, 64]])


# ------------------------------------------------------- (c) the int8 conv


def _conv_inputs(rng, c, n, real_scales):
    x = rng.integers(-127, 128, (2, 9, 7, c)).astype(np.int8)
    w = rng.integers(-127, 128, (n, 3, 3, c)).astype(np.int8)
    if real_scales:
        s_x = np.float32(0.0123)
        w_scale = rng.uniform(0.001, 0.02, n).astype(np.float32)
        bias = rng.standard_normal(n).astype(np.float32)
    else:
        s_x = np.float32(1.0)
        w_scale = np.ones(n, np.float32)
        bias = np.zeros(n, np.float32)
    return x, w, s_x, w_scale, bias


def _jax_qconv(x, w, s_x, w_scale, bias, acc, out_scale=None):
    with jax.disable_jit():
        y = jq._qconv(jnp.asarray(x), jnp.asarray(w.transpose(1, 2, 3, 0)),
                      jnp.asarray(w_scale), jnp.asarray(bias),
                      out_dtype=jnp.float32, s_x=jnp.asarray(s_x),
                      acc_dtype=acc, x_quantized=True,
                      out_scale=None if out_scale is None
                      else jnp.asarray(out_scale))
    return np.asarray(y)


def _port_qconv(x, w, s_x, w_scale, bias, acc, out_scale=None):
    y = qconv(torch.from_numpy(x), torch.from_numpy(w), torch.tensor(s_x),
              torch.from_numpy(w_scale), torch.from_numpy(bias), acc,
              torch.float32,
              None if out_scale is None else torch.from_numpy(out_scale))
    assert y.is_contiguous(memory_format=torch.channels_last)
    return nhwc(y) if y.dtype != torch.int8 else \
        y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("c", [16, 32])
def test_qconv_plain_int32_accumulation_is_exact(rng, c):
    """Unit scales, zero bias, float32 out: y is the int32 sum itself, and
    |sum| <= 9 * 32 * 127^2 < 2^24 is exact in float32."""
    args = _conv_inputs(rng, c, 24, real_scales=False)
    got = _port_qconv(*args, torch.int32)
    want = _jax_qconv(*args, jnp.int32)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 1e5


@pytest.mark.parametrize("acc", ["int32", "bfloat16"])
def test_qconv_plain_epilogue_within_one_ulp(rng, acc):
    args = _conv_inputs(rng, 32, 24, real_scales=True)
    got = _port_qconv(*args, getattr(torch, acc))
    want = _jax_qconv(*args, getattr(jnp, acc))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_qconv_plain_requant_codes_within_one(rng):
    """bf16-accumulated, requantized to s8 per channel: a code may flip by
    one where y * inv lands within an ulp of a half-integer."""
    x, w, s_x, w_scale, bias = _conv_inputs(rng, 32, 24, real_scales=True)
    inv = rng.uniform(5.0, 40.0, 24).astype(np.float32)
    got = _port_qconv(x, w, s_x, w_scale, bias, torch.bfloat16, inv)
    want = _jax_qconv(x, w, s_x, w_scale, bias, jnp.bfloat16, inv)
    assert got.dtype == want.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and diff.mean() < 0.01
    assert (np.abs(want) == 127).any() and (np.abs(want) < 127).mean() > 0.5


def test_qconv_contract():
    x = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    w = torch.zeros((8, 3, 3, 16), dtype=torch.int8)
    one, vec = torch.tensor(1.0), torch.ones(8)
    with pytest.raises(TypeError):
        qconv(x.float(), w, one, vec, vec, torch.int32, torch.float32)
    with pytest.raises(ValueError, match="0-d"):
        qconv(x, w, vec, vec, vec, torch.int32, torch.float32)
    with pytest.raises(ValueError, match="channels"):
        qconv(x[..., :8], w, one, vec, vec, torch.int32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        qconv(x.transpose(1, 2), w, one, vec, vec, torch.int32, torch.float32)
    with pytest.raises(ValueError, match="acc_dtype"):
        qconv(x, w, one, vec, vec, torch.float32, torch.float32)
    y = qconv_plain(x, w, one, vec, vec, torch.int32, torch.bfloat16)
    assert y.shape == (1, 8, 4, 4) and y.dtype == torch.bfloat16


# ----------------------------------------------- (d) generator against JAX


@pytest.mark.parametrize("acc", ["int32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_quantized_generator_matches_jax(gen, jax_runs, static, acc):
    g, _, z, src = gen
    want, want_scales = jax_runs(static, acc)
    q = _port_q(g, acc_dtype=acc)
    if static:
        q.calibrate(torch.from_numpy(z), nchw(src))
        assert set(q._host_scales) == set(want_scales)
        for k, v in want_scales.items():
            np.testing.assert_allclose(q._host_scales[k], np.asarray(v),
                                       rtol=1e-5, err_msg=k)
    got = _run(q, z, src)
    assert got.shape == want.shape == (2, IMG, IMG, 1)
    assert rel_rmse(got, want) <= REL


# --------------------------------------------------- (e) the port's bounds


def test_int8_generator_close_to_float(gen_init):
    g, _, z, src = gen_init
    with torch.no_grad():
        ref = nhwc(g(torch.from_numpy(z), nchw(src)))
    out = _run(_port_q(g), z, src)
    assert rel_rmse(out, ref) < 0.02
    assert not np.array_equal(out, ref)


def test_bf16_acc_close_to_int32_acc(gen_init):
    g, _, z, src = gen_init
    with torch.no_grad():
        ref = nhwc(g(torch.from_numpy(z), nchw(src)))
    out32 = _run(_port_q(g), z, src)
    outbf = _run(_port_q(g, acc_dtype="bfloat16"), z, src)
    assert rel_rmse(outbf, out32, span_of=ref) < 0.01
    assert rel_rmse(outbf, ref) < 0.02
    assert not np.array_equal(outbf, out32)


def test_static_scales_close_to_dynamic_and_monotone(gen_init):
    g, _, z, src = gen_init
    q = _port_q(g)
    dyn = _run(q, z, src)
    scales = q.calibrate(torch.from_numpy(z), nchw(src))
    assert len(scales) >= 20 and q.act_scales is scales
    stat = _run(q, z, src)
    assert rel_rmse(stat, dyn) < 0.01
    before = dict(q._host_scales)
    q.calibrate(torch.from_numpy(z), nchw(src * 1.5))
    for k, v in before.items():
        if k.endswith("_inv"):  # derived inverses shrink as scales grow
            continue
        assert np.all(q._host_scales[k] >= v * 0.999), k
        torch.testing.assert_close(q.act_scales[k],
                                   torch.from_numpy(q._host_scales[k]),
                                   rtol=0, atol=0)


def test_int8_deterministic(gen_init):
    g, _, z, src = gen_init
    q = _port_q(g)
    np.testing.assert_array_equal(_run(q, z, src), _run(q, z, src))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_quantize_passes_write_nhwc(gen, monkeypatch, static):
    """Every s8 conv input already lies in NHWC storage (channels_last), so
    the kernel's input needs no transpose."""
    g, _, z, src = gen
    q = _port_q(g)
    if static:
        q.calibrate(torch.from_numpy(z), nchw(src))
    seen = []
    real = tq._nhwc

    def nhwc_checked(t):
        seen.append(t.permute(0, 2, 3, 1).is_contiguous())
        return real(t)

    monkeypatch.setattr(tq, "_nhwc", nhwc_checked)
    _run(q, z, src)
    # Per block: 3 gb + 3 convs with a skip, 2 + 2 without.
    assert len(seen) == sum(6 if a != b else 4
                            for a, b in zip((PLAN[0],) + PLAN, PLAN))
    assert all(seen)
