"""Parity of the port's model stack with the JAX modules.

The same numpy inputs and the same weights (carried across by
utils/convert.py) go through the flax module and its torch counterpart.
float32 comparisons allow for convolutions summed in another order
(tolerances below); a bf16 case has its own, looser bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonsuperresolution_tpu.config import ModelConfig as JModelConfig
from moonsuperresolution_tpu.config import TrainConfig
from moonsuperresolution_tpu.models import layers as jl
from moonsuperresolution_tpu.models import networks as jn
from moonsuperresolution_tpu.ops.resize import resize_nearest as j_resize
from moonsuperresolution_tpu.train.trainers import GauGANTrainer
from moonsuperresolution_tpu_torch.config import ModelConfig
from moonsuperresolution_tpu_torch.models import layers as tl
from moonsuperresolution_tpu_torch.models import networks as tn
from moonsuperresolution_tpu_torch.models.gaugan import GauGAN
from moonsuperresolution_tpu_torch.ops.resize import resize_nearest
from moonsuperresolution_tpu_torch.utils.convert import (
    convert_params,
    export_params,
    flatten_tree,
    load_params,
    save_npz,
)

torch.set_num_threads(2)

SMALL = dict(image_size=64, latent_dim=16,
             channel_plan=(64, 64, 32, 32, 16, 8), encoder_filters=8)
# float32: the two frameworks sum convolutions in different orders.
RTOL, ATOL = 1e-4, 1e-5
# Whole models (encoder -> latent -> generator, 17 convs and two Dense layers
# deep): the order differences compound; on these inputs the largest
# difference is 1.2e-5 on outputs of magnitude ~0.1.
NET_ATOL = 3e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def perturbed(tree, rng):
    """Flax params with every bias and scale moved off its init value, so
    that a mix-up in the mapping shows."""
    def go(t):
        return {k: go(v) if isinstance(v, dict) else (
            np.asarray(v) + 0.1 * rng.standard_normal(np.shape(v)).astype(
                np.float32) if k in ("bias", "scale") else np.asarray(v))
            for k, v in t.items()}
    return go(jax.device_get(tree))


def init_flax(module, *args):
    return jax.device_get(module.init(jax.random.PRNGKey(0), *args)["params"])


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def gaugan_params():
    cfg = TrainConfig(model=JModelConfig(variant="gaugan", **SMALL),
                      batch_size=2)
    tr = GauGANTrainer(cfg)
    src = jnp.zeros((1, 64, 64, 2), jnp.float32)
    k_enc, k_gen = jax.random.split(jax.random.PRNGKey(0))
    params = {"encoder": tr.encoder.init(k_enc, src)["params"],
              "generator": tr.generator.init(
                  k_gen, jnp.zeros((1, 16), jnp.float32), src)["params"]}
    return perturbed(params, np.random.default_rng(1))


@pytest.mark.parametrize("hw,out_hw", [((64, 64), (8, 8)),
                                       ((13, 11), (5, 7)),
                                       ((7, 9), (20, 30))])
def test_resize_nearest_half_pixel(rng, hw, out_hw):
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), out_hw))
    got = nhwc(resize_nearest(nchw(x), out_hw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm(rng, dtype):
    """The bf16 case normalises in bf16 arithmetic (layers.py:59-64); it
    must stay within one bf16 ulp (2^-7 relative) of JAX's."""
    x = (rng.standard_normal((2, 16, 16, 8)) * 3 + 1).astype(np.float32)
    params = perturbed(init_flax(jl.InstanceNorm(), jnp.asarray(x)), rng)
    tol = dict(rtol=RTOL, atol=ATOL)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        tol = dict(rtol=2**-7, atol=2**-7)
    jdt = jnp.dtype(dtype)
    want = jl.InstanceNorm(dtype=jdt).apply({"params": params},
                                            jnp.asarray(x).astype(jdt))
    tdt = getattr(torch, dtype)
    m = load_params(tl.InstanceNorm(8, dtype=tdt), params).to(tdt)
    np.testing.assert_allclose(nhwc(m(nchw(x).to(tdt))),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("stats", ["batch", "instance"])
def test_spade(rng, stats):
    x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    mask = rng.standard_normal((2, 64, 64, 2)).astype(np.float32)
    jm = jl.SPADE(16, stats=stats)
    params = perturbed(init_flax(jm, jnp.asarray(x), jnp.asarray(mask)), rng)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    m = load_params(tl.SPADE(16, stats=stats), params)
    np.testing.assert_allclose(nhwc(m(nchw(x), nchw(mask))), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cin,cout", [(16, 8), (16, 16)])
def test_spade_residual_block(rng, cin, cout):
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    mask = rng.standard_normal((2, 64, 64, 2)).astype(np.float32)
    jm = jl.SpadeResidualBlock(cout)
    params = perturbed(init_flax(jm, jnp.asarray(x), jnp.asarray(mask)), rng)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    m = load_params(tl.SpadeResidualBlock(cin, cout), params)
    np.testing.assert_allclose(nhwc(m(nchw(x), nchw(mask))), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size,kernel", [(16, 3), (15, 3), (16, 4), (15, 4)])
def test_downsample_block_same_padding(rng, size, kernel):
    """XLA "SAME" pads a 3x3 stride-2 conv 0 before and 1 after at even
    sizes; torch's padding=1 would not."""
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    jm = jl.DownsampleBlock(8, kernel)
    params = perturbed(init_flax(jm, jnp.asarray(x)), rng)
    want = jm.apply({"params": params}, jnp.asarray(x))
    m = load_params(tl.DownsampleBlock(4, 8, kernel), params)
    got = nhwc(m(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_same_pad_matches_xla():
    assert tl.same_pad(16, 3, 2) == (0, 1)
    assert tl.same_pad(15, 3, 2) == (1, 1)
    assert tl.same_pad(16, 4, 1) == (1, 2)
    assert tl.same_pad(16, 3, 1) == (1, 1)


def _source(rng, b=2, size=64):
    return (rng.uniform(-0.5, 0.5, (b, size, size, 2))).astype(np.float32)


def test_encoder(rng, gaugan_params):
    src = _source(rng)
    jm = jn.Encoder(latent_dim=16, downsample_factor=8)
    mean, logvar = jm.apply({"params": gaugan_params["encoder"]},
                            jnp.asarray(src))
    m = load_params(tn.Encoder(64, 16, downsample_factor=8),
                    gaugan_params["encoder"])
    tmean, tlogvar = m(nchw(src))
    assert tmean.dtype == tlogvar.dtype == torch.float32
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tlogvar.numpy(), np.asarray(logvar),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("subpixel", [True, False])
def test_spade_generator(rng, gaugan_params, subpixel):
    src = _source(rng)
    z = rng.standard_normal((2, 16)).astype(np.float32)
    jm = jn.SpadeGenerator(image_size=64, channel_plan=SMALL["channel_plan"],
                           subpixel_head=subpixel)
    want = jm.apply({"params": gaugan_params["generator"]}, jnp.asarray(z),
                    jnp.asarray(src))
    m = load_params(tn.SpadeGenerator(64, 16,
                                      channel_plan=SMALL["channel_plan"],
                                      subpixel_head=subpixel),
                    gaugan_params["generator"])
    got = nhwc(m(torch.from_numpy(z), nchw(src)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _trainer(variant, compute_dtype="float32"):
    return GauGANTrainer(TrainConfig(
        model=JModelConfig(variant=variant, compute_dtype=compute_dtype,
                           **SMALL), batch_size=2))


def _port(variant, params, compute_dtype="float32"):
    model = GauGAN(ModelConfig(variant=variant, compute_dtype=compute_dtype,
                               **SMALL))
    model = load_params(model, params)
    return model.to({"float32": torch.float32,
                     "bfloat16": torch.bfloat16}[compute_dtype])


@pytest.mark.parametrize("variant", ["gaugan", "gaugan_no_kl", "cnn_spade"])
def test_generate(rng, gaugan_params, variant):
    """``_generate``: encoder -> the variant's latent -> generator.  The
    gaugan draw is JAX's own (``sample_latent``'s normal from the same
    key), handed to the port as ``eps``."""
    src = _source(rng)
    key = jax.random.PRNGKey(3)
    fake, _, _ = _trainer(variant)._generate(gaugan_params, jnp.asarray(src),
                                             key)
    eps = np.asarray(jax.random.normal(key, (2, 16), jnp.float32))
    got = _port(variant, gaugan_params)(nchw(src),
                                        eps=torch.tensor(eps))
    np.testing.assert_allclose(nhwc(got), np.asarray(fake),
                               rtol=RTOL, atol=NET_ATOL)


def test_generate_bf16(rng, gaugan_params):
    """bf16 compute with float32 SPADE statistics, the production mode.  The
    frameworks round at different places, and bf16 keeps 8 significant
    bits: on these inputs JAX's own bf16 output lies up to 9% (mean 1.3%) of
    the output range from its float32 output.  Bound: the port's bf16 output
    within 10% (mean 1%) of the range from JAX's bf16 output, and no further
    from the float32 output than 1.5x JAX's bf16 output is."""
    src = _source(rng)
    want = np.asarray(_trainer("cnn_spade", "bfloat16")._generate(
        gaugan_params, jnp.asarray(src).astype(jnp.bfloat16), None)[0])
    ref = np.asarray(_trainer("cnn_spade")._generate(
        gaugan_params, jnp.asarray(src), None)[0])
    got = nhwc(_port("cnn_spade", gaugan_params, "bfloat16")(
        nchw(src).to(torch.bfloat16)))
    assert got.dtype == np.float32
    span = ref.max() - ref.min()
    err = np.abs(got - want)
    assert err.max() < 0.10 * span and err.mean() < 0.01 * span
    assert np.abs(got - ref).mean() < 1.5 * np.abs(want - ref).mean()


def test_converter_is_strict(gaugan_params):
    state = convert_params(gaugan_params)
    model = GauGAN(ModelConfig(**SMALL))
    assert set(state) == set(model.state_dict())
    assert not any(k.startswith("discriminator") for k in state)
    missing = {k: v for k, v in gaugan_params.items() if k != "generator"}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_params(model, missing)
    extra = dict(gaugan_params, extra={"head": {"bias": np.zeros(1)}})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_params(model, extra)


def test_npz_roundtrip(tmp_path, rng, gaugan_params):
    path = str(tmp_path / "w.npz")
    save_npz(path, gaugan_params)
    a = _port("cnn_spade", gaugan_params)
    b = _port("cnn_spade", path)
    src = nchw(_source(rng))
    torch.testing.assert_close(a(src), b(src), rtol=0, atol=0)


def test_glorot_init_matches_flax_scales():
    gen = torch.Generator().manual_seed(0)
    model = tl.init_params(GauGAN(ModelConfig(**SMALL)), gen)
    w = model.generator.resblock_0.conv_1.weight        # 64 -> 64, 3x3
    limit = np.sqrt(6.0 / (2 * 64 * 9))
    assert float(w.abs().max()) <= limit
    assert abs(float(w.std()) - limit / np.sqrt(3)) < 0.05 * limit
    d = model.encoder.down_2.conv.weight                # glorot normal
    std = np.sqrt(2.0 / ((16 + 32) * 9))
    assert abs(float(d.std()) - std) < 0.1 * std
    assert float(d.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(model.encoder.down_1.norm.scale.min()) == 1.0
    assert float(model.generator.resblock_0.conv_1.bias.abs().max()) == 0.0
    again = tl.init_params(GauGAN(ModelConfig(**SMALL)),
                           torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.generator.head.weight,
                               model.generator.head.weight, rtol=0, atol=0)


def _flat_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_export_params_inverts_the_converter(gaugan_params):
    """export_params(load_params(model, tree)) is the flattened tree, key
    for key and bit for bit."""
    model = load_params(GauGAN(ModelConfig(**SMALL)), gaugan_params)
    _flat_equal(export_params(model), flatten_tree(gaugan_params))


def test_export_script_reads_an_orbax_checkpoint(tmp_path, gaugan_params):
    """scripts/export_params_npz.py on an Orbax checkpoint gives an .npz
    that load_model_fn loads with strict=True, weights unchanged."""
    import importlib.util
    import os

    from moonsuperresolution_tpu.utils.checkpoint import save_params
    from moonsuperresolution_tpu_torch.infer.engine import load_model_fn

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "export_params_npz",
        os.path.join(root, "scripts", "export_params_npz.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    ckpt, npz = str(tmp_path / "ckpt"), str(tmp_path / "w.npz")
    save_params(ckpt, gaugan_params)
    script.main([ckpt, npz])
    kw = {k: v for k, v in SMALL.items() if k != "image_size"}
    model = load_model_fn(npz, "gaugan", 64, compute_dtype="float32",
                          device="cpu", **kw)
    _flat_equal(export_params(model), flatten_tree(gaugan_params))
