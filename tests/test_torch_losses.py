"""Parity of the port's losses, image gradients, box means, VGG19 perceptual
loss and discriminator with the JAX package's, on the same seeded inputs.

Elementwise functions and global reductions are held to rtol 1e-6 (the
sums run in another order), the feature-matching sum of four means over
16 K elements to 3e-6 (measured: 1.3e-6); the VGG19 loss and the
discriminator, convs deep, to the model-level bound of
tests/test_torch_models.py (rtol 1e-4, atol 3e-5).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonsuperresolution_tpu import losses as JL
from moonsuperresolution_tpu.models import networks as jn
from moonsuperresolution_tpu.models import vgg as jv
from moonsuperresolution_tpu.ops.gradients import image_gradients as j_grads
from moonsuperresolution_tpu.ops.resize import area_downscale as j_area
from moonsuperresolution_tpu_torch import losses as L
from moonsuperresolution_tpu_torch.config import ModelConfig, TrainConfig
from moonsuperresolution_tpu_torch.models import vgg
from moonsuperresolution_tpu_torch.models.layers import init_params
from moonsuperresolution_tpu_torch.models.networks import SpadeDiscriminator
from moonsuperresolution_tpu_torch.ops.gradients import image_gradients
from moonsuperresolution_tpu_torch.ops.resize import area_downscale
from moonsuperresolution_tpu_torch.train.trainers import make_trainer
from moonsuperresolution_tpu_torch.utils.convert import export_params

torch.set_num_threads(2)

RTOL = 1e-6
FEATURE_MATCHING_RTOL = 3e-6
NET_RTOL, NET_ATOL = 1e-4, 3e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def nest(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.fixture
def imgs(rng):
    return tuple((rng.standard_normal((2, 64, 64, 1)) * 0.2).astype(np.float32)
                 for _ in range(2))


def test_image_gradients(rng):
    x = rng.standard_normal((2, 13, 11, 3)).astype(np.float32)
    for got, want in zip(image_gradients(nchw(x)), j_grads(jnp.asarray(x))):
        np.testing.assert_array_equal(nhwc(got), np.asarray(want))


@pytest.mark.parametrize("factor", [2, 4, 16])
def test_area_downscale(rng, factor):
    x = rng.standard_normal((2, 64, 32, 3)).astype(np.float32)
    want = np.asarray(j_area(jnp.asarray(x), factor))
    np.testing.assert_allclose(nhwc(area_downscale(nchw(x), factor)), want,
                               rtol=RTOL, atol=1e-7)


def _pairs(rng, imgs):
    """name -> (port call, JAX call) on the same inputs (NCHW / NHWC)."""
    t, p = imgs
    logits = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
    labels = (rng.random((2, 6, 6, 1)) > 0.5).astype(np.float32)
    mean = rng.standard_normal((4, 16)).astype(np.float32)
    logvar = (rng.standard_normal((4, 16)) * 0.5).astype(np.float32)
    feats = [rng.standard_normal((2, s, s, c)).astype(np.float32)
             for s, c in ((32, 8), (16, 16), (8, 32), (8, 64), (5, 1))]
    feats2 = [f + 0.1 * rng.standard_normal(f.shape).astype(np.float32)
              for f in feats]
    crop_t, crop_p = (rng.standard_normal((2, 70, 75, 1)).astype(np.float32)
                      for _ in range(2))
    J, T = jnp.asarray, nchw
    return {
        "generator_hinge": (lambda: L.generator_hinge_loss(T(logits)),
                            lambda: JL.generator_hinge_loss(J(logits))),
        "disc_hinge_real": (
            lambda: L.discriminator_hinge_loss(T(logits), True),
            lambda: JL.discriminator_hinge_loss(J(logits), True)),
        "disc_hinge_fake": (
            lambda: L.discriminator_hinge_loss(T(logits), False),
            lambda: JL.discriminator_hinge_loss(J(logits), False)),
        "kl_divergence": (
            lambda: L.kl_divergence_loss(torch.tensor(mean),
                                         torch.tensor(logvar)),
            lambda: JL.kl_divergence_loss(J(mean), J(logvar))),
        "gradient": (lambda: L.gradient_loss(T(t), T(p)),
                     lambda: JL.gradient_loss(J(t), J(p))),
        "normal": (lambda: L.normal_loss(T(t), T(p)),
                   lambda: JL.normal_loss(J(t), J(p))),
        "consistency": (lambda: L.consistency_loss(T(t), T(p), 16),
                        lambda: JL.consistency_loss(J(t), J(p), 16)),
        "consistency_cropped": (
            lambda: L.consistency_loss(T(crop_t), T(crop_p), 16),
            lambda: JL.consistency_loss(J(crop_t), J(crop_p), 16)),
        "mse": (lambda: L.mse_loss(T(t), T(p)),
                lambda: JL.mse_loss(J(t), J(p))),
        "mae": (lambda: L.mae_loss(T(t), T(p)),
                lambda: JL.mae_loss(J(t), J(p))),
        "feature_matching": (
            lambda: L.feature_matching_loss([T(f) for f in feats],
                                            [T(f) for f in feats2]),
            lambda: JL.feature_matching_loss([J(f) for f in feats],
                                             [J(f) for f in feats2])),
        "bce_with_logits": (lambda: L.bce_with_logits(T(logits), T(labels)),
                            lambda: JL.bce_with_logits(J(logits), J(labels))),
        "pix2pix_generator": (
            lambda: L.pix2pix_generator_loss(T(logits), T(t), T(p), 100.0),
            lambda: JL.pix2pix_generator_loss(J(logits), J(t), J(p), 100.0)),
        "pix2pix_discriminator": (
            lambda: L.pix2pix_discriminator_loss(T(logits), T(-logits)),
            lambda: JL.pix2pix_discriminator_loss(J(logits), J(-logits))),
    }


LOSSES = ["generator_hinge", "disc_hinge_real", "disc_hinge_fake",
          "kl_divergence", "gradient", "normal", "consistency",
          "consistency_cropped", "mse", "mae", "feature_matching",
          "bce_with_logits", "pix2pix_generator", "pix2pix_discriminator"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(rng, imgs, name):
    port, ref = _pairs(rng, imgs)[name]
    got, want = port(), ref()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    rtol = FEATURE_MATCHING_RTOL if name == "feature_matching" else RTOL
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.ndim == 0
        np.testing.assert_allclose(float(g), float(w), rtol=rtol)


def test_kl_is_a_sum_not_a_mean(rng):
    """The reference reduces the KL term with reduce_sum
    (spade/losses.py:8-9): doubling the batch doubles it."""
    mean = torch.tensor(rng.standard_normal((2, 8)), dtype=torch.float32)
    logvar = torch.zeros_like(mean)
    one = L.kl_divergence_loss(mean, logvar)
    two = L.kl_divergence_loss(torch.cat([mean, mean]),
                               torch.cat([logvar, logvar]))
    np.testing.assert_allclose(float(two), 2 * float(one), rtol=RTOL)
    np.testing.assert_allclose(float(one), 0.5 * float((mean ** 2).sum()),
                               rtol=RTOL)


# ------------------------------------------------------------------- VGG19


@pytest.fixture(scope="module")
def vgg_pair():
    """A random VGG19 made by the port, and its tree in the JAX layout."""
    model = vgg.init_vgg(torch.Generator().manual_seed(0))
    return model, nest(export_params(model))


def test_vgg_preprocess(rng):
    x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(nhwc(vgg.vgg_preprocess(nchw(x))),
                               np.asarray(jv.vgg_preprocess(jnp.asarray(x))),
                               rtol=RTOL)


def test_vgg_loss_matches_jax(rng, vgg_pair):
    model, tree = vgg_pair
    t = rng.uniform(-0.5, 0.5, (2, 64, 64, 1)).astype(np.float32)
    p = t + 0.05 * rng.standard_normal(t.shape).astype(np.float32)
    want = jax.jit(jv.vgg_feature_matching_loss)(
        tree, jv.repeat3(jnp.asarray(t)), jv.repeat3(jnp.asarray(p)))
    got = vgg.vgg_feature_matching_loss(model, vgg.repeat3(nchw(t)),
                                        vgg.repeat3(nchw(p)))
    np.testing.assert_allclose(float(got), float(want), rtol=NET_RTOL)
    assert float(vgg.vgg_feature_matching_loss(
        model, vgg.repeat3(nchw(t)), vgg.repeat3(nchw(t)))) == 0.0


def test_vgg_features_match_jax(rng, vgg_pair):
    model, tree = vgg_pair
    x = rng.uniform(-50, 50, (1, 32, 32, 3)).astype(np.float32)
    want = jv.VGG19Features().apply({"params": tree}, jnp.asarray(x))
    got = model(nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=NET_RTOL,
                                   atol=NET_ATOL * float(np.abs(w).max()))


def test_vgg_loaders(tmp_path, vgg_pair):
    """The JAX package's .npz (save_vgg19_npz) and a Keras-layout .h5 load
    into the same weights."""
    import h5py

    model, tree = vgg_pair
    npz = str(tmp_path / "vgg.npz")
    jv.save_vgg19_npz(tree, npz)
    h5 = str(tmp_path / "vgg.h5")
    with h5py.File(h5, "w") as f:
        grp = f.create_group("model_weights")
        for name, p in tree.items():
            inner = grp.create_group(name).create_group(name)
            inner["kernel:0"] = np.asarray(p["kernel"])
            inner["bias:0"] = np.asarray(p["bias"])
    want = model.state_dict()
    for path in (npz, h5):
        got = vgg.load_vgg19(path)
        assert not any(p.requires_grad for p in got.parameters())
        for k, v in got.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    jax_h5 = jv.load_keras_vgg19_weights(h5)
    np.testing.assert_array_equal(np.asarray(jax_h5["block5_conv4"]["kernel"]),
                                  np.asarray(tree["block5_conv4"]["kernel"]))


def test_random_vgg_fallback_warns_and_is_seeded():
    cfg = TrainConfig(model=ModelConfig(variant="cnn_spade", image_size=64,
                                        latent_dim=16,
                                        channel_plan=(16,) * 6,
                                        encoder_filters=4),
                      batch_size=2, seed=3)
    with pytest.warns(UserWarning, match="FIXED-SEED RANDOM"):
        a = make_trainer(cfg, device="cpu").vgg
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = make_trainer(cfg, device="cpu").vgg
    w = a.block3_conv2.weight
    torch.testing.assert_close(w, b.block3_conv2.weight, rtol=0, atol=0)
    std = np.sqrt(1.0 / (256 * 9))     # lecun normal, as flax's nn.Conv
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6


# ------------------------------------------------------------ discriminator


@pytest.mark.parametrize("size", [64, 30])
def test_discriminator_matches_jax(rng, size):
    """Five float32 maps; down_3 is a stride-1 4x4 SAME conv (padding 1
    before, 2 after) and the head a 4x4 VALID conv."""
    disc = init_params(SpadeDiscriminator(8),
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in disc.named_parameters():
            if name.endswith(("bias", "scale")):
                p.add_(0.1 * torch.randn(p.shape))
    src = rng.uniform(-0.5, 0.5, (2, size, size, 2)).astype(np.float32)
    tgt = rng.uniform(-0.5, 0.5, (2, size, size, 1)).astype(np.float32)
    want = jn.SpadeDiscriminator(downsample_factor=8).apply(
        {"params": nest(export_params(disc))}, jnp.asarray(src),
        jnp.asarray(tgt))
    with torch.no_grad():
        got = disc(nchw(src), nchw(tgt))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and nhwc(g).shape == w.shape
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=NET_RTOL,
                                   atol=NET_ATOL)
