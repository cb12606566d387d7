"""The port's Keras / TF SavedModel import (utils/checkpoint.py) against the
JAX package's, and the reference's Keras models against the port's
forwards; ``moonsr-torch-convert-vgg`` against the JAX converter.

- The five ``*_params_from_weights`` builders return JAX's trees exactly
  on the same weight streams: numpy streams with Keras' auto-generated
  names in creation order, at full width (``tests/
  test_importer_adversarial.py``'s streams and three more built here).
- Streams with same-shape tensors swapped are rejected by both sides,
  with the same error.
- Live Keras models (``tests/test_keras_parity.py``'s builders, with
  random weights) -> the port's builders -> ``load_params`` -> the port's
  forward, against Keras' own, to rtol 1e-3 / atol 1e-4 (the JAX tests'
  bound; the full-width SPADE generator, whose JAX test holds it to 2e-3,
  too).
- A SavedModel checkpoint directory (``generator/``, ``encoder/``,
  ``discriminator/``) through ``import_tf_savedmodel``: the JAX tree.

This is the one port test file that imports TensorFlow.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from moonsuperresolution_tpu.cli.convert_vgg import (  # noqa: E402
    convert_torch_vgg19 as jax_convert_torch_vgg19,
)
from moonsuperresolution_tpu.utils import checkpoint as J  # noqa: E402
from moonsuperresolution_tpu_torch.cli import convert_vgg  # noqa: E402
from moonsuperresolution_tpu_torch.models.networks import (  # noqa: E402
    Encoder,
    SpadeDiscriminator,
    SpadeGenerator,
)
from moonsuperresolution_tpu_torch.models.pix2pix import (  # noqa: E402
    Pix2PixDiscriminator,
    Pix2PixGenerator,
)
from moonsuperresolution_tpu_torch.models.vgg import (  # noqa: E402
    load_vgg19,
    load_vgg19_npz,
)
from moonsuperresolution_tpu_torch.utils import checkpoint as P  # noqa: E402
from moonsuperresolution_tpu_torch.utils.convert import (  # noqa: E402
    flatten_tree,
    load_params,
)
from tests.test_importer_adversarial import (  # noqa: E402
    _encoder_stream,
    _generator_stream,
    _swap,
)
from tests.test_keras_parity import (  # noqa: E402
    IMG,
    LATENT,
    P2P_DEPTH,
    build_keras_discriminator,
    build_keras_encoder,
    build_keras_generator,
    build_keras_pix2pix_discriminator,
    build_keras_pix2pix_generator,
)

torch.set_num_threads(2)

KERAS = dict(rtol=1e-3, atol=1e-4)


def _stream(layers, seed):
    """(names, values) of ``layers``: (family, [(leaf, shape), ...]) in
    creation order, each layer under Keras' auto-name (``conv2d``,
    ``conv2d_1``, ...), random float32 values."""
    rng = np.random.default_rng(seed)
    made = {}
    names, values = [], []
    for family, leaves in layers:
        i = made.get(family, 0)
        made[family] = i + 1
        layer = f"{family}_{i}" if i else family
        for leaf, shape in leaves:
            names.append(f"model/{layer}/{leaf}")
            values.append(rng.standard_normal(shape).astype(np.float32))
    return names, values


def _conv(k, cin, cout, bias=True, family="conv2d"):
    leaves = [("kernel", (k, k, cin, cout))]
    return family, leaves + ([("bias", (cout,))] if bias else [])


def _bn(c):
    return "batch_normalization", [(leaf, (c,)) for leaf in (
        "gamma", "beta", "moving_mean", "moving_variance")]


def _disc_stream():
    """The reference's multi-scale discriminator (networks.py:60-76)."""
    layers = [_conv(4, 3, 64, bias=False)]
    for cin, cout in ((64, 128), (128, 256), (256, 512)):
        layers += [_conv(4, cin, cout, bias=False),
                   ("group_normalization", [("gamma", (cout,)),
                                            ("beta", (cout,))])]
    return _stream(layers + [_conv(4, 512, 1)], 2)


def _p2p_generator_stream(depth=8):
    """The reference's U-Net (pix2pix.py:88-108) at ``depth``."""
    ch = (64, 128, 256, 512, 512, 512, 512, 512)[:depth]
    layers, cin = [], 2
    for i, f in enumerate(ch):
        layers.append(_conv(4, cin, f, bias=False))
        if i:
            layers.append(_bn(f))
        cin = f
    for i in range(depth - 1):
        f = ch[depth - 2 - i]
        layers += [_conv(4, f, cin, bias=False, family="conv2d_transpose"),
                   _bn(f)]
        cin = 2 * f
    return _stream(layers + [_conv(4, 1, cin, family="conv2d_transpose")], 3)


def _p2p_discriminator_stream():
    layers = [_conv(4, 3, 64, bias=False), _conv(4, 64, 128, bias=False),
              _bn(128), _conv(4, 128, 256, bias=False), _bn(256),
              _conv(4, 256, 512, bias=False), _bn(512), _conv(4, 512, 1)]
    return _stream(layers, 4)


BUILDERS = {
    "encoder": ("encoder_params_from_weights", _encoder_stream),
    "generator": ("generator_params_from_weights", _generator_stream),
    "discriminator": ("discriminator_params_from_weights", _disc_stream),
    "pix2pix_generator": ("pix2pix_generator_params_from_weights",
                          _p2p_generator_stream),
    "pix2pix_discriminator": ("pix2pix_discriminator_params_from_weights",
                              _p2p_discriminator_stream),
}


@pytest.fixture(scope="module")
def streams():
    return {k: make() for k, (_, make) in BUILDERS.items()}


def assert_same_tree(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("kind", list(BUILDERS))
def test_builders_return_the_jax_tree(streams, kind):
    fn, _ = BUILDERS[kind]
    names, values = streams[kind]
    want = getattr(J, fn)(names, values)
    got = getattr(P, fn)(names, values)
    assert_same_tree(got, want)


def _stream_index(names, name):
    return next(i for i, n in enumerate(names) if n.endswith(name))


def _swapped(streams, kind, a, b, pairs=2):
    names, values = streams[kind]
    i, j = _stream_index(names, a), _stream_index(names, b)
    for k in range(pairs):
        names, values = _swap(names, values, i + k, j + k)
    return names, values


SHUFFLED = {
    # resblock_0's conv_1 and conv_2, both [3, 3, 1024, 1024]
    "generator_conv_swap": ("generator", "creation order",
                            lambda s: _swapped(s, "generator",
                                               "conv2d_6/kernel:0",
                                               "conv2d_7/kernel:0")),
    # spade_1's gamma against spade_2's
    "generator_spade_swap": ("generator", "creation order",
                             lambda s: _swapped(s, "generator",
                                                "conv2d_1/kernel:0",
                                                "conv2d_4/kernel:0")),
    # a Dense kernel against a conv kernel, names uninformative
    "generator_cross_ndim": ("generator", "unexpected weight",
                             lambda s: _swap([None] * len(s["generator"][0]),
                                             s["generator"][1], 0, 2)),
    # down_3's conv (256 -> 512) against down_4's (512 -> 512): the order
    # guard or the shape mismatch after it, loud either way
    "encoder_conv_swap": ("encoder", None,
                          lambda s: _swapped(s, "encoder",
                                             "conv2d_3/kernel:0",
                                             "conv2d_4/kernel:0", pairs=1)),
    # down_4's and down_5's convs, both [4, 4, 512, 512]
    "pix2pix_down_swap": ("pix2pix_generator", "creation order",
                          lambda s: _swapped(s, "pix2pix_generator",
                                             "conv2d_4/kernel",
                                             "conv2d_5/kernel", pairs=1)),
}


@pytest.mark.parametrize("case", list(SHUFFLED))
def test_shuffled_streams_fail_on_both_sides(streams, case):
    kind, match, make = SHUFFLED[case]
    names, values = make(streams)
    fn, _ = BUILDERS[kind]
    errors = []
    for side in (J, P):
        with pytest.raises(ValueError, match=match) as e:
            getattr(side, fn)(names, values)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ------------------------------------------------- live Keras models


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((2, IMG, IMG, 2)).astype(np.float32) * 0.3
    tgt = rng.standard_normal((2, IMG, IMG, 1)).astype(np.float32) * 0.3
    z = rng.standard_normal((2, LATENT)).astype(np.float32)
    return src, tgt, z


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _port(model, fn, keras_model, **kw):
    names, values = P._keras_ordered_weights(keras_model)
    return load_params(model, getattr(P, fn)(names, values, **kw)).eval()


def test_keras_encoder_forward(data):
    src, _, _ = data
    km = build_keras_encoder()
    k_mean, k_var = km(src)
    enc = _port(Encoder(IMG, LATENT), "encoder_params_from_weights", km)
    with torch.no_grad():
        mean, var = enc(nchw(src))
    np.testing.assert_allclose(mean.numpy(), k_mean.numpy(), **KERAS)
    np.testing.assert_allclose(var.numpy(), k_var.numpy(), **KERAS)


def test_keras_generator_forward(data):
    src, _, z = data
    km = build_keras_generator()
    want = km([z, src]).numpy()
    gen = _port(SpadeGenerator(IMG, LATENT), "generator_params_from_weights",
                km)
    with torch.no_grad():
        got = nhwc(gen(torch.from_numpy(z), nchw(src)))
    np.testing.assert_allclose(got, want, **KERAS)


def test_keras_discriminator_forward(data):
    src, tgt, _ = data
    km = build_keras_discriminator()
    want = [f.numpy() for f in km([src, tgt])]
    disc = _port(SpadeDiscriminator(), "discriminator_params_from_weights",
                 km)
    with torch.no_grad():
        got = disc(nchw(src), nchw(tgt))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), w, **KERAS)


def test_keras_pix2pix_forward(data):
    """The reference's U-Net and PatchGAN in Keras' training mode (batch
    statistics, which the reference always uses)."""
    src, tgt, _ = data
    kg = build_keras_pix2pix_generator()
    gen = _port(Pix2PixGenerator(P2P_DEPTH),
                "pix2pix_generator_params_from_weights", kg, depth=P2P_DEPTH)
    kd = build_keras_pix2pix_discriminator()
    disc = _port(Pix2PixDiscriminator(),
                 "pix2pix_discriminator_params_from_weights", kd)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(gen(nchw(src))),
                                   kg(src, training=True).numpy(), **KERAS)
        np.testing.assert_allclose(nhwc(disc(nchw(src), nchw(tgt))),
                                   kd([src, tgt], training=True).numpy(),
                                   **KERAS)


# ------------------------------------------------ SavedModel directory


def _save_stream(path, names, values):
    """A SavedModel whose variables are the stream, in its order."""
    root = tf.__internal__.tracking.AutoTrackable()
    root.variables = [tf.Variable(v, name=n.removeprefix("model/")
                                  .removesuffix(":0"))
                      for n, v in zip(names, values)]
    tf.saved_model.save(root, str(path))


def test_savedmodel_directory_imports_the_jax_tree(streams, data, tmp_path):
    """``generator/`` and ``discriminator/`` written from the streams,
    ``encoder/`` exported from a live Keras encoder: the port's
    ``import_tf_savedmodel`` gives JAX's tree, and the encoder it imports
    reproduces Keras' forward."""
    src, _, _ = data
    _save_stream(tmp_path / "generator", *streams["generator"])
    _save_stream(tmp_path / "discriminator", *streams["discriminator"])
    km = build_keras_encoder()
    km.export(str(tmp_path / "encoder"))
    got = P.import_tf_savedmodel(str(tmp_path))
    assert set(got) == {"generator", "encoder", "discriminator"}
    assert_same_tree(got, J.import_tf_savedmodel(str(tmp_path)))
    assert_same_tree(got["generator"], J.generator_params_from_weights(
        *streams["generator"]))
    assert set(P.import_tf_savedmodel(str(tmp_path),
                                      with_discriminator=False)) == {
        "generator", "encoder"}
    enc = load_params(Encoder(IMG, LATENT), got["encoder"]).eval()
    k_mean, k_var = km(src)
    with torch.no_grad():
        mean, var = enc(nchw(src))
    np.testing.assert_allclose(mean.numpy(), k_mean.numpy(), **KERAS)
    np.testing.assert_allclose(var.numpy(), k_var.numpy(), **KERAS)


# --------------------------------------------------------- convert_vgg


def test_convert_vgg_pth_matches_jax(tmp_path, capsys):
    """A torchvision-layout VGG19 state dict -> ``.npz``: the tree JAX's
    ``convert_torch_vgg19`` makes, in the file both packages read."""
    rng = np.random.default_rng(5)
    sd, idx = {}, 0
    cin = 3
    for n_convs, ch in ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512)):
        for _ in range(n_convs):
            sd[f"features.{idx}.weight"] = torch.from_numpy(
                rng.standard_normal((ch, cin, 3, 3)).astype(np.float32))
            sd[f"features.{idx}.bias"] = torch.from_numpy(
                rng.standard_normal(ch).astype(np.float32))
            cin = ch
            idx += 2
        idx += 1
    pth = str(tmp_path / "vgg19.pth")
    torch.save(sd, pth)
    out = str(tmp_path / "vgg19.npz")
    assert convert_vgg.main(["--input", pth, "--output", out]) == 0
    assert "16 conv layers" in capsys.readouterr().out
    want = jax_convert_torch_vgg19(pth)
    assert_same_tree(load_vgg19_npz(out), want)
    assert_same_tree(convert_vgg.convert_torch_vgg19(pth), want)
    with np.load(out) as f:
        assert set(f.files) == set(flatten_tree(want))
    load_vgg19(out)     # strict load into VGG19Features
