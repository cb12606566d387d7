"""One ``train_step`` of the port's GauGAN trainer against the JAX trainer,
per variant.

Both start from the same weights (made by the port, every bias and scale
moved off its init value, carried to JAX by ``export_params``), the same
VGG19 features, the same batch and the same latent noise (JAX's draws of
the step's split keys, handed to the port as ``eps_d``/``eps_g``).  The
metrics are held to rtol 1e-4.

The gradients are held first: JAX's, of both phases, come out of its own
jitted step (each optimizer is chained behind a transform that keeps the
gradient it is given in its state), and the port's ``.grad`` of each group
is held to them at 1e-4 |g| + 1e-3 max|g| (max over the group; measured
worst 1.8e-4 max|g|, cnn_spade's encoder, 0.16 of the bound; a gradient
1.5 times too large fails it, where the update checks below still pass).

The updated parameters cannot all be held to one absolute bound: with
beta1 = 0 Adam's first update is -lr g / (|g| + 1e-7), about lr times the
sign of g, so an element whose gradient lies within float32 noise of zero
moves by +lr in one framework and -lr in the other (at batch 4, up to 127
of the generator's 1.6 M elements differ by more than 1e-5, by up to
1.3e-4).  So each element is held so: the port's update is Keras Adam's
step of the port's own gradient (atol 5e-7), and JAX's update lies within
1e-5 of Adam's step of some gradient within the bound above of the port's.

Batch 4, not 2: at image 64 the generator's first SPADE takes batch moments
over one pixel per sample, and over two samples they amplify float32 noise
about fifty-fold (the fake differed by 1.8e-4 at batch 2, 1.3e-6 at 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moonsuperresolution_tpu.config import ModelConfig as JModelConfig
from moonsuperresolution_tpu.config import TrainConfig as JTrainConfig
from moonsuperresolution_tpu.train.trainers import TrainState
from moonsuperresolution_tpu.train.trainers import make_trainer as jmake
from moonsuperresolution_tpu_torch.config import ModelConfig, TrainConfig
from moonsuperresolution_tpu_torch.models.vgg import init_vgg
from moonsuperresolution_tpu_torch.train.trainers import make_trainer
from moonsuperresolution_tpu_torch.utils.convert import (
    export_params,
    flatten_tree,
    load_params,
)

torch.set_num_threads(2)

SMALL = dict(image_size=64, latent_dim=16,
             channel_plan=(64, 64, 32, 32, 16, 8), encoder_filters=8,
             disc_filters=8)
BATCH = 4
METRIC_RTOL = 1e-4
FAKE_ATOL = 3e-5      # whole-model bound of tests/test_torch_models.py
PARAM_ATOL = 1e-5
OWN_ATOL = 5e-7       # float32 rounding of p + u for |p| up to ~2
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3


def nest(flat):
    """{"a/b/c": v} -> {"a": {"b": {"c": jnp v}}}."""
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def port_cfg(variant, **kw):
    return TrainConfig(model=ModelConfig(variant=variant, **SMALL, **kw),
                       batch_size=BATCH)


@pytest.fixture(scope="module")
def shared():
    """Weights of all three networks, the VGG19 and a batch."""
    tr = make_trainer(port_cfg("gaugan"), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in tr.nets.named_parameters():
            if name.endswith(("bias", "scale")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    vgg = init_vgg(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(0)
    src = rng.uniform(-0.5, 0.5, (BATCH, 64, 64, 2)).astype(np.float32)
    tgt = (rng.standard_normal((BATCH, 64, 64, 1)) * 0.2).astype(np.float32)
    return export_params(tr.nets), vgg, src, tgt


def keep_grads():
    """An optax transform that passes the gradient on unchanged and keeps
    it as its state: chained before Adam, the new state holds the step's
    gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def jax_step(variant, flat, vgg, src, tgt, key):
    """The JAX trainer's jitted step from the given weights: the new
    parameters, the metrics, the fake, the step and the gradients of both
    phases (flat, "/"-keyed)."""
    jtr = jmake(JTrainConfig(model=JModelConfig(variant=variant, **SMALL),
                             batch_size=BATCH),
                vgg_params=nest(export_params(vgg)))
    jtr.gen_tx = optax.chain(keep_grads(), jtr.gen_tx)
    jtr.disc_tx = optax.chain(keep_grads(), jtr.disc_tx)
    params = nest(flat)
    ge = {"generator": params["generator"], "encoder": params["encoder"]}
    state = TrainState(
        params=params, gen_opt_state=jtr.gen_tx.init(ge),
        disc_opt_state=(jtr.disc_tx.init(params["discriminator"])
                        if "discriminator" in params else ()),
        step=jnp.zeros((), jnp.int32))
    new, metrics, fake = jtr.train_step(state, jnp.asarray(src),
                                        jnp.asarray(tgt), key)
    grads = flatten_tree(jax.device_get(new.gen_opt_state[0]))
    if "discriminator" in params:
        grads.update(flatten_tree(
            {"discriminator": jax.device_get(new.disc_opt_state[0])}))
    return (flatten_tree(jax.device_get(new.params)),
            {k: float(v) for k, v in metrics.items()}, np.asarray(fake),
            int(new.step), grads)


def jax_layout(name, t):
    """A port parameter (or gradient) name and tensor -> the JAX key and
    float64 array."""
    *path, leaf = name.split(".")
    a = t.detach().double().numpy()
    a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    return "/".join(path + ["kernel" if leaf == "weight" else leaf]), a


def keras_adam_first_step(g, lr, eps=1e-7):
    """Adam's first update with beta1 = 0: m = g, v = g^2."""
    return -lr * g / (np.abs(g) + eps)


@pytest.mark.parametrize("variant", ["gaugan", "gaugan_no_kl", "cnn_spade"])
def test_train_step_matches_jax(shared, variant):
    flat, vgg, src, tgt = shared
    if variant == "cnn_spade":
        flat = {k: v for k, v in flat.items()
                if not k.startswith("discriminator/")}
    key = jax.random.PRNGKey(3)
    want_params, want, want_fake, want_step, want_grads = jax_step(
        variant, flat, vgg, src, tgt, key)
    k_d, k_g = jax.random.split(key)
    eps_d, eps_g = (torch.tensor(np.asarray(
        jax.random.normal(k, (BATCH, 16), jnp.float32))) for k in (k_d, k_g))

    tr = make_trainer(port_cfg(variant), vgg=vgg, device="cpu")
    load_params(tr.nets, flat)
    metrics, fake = tr.train_step(nchw(src), nchw(tgt), eps_d=eps_d,
                                  eps_g=eps_g)

    assert tr.step == want_step == 1
    assert set(metrics) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=METRIC_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(np.moveaxis(fake.numpy(), 1, -1), want_fake,
                               rtol=METRIC_RTOL, atol=FAKE_ATOL)

    # The gradients (in .grad: the discriminator's from its phase, the
    # others' from the generator phase) against JAX's.
    got = export_params(tr.nets)
    assert set(got) == set(want_params) == set(want_grads)
    grads = dict(jax_layout(n, p.grad) for n, p in tr.nets.named_parameters())
    gmax = {}
    for k, g in want_grads.items():
        group = k.split("/")[0]
        gmax[group] = max(gmax.get(group, 0.0), float(np.abs(g).max()))
    for k, g in grads.items():
        np.testing.assert_allclose(
            g, want_grads[k], rtol=GRAD_RTOL,
            atol=GRAD_ATOL * gmax[k.split("/")[0]], err_msg=k)

    # Each framework's update against the Keras Adam step of the port's own
    # gradient.
    o = tr.cfg.optimizer
    for k, g in grads.items():
        lr = o.disc_lr if k.startswith("discriminator/") else o.gen_lr
        u_port = got[k].astype(np.float64) - flat[k]
        u_jax = want_params[k].astype(np.float64) - flat[k]
        np.testing.assert_allclose(u_port, keras_adam_first_step(g, lr),
                                   rtol=0, atol=OWN_ATOL, err_msg=k)
        d = GRAD_RTOL * np.abs(g) + GRAD_ATOL * gmax[k.split("/")[0]]
        lo = keras_adam_first_step(g + d, lr) - PARAM_ATOL
        hi = keras_adam_first_step(g - d, lr) + PARAM_ATOL
        assert ((lo <= u_jax) & (u_jax <= hi)).all(), k
    for g in gmax:     # every group moved, on both sides
        for side in (want_params, got):
            assert max(float(np.abs(side[k] - flat[k]).max())
                       for k in flat if k.startswith(g + "/")) > 1e-5, g
