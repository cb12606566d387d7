"""Data- and tensor-parallel train steps of the port, in gloo processes on
the CPU, against the JAX trainer's single-device step and the port's own
single-process step, from the same weights, batch and latent draws.

A small gaugan (image 64, latent 16, plan 32-32-32-16-16-8, widths 8) at
global batch 8 takes one step:

- in 2 processes, DP 2 x 1 (4 rows each);
- in 4 processes, DP 2 x TP 2 with ``min_dim`` 16, so that the first five
  blocks and the latent dense are tensor-parallel.

The draws are JAX's for the global batch (each process takes its rows).
Metrics are held to JAX's at rtol 2e-3 / atol 1e-4 (the bound of the JAX
package's own DP test, tests/test_sharding.py:96-97) and to the port's
single-process step at rtol 1e-4 (tests/test_torch_train.py's bound).
The gradients, averaged over the data axis and gathered whole, are held to
JAX's at 1e-4 |g| + 1e-3 max|g|, and the updated weights to the Adam-step
bound of tests/test_torch_train.py (``check_updates``): each update is
Adam's first step of the port's own gradient, and JAX's (and the
single-process port's) lies within 1e-5 of the step of a gradient within
that bound.
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
from tests.test_torch_pix2pix import group_max
from tests.test_torch_train import (
    keep_grads,
    keras_adam_first_step,
    nchw,
    nest,
)
from tests.torch_dist_cases import launch

torch.set_num_threads(2)

BATCH = 8
DP_RTOL, DP_ATOL = 2e-3, 1e-4      # tests/test_sharding.py:96-97
METRIC_RTOL = 1e-4                 # tests/test_torch_train.py
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3
OWN_ATOL, PARAM_ATOL = 5e-7, 1e-5  # tests/test_torch_train.py
MODEL = dict(image_size=64, latent_dim=16,
             channel_plan=(32, 32, 32, 16, 16, 8), encoder_filters=8,
             disc_filters=8)


def port_cfg(variant, batch=BATCH, **model):
    return TrainConfig(model=ModelConfig(variant=variant, **{**MODEL,
                                                              **model}),
                       batch_size=batch)


def start_weights(cfg, seed=0):
    """The port's initial weights with every bias and scale moved off its
    init value (as tests/test_torch_train.py makes them), flat JAX
    layout."""
    tr = make_trainer(cfg, device="cpu")
    tr.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in tr.nets.named_parameters():
            if name.endswith(("bias", "scale")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return export_params(tr.nets)


def batch(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 0.5, (BATCH, 64, 64, 2)).astype(np.float32)
    tgt = (rng.standard_normal((BATCH, 64, 64, 1)) * 0.2).astype(np.float32)
    return src, tgt


def jax_gaugan_step(variant, flat, vgg, src, tgt, key, **model):
    """The JAX trainer's jitted step: new weights, metrics and both
    phases' gradients (flat), and the step's eps draws."""
    jtr = jmake(JTrainConfig(model=JModelConfig(variant=variant,
                                                **{**MODEL, **model}),
                             batch_size=BATCH),
                vgg_params=nest(export_params(vgg)))
    jtr.gen_tx = optax.chain(keep_grads(), jtr.gen_tx)
    jtr.disc_tx = optax.chain(keep_grads(), jtr.disc_tx)
    params = nest(flat)
    state = TrainState(
        params=params,
        gen_opt_state=jtr.gen_tx.init({"generator": params["generator"],
                                       "encoder": params["encoder"]}),
        disc_opt_state=(jtr.disc_tx.init(params["discriminator"])
                        if "discriminator" in params else ()),
        step=jnp.zeros((), jnp.int32))
    new, metrics, _ = jtr.train_step(state, jnp.asarray(src),
                                     jnp.asarray(tgt), key)
    grads = flatten_tree(jax.device_get(new.gen_opt_state[0]))
    if "discriminator" in params:
        grads.update(flatten_tree(
            {"discriminator": jax.device_get(new.disc_opt_state[0])}))
    k_d, k_g = jax.random.split(key)
    latent = model.get("latent_dim", MODEL["latent_dim"])
    eps = [torch.tensor(np.asarray(jax.random.normal(k, (BATCH, latent))))
           for k in (k_d, k_g)]
    return dict(weights=flatten_tree(jax.device_get(new.params)),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=grads, eps_d=eps[0], eps_g=eps[1])


def run_mesh(tmp_path, cfg, flat, src, tgt, draws, mesh, min_dim=512,
             vgg=None):
    """One step of the port on ``mesh`` (world = its size); rank 0's
    metrics, and its whole weights and gradients in the JAX layout."""
    weights = make_trainer(cfg, device="cpu").nets
    load_params(weights, flat)
    torch.save(dict(cfg=cfg, weights=weights.state_dict(), vgg=vgg,
                    src=nchw(src), tgt=nchw(tgt), draws=draws, mesh=mesh,
                    min_dim=min_dim), tmp_path / "in.pt")
    outs = launch("train_step", mesh[0] * mesh[1], tmp_path)
    for o in outs[1:]:      # every process reports the global losses
        assert o["metrics"] == outs[0]["metrics"]
    o = outs[0]
    return (o["metrics"], layout32(o["weights"]), layout32(o["grads"]),
            o["sharded"])


def layout32(state: dict) -> dict:
    """``jax_layout`` of a state dict, kept in float32 (each update is a
    float32 difference, exact between nearby floats)."""
    out = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        a = t.detach().numpy()
        out["/".join(path + ["kernel" if leaf == "weight" else leaf])] = (
            a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T)
    return out


def within(got, want, rtol, atol, what):
    """``|got - want| <= atol + rtol |want|`` everywhere (the test of
    ``np.testing.assert_allclose``, without its cost on millions of
    elements)."""
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {bad.size} "
                           f"elements off, worst {np.abs(got - want).max()}")


def hold(metrics, weights, grads, want, flat, single, opt):
    """The checks of the module docstring; ``single``: the port's
    single-process (metrics, weights).  The updates as
    tests/test_torch_pix2pix.py's ``check_updates`` holds them: the port's
    is Adam's first step (any beta1) of its own gradient, the other
    side's within ``PARAM_ATOL`` of the step of a gradient within the
    gradient bound of it."""
    assert set(metrics) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=DP_RTOL, atol=DP_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(metrics[k], single[0][k],
                                   rtol=METRIC_RTOL, err_msg=k)
    assert set(grads) == set(want["grads"]) == set(flat)
    gmax = group_max(want["grads"])
    for k, g in grads.items():
        group = k.split("/")[0]
        within(g, want["grads"][k], GRAD_RTOL, GRAD_ATOL * gmax[group], k)
        lr = opt.disc_lr if group == "discriminator" else opt.gen_lr
        s = flat[k]
        u = weights[k] - s
        within(u, keras_adam_first_step(g, lr), 0, OWN_ATOL, f"{k} update")
        d = GRAD_RTOL * np.abs(g) + GRAD_ATOL * gmax[group]
        lo = keras_adam_first_step(g + d, lr) - PARAM_ATOL
        hi = keras_adam_first_step(g - d, lr) + PARAM_ATOL
        for side, other in (("JAX", want["weights"]), ("single", single[1])):
            uo = other[k] - s
            assert ((lo <= uo) & (uo <= hi)).all(), f"{k}: {side} update"
    for group in gmax:      # every network moved, on every side
        for side in (weights, want["weights"], single[1]):
            assert max(float(np.abs(side[k] - flat[k]).max())
                       for k in flat if k.startswith(group + "/")) > 1e-5


@pytest.fixture(scope="module")
def gaugan():
    """Weights, VGG, batch, JAX's step and the port's single-process
    step."""
    cfg = port_cfg("gaugan")
    flat = start_weights(cfg)
    vgg = init_vgg(torch.Generator().manual_seed(2))
    src, tgt = batch()
    want = jax_gaugan_step("gaugan", flat, vgg, src, tgt,
                           jax.random.PRNGKey(3))
    tr = make_trainer(cfg, vgg=vgg, device="cpu")
    load_params(tr.nets, flat)
    m, _ = tr.train_step(nchw(src), nchw(tgt), eps_d=want["eps_d"],
                         eps_g=want["eps_g"])
    single = ({k: float(v) for k, v in m.items()}, export_params(tr.nets))
    return cfg, flat, vgg, src, tgt, want, single


@pytest.mark.parametrize("mesh,min_dim", [((2, 1), 512), ((2, 2), 16)],
                         ids=["dp2", "dp2xtp2"])
def test_gaugan_step_on_a_mesh_matches_jax(tmp_path, gaugan, mesh, min_dim):
    cfg, flat, vgg, src, tgt, want, single = gaugan
    draws = {"eps_d": want["eps_d"], "eps_g": want["eps_g"]}
    metrics, weights, grads, sharded = run_mesh(
        tmp_path, cfg, flat, src, tgt, draws, mesh, min_dim, vgg)
    if mesh[1] > 1:
        assert len(sharded) == 12 and sharded["generator.dense.weight"] == 1
        assert "generator.resblock_5.conv_1.weight" not in sharded
    else:
        assert not sharded
    hold(metrics, weights, grads, want, flat, single, cfg.optimizer)
