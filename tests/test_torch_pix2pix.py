"""The port's pix2pix (models/pix2pix.py, ``Pix2PixTrainer``) against the
JAX package's, on the CPU at the JAX tests' size (depth 6, image 64) and
batch 4.

Both sides start from the same weights: made by the port, every bias and
BatchNorm scale moved off its init value, carried to JAX by
``export_params``.  Dropout masks cannot match (threefry against torch's
generators), so JAX's are captured with ``flax.linen.intercept_methods``
around an eager ``generator.apply`` with the step's key (each
``nn.Dropout``'s output is 0 where dropped and twice its input where
kept) and handed to the port.  The JAX step applies the generator with
that same key in both of its gradient functions, so these are the step's
masks.

Forwards are held to rtol 1e-4 / atol 3e-5 (float32 sums in another
order), one train step's metrics to rtol 1e-4 and its gradients to
1e-4 |g| + 1e-3 max|g| (the bound of tests/test_torch_train.py).  Adam's
first update is about lr times the sign of g for any beta1, so an update is
held to Adam's step of the port's own gradient (atol 5e-7), and JAX's
update to within 1e-5 of Adam's step of a gradient within that bound.

Batch 4, not 2: the innermost Down's BatchNorm normalises a 1 x 1 map over
the batch alone, and over two samples its moments amplify float32 noise
(ROADMAP Queue 3).
"""

import dataclasses
import glob
import os
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from moonsuperresolution_tpu.config import RECIPES as JRECIPES
from moonsuperresolution_tpu.models.pix2pix import (
    Pix2PixDiscriminator as JDisc,
)
from moonsuperresolution_tpu.models.pix2pix import Pix2PixGenerator as JGen
from moonsuperresolution_tpu.train.trainers import (
    Pix2PixState,
    Pix2PixTrainer as JTrainer,
)
from moonsuperresolution_tpu_torch.cli import train as cli_train
from moonsuperresolution_tpu_torch.config import RECIPES
from moonsuperresolution_tpu_torch.infer.engine import load_model_fn
from moonsuperresolution_tpu_torch.models.pix2pix import (
    BN_EPSILON,
    BatchStatNorm,
    Pix2PixDiscriminator,
    Pix2PixGenerator,
    transpose_conv,
)
from moonsuperresolution_tpu_torch.train.trainers import (
    Pix2PixTrainer,
    make_trainer,
)
from moonsuperresolution_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    restore_params,
)
from moonsuperresolution_tpu_torch.utils.convert import (
    convert_params,
    export_params,
    flatten_tree,
    load_params,
    save_npz,
)
from tests.test_torch_train import (
    jax_layout,
    keep_grads,
    keras_adam_first_step,
    nchw,
    nest,
)

torch.set_num_threads(2)

DEPTH, IMG, BATCH = 6, 64, 4
FWD = dict(rtol=1e-4, atol=3e-5)
METRIC_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3
OWN_ATOL, PARAM_ATOL = 5e-7, 1e-5


def port_cfg(grad_accum=1, **model):
    c = RECIPES["pix2pix"]
    return dataclasses.replace(
        c, batch_size=BATCH, grad_accum=grad_accum,
        model=dataclasses.replace(c.model, image_size=IMG,
                                  pix2pix_depth=DEPTH, **model))


def jax_cfg(grad_accum=1):
    c = JRECIPES["pix2pix"]
    return dataclasses.replace(
        c, batch_size=BATCH, grad_accum=grad_accum,
        model=dataclasses.replace(c.model, image_size=IMG,
                                  pix2pix_depth=DEPTH))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


@pytest.fixture(scope="module")
def shared():
    """Weights of both networks and a batch."""
    tr = make_trainer(port_cfg(), device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in tr.nets.named_parameters():
            if name.endswith(("bias", "scale")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    rng = np.random.default_rng(0)
    src = rng.uniform(-0.5, 0.5, (BATCH, IMG, IMG, 2)).astype(np.float32)
    tgt = np.tanh(rng.standard_normal((BATCH, IMG, IMG, 1))
                  ).astype(np.float32)
    return export_params(tr.nets), src, tgt


def jax_masks(gen_params, src, key):
    """The dropout keep masks of ``JGen(DEPTH).apply`` with dropout ``key``,
    NCHW bool, in up-block order; checks that a kept element is twice its
    input."""
    seen = {}

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            seen[context.module.scope.path] = (np.asarray(args[0]),
                                               np.asarray(out))
        return out

    with fnn.intercept_methods(grab):
        JGen(depth=DEPTH).apply({"params": gen_params}, jnp.asarray(src),
                                False, rngs={"dropout": key})
    masks = []
    for path in sorted(seen):
        x, y = seen[path]
        keep = y != 0
        np.testing.assert_array_equal(y[keep], 2 * x[keep])
        masks.append(torch.from_numpy(np.moveaxis(keep, -1, 1).copy()))
    return masks


# ------------------------------------------------------------- modules


@pytest.mark.parametrize("train", [False, True], ids=["eval", "dropout"])
def test_generator_matches_flax(shared, train):
    flat, src, _ = shared
    params = nest(flat)["generator"]
    key = jax.random.PRNGKey(5)
    want = np.asarray(JGen(depth=DEPTH).apply(
        {"params": params}, jnp.asarray(src), not train,
        rngs={"dropout": key} if train else None))
    masks = jax_masks(params, src, key)
    assert all(0.4 < float(m.float().mean()) < 0.6 for m in masks)
    g = Pix2PixGenerator(DEPTH)
    load_params(g, {k[len("generator/"):]: v for k, v in flat.items()
                    if k.startswith("generator/")})
    assert g.dropout_shapes(BATCH, IMG) == [tuple(m.shape) for m in masks] \
        == [(BATCH, 512, 2, 2), (BATCH, 512, 4, 4), (BATCH, 256, 8, 8)]
    got = nhwc(g(nchw(src), train, masks))
    np.testing.assert_allclose(got, want, **FWD)


def test_discriminator_matches_flax(shared):
    flat, src, tgt = shared
    params = nest(flat)["discriminator"]
    want = np.asarray(JDisc().apply({"params": params}, jnp.asarray(src),
                                    jnp.asarray(tgt)))
    d = Pix2PixDiscriminator()
    load_params(d, {k[len("discriminator/"):]: v for k, v in flat.items()
                    if k.startswith("discriminator/")})
    got = nhwc(d(nchw(src), nchw(tgt)))
    assert got.shape == (BATCH, 6, 6, 1)
    np.testing.assert_allclose(got, want, **FWD)


def test_batch_stat_norm_is_not_batchnorm2d():
    """Batch statistics in every mode, biased variance, eps 1e-3: not
    ``nn.BatchNorm2d``'s eps 1e-5 (in training) or running statistics (in
    eval)."""
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    norm = BatchStatNorm(3).eval()
    mean = x.mean((0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean((0, 2, 3), keepdim=True)
    torch.testing.assert_close(norm(x), (x - mean) / torch.sqrt(
        var + BN_EPSILON), rtol=1e-6, atol=1e-6)
    bn = torch.nn.BatchNorm2d(3, affine=False)
    assert not torch.allclose(norm(x), bn.train()(x), atol=1e-5)
    assert not torch.allclose(norm(x), bn.eval()(x), atol=1e-2)
    assert not list(norm.buffers())


def test_depth_8_tree_loads_strictly():
    """The full-depth parameter tree of both flax modules at 256 px (through
    ``jax.eval_shape``, which compiles nothing) loads into the port with
    ``strict=True`` and is what ``export_params`` gives back; the
    discriminator's logit map at 256 is 30 x 30."""
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    src = jnp.zeros((1, 256, 256, 2))
    tgt = jnp.zeros((1, 256, 256, 1))
    shapes = {
        "generator": jax.eval_shape(JGen(depth=8).init, keys, src)["params"],
        "discriminator": jax.eval_shape(JDisc().init, keys["params"], src,
                                        tgt)["params"]}
    rng = np.random.default_rng(0)
    tree = flatten_tree(jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes))
    tr = make_trainer(RECIPES["pix2pix"], device="cpu")
    assert isinstance(tr, Pix2PixTrainer)
    load_params(tr.nets, tree)
    got = export_params(tr.nets)
    assert set(got) == set(tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with torch.no_grad():
        logits = tr.discriminator(torch.zeros(1, 2, 256, 256),
                                  torch.zeros(1, 1, 256, 256))
    assert logits.shape == (1, 1, 30, 30)


@pytest.mark.parametrize("size", [1, 4, 8])
def test_transposed_conv_is_convert_params_without_a_flip(size):
    """flax ``ConvTranspose(4, strides 2, "SAME", transpose_kernel=True)``
    equals ``nn.ConvTranspose2d(stride=2, padding=1)`` with the kernel that
    ``convert_params`` makes of the (kh, kw, out, in) one, no spatial flip;
    with a flip it does not."""
    rng = np.random.default_rng(size)
    cin, cout = 6, 5
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    k = rng.standard_normal((4, 4, cout, cin)).astype(np.float32)
    flax_deconv = fnn.ConvTranspose(cout, (4, 4), strides=(2, 2),
                                    padding="SAME", use_bias=False,
                                    transpose_kernel=True)
    want = np.asarray(flax_deconv.apply({"params": {"kernel": k}},
                                        jnp.asarray(x)))
    m = transpose_conv(cin, cout, bias=False)
    m.load_state_dict(convert_params({"kernel": k}), strict=True)
    got = nhwc(m(nchw(x)))
    assert got.shape == (2, 2 * size, 2 * size, cout)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    flipped = F.conv_transpose2d(nchw(x), m.weight.flip(2, 3), stride=2,
                                 padding=1)
    assert np.abs(nhwc(flipped) - want).max() > 0.1


# ---------------------------------------------------------- train step


def jax_trainer(grad_accum=1, keep=True):
    jtr = JTrainer(jax_cfg(grad_accum))
    if keep:
        import optax

        jtr.gen_tx = optax.chain(keep_grads(), jtr.gen_tx)
        jtr.disc_tx = optax.chain(keep_grads(), jtr.disc_tx)
    return jtr


def jax_state(jtr, flat):
    params = nest(flat)
    return Pix2PixState(
        params=params, gen_opt_state=jtr.gen_tx.init(params["generator"]),
        disc_opt_state=jtr.disc_tx.init(params["discriminator"]),
        step=jnp.zeros((), jnp.int32))


def port_grads(tr):
    return dict(jax_layout(n, p.grad) for n, p in tr.nets.named_parameters())


def group_max(grads):
    gmax = {}
    for k, g in grads.items():
        group = k.split("/")[0]
        gmax[group] = max(gmax.get(group, 0.0), float(np.abs(g).max()))
    return gmax


def check_updates(got, want, start, grads, gmax, opt):
    """Each framework's update against Adam's first step (any beta1) of
    the port's gradient: the port's within ``OWN_ATOL``, JAX's within
    ``PARAM_ATOL`` of the step of some gradient within the bound."""
    for k, g in grads.items():
        lr = opt.disc_lr if k.startswith("discriminator/") else opt.gen_lr
        u_port = got[k].astype(np.float64) - start[k]
        u_jax = want[k].astype(np.float64) - start[k]
        np.testing.assert_allclose(u_port, keras_adam_first_step(g, lr),
                                   rtol=0, atol=OWN_ATOL, err_msg=k)
        d = GRAD_RTOL * np.abs(g) + GRAD_ATOL * gmax[k.split("/")[0]]
        lo = keras_adam_first_step(g + d, lr) - PARAM_ATOL
        hi = keras_adam_first_step(g - d, lr) + PARAM_ATOL
        assert ((lo <= u_jax) & (u_jax <= hi)).all(), k
    for group in gmax:
        for side in (got, want):
            assert max(float(np.abs(side[k] - start[k]).max())
                       for k in start if k.startswith(group + "/")) > 1e-5


def test_train_step_matches_jax(shared):
    """Both gradients from one forward with the same masks, both Adams
    applied together: metrics, fake, gradients and updates against the JAX
    ``_train_step_impl``."""
    flat, src, tgt = shared
    jtr = jax_trainer()
    key = jax.random.PRNGKey(3)
    masks = jax_masks(nest(flat)["generator"], src, key)
    new, want, want_fake = jtr.train_step(
        jax_state(jtr, flat), jnp.asarray(src), jnp.asarray(tgt), key)
    want_grads = flatten_tree(jax.device_get(
        {"generator": new.gen_opt_state[0],
         "discriminator": new.disc_opt_state[0]}))

    tr = make_trainer(port_cfg(), device="cpu")
    load_params(tr.nets, flat)
    metrics, fake = tr.train_step(nchw(src), nchw(tgt), masks=masks)
    assert tr.step == int(new.step) == 1
    assert set(metrics) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=METRIC_RTOL, err_msg=k)
    np.testing.assert_allclose(nhwc(fake), np.asarray(want_fake), **FWD)

    grads = port_grads(tr)
    assert set(grads) == set(want_grads) == set(flat)
    gmax = group_max(want_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(
            g, want_grads[k], rtol=GRAD_RTOL,
            atol=GRAD_ATOL * gmax[k.split("/")[0]], err_msg=k)
    check_updates(export_params(tr.nets),
                  flatten_tree(jax.device_get(new.params)), flat, grads,
                  gmax, tr.cfg.optimizer)


def test_grad_accum_matches_optax_multisteps(shared):
    """``grad_accum=2``: nothing moves after the first micro-step, whose
    gradients equal optax.MultiSteps' accumulator; after the second, Adam
    applies once to the mean gradient on both sides."""
    flat, src, tgt = shared
    jtr = jax_trainer(grad_accum=2, keep=False)
    tr = make_trainer(port_cfg(grad_accum=2), device="cpu")
    load_params(tr.nets, flat)
    state = jax_state(jtr, flat)
    names = [jax_layout(n, p)[0] for n, p in tr.nets.named_parameters()]
    halves = [(src[::-1].copy(), tgt[::-1].copy()), (src, tgt)]
    for i, (s, t) in enumerate(halves):
        key = jax.random.PRNGKey(10 + i)
        masks = jax_masks(nest(flat)["generator"], s, key)
        state, want, _ = jtr.train_step(state, jnp.asarray(s),
                                        jnp.asarray(t), key)
        metrics, _ = tr.train_step(nchw(s), nchw(t), masks=masks)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=METRIC_RTOL, err_msg=k)
        if i == 0:
            got = export_params(tr.nets)
            for k in flat:
                np.testing.assert_array_equal(got[k], flat[k])
            acc = flatten_tree(jax.device_get(
                {"generator": state.gen_opt_state.acc_grads,
                 "discriminator": state.disc_opt_state.acc_grads}))
            n_gen = len(list(tr.generator.parameters()))
            port_acc = {}
            for j, name in enumerate(names):
                key_ = f"g{j}" if j < n_gen else f"d{j - n_gen}"
                port_acc[name] = jax_layout(name, tr.accum[key_])[1]
            gmax = group_max(acc)
            for k, g in port_acc.items():
                np.testing.assert_allclose(
                    g, acc[k], rtol=GRAD_RTOL,
                    atol=GRAD_ATOL * gmax[k.split("/")[0]], err_msg=k)
    assert tr.step == int(state.step) == 2 and not tr.accum
    grads = port_grads(tr)          # the mean, handed to Adam
    check_updates(export_params(tr.nets),
                  flatten_tree(jax.device_get(state.params)), flat, grads,
                  group_max(grads), tr.cfg.optimizer)


def test_validation_keeps_dropout_and_forward_drops_it(shared):
    """``val_step`` draws its masks from the given generator (the same seed,
    the same losses) and differs from ``forward``, which runs without
    dropout; neither moves a weight; bf16 compute changes nothing."""
    flat, src, tgt = shared
    tr = make_trainer(port_cfg(), device="cpu")
    load_params(tr.nets, flat)
    runs = [tr.val_step(nchw(src), nchw(tgt),
                        generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k]), k
    plain = tr.forward(nchw(src))
    assert not torch.allclose(runs[0][1], plain)
    np.testing.assert_allclose(
        nhwc(plain), np.asarray(JGen(depth=DEPTH).apply(
            {"params": nest(flat)["generator"]}, jnp.asarray(src), True)),
        **FWD)
    for k, v in export_params(tr.nets).items():
        np.testing.assert_array_equal(v, flat[k])
    bf16 = make_trainer(port_cfg(compute_dtype="bfloat16"), device="cpu")
    load_params(bf16.nets, flat)
    assert torch.equal(bf16.forward(nchw(src)), plain)


# ------------------------------------------------- loop, CLI and engine


def test_cli_trains_pix2pix_and_resumes(tmp_path):
    """``moonsr-torch-train --recipe pix2pix --small --synthetic --device
    cpu``: depth 6 at image 64, one epoch of 2 steps; the checkpoint
    restores into a fresh trainer bit for bit, ``epoch_0.pt`` holds both
    networks, and ``--resume`` goes on from step 2 to 4."""
    argv = ["--recipe", "pix2pix", "--small", "--synthetic", "--device",
            "cpu", "--no_log", "--max_steps_per_epoch", "2",
            "--batch_size", "4", "--output_path", str(tmp_path)]
    tr, history = cli_train.run(argv + ["--epochs", "1"])
    m = tr.cfg.model
    assert isinstance(tr, Pix2PixTrainer)
    assert (tr.step, m.pix2pix_depth, m.image_size) == (2, 6, 64)
    assert set(history[0]["train"]) == {"gen_loss", "gan_loss", "l1_loss",
                                        "disc_loss"}
    assert all(np.isfinite(v) for part in ("train", "val")
               for v in history[0][part].values())
    fresh = make_trainer(tr.cfg, device="cpu")
    gen = torch.Generator()
    assert restore_checkpoint(str(tmp_path / "checkpoints" / "latest.pt"),
                              fresh, gen) == 2
    saved = tr.nets.state_dict()
    for k, v in fresh.nets.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for opt in ("gen_opt", "disc_opt"):
        a = getattr(tr, opt).state_dict()["state"]
        b = getattr(fresh, opt).state_dict()["state"]
        assert all(torch.equal(v, b[i][k]) for i, st in a.items()
                   for k, v in st.items()), opt
    (weights,) = glob.glob(str(tmp_path / "models" / "*" / "epoch_0.pt"))
    groups = {k.split(".")[0] for k in restore_params(weights)}
    assert groups == {"generator", "discriminator"}

    tr2, history2 = cli_train.run(argv + ["--epochs", "2", "--resume"])
    assert tr2.step == 4 and [h["epoch"] for h in history2] == [1]


def test_load_model_fn_refuses_pix2pix(shared, tmp_path):
    """The map engine serves the GauGAN family, as the JAX engine does: a
    pix2pix kind raises a ValueError naming it instead of building a wrong
    model, with weights or without."""
    flat, _, _ = shared
    npz = str(tmp_path / "p2p.npz")
    save_npz(npz, flat)
    for path in (npz, ""):
        with pytest.raises(ValueError, match="pix2pix"):
            load_model_fn(path, "pix2pix", IMG, device="cpu")
    assert os.path.isfile(npz)


def test_small_flag_and_bf16_flag_for_pix2pix():
    """``--small`` is depth 6 at image 64; ``--bf16`` sets the config's
    compute dtype, which the pix2pix trainer does not read."""
    args = cli_train.parse(["--recipe", "pix2pix", "--small", "--bf16"])
    c = cli_train.config(args)
    assert (c.model.variant, c.model.pix2pix_depth, c.model.image_size,
            c.batch_size) == ("pix2pix", 6, 64, 64)
    assert cli_train.config(cli_train.parse(
        ["--recipe", "pix2pix"])).model.pix2pix_depth == 8
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_trainer(c, device="cpu")
