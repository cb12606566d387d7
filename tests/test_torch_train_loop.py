"""The port's trainer beyond one step against JAX: mixed precision, the
parameter tree, gradient accumulation, checkpoints, the loop with resume,
and the CLI, on the CPU at a small size; the loop from an HDF5 tile store
(the JAX loop's whole-epoch cadence and step count), and the epoch's
weights served by the map engine as the same weights' ``.npz`` are."""

import dataclasses
import glob
import os
import pickle
import sys
import warnings

import numpy as np
import pytest
import torch

from moonsuperresolution_tpu.data.h5_builder import tile_pair
from moonsuperresolution_tpu.data.sampler import TileSampler as JTileSampler
from moonsuperresolution_tpu.train.loop import (
    _steps_per_epoch as jax_steps_per_epoch,
)
from moonsuperresolution_tpu_torch.cli import train as cli_train
from moonsuperresolution_tpu_torch.config import (
    RECIPES,
    DataConfig,
    DSRConfig,
    ModelConfig,
    TrainConfig,
)
from moonsuperresolution_tpu_torch.data.hdf5 import H5Writer
from moonsuperresolution_tpu_torch.models.gaugan import GauGAN
from moonsuperresolution_tpu_torch.models.layers import init_params
from moonsuperresolution_tpu_torch.models.networks import SpadeDiscriminator
from moonsuperresolution_tpu_torch.models.vgg import init_vgg
from moonsuperresolution_tpu_torch.infer.engine import (
    DEMSuperResolution,
    load_model_fn,
)
from moonsuperresolution_tpu_torch.train.loop import TBLogger, train
from moonsuperresolution_tpu_torch.train.trainers import (
    Pix2PixTrainer,
    make_trainer,
)
from moonsuperresolution_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from moonsuperresolution_tpu_torch.utils.convert import (
    export_params,
    flatten_tree,
    load_params,
    save_npz,
)

torch.set_num_threads(2)

SMALL = dict(image_size=64, latent_dim=16,
             channel_plan=(64, 64, 32, 32, 16, 8), encoder_filters=8,
             disc_filters=8)


def cfg(variant="gaugan", batch=2, **kw):
    model = {k: kw.pop(k) for k in list(kw) if k in ModelConfig.__annotations__}
    return TrainConfig(model=ModelConfig(variant=variant, **SMALL, **model),
                       batch_size=batch, **kw)


@pytest.fixture(scope="module")
def vgg():
    return init_vgg(torch.Generator().manual_seed(0))


def trainer(vgg, seed=0, **kw):
    tr = make_trainer(cfg(**kw), vgg=vgg, device="cpu")
    return tr.init(torch.Generator().manual_seed(seed))


def batch(seed, b=2):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 0.5, (b, 2, 64, 64)).astype(np.float32)
    tgt = (rng.standard_normal((b, 1, 64, 64)) * 0.2).astype(np.float32)
    return torch.from_numpy(src), torch.from_numpy(tgt)


def state_equal(a, b):
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


# ------------------------------------------------------- mixed precision


def test_bf16_casts_are_the_identity_on_a_cast_model(rng):
    """A float32-held model computing in bf16 gives the bits of the same
    model cast to bf16 (the inference path), generator and discriminator."""
    mcfg = ModelConfig(variant="cnn_spade", compute_dtype="bfloat16", **{
        k: v for k, v in SMALL.items() if k != "disc_filters"})
    held = init_params(GauGAN(mcfg), torch.Generator().manual_seed(0))
    cast = GauGAN(mcfg)
    cast.load_state_dict(held.state_dict())
    cast = cast.to(torch.bfloat16)
    src = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 2, 64, 64)).astype(
        np.float32))
    with torch.no_grad():
        a = held(src.to(torch.bfloat16))
        b = cast(src.to(torch.bfloat16))
    assert all(p.dtype == torch.float32 for p in held.parameters())
    assert a.dtype == torch.float32 and torch.equal(a, b)

    disc = init_params(SpadeDiscriminator(8, dtype=torch.bfloat16),
                       torch.Generator().manual_seed(1))
    disc16 = SpadeDiscriminator(8, dtype=torch.bfloat16)
    disc16.load_state_dict(disc.state_dict())
    disc16 = disc16.to(torch.bfloat16)
    with torch.no_grad():
        for x, y in zip(disc(src, src[:, :1]), disc16(src, src[:, :1])):
            assert x.dtype == torch.float32 and torch.equal(x, y)


def test_bf16_training_close_to_fp32(vgg):
    """The bound of the JAX package's test_bf16_mixed_precision_close_to_
    fp32 (tests/test_trainers.py:286): forward within 0.05 mean abs of
    float32; a bf16 step has finite losses and float32 parameters."""
    tr32 = trainer(vgg, variant="cnn_spade")
    tr16 = make_trainer(cfg("cnn_spade", compute_dtype="bfloat16"), vgg=vgg,
                        device="cpu")
    tr16.nets.load_state_dict(tr32.nets.state_dict())
    src, tgt = batch(1)
    f32, f16 = tr32.forward(src), tr16.forward(src)
    assert f16.dtype == torch.float32
    assert float((f32 - f16).abs().mean()) < 0.05
    metrics, _ = tr16.train_step(src, tgt)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in tr16.nets.parameters())


# --------------------------------------------------------- parameter tree


def jax_trainer_tree():
    """A tree of the JAX GauGANTrainer.init's shapes (encoder, generator,
    discriminator), filled from a seed."""
    import jax

    from moonsuperresolution_tpu.config import ModelConfig as JModelConfig
    from moonsuperresolution_tpu.config import TrainConfig as JTrainConfig
    from moonsuperresolution_tpu.train.trainers import GauGANTrainer

    jtr = GauGANTrainer(JTrainConfig(model=JModelConfig(**SMALL),
                                     batch_size=2))
    shapes = jax.eval_shape(jtr.init, jax.random.PRNGKey(0)).params
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def test_jax_trainer_tree_loads_strictly():
    """The tree of the JAX GauGANTrainer.init (encoder, generator,
    discriminator) fills the port trainer's nets with strict=True, and
    export_params gives it back key for key, bit for bit."""
    tree = jax_trainer_tree()
    tr = make_trainer(cfg(), device="cpu")
    load_params(tr.nets, tree)
    got, want = export_params(tr.nets), flatten_tree(tree)
    assert set(got) == set(want)
    assert any(k.startswith("discriminator/") for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_load_model_fn_takes_a_training_tree(tmp_path):
    """An .npz of a training run's whole tree, discriminator included,
    loads for inference: the encoder and generator strictly and bit for
    bit, the discriminator left out; a generator key missing still fails."""
    flat = flatten_tree(jax_trainer_tree())
    path = str(tmp_path / "trained.npz")
    save_npz(path, flat)
    model = load_model_fn(path, "gaugan", 64, latent_dim=16,
                          compute_dtype="float32", device="cpu",
                          **{k: SMALL[k] for k in ("channel_plan",
                                                   "encoder_filters")})
    got = export_params(model)
    want = {k: v for k, v in flat.items()
            if not k.startswith("discriminator/")}
    assert set(got) == set(want) and len(want) < len(flat)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    del flat["generator/head/kernel"]
    save_npz(path, flat)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_model_fn(path, "gaugan", 64, latent_dim=16, device="cpu",
                      **{k: SMALL[k] for k in ("channel_plan",
                                               "encoder_filters")})


def test_normalised_biases_have_no_gradient(vgg):
    """The biases chip_smoke.py's ``normalised_biases`` names (its card
    against CPU check holds them apart) are exactly the generator biases
    whose gradient is rounding noise (below 1e-6 of the largest)."""
    from chip_smoke import normalised_biases

    tr = trainer(vgg, variant="cnn_spade")
    src, tgt = batch(2)
    tr.train_step(src, tgt)
    grads = {n: p.grad for n, p in tr.nets.named_parameters()}
    top = max(float(g.abs().max()) for g in grads.values())
    tiny = {n for n, g in grads.items()
            if n.startswith("generator.") and n.endswith("bias")
            and float(g.abs().max()) < 1e-6 * top}
    assert tiny == set(normalised_biases(tr.cfg.model))


# ----------------------------------------------------- gradient accumulation


def test_grad_accum_matches_double_batch(vgg):
    """bs 2 x grad_accum 2 lands on the parameters of one bs 4 step (the
    JAX package's tests/test_trainers.py:205): cnn_spade with instance
    statistics couples no samples, and SGD is linear in the gradient.  The
    parameters do not move after the first micro-step."""
    lr = 1e-3

    def sgd(tr):
        tr.gen_opt = torch.optim.SGD(tr.gen_params(), lr=lr)
        return tr

    big = sgd(trainer(vgg, variant="cnn_spade", batch=4,
                      spade_stats="instance"))
    acc = sgd(trainer(vgg, variant="cnn_spade", batch=2, grad_accum=2,
                      spade_stats="instance"))
    start = {k: v.clone() for k, v in acc.nets.state_dict().items()}
    src, tgt = batch(3, b=4)
    big.train_step(src, tgt)
    acc.train_step(src[:2], tgt[:2])
    state_equal(start, acc.nets.state_dict())
    assert acc.step == 1 and acc.accum
    acc.train_step(src[2:], tgt[2:])
    assert acc.step == 2 and not acc.accum
    want = big.nets.state_dict()
    for k, v in acc.nets.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-5, atol=1e-7)
    assert any(not torch.equal(v, start[k]) for k, v in want.items())


# ----------------------------------------------------------- checkpoints


def test_checkpoint_roundtrip(tmp_path, vgg):
    """The whole state (weights, both Adams, step, grad_accum's partial
    mean, the latent generator) restores bit for bit, and training goes on
    as if never stopped."""
    tr = trainer(vgg, grad_accum=2)
    gen = torch.Generator().manual_seed(5)
    steps = [batch(s) for s in range(4, 8)]
    for s, t in steps[:3]:              # 3 micro-steps: a partial cycle
        tr.train_step(s, t, generator=gen)
    path = str(tmp_path / "ckpt" / "latest.pt")
    save_checkpoint(path, tr, gen)

    other = trainer(vgg, seed=9, grad_accum=2)
    gen2 = torch.Generator()
    assert restore_checkpoint(path, other, gen2) == 3
    state_equal(tr.nets.state_dict(), other.nets.state_dict())
    for opt in ("gen_opt", "disc_opt"):
        a, b = getattr(tr, opt).state_dict(), getattr(other, opt).state_dict()
        assert a["param_groups"] == b["param_groups"]
        for i, st in a["state"].items():
            for k, v in st.items():
                assert torch.equal(v, b["state"][i][k]), (opt, i, k)
    assert set(tr.accum) == set(other.accum) and tr.accum
    assert torch.equal(gen.get_state(), gen2.get_state())

    m1, _ = tr.train_step(*steps[3], generator=gen)
    m2, _ = other.train_step(*steps[3], generator=gen2)
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    state_equal(tr.nets.state_dict(), other.nets.state_dict())


# --------------------------------------------------------- loop and CLI


def test_train_loop_and_resume(tmp_path, vgg):
    """Synthetic data, TensorBoard files under the reference's train/ and
    test/ writers, the resume checkpoint and per-epoch weights; a resumed
    run starts at the saved epoch and continues the step count."""
    c = cfg(epochs=1, output_path=str(tmp_path), seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the random-VGG warning
        tr, history = train(c, synthetic=True, max_steps_per_epoch=2,
                            log=True, device="cpu")
        assert tr.step == 2 and len(history) == 1
        assert {"disc_loss", "gen_loss", "kl_loss"} <= set(history[0]["train"])
        assert "gen_loss" in history[0]["val"]
        for part in ("train", "test"):
            assert glob.glob(str(tmp_path / "tensorboard" / "*" / part
                                 / "events*"))
        latest = tmp_path / "checkpoints" / "latest.pt"
        assert latest.is_file()
        (weights,) = glob.glob(str(tmp_path / "models" / "*" / "epoch_0.pt"))
        state_equal(tr.nets.state_dict(), restore_params(weights))

        tr2, history2 = train(cfg(epochs=2, output_path=str(tmp_path)),
                              resume=True, synthetic=True,
                              max_steps_per_epoch=2, log=False, device="cpu")
    assert tr2.step == 4 and [h["epoch"] for h in history2] == [1]


def test_cli_trains_on_the_cpu_when_asked(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr, history = cli_train.run([
            "--recipe", "cnn_256", "--synthetic", "--epochs", "1",
            "--max_steps_per_epoch", "1", "--batch_size", "2", "--bf16",
            "--output_path", str(tmp_path), "--device", "cpu", "--no_log",
            "--small"])
    m = tr.cfg.model
    assert (tr.step, tr.device.type, m.compute_dtype, m.image_size,
            m.channel_plan) == (1, "cpu", "bfloat16", 64, SMALL["channel_plan"])
    assert m.vgg_feature_loss_coeff == RECIPES["cnn_256"].model \
        .vgg_feature_loss_coeff
    assert np.isfinite(history[0]["train"]["total_loss"])
    assert not os.path.exists(tmp_path / "tensorboard")


def test_logging_without_tensorboardx_raises(tmp_path, monkeypatch):
    """Asked to log, the logger raises when tensorboardX is absent (as on
    the card's machine), and so does the CLI without --no_log."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(RuntimeError, match="tensorboardX"):
        TBLogger(str(tmp_path / "tb"))
    assert TBLogger(None).writer is None
    with pytest.raises(RuntimeError, match="--no_log"):
        cli_train.run(["--synthetic", "--small", "--device", "cpu",
                       "--output_path", str(tmp_path)])


@pytest.mark.parametrize("argv", [["--mesh", "2"], ["--mesh", "2,x"]])
def test_cli_refuses_multi_device_flags(argv):
    """The multi-device flags are taken (tests/test_torch_distributed*.py
    run them); a mesh that is not DATA,MODEL is refused."""
    with pytest.raises(SystemExit):
        cli_train.parse(["--synthetic", *argv])
    args = cli_train.parse(["--synthetic", "--mesh", "2,1", "--distributed",
                            "--num_processes", "2", "--process_id", "1"])
    assert (args.mesh, args.distributed, args.num_processes,
            args.process_id) == ((2, 1), True, 2, 1)
    assert cli_train.config(args).mesh_shape == (2, 1)


def test_pix2pix_and_datasets_wait_for_later_slices(tmp_path):
    """The pix2pix recipe gets its own trainer (tests/test_torch_pix2pix.py
    holds it to JAX's); a run from the store without its paths says which
    it needs."""
    tr = make_trainer(RECIPES["pix2pix"], device="cpu")
    assert isinstance(tr, Pix2PixTrainer)
    assert set(tr.nets) == {"generator", "discriminator"}
    assert tr.cfg.model.pix2pix_depth == 8
    with pytest.raises(ValueError, match="h5_path, train_pkl and val_pkl"):
        train(cfg(output_path=str(tmp_path)), synthetic=False, device="cpu")


# ------------------------------------------- training from the tile store


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A store written by the port (``tile_pair`` into ``H5Writer``): a
    1500 x 3000 pair, 2 x 5 tiles of 1000 px; 7 training keys, 3 for
    validation."""
    rng = np.random.default_rng(0)
    td = tmp_path_factory.mktemp("store")
    ort = (rng.random((1500, 3000)) * 255).astype(np.float32)
    dem = (rng.random((1500, 3000)) * 4000 - 2000).astype(np.float32)
    dct = {}
    with H5Writer(str(td / "tiles.hdf5")) as h5:
        tile_pair(ort, dem, "R", h5, dct)
    keys = list(dct)
    for name, part in (("train", keys[:7]), ("val", keys[7:])):
        with open(td / f"{name}.pkl", "wb") as f:
            pickle.dump({k: dct[k] for k in part}, f)
    return DataConfig(h5_path=str(td / "tiles.hdf5"),
                      train_pkl=str(td / "train.pkl"),
                      val_pkl=str(td / "val.pkl"))


@pytest.fixture(scope="module")
def trained(store, tmp_path_factory):
    """One epoch of a small gaugan from the store on the CPU, with
    ``max_steps_per_epoch=1``: (config, trainer, history, epoch_0.pt)."""
    out = tmp_path_factory.mktemp("run")
    c = dataclasses.replace(cfg(epochs=1, output_path=str(out), seed=0),
                            data=store)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the random-VGG warning
        tr, history = train(c, synthetic=False, max_steps_per_epoch=1,
                            log=False, device="cpu")
    (weights,) = glob.glob(str(out / "models" / "*" / "epoch_0.pt"))
    return c, tr, history, weights


def test_train_from_the_store_runs_whole_epochs(trained):
    """JAX's cadence on real data: the whole shuffled training set (7
    samples, 3 batches of 2, JAX's ``_steps_per_epoch``) and the whole
    validation set (one batch of 2), whatever ``max_steps_per_epoch`` (1
    here) says."""
    c, tr, history, weights = trained
    jax_sampler = JTileSampler(c.data.h5_path, c.data.train_pkl, hw=64)
    assert jax_steps_per_epoch(c, False, jax_sampler) == 3
    assert tr.step == 3 and len(history) == 1
    assert all(np.isfinite(v) for part in ("train", "val")
               for v in history[0][part].values())
    state_equal(tr.nets.state_dict(), restore_params(weights))


@pytest.mark.parametrize("quantize", ["none", "int8", "int8_static"])
def test_trained_epoch_serves_like_its_npz(trained, tmp_path, rng,
                                           quantize):
    """The loop's ``epoch_0.pt`` through ``load_model_fn`` and
    ``process_tile`` gives the tile that the same weights give through
    ``export_params`` and the ``.npz`` (the discriminator left out by
    both), in every quantize mode."""
    c, tr, _, weights = trained
    npz = str(tmp_path / "trained.npz")
    save_npz(npz, export_params(tr.nets))
    kw = dict(latent_dim=16, compute_dtype="float32", quantize=quantize,
              device="cpu", channel_plan=SMALL["channel_plan"],
              encoder_filters=SMALL["encoder_filters"])
    img = (rng.standard_normal((160, 160)) * 30 + 128).astype(np.float32)
    dem = (rng.standard_normal((160, 160)) * 40).astype(np.float32)
    tiles = []
    for path in (weights, npz):
        model = load_model_fn(path, "gaugan", 64, **kw)
        eng = DEMSuperResolution(
            DSRConfig(image_size=64, stride=32, tile_size=128, batch_size=8,
                      compute_dtype="float32"), model=model, device="cpu")
        eng.img, eng.dem, eng.dem_shape = img, dem, dem.shape
        eng.pad_inputs()
        tiles.append([t.numpy() for t in eng.process_tile(0, 0)])
    (mean, std, good), want = tiles
    cover = good > 0            # the tile's corner lies in the padding
    assert cover.mean() > 0.3 and np.isfinite(mean[cover]).all()
    for g, w in zip((mean, std, good), want):
        np.testing.assert_array_equal(g, w)


def test_train_from_the_store_refuses_an_epoch_without_a_batch(store,
                                                               tmp_path):
    """7 training samples cannot make a batch of 8: a ValueError naming
    both (the JAX loop fails with an IndexError after its empty epoch)."""
    c = dataclasses.replace(cfg(batch=8, output_path=str(tmp_path)),
                            data=store)
    with pytest.raises(ValueError, match="holds 7 training samples, fewer "
                                         "than one batch of 8"):
        train(c, synthetic=False, log=False, device="cpu")


def test_pix2pix_trains_from_the_store(store, tmp_path):
    """The pix2pix recipe (depth 6 at image 64) through ``train`` from the
    store: the whole epoch (3 batches of 2), finite losses, and an
    ``epoch_0.pt`` holding both networks as they ended."""
    c = dataclasses.replace(
        RECIPES["pix2pix"], batch_size=2, epochs=1, output_path=str(tmp_path),
        data=store, model=dataclasses.replace(
            RECIPES["pix2pix"].model, image_size=64, pix2pix_depth=6))
    tr, history = train(c, synthetic=False, log=False, device="cpu")
    assert isinstance(tr, Pix2PixTrainer) and tr.step == 3
    assert all(np.isfinite(v) for part in ("train", "val")
               for v in history[0][part].values())
    (weights,) = glob.glob(str(tmp_path / "models" / "*" / "epoch_0.pt"))
    state_equal(tr.nets.state_dict(), restore_params(weights))


def test_cli_trains_from_the_store(store, tmp_path):
    """``--path_h5/--path_trn/--path_val``, no ``--synthetic``: the console
    script returns 0, and ``run`` trains the whole epoch."""
    argv = ["--path_h5", store.h5_path, "--path_trn", store.train_pkl,
            "--path_val", store.val_pkl, "--small", "--device", "cpu",
            "--no_log", "--epochs", "1", "--batch_size", "2",
            "--output_path", str(tmp_path)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli_train.main(argv) == 0
        tr, history = cli_train.run(argv + ["--max_steps_per_epoch", "2"])
    assert tr.step == 3 and tr.cfg.data == store
