"""The port's multi-device layer (parallel/) on the CPU: the tensor-parallel
rule table against the JAX package's, the mesh in one process and across
processes, the moments of the global batch, the tile-parallel map engine,
and the profiles.

- Rule table: ``param_sharding_rules`` decides every parameter of the
  full-width GauGAN trainer (built on the meta device) as JAX's does for
  the same parameter of ``jax.eval_shape`` of its trainer's init, at model
  size 2 and 4, ``min_dim`` 512.
- Moments: SPADE's and pix2pix's BatchNorm over two gloo processes' rows
  against the same on the whole batch in one process, outputs and input
  gradients to 1e-6.
- Tile-parallel: the identity engine on a ``make_mesh((2, 1), devices=
  ["cpu", "cpu"])`` equals the port's serial map bit for bit, and JAX's
  ``process_map`` on its (8, 1) mesh and on one device as the port's
  serial map does (coverage equal, mean and std to atol 0.02 m: the
  bound of tests/test_torch_map.py, for the preprocessing's cubic
  upsample); JAX's two runs agree to TestShardedInference's atol 1e-5.  A
  small GauGAN, float32 and int8_static, tile-parallel equals its serial
  run bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from moonsuperresolution_tpu.config import TrainConfig as JTrainConfig
from moonsuperresolution_tpu.infer import DEMSuperResolution as JEngine
from moonsuperresolution_tpu.parallel import mesh as jmesh
from moonsuperresolution_tpu.train.trainers import GauGANTrainer as JTrainer
from moonsuperresolution_tpu_torch.config import (
    DSRConfig,
    ModelConfig,
    TrainConfig,
)
from moonsuperresolution_tpu_torch.infer.engine import (
    DEMSuperResolution,
    quantize_model,
)
from moonsuperresolution_tpu_torch.models.gaugan import GauGAN
from moonsuperresolution_tpu_torch.models.layers import init_params
from moonsuperresolution_tpu_torch.parallel.mesh import (
    make_mesh,
    param_sharding_rules,
    shard_batch,
    shard_state_for_dp_tp,
)
from moonsuperresolution_tpu_torch.train.loop import train
from moonsuperresolution_tpu_torch.train.trainers import make_trainer
from moonsuperresolution_tpu_torch.utils import profiling
from tests.test_torch_map import MAP, _cfgs, _synthetic_pair
from tests.torch_dist_cases import free_port, launch

torch.set_num_threads(2)


# ------------------------------------------------------------- rule table


def jax_path(name: str) -> str:
    *path, leaf = name.split(".")
    return "/".join(path + ["kernel" if leaf == "weight" else leaf])


def jax_decision(sharding, ndim: int) -> str:
    spec = tuple(sharding.spec)
    if not any(spec):
        return "replicate"
    spec = (None,) * (ndim - len(spec)) + spec
    if ndim == 2:       # the dense [in, out]: sharded over "in"
        assert spec == ("model", None), spec
        return "row"
    if spec[-1] == "model":
        return "column"
    assert spec[-2] == "model", spec
    return "row"


@pytest.fixture(scope="module")
def full_width():
    """The full-width GauGAN trainer's parameters (meta tensors) and JAX's
    trainer tree of shapes."""
    tr = make_trainer(TrainConfig(), device="meta")
    shapes = jax.eval_shape(JTrainer(JTrainConfig()).init,
                            jax.random.PRNGKey(0)).params
    return dict(tr.nets.named_parameters()), shapes


@pytest.mark.parametrize("model_size", [2, 4])
def test_param_rules_match_jax_on_the_full_width_tree(full_width,
                                                      model_size):
    params, shapes = full_width
    rule = param_sharding_rules(
        make_mesh((8 // model_size, model_size), devices=["cpu"] * 8), 512)
    jrule = jmesh.param_sharding_rules(
        jmesh.make_mesh((8 // model_size, model_size)), 512)
    flat = {jmesh._path_str(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert set(map(jax_path, params)) == set(flat)
    got, seen = {}, set()
    for name, p in params.items():
        path = jax_path(name)
        x = flat[path]
        assert p.numel() == int(np.prod(x.shape)), name
        got[name] = rule(name, p)
        want = jax_decision(jrule(path, x), len(x.shape))
        assert got[name] == want, (name, got[name], want)
        seen.add(got[name])
    assert seen == {"column", "row", "replicate"}
    # The 1024-channel blocks and the 1024 -> 512 block shard; the latent
    # dense is row-parallel; the rest stays whole.
    for i in range(4):
        assert got[f"generator.resblock_{i}.conv_1.weight"] == "column"
        assert got[f"generator.resblock_{i}.conv_2.weight"] == "row"
        assert got[f"generator.resblock_{i}.conv_1.bias"] == "replicate"
    assert got["generator.resblock_3.conv_3.weight"] == "column"
    assert got["generator.resblock_4.conv_1.weight"] == "replicate"
    assert got["generator.dense.weight"] == "row"
    assert got["generator.resblock_0.spade_2.conv_gamma.weight"] == \
        "replicate"


def test_rules_replicate_without_a_model_axis_and_on_odd_widths():
    rule = param_sharding_rules(make_mesh((2, 1), devices=["cpu"] * 2))
    assert rule("generator.resblock_0.conv_1.weight",
                (1024, 1024, 3, 3)) == "replicate"
    rule = param_sharding_rules(make_mesh((1, 2), devices=["cpu"] * 2))
    assert rule("generator.resblock_0.conv_1.weight",
                (1023, 1024, 3, 3)) == "replicate"
    assert rule("generator.resblock_0.conv_1.weight",
                (1024, 1024, 3, 3)) == "column"
    assert rule("discriminator.down_3.conv.weight",
                (1024, 1024, 4, 4)) == "replicate"


# ------------------------------------------------------------------ mesh


def test_one_process_mesh_is_a_grid_of_devices():
    m = make_mesh((2, 2), devices=["cpu"] * 4)
    assert not m.multiprocess and m.shape == {"data": 2, "model": 2}
    assert m.data_devices() == [torch.device("cpu")] * 2
    assert make_mesh((3, 1), device="cpu").shape["data"] == 3
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh((2, 2), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="axes"):
        make_mesh((2, 1), ("batch", "model"), devices=["cpu"] * 2)
    parts = shard_batch((np.arange(8).reshape(4, 2), np.arange(4)), m)
    assert [p[0].tolist() for p in parts] == [[[0, 1], [2, 3]],
                                              [[4, 5], [6, 7]]]
    assert [p[1].tolist() for p in parts] == [[0, 1], [2, 3]]


def test_initialize_reads_the_moonsr_variables(monkeypatch):
    """The MOONSR_* variables stand for the arguments; joining twice is
    joining once; the batch's rows go to the process's device."""
    from moonsuperresolution_tpu_torch.parallel import distributed as d

    assert d.process_info() == (0, 1) and not d.is_multiprocess()
    with pytest.raises(ValueError, match="coordinator"):
        d.initialize(device="cpu")
    monkeypatch.setenv("MOONSR_COORDINATOR", f"localhost:{free_port()}")
    monkeypatch.setenv("MOONSR_NUM_PROCESSES", "1")
    monkeypatch.setenv("MOONSR_PROCESS_ID", "0")
    try:
        assert d.initialize(device="cpu").type == "cpu"
        assert d.initialize(device="cpu").type == "cpu"
        assert d.process_info() == (0, 1) and not d.is_multiprocess()
        m = make_mesh(device="cpu")
        assert m.multiprocess and m.shape == {"data": 1, "model": 1}
        assert (m.data.size, m.model.size) == (1, 1)
        x, y = d.global_batch((np.ones((2, 3)), np.zeros(2)), m)
        assert x.shape == (2, 3) and x.device == m.device
        with pytest.raises(ValueError, match="does not hold"):
            make_mesh((2, 1), device="cpu")
        d.barrier()
    finally:
        d.shutdown()
    assert d.process_info() == (0, 1)


def test_training_refuses_a_one_process_mesh(tmp_path):
    tr = make_trainer(TrainConfig(model=ModelConfig(
        image_size=64, latent_dim=16, channel_plan=(16,) * 6,
        encoder_filters=4, disc_filters=4)), device="cpu")
    with pytest.raises(ValueError, match="one process per place"):
        shard_state_for_dp_tp(tr, make_mesh((2, 1), device="cpu"))
    assert shard_state_for_dp_tp(tr, make_mesh((1, 1), device="cpu")) is tr


def test_moments_cover_the_global_batch(tmp_path):
    """Two processes' rows, moments all-reduced (differentiably): the
    outputs and the gradients of the whole batch in one process."""
    from moonsuperresolution_tpu_torch.models.layers import spade_normalize
    from moonsuperresolution_tpu_torch.models.pix2pix import BatchStatNorm

    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 5, 4, 4), generator=g) * 3 + 1
    w = torch.randn((6, 5, 4, 4), generator=g)
    torch.save({"x": x, "w": w}, tmp_path / "in.pt")
    outs = launch("moments", 2, tmp_path)
    for name, fn in (("spade", lambda t: spade_normalize(t, "batch",
                                                         torch.float32)),
                     ("bn", BatchStatNorm(5))):
        xx = x.clone().requires_grad_(True)
        y = fn(xx)
        (y * w).sum().backward()
        for r, part in enumerate((slice(0, 3), slice(3, 6))):
            got_y, got_g = outs[r][name]
            torch.testing.assert_close(got_y, y.detach()[part], rtol=1e-6,
                                       atol=1e-6)
            torch.testing.assert_close(got_g, xx.grad[part], rtol=1e-6,
                                       atol=1e-6)


# ----------------------------------------------------------- tile-parallel


def test_tile_parallel_identity_matches_jax(tmp_path, rng):
    td = str(tmp_path)
    _synthetic_pair(td, rng)
    jc, pc = _cfgs(td, save=None)
    jsingle = JEngine(jc, model=None)
    jsingle.process_map(progress=False)
    jsharded = JEngine(jc, model=None, mesh=jmesh.make_mesh((8, 1)))
    jsharded.process_map(progress=False)
    serial = DEMSuperResolution(pc, device="cpu")
    serial.process_map(progress=False)
    par = DEMSuperResolution(pc, mesh=make_mesh((2, 1),
                                                devices=["cpu", "cpu"]))
    assert par.device.type == "cpu"
    stats = par.process_map(progress=False)
    assert stats["tiles"] == 12
    for k in ("mean", "std", "good"):
        np.testing.assert_array_equal(par.result[k], serial.result[k])
    np.testing.assert_array_equal(jsharded.result["good"],
                                  jsingle.result["good"])
    for k in ("mean", "std"):
        np.testing.assert_allclose(jsharded.result[k], jsingle.result[k],
                                   atol=1e-5)
    for want in (jsingle.result, jsharded.result):
        assert (want["good"] > 0).mean() > 0.5
        np.testing.assert_array_equal(par.result["good"], want["good"])
        for k in ("mean", "std"):
            np.testing.assert_allclose(par.result[k], want[k], atol=0.02)


@pytest.fixture(scope="module")
def small_gaugan():
    model = GauGAN(ModelConfig(image_size=64, latent_dim=16,
                               channel_plan=(32, 32, 16, 16, 8, 8),
                               encoder_filters=8))
    return init_params(model, torch.Generator().manual_seed(0)).eval()


@pytest.mark.parametrize("quantize", ["none", "int8_static"])
def test_tile_parallel_model_equals_serial(tmp_path, rng, small_gaugan,
                                           quantize):
    """Three devices over 6 tiles (groups of 3, the calibration once, on
    the first group's first tile): the serial map bit for bit."""
    td = str(tmp_path)
    _synthetic_pair(td, rng, h=200, w=300)
    cfg = DSRConfig(**{**MAP, "stride": 32, "batch_size": 8},
                    source_folder_path=td, compute_dtype="float32",
                    quantize=quantize)
    results = []
    for mesh in (None, make_mesh((3, 1), devices=["cpu"] * 3)):
        model = small_gaugan if quantize == "none" else quantize_model(
            small_gaugan, quantize, "float32", device="cpu")
        calls = []
        if quantize != "none":
            real = model.calibrate_on
            model.calibrate_on = lambda b: calls.append(b.shape[0]) or real(b)
        eng = DEMSuperResolution(cfg, model=model, device="cpu", mesh=mesh)
        eng.process_map(progress=False)
        results.append(eng.result)
        assert len(calls) == (quantize != "none")
    assert (results[0]["good"] > 0).mean() > 0.5
    for k in ("mean", "std", "good"):
        np.testing.assert_array_equal(results[1][k], results[0][k])


# -------------------------------------------------------------- profiles


def test_profile_dir_traces_a_tile_and_a_train_step(tmp_path, rng):
    td = str(tmp_path)
    _synthetic_pair(td, rng, h=200, w=300)
    eng = DEMSuperResolution(DSRConfig(**MAP, source_folder_path=td),
                             device="cpu")
    eng.process_map(progress=False, profile_dir=str(tmp_path / "tiles"))
    assert os.listdir(tmp_path / "tiles") == ["tile_1.json"]
    cfg = TrainConfig(model=ModelConfig(image_size=64, latent_dim=16,
                                        channel_plan=(16,) * 6,
                                        encoder_filters=4, disc_filters=4),
                      batch_size=2, epochs=1, output_path=str(tmp_path))
    with pytest.warns(UserWarning, match="VGG19"):
        train(cfg, synthetic=True, max_steps_per_epoch=2, log=False,
              device="cpu", profile_dir=str(tmp_path / "train"))
    assert os.listdir(tmp_path / "train") == ["train_step_0.json"]
    trace = (tmp_path / "train" / "train_step_0.json").read_text()
    assert "aten::convolution" in trace


@pytest.mark.parametrize("seen", [profiling.LEAD_KERNELS, 3, 0])
def test_lead_kernels_lost_counts_the_missing_head(seen):
    """A card trace opens with the lead kernels that survived, then the
    block's; the events come in any order."""
    lead = [{"cat": "kernel", "ts": 10 + i,
             "name": f"void k<{profiling.LEAD_KERNEL_NAME}<float>>"}
            for i in range(seen)]
    block = [{"cat": "kernel", "ts": 5000 + i, "name": n} for i, n in
             enumerate(["patches_block_minmax", "patches_normalize",
                        f"{profiling.LEAD_KERNEL_NAME}"])]
    host = [{"cat": "cpu_op", "ts": 0, "name": "aten::add_"}]
    events = block[::-1] + host + lead[::-1]
    assert profiling.lead_kernels_lost(events) == \
        profiling.LEAD_KERNELS - seen
