"""The int8 generator's entry points against the JAX package's:
``load_model_fn(quantize=...)`` (infer/engine.py, models/gaugan.py) and the
engine's one-time calibration on real patches (``_maybe_calibrate``), at
the small config of test_torch_quant.py."""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonsuperresolution_tpu.models import quant as jq
from moonsuperresolution_tpu_torch.config import DSRConfig, ModelConfig
from moonsuperresolution_tpu_torch.geo.tiff import write_geotiff
from moonsuperresolution_tpu_torch.infer.engine import (
    DEMSuperResolution,
    load_model_fn,
    quantize_model,
)
from moonsuperresolution_tpu_torch.models import layers as tl
from moonsuperresolution_tpu_torch.models.gaugan import (
    GauGAN,
    QuantizedGauGAN,
    StaticQuantizedGauGAN,
)
from moonsuperresolution_tpu_torch.utils.convert import export_params, save_npz

torch.set_num_threads(2)

IMG = 64
PLAN = (64, 64, 32, 32, 16, 8)
SMALL = dict(latent_dim=16, channel_plan=PLAN, encoder_filters=8)


def nested(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return tree


def rel_rmse(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(want.max() - want.min(), 1e-9))


# ------------------------------------------------ (f) load_model_fn, int8


def test_load_model_fn_int8_matches_jax(tmp_path, monkeypatch, rng):
    """The port's loader through an .npz against the JAX loader through an
    Orbax checkpoint of the same weights.  The JAX loader builds the
    default (full-width) ModelConfig and QuantizedSpadeGenerator; both are
    narrowed here to the small config, in the test only.  Both encoders run
    in bf16, the production default, and the JAX model runs under ``jit``
    (a whole eager bf16 forward compiles op by op for half a minute), so
    its conv sums skip the bf16 rounding (module docstring): the JAX engine
    test's bound holds them, tests/test_quant.py:153."""
    import moonsuperresolution_tpu.config as jconfig
    from moonsuperresolution_tpu.infer.engine import (
        load_model_fn as j_load_model_fn,
    )
    from moonsuperresolution_tpu.utils.checkpoint import save_params

    model = tl.init_params(
        GauGAN(ModelConfig(variant="cnn_spade", image_size=IMG, **SMALL)),
        torch.Generator().manual_seed(2))
    with torch.no_grad():  # biases off zero, so a mix-up shows
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape,
                                         generator=torch.Generator()
                                         .manual_seed(3)))
    flat = export_params(model)
    npz, ckpt = str(tmp_path / "w.npz"), str(tmp_path / "ckpt")
    save_npz(npz, flat)
    save_params(ckpt, nested(flat))
    monkeypatch.setattr(jconfig, "ModelConfig", functools.partial(
        jconfig.ModelConfig, channel_plan=PLAN, encoder_filters=8))
    monkeypatch.setattr(jq, "QuantizedSpadeGenerator", functools.partial(
        jq.QuantizedSpadeGenerator, channel_plan=PLAN))
    fn, params = j_load_model_fn(ckpt, "cnn_spade", IMG, latent_dim=16,
                                 quantize="int8")
    src = rng.uniform(-0.5, 0.5, (2, IMG, IMG, 2)).astype(np.float32)
    want = np.asarray(jax.jit(fn)(params,
                                  jnp.asarray(src).astype(jnp.bfloat16),
                                  jax.random.PRNGKey(1)))

    port = load_model_fn(npz, "cnn_spade", IMG, quantize="int8",
                         device="cpu", **SMALL)
    assert isinstance(port, QuantizedGauGAN)
    assert not hasattr(port, "calibrate_on")
    assert port.generator.acc_dtype == "bfloat16"
    with torch.no_grad():
        got = port(torch.from_numpy(src).permute(0, 3, 1, 2)
                   .to(torch.bfloat16))[:, 0].numpy()
    assert got.shape == want.shape == (2, IMG, IMG)
    assert rel_rmse(got, want) < 0.03

    static = load_model_fn(npz, "cnn_spade", IMG, quantize="int8_static",
                           device="cpu", **SMALL)
    assert isinstance(static, StaticQuantizedGauGAN)
    assert len(static.generator.act_scales) >= 20
    with pytest.raises(ValueError, match="unknown quantize mode"):
        load_model_fn(npz, "cnn_spade", IMG, quantize="int4", device="cpu")


def test_quantize_model_leaves_the_float_model_as_it_was():
    """The int8 model casts its own copy of the encoder: the float model's
    weights keep their values and their float32 dtype."""
    model = tl.init_params(
        GauGAN(ModelConfig(variant="cnn_spade", image_size=IMG, **SMALL)),
        torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    q = quantize_model(model, "int8", compute_dtype="bfloat16", device="cpu")
    assert q.encoder is not model.encoder
    assert all(p.dtype == torch.bfloat16 for p in q.encoder.parameters())
    after = model.state_dict()
    assert after.keys() == before.keys()
    for k, v in before.items():
        assert after[k].dtype == torch.float32, k
        assert torch.equal(after[k], v), k


# ------------------------------------------- (g) real-patch calibration


def test_engine_real_patch_calibration(tmp_path):
    """int8_static re-calibrates its activation scales once, on real
    patches of the raster, before the first tile (port of
    tests/test_quant.py:156-213, with a stand-in model)."""
    h, w = 200, 260
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    dem = (1500 + 100 * np.sin(x / 23) * np.cos(y / 31)).astype(np.float32)
    ort = (128 + 40 * np.sin(x / 11 + y / 17)).astype(np.float32)
    dem[40:44, 50:54] = -32768.0  # a hole: some patches invalid
    td = str(tmp_path)
    gt = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
    write_geotiff(os.path.join(td, "run-DEM.tif"), dem, gt, "P", -32768.0)
    write_geotiff(os.path.join(td, "run-DRG.tif"), ort, gt, "P", -32768.0)

    events = []

    def stand_in(source, generator=None):
        events.append("tile")
        return source[:, 1:2]

    stand_in.calibrate_on = lambda batch: events.append(batch.clone())

    cfg = DSRConfig(image_size=IMG, stride=16, batch_size=16, tile_size=128,
                    source_folder_path=td, map_name="t", save_path=None,
                    fill_workers=1)
    eng = DEMSuperResolution(cfg, model=stand_in, device="cpu")
    eng.process_map(progress=False)

    calls = [e for e in events if not isinstance(e, str)]
    assert len(calls) == 1 and eng._calibrated
    assert not isinstance(events[0], str) and "tile" in events
    batch = calls[0].numpy()
    assert batch.ndim == 4 and batch.shape[1:] == (2, IMG, IMG)
    assert 1 <= len(batch) <= 8
    for p in batch:  # min-max normalised to [-0.5, 0.5], no nodata inside
        for c in range(2):
            assert np.isclose(p[c].min(), -0.5, atol=1e-5)
            assert np.isclose(p[c].max(), 0.5, atol=1e-5)


@pytest.mark.parametrize("case", ["holed", "no-valid-patch"])
def test_calibration_patches_match_jax(rng, case):
    """The same slabs through the JAX engine's ``_maybe_calibrate`` (patches
    cut and normalised in numpy) and the port's (the tile program's patch
    prep): the same first 8 valid patches in grid order, normalised alike,
    or no calibration at all when no patch is valid."""
    from moonsuperresolution_tpu.config import DSRConfig as JDSRConfig
    from moonsuperresolution_tpu.infer.engine import (
        DEMSuperResolution as JDEMSuperResolution,
    )

    geom = dict(image_size=IMG, stride=16, tile_size=128, batch_size=16)
    eng = DEMSuperResolution(DSRConfig(**geom), device="cpu")
    side, nv = eng.geom.slab, eng.no_value
    img = (rng.standard_normal((side, side)) * 30 + 128).astype(np.float32)
    dem = (rng.standard_normal((side, side)) * 40).astype(np.float32)
    if case == "holed":  # the first patches of the grid's top rows invalid
        dem[0:20, 0:100] = nv
    else:  # a nodata pixel in every 64-px window
        dem[::16, ::16] = nv

    got = []
    eng.model = types.SimpleNamespace(
        calibrate_on=lambda batch: got.append(batch.numpy()))
    eng._maybe_calibrate(torch.from_numpy(img), torch.from_numpy(dem))

    want = []

    def j_calibrate_on(params, batch):
        want.append(batch)
        return params

    jeng = JDEMSuperResolution(
        JDSRConfig(**geom),
        model=types.SimpleNamespace(calibrate_on=j_calibrate_on),
        model_params={})
    jeng._maybe_calibrate(img, dem)

    assert eng._calibrated and len(got) == len(want)
    if case == "holed":
        assert len(got) == 1
        g, w = got[0], np.moveaxis(want[0], -1, 1)  # JAX's batch is NHWC
        assert g.shape == w.shape == (8, 2, IMG, IMG)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    else:
        assert not got
