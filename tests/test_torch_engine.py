"""Parity of the port's tile program and tile loop with the JAX engine.

One slab with a nodata block goes through JAX ``DEMSuperResolution.
process_tile`` and the port's, in float32 at image 64, stride 16, tile 128,
batch 4.  Coverage must match exactly; mean and std to rtol 1e-5 / atol
1e-4, the bound of tests/test_engine.py's packing test (the folds sum in
another order, and the real model's convolutions too).

The DEMs lie around the datum (elevation 0 +- 40 m).  Where one generation
covers a pixel, or the identity model returns the DEM itself, the std is
|x - mean|: rounding noise of an ulp or two of the elevation, which at
1500 m (1.2e-4) would exceed the absolute bound by itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonsuperresolution_tpu.config import DSRConfig as JDSRConfig
from moonsuperresolution_tpu.config import ModelConfig as JModelConfig
from moonsuperresolution_tpu.config import TrainConfig
from moonsuperresolution_tpu.infer.engine import (
    DEMSuperResolution as JEngine,
)
from moonsuperresolution_tpu.train.trainers import GauGANTrainer
from moonsuperresolution_tpu_torch.config import DSRConfig
from moonsuperresolution_tpu_torch.infer.engine import (
    DEMSuperResolution,
    TileGeometry,
    load_model_fn,
)
from moonsuperresolution_tpu_torch.utils.convert import save_npz

torch.set_num_threads(2)

NO_VALUE = -32768.0
GEOM = dict(image_size=64, stride=16, tile_size=128, batch_size=4,
            no_value=NO_VALUE, compute_dtype="float32")
SMALL = dict(latent_dim=16, channel_plan=(64, 64, 32, 32, 16, 8),
             encoder_filters=8)


def _coupled_jax(params, source, rng):
    # Couples the batch as SPADE's (B, H, W) moments do: the low-res DEM
    # channel plus the batch mean of the ortho channel.
    return source[..., 1] + jnp.mean(source[..., 0])


def _coupled_torch(source, generator=None):
    return source[:, 1] + source[:, 0].mean()


@pytest.fixture(scope="module")
def cnn_spade(tmp_path_factory):
    """(JAX model fn, params, port model): one cnn_spade parameter tree
    carried across through the converter's .npz."""
    cfg = TrainConfig(model=JModelConfig(variant="cnn_spade", image_size=64,
                                         **SMALL), batch_size=1)
    trainer = GauGANTrainer(cfg)
    params = jax.device_get(trainer.init(jax.random.PRNGKey(0)).params)
    path = str(tmp_path_factory.mktemp("w") / "cnn_spade.npz")
    save_npz(path, params)

    def fn(p, source, rng):
        return trainer._generate(p, source, rng)[0][..., 0]

    port = load_model_fn(path, "cnn_spade", 64, compute_dtype="float32",
                         device="cpu", **SMALL)
    return fn, params, port


def _models(kind, cnn_spade):
    if kind == "identity":
        return (None, None), None
    if kind == "coupled":
        return (_coupled_jax, {}), _coupled_torch
    fn, params, port = cnn_spade
    return (fn, params), port


def _slab(rng):
    g = TileGeometry(64, 16, 128)
    img = (rng.standard_normal((g.slab, g.slab)) * 30 + 128).astype(np.float32)
    dem = (rng.standard_normal((g.slab, g.slab)) * 40).astype(np.float32)
    # Invalidates every patch over the tile pixels around (100, 100).
    dem[60:140, 60:140] = NO_VALUE
    return img, dem


@pytest.mark.parametrize("kind", ["identity", "coupled", "cnn_spade"])
def test_tile_program_matches_jax(rng, cnn_spade, kind):
    img, dem = _slab(rng)
    (jfn, jparams), tfn = _models(kind, cnn_spade)
    jeng = JEngine(JDSRConfig(**GEOM), model=jfn, model_params=jparams)
    jeng.img_padded, jeng.dem_padded = img, dem
    want = [np.asarray(a) for a in jeng.process_tile(0, 0)]

    eng = DEMSuperResolution(DSRConfig(**GEOM), model=tfn, device="cpu")
    eng.img_padded, eng.dem_padded = img, dem
    got = [a.numpy() for a in eng.process_tile(0, 0)]

    good = want[2]
    assert 0 < (good > 0).mean() < 1
    np.testing.assert_array_equal(got[2], good)
    for g, w in zip(got[:2], want[:2]):
        assert (g[good == 0] == NO_VALUE).all()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


def test_last_chunk_keeps_its_padding(rng):
    """The last active chunk runs at full batch with zero patches in it:
    a model that sees the batch notices a shortened chunk."""
    img, dem = _slab(rng)
    seen = []

    def model(source, generator=None):
        seen.append(source.shape[0])
        return _coupled_torch(source)

    eng = DEMSuperResolution(DSRConfig(**GEOM), model=model, device="cpu")
    eng.img_padded, eng.dem_padded = img, dem
    eng.process_tile(0, 0)
    n = eng.geom.grid ** 2
    assert set(seen) == {4}
    assert len(seen) < -(-n // 4)  # chunks with no valid patch are skipped


def _raster(rng, h=200, w=230):
    img = (rng.standard_normal((h, w)) * 30 + 128).astype(np.float32)
    dem = (rng.standard_normal((h, w)) * 40).astype(np.float32)
    dem[20:110, 150:230] = NO_VALUE
    return img, dem


def _run_map(eng, img, dem):
    eng.img, eng.dem, eng.dem_shape = img.copy(), dem.copy(), dem.shape
    eng.pad_inputs()
    tiles = eng.generate_tile_list()
    maps = (np.full(dem.shape, NO_VALUE, np.float32),
            np.full(dem.shape, NO_VALUE, np.float32),
            np.zeros(dem.shape, np.uint8))

    def commit(px, py, out):
        eng._commit_tile((px, py, out), *maps)

    eng.run_tiles_serial(tiles, commit)
    return tiles, maps


def test_tile_loop_matches_jax(rng):
    """pad_inputs -> tile list -> run_tiles_serial -> commits over a raster
    of 2 x 2 tiles, the last row and column partial."""
    img, dem = _raster(rng)
    jeng = JEngine(JDSRConfig(**GEOM), model=_coupled_jax, model_params={})
    jtiles, want = _run_map(jeng, img, dem)
    eng = DEMSuperResolution(DSRConfig(**GEOM), model=_coupled_torch,
                             device="cpu")
    tiles, got = _run_map(eng, img, dem)
    assert tiles == jtiles and len(tiles) == 4
    np.testing.assert_array_equal(eng.img_padded, jeng.img_padded)
    np.testing.assert_array_equal(eng.dem_padded, jeng.dem_padded)
    assert 0 < (want[2] > 0).mean() < 1
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
