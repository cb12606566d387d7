"""Parity of the port's full-map pipeline with the JAX engine, on the CPU.

Rasters are the synthetic GeoTIFF pairs of tests/test_engine.py (smooth
terrain, optional small and large nodata holes) at image 64, stride 8 or 16,
tile 128.  Tolerances:

- ``preprocess``: the ortho planes are equal (the same fill); the DEM's
  nodata masks agree on >= 99.5 % of pixels with holes, exactly without;
  values to atol 0.02 m.  The only difference is the final cubic upsample
  (the port's banded taps against cv2, rtol 1e-5 in
  tests/test_torch_resize_fill.py) and the NaN it may spread by a pixel
  more or less at a hole's edge.
- Identity-model maps: coverage equal, mean and std to atol 0.02 m
  (tests/test_engine.py's streaming bound, for the same upsample
  difference).
- The cnn_spade model in float32, both engines tiling the JAX-preprocessed
  planes: rtol 1e-5 / atol 1e-4 (tests/test_torch_engine.py's bound).
- The port's streaming map against its in-RAM map, and shards merged
  against the whole map: the GeoTIFF files are identical.  The port's
  streaming against JAX streaming: coverage equal, atol 0.02 m.
- ``IncrementalLrSynth`` against the JAX one: equal on the full 4-row
  groups (both sum in cv2's order); the clipped tail group to rtol 2e-6 (the
  JAX package sums it with numpy, in another order).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from moonsuperresolution_tpu.config import DSRConfig as JDSRConfig
from moonsuperresolution_tpu.config import ModelConfig as JModelConfig
from moonsuperresolution_tpu.config import TrainConfig
from moonsuperresolution_tpu.geo import read_geotiff
from moonsuperresolution_tpu.infer import DEMSuperResolution as JEngine
from moonsuperresolution_tpu.infer.lr_synth import (
    IncrementalLrSynth as JSynth,
)
from moonsuperresolution_tpu.train.trainers import GauGANTrainer
from moonsuperresolution_tpu.utils.checkpoint import save_params
from moonsuperresolution_tpu_torch.cli import merge_maps, process_full_tiles
from moonsuperresolution_tpu_torch.config import DSRConfig, ModelConfig
from moonsuperresolution_tpu_torch.geo.tiff import write_geotiff
from moonsuperresolution_tpu_torch.infer.engine import (
    DEMSuperResolution,
    load_model_fn,
)
from moonsuperresolution_tpu_torch.infer.lr_synth import IncrementalLrSynth
from moonsuperresolution_tpu_torch.models.gaugan import GauGAN
from moonsuperresolution_tpu_torch.models.layers import init_params
from moonsuperresolution_tpu_torch.utils.convert import export_params

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

GT = (30.5, 2.0, 0.0, -10.25, 0.0, -2.0)
NO_VALUE = -32768.0
MAP = dict(image_size=64, stride=8, batch_size=32, tile_size=128,
           map_name="toy", fill_workers=1)
SMALL = dict(latent_dim=16, channel_plan=(64, 64, 32, 32, 16, 8),
             encoder_filters=8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synthetic_pair(td, rng, h=300, w=420, holes=False, datum=1500.0,
                    relief=100.0):
    dem = cv2.resize(rng.standard_normal((6, 8)).astype(np.float32), (w, h),
                     interpolation=cv2.INTER_CUBIC) * relief + datum
    ort = (cv2.resize(rng.standard_normal((12, 16)).astype(np.float32),
                      (w, h), interpolation=cv2.INTER_CUBIC) * 40 + 128
           ).clip(1, 255)
    if holes:
        dem[50:53, 60:63] = NO_VALUE           # small fillable hole
        dem[100:180, 200:300] = NO_VALUE        # large hole, stays nodata
        # small ortho hole inside the fill sweep's interior, which leaves
        # the raster's outer 128 px as they are
        ort[150:152, 150:152] = NO_VALUE
    write_geotiff(os.path.join(td, "run-DEM.tif"), dem, GT, "P", NO_VALUE)
    write_geotiff(os.path.join(td, "run-DRG.tif"), ort, GT, "P", NO_VALUE)
    return dem, ort


def _cfgs(td, save="out", **kw):
    geom = {**MAP, **kw}
    save_path = os.path.join(td, save) if save else None
    return (JDSRConfig(**geom, source_folder_path=td, save_path=save_path),
            DSRConfig(**geom, source_folder_path=td, save_path=save_path))


@pytest.mark.parametrize("holes", [False, True])
def test_preprocess_matches_jax(tmp_path, rng, holes):
    td = str(tmp_path)
    _synthetic_pair(td, rng, holes=holes)
    jc, pc = _cfgs(td, save=None)
    jeng = JEngine(jc, model=None)
    eng = DEMSuperResolution(pc, device="cpu")
    for e in (jeng, eng):
        e.load_images()
        e.preprocess()
    assert eng.geo_transform == GT and eng.projection == "P"
    np.testing.assert_array_equal(eng.img, jeng.img)
    if holes:
        assert (jeng.img[150:152, 150:152] > NO_VALUE).all()   # filled
    jnd, pnd = jeng.dem <= NO_VALUE, eng.dem <= NO_VALUE
    if holes:
        assert jnd.any() and (jnd == pnd).mean() >= 0.995
    else:
        np.testing.assert_array_equal(pnd, jnd)
    both = ~jnd & ~pnd
    np.testing.assert_allclose(eng.dem[both], jeng.dem[both], atol=0.02)


def _maps(path, name="toy"):
    return {k: read_geotiff(os.path.join(path, f"{name}_{k}.tiff"))
            for k in ("mean", "std", "good")}


def test_identity_map_matches_jax(tmp_path, rng):
    td = str(tmp_path)
    _synthetic_pair(td, rng)
    jc, pc = _cfgs(td)
    jeng = JEngine(jc, model=None)
    jeng.process_map(progress=False)
    eng = DEMSuperResolution(pc, device="cpu")
    stats = eng.process_map(progress=False)
    assert stats["tiles"] == len(jeng.generate_tile_list()) == 12
    assert {"preprocess_s", "tiles_s", "save_s"} <= set(stats)
    want, got = jeng.result, eng.result
    cover = want["good"] > 0
    assert cover.mean() > 0.5
    np.testing.assert_array_equal(got["good"], want["good"])
    for k in ("mean", "std"):
        np.testing.assert_allclose(got[k], want[k], atol=0.02)
    files = _maps(pc.save_path)
    for k, g in files.items():
        assert (g.geo_transform, g.projection, g.nodata) == (GT, "P", NO_VALUE)
        np.testing.assert_array_equal(g.data.squeeze(), got[k])


def _export_script():
    spec = importlib.util.spec_from_file_location(
        "export_params_npz", os.path.join(ROOT, "scripts",
                                          "export_params_npz.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_tiles(eng, img, dem):
    eng.img, eng.dem, eng.dem_shape = img.copy(), dem.copy(), dem.shape
    eng.pad_inputs()
    maps = (np.full(dem.shape, NO_VALUE, np.float32),
            np.full(dem.shape, NO_VALUE, np.float32),
            np.zeros(dem.shape, np.uint8))

    def commit(px, py, out):
        eng._commit_tile((px, py, out), *maps)

    eng.run_tiles_serial(eng.generate_tile_list(), commit)
    return maps


def _nested(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def test_cnn_spade_map_matches_jax(tmp_path, rng):
    """A small float32 cnn_spade (deterministic latent) on both sides with
    the same weights, carried across as JAX save_params ->
    scripts/export_params_npz.py -> load_model_fn; both engines tile the
    JAX-preprocessed planes of a 1 x 2-tile raster.  The weights are made
    from a seed by the port (a flax init of the model takes ~30 s here).

    The DEM lies around the datum with +-10 m of relief.  Where one
    generation covers a pixel the std is rounding noise of an ulp of the
    elevation, which at 1500 m (1.2e-4 m) would exceed the absolute bound by
    itself.  And the two models differ by up to 3e-5 in normalised units
    (tests/test_torch_models.py), which denormalisation multiplies by each
    patch's elevation range: at +-100 m of relief that alone reaches
    2.4e-4 m."""
    td = str(tmp_path)
    _synthetic_pair(td, rng, h=120, w=250, holes=True, datum=0.0,
                    relief=10.0)
    cfg = ModelConfig(variant="cnn_spade", image_size=64,
                      compute_dtype="float32", **SMALL)
    seeded = init_params(GauGAN(cfg), torch.Generator().manual_seed(0))
    params = _nested(export_params(seeded))
    ckpt, npz = str(tmp_path / "ckpt"), str(tmp_path / "w.npz")
    save_params(ckpt, params)
    _export_script().main([ckpt, npz])
    model = load_model_fn(npz, "cnn_spade", 64, compute_dtype="float32",
                          device="cpu", **SMALL)
    trainer = GauGANTrainer(TrainConfig(
        model=JModelConfig(variant="cnn_spade", image_size=64, **SMALL),
        batch_size=1))

    def jfn(p, source, key):
        return trainer._generate(p, source, key)[0][..., 0]

    jc, pc = _cfgs(td, save=None, stride=16, compute_dtype="float32")
    jeng = JEngine(jc, model=jfn, model_params=params)
    jeng.load_images()
    jeng.preprocess()
    img, dem = jeng.img, jeng.dem
    want = _run_tiles(jeng, img, dem)
    got = _run_tiles(DEMSuperResolution(pc, model=model, device="cpu"),
                     img, dem)
    assert 0.3 < (want[2] > 0).mean() < 1
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


def _cli(td, save, *extra):
    return process_full_tiles.run([
        "--source_folder_path", td, "--map_name", "toy",
        "--save_path", os.path.join(td, save), "--image_size", "64",
        "--stride", "8", "--tile_size", "128", "--batch_size", "32",
        "--fill_workers", "1", "--device", "cpu", *extra])


def test_cli_writes_the_georeferenced_triple(tmp_path, rng, capsys):
    td = str(tmp_path)
    dem, _ = _synthetic_pair(td, rng, holes=True)
    stats = _cli(td, "cli")
    assert stats["tiles"] == 12 and "tiles_s" in capsys.readouterr().out
    eng = DEMSuperResolution(_cfgs(td, save=None)[1], device="cpu")
    eng.process_map(progress=False)
    maps = _maps(os.path.join(td, "cli"))
    for k, g in maps.items():
        assert (g.geo_transform, g.projection, g.nodata) == (GT, "P", NO_VALUE)
        np.testing.assert_array_equal(g.data.squeeze(), eng.result[k])
    good = maps["good"].data.squeeze()
    assert good.dtype == np.uint16 and good[140, 250] == 0  # the big hole


STREAMING = {  # case -> (h, w, holes)
    "clean": (296, 420, False),
    # quarter height 30 (hq % 4 == 2): the /16 synthesis has a clipped
    # 2-row tail group
    "partial tail": (120, 420, False),
    "holes": (296, 420, True),
}


def _assert_same_files(a, b, name="toy"):
    for k in ("mean", "std", "good"):
        with open(os.path.join(a, f"{name}_{k}.tiff"), "rb") as fa, \
                open(os.path.join(b, f"{name}_{k}.tiff"), "rb") as fb:
            assert fa.read() == fb.read(), k


@pytest.mark.parametrize("case", [*STREAMING, "vs jax"])
def test_streaming_matches(tmp_path, rng, case):
    """The port's streaming map against its in-RAM map (the three cases of
    tests/test_engine.py::TestStreamingEngine): the same files, since both
    run the same fills, synthesis and banded cubic upsample.  Against JAX
    streaming: coverage equal, mean and std to atol 0.02 m."""
    h, w, holes = STREAMING.get(case, (296, 420, True))
    td = str(tmp_path)
    _synthetic_pair(td, rng, h=h, w=w, holes=holes)
    jc, pc = _cfgs(td, save="st")
    stats = DEMSuperResolution(pc, device="cpu").process_map_streaming(
        progress=False)
    assert stats["tiles"] == (h // 128 + 1) * (w // 128 + 1)
    got = _maps(pc.save_path)
    for k in got:
        assert (got[k].geo_transform, got[k].projection) == (GT, "P")
    cover = got["good"].data.squeeze() > 0
    assert cover.mean() > 0.5
    if case != "vs jax":
        DEMSuperResolution(_cfgs(td, save="ram")[1], device="cpu").process_map(
            progress=False)
        _assert_same_files(os.path.join(td, "ram"), pc.save_path)
        return
    JEngine(_cfgs(td, save="jst")[0], model=None).process_map_streaming(
        progress=False)
    want = _maps(os.path.join(td, "jst"))
    np.testing.assert_array_equal(got["good"].data, want["good"].data)
    for k in ("mean", "std"):
        np.testing.assert_allclose(got[k].data.squeeze()[cover],
                                   want[k].data.squeeze()[cover], atol=0.02)


@pytest.mark.parametrize("mode", ["tiles", "streaming"])
def test_sharded_map_merges_bit_exact(tmp_path, rng, mode):
    """Shards through the CLI, merged by the merge CLI, give the files of
    one whole run; an incomplete shard set raises."""
    td = str(tmp_path)
    _synthetic_pair(td, rng, h=296, w=420, holes=True)
    flags = ["--streaming"] if mode == "streaming" else []
    n = 2 if mode == "streaming" else 3
    _cli(td, "whole", *flags)
    for i in range(n):
        _cli(td, "sh", *flags, "--shard_index", str(i), "--num_shards", str(n))
    sh = os.path.join(td, "sh")
    assert not os.path.exists(os.path.join(sh, "toy_mean.tiff"))
    manifest = os.path.join(
        sh, f"toy_{'s' if mode == 'streaming' else ''}shard1of{n}.json")
    os.rename(manifest, manifest + ".bak")
    with pytest.raises(ValueError, match="missing shards"):
        merge_maps.run(["--save_path", sh, "--map_name", "toy", *flags])
    os.rename(manifest + ".bak", manifest)
    merge_maps.run(["--save_path", sh, "--map_name", "toy", "--num_shards",
                     str(n), *flags])
    _assert_same_files(os.path.join(td, "whole"), sh)


class _ArrayReader:
    def __init__(self, data):
        self.data = data

    def read_rows(self, y0, y1):
        return self.data[y0:y1]


@pytest.mark.parametrize("h,w,chunk", [
    (296, 420, 4096),   # single chunk, hq=74 (h16 rounds down, no tail)
    (300, 420, 128),    # hq=75 -> 3-row tail group
    (2048, 424, 256),   # many chunks; fill tiles run incrementally
    (120, 416, 64),     # hq=30 -> 2-row tail group
    (120, 440, 64),     # and a clipped column (wq=110 -> w16=28)
])
def test_lr_synth_matches_jax(rng, h, w, chunk):
    dem = cv2.resize(rng.standard_normal((8, 8)).astype(np.float32), (w, h),
                     interpolation=cv2.INTER_CUBIC) * 100 + 1500
    for _ in range(8):
        cy, cx = int(rng.integers(5, h - 8)), int(rng.integers(5, w - 8))
        dem[cy : cy + 3, cx : cx + 3] = NO_VALUE
    dem[h // 3 : h // 3 + h // 5, w // 3 : w // 3 + w // 5] = NO_VALUE
    synths = [cls(_ArrayReader(dem), h, w, NO_VALUE, workers=1,
                  chunk_rows=chunk) for cls in (JSynth, IncrementalLrSynth)]
    for s in synths:
        s.join()
    want, got = (s.s16 for s in synths)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    nf = min(want.shape[0], (h // 4) // 4)   # full 4-row groups
    np.testing.assert_array_equal(got[:nf], want[:nf])
    ok = ~np.isnan(want[nf:])
    np.testing.assert_allclose(got[nf:][ok], want[nf:][ok], rtol=2e-6)


def test_lr_synth_producer_error_propagates():
    class _Boom:
        def read_rows(self, y0, y1):
            raise RuntimeError("disk on fire")

    synth = IncrementalLrSynth(_Boom(), 64, 64, NO_VALUE, chunk_rows=64)
    with pytest.raises(RuntimeError, match="disk on fire"):
        synth.wait_rows(1)
    with pytest.raises(RuntimeError, match="disk on fire"):
        synth.join()


def test_console_scripts_return_0(tmp_path, rng):
    """``main`` of the map CLI and of the merge CLI return 0 for their
    console scripts (``run`` returns the stats), here over two shards of
    an identity map merged."""
    td = str(tmp_path)
    _synthetic_pair(td, rng, h=200, w=260)
    sh = os.path.join(td, "shards")
    for i in range(2):
        assert process_full_tiles.main([
            "--source_folder_path", td, "--map_name", "toy", "--save_path",
            sh, "--image_size", "64", "--stride", "32", "--tile_size", "128",
            "--fill_workers", "1", "--device", "cpu", "--shard_index",
            str(i), "--num_shards", "2"]) == 0
    assert merge_maps.main(["--save_path", sh, "--map_name", "toy",
                            "--num_shards", "2"]) == 0
    good = _maps(sh)["good"].data.squeeze()
    assert good.shape == (200, 260) and (good > 0).mean() > 0.5
