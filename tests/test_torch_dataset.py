"""The port's dataset tools against the JAX package's: ``tile_pair``,
``split_train_val`` and ``build_h5_dataset`` (the same datasets byte for
byte, uint16 DEM tiles included, and equal pickles; the port writes with its
own HDF5 writer and reads the JAX store with its reader), the WAC tiler on a
GeoTIFF written by the port (equal ``.npy`` files), ``compare`` (equal
statistics), and the three data CLIs, whose console scripts return 0."""

import filecmp
import os
import pickle

import h5py
import numpy as np
import pytest

from moonsuperresolution_tpu.cli.compare_maps import compare as jax_compare
from moonsuperresolution_tpu.data import h5_builder as jb
from moonsuperresolution_tpu.data.wac_tiler import (
    tile_wac_mosaic as jax_tile_wac,
)
from moonsuperresolution_tpu_torch.cli import compare_maps, make_h5, tile_wac
from moonsuperresolution_tpu_torch.data import h5_builder as pb
from moonsuperresolution_tpu_torch.data.hdf5 import H5Reader, H5Writer
from moonsuperresolution_tpu_torch.data.wac_tiler import tile_wac_mosaic
from moonsuperresolution_tpu_torch.geo.tiff import write_geotiff

KEY = "N0-60_W000-120"


def _same_store(port_path, jax_path):
    """Every dataset of the two stores equal byte for byte, each file read
    by the other side's reader."""
    with H5Reader(jax_path) as j, h5py.File(port_path, "r") as p:
        assert sorted(p.keys()) == list(j)
        for k in j:
            got, want = p[k][()], np.asarray(j[k])
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.tobytes() == want.tobytes(), k
    return list(j)


def test_tile_pair_matches_jax(tmp_path, rng):
    """A 1700 x 2600 pair (ragged edges) at the production tiles, 1000 px at
    offset 500: 2 x 4 tiles, the DEM quantized to uint16, one flat tile."""
    ort = (rng.random((1700, 2600)) * 255).astype(np.float32)
    dem = (rng.random((1700, 2600)) * 4000 - 2000).astype(np.float32)
    dem[:1000, :1000] = 7.0
    pd, jd = {}, {}
    with H5Writer(str(tmp_path / "p.hdf5")) as h5:
        pb.tile_pair(ort, dem, "R", h5, pd)
    with h5py.File(str(tmp_path / "j.hdf5"), "w") as h5:
        jb.tile_pair(ort, dem, "R", h5, jd)
    assert pd == jd and len(pd) == 2 * 4
    names = _same_store(str(tmp_path / "p.hdf5"), str(tmp_path / "j.hdf5"))
    assert len(names) == 2 * len(pd)
    with H5Reader(str(tmp_path / "p.hdf5")) as f:
        q = f["R-dem-0-500"]
        assert q.dtype == np.uint16 and q.min() == 0 and q.max() == 65535
        assert not np.asarray(f["R-dem-0-0"]).any()      # flat: all 0


@pytest.mark.parametrize("n,seed", [(15, 0), (40, 1), (5000, 2)])
def test_split_train_val_matches_jax(n, seed):
    dct = {f"k{i}": [f"d{i}", f"o{i}"] for i in range(n)}
    got = pb.split_train_val(dct, seed=seed)
    want = jb.split_train_val(dct, seed=seed)
    assert got == want
    assert [list(d) for d in got] == [list(d) for d in want]   # order too


def _regions(data, rng, ort_shape, ort_dtype, rows=64, cols=96):
    for key in (KEY, "S0-60_W240-360"):
        dem = (rng.random((rows, cols)) * 2000).astype(np.float32)
        dem.tofile(os.path.join(data, pb.DEM_FILES[key]))
        np.save(os.path.join(data, pb.ORT_FILES[key]),
                (rng.random(ort_shape) * 255).astype(ort_dtype))
    return rows


@pytest.mark.parametrize("ort_shape,ort_dtype", [
    ((32, 48), "float32"),     # enlarged onto the DEM grid, as JAX tests
    ((76, 114), "float32"),    # shrunk, as a 100 m ortho onto 256 px/deg
    ((76, 114), "uint8"),
])
def test_build_h5_dataset_matches_jax(tmp_path, rng, ort_shape, ort_dtype):
    """Two regions through ``load_pair`` (INTER_AREA onto the 64 x 96 DEM
    grid), 32-px tiles at offset 16: the same store and the same pickles."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    rows = _regions(data, rng, ort_shape, ort_dtype)
    kw = dict(regions=[KEY, "S0-60_W240-360"], tile_size=32, tile_offset=16,
              seed=0, dem_rows=rows)
    got = pb.build_h5_dataset(data, str(tmp_path / "p"), **kw)
    want = jb.build_h5_dataset(data, str(tmp_path / "j"), **kw)
    assert got[1:] == want[1:] and sum(got[1:]) == 2 * 3 * 5
    assert _same_store(got[0], want[0])
    for split in ("train", "val"):
        name = f"MoonORTO2DEM_{split}.pkl"
        assert filecmp.cmp(str(tmp_path / "p" / name),
                           str(tmp_path / "j" / name), shallow=False)


def _mosaic(path, rng, gt, h=360, w=720):
    mosaic = rng.integers(0, 255, (h, w)).astype(np.uint8)
    write_geotiff(path, mosaic, gt, "", None, compress="lzw")


@pytest.mark.parametrize("gt", [
    (0.0, 0.5, 0.0, 90.0, 0.0, -0.5),       # degrees: windows from it
    (0.0, 1.0, 0.0, 0.0, 0.0, -1.0),        # none: the global fallback
])
def test_tile_wac_matches_jax(tmp_path, rng, gt):
    src = str(tmp_path / "wac.tif")
    _mosaic(src, rng, gt)
    got = tile_wac_mosaic(src, str(tmp_path / "p"), block_rows=50)
    want = jax_tile_wac(src, str(tmp_path / "j"), block_rows=50)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert {os.path.basename(p) for p in got} == set(
        pb.ORT_FILES.values())
    for g, w in zip(got, want):
        a = np.load(g)
        assert a.shape == (120, 240) and a.dtype == np.uint8
        assert filecmp.cmp(g, w, shallow=False)


def test_compare_matches_jax(rng):
    a = (rng.standard_normal((60, 70)) * 100).astype(np.float32)
    b = a + rng.standard_normal((60, 70)).astype(np.float32)
    a[:10], b[:, :5], b[30, 30] = -32768.0, -32768.0, np.nan
    got = compare_maps.compare(a, b, -32768.0)
    assert got == jax_compare(a, b, -32768.0) and 0 < got["coverage"] < 1
    a[:] = -32768.0
    assert compare_maps.compare(a, b, -32768.0) == {"coverage": 0.0}
    with pytest.raises(ValueError, match="shape"):
        compare_maps.compare(a, b[:5], -32768.0)


def test_data_clis_run_and_their_console_scripts_return_0(tmp_path, rng,
                                                          capsys):
    """tile_wac -> make_h5 over the whole six regions at a tiny size (the
    CLI builds the production DEM grid, so the DEMs here are 15360 rows of
    2 px); compare_maps of two GeoTIFFs."""
    src = str(tmp_path / "wac.tif")
    _mosaic(src, rng, (0.0, 0.5, 0.0, 90.0, 0.0, -0.5))
    data = str(tmp_path / "data")
    assert tile_wac.main(["--mosaic", src, "--output_path", data]) == 0
    assert len(os.listdir(data)) == 6
    for key in pb.REGIONS:
        (rng.random((pb.SLDEM_ROWS, 2)) * 10).astype(np.float32).tofile(
            os.path.join(data, pb.DEM_FILES[key]))
    out = str(tmp_path / "out")
    h5_path, n_train, n_val = make_h5.run(["--data_path", data,
                                           "--output_path", out, "--seed",
                                           "0"])
    assert (n_train, n_val) == (0, 0) and os.path.isfile(h5_path)
    assert make_h5.main(["--data_path", data, "--output_path", out]) == 0
    with open(os.path.join(out, "MoonORTO2DEM_train.pkl"), "rb") as f:
        assert pickle.load(f) == {}

    gt = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
    m = (rng.random((20, 30)) * 100).astype(np.float32)
    write_geotiff(str(tmp_path / "a.tif"), m, gt, "", -32768.0)
    write_geotiff(str(tmp_path / "b.tif"), m - 1, gt, "", -32768.0)
    argv = ["--a", str(tmp_path / "a.tif"), "--b", str(tmp_path / "b.tif")]
    stats = compare_maps.run(argv)
    assert abs(stats["bias"] - 1.0) < 1e-5 and stats["coverage"] == 1.0
    assert compare_maps.main(argv) == 0
    assert '"rmse"' in capsys.readouterr().out
