"""The port's HDF5 reader and writer (data/hdf5.py) against h5py, the
oracle of the format on the CPU test machine: the reader returns the bytes
h5py wrote (the B-tree of the root group at more than one level too, and
the store that the JAX package's ``tile_pair`` writes), h5py reads the
writer's files back equal, and what lies outside the subset raises a named
error.  Every comparison is exact: the format moves bytes."""

import os
import pickle

import h5py
import numpy as np
import pytest

from moonsuperresolution_tpu.data.h5_builder import tile_pair as jax_tile_pair
from moonsuperresolution_tpu_torch.data.hdf5 import (
    H5Reader,
    H5Writer,
    HDF5FormatError,
)

DTYPES = ["u1", "u2", "i2", "i4", "f4", "f8"]


def _arrays(rng, dtype, n=3):
    """2-D and 3-D arrays of ``dtype`` over its range."""
    out = {}
    for i in range(n):
        shape = [(5, 7), (3, 4, 6), (1, 9)][i % 3]
        x = rng.standard_normal(shape) * 1000
        if np.dtype(dtype).kind in "iu":
            info = np.iinfo(dtype)
            x = rng.integers(info.min, info.max, shape, endpoint=True)
        out[f"{dtype}-{i}"] = x.astype(dtype)
    return out


def _h5py_file(path, arrays, **kw):
    with h5py.File(path, "w", **kw) as f:
        for k, v in arrays.items():
            f[k] = v


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_reader_matches_h5py(tmp_path, rng, dtype):
    arrays = _arrays(rng, dtype)
    path = str(tmp_path / "a.h5")
    _h5py_file(path, arrays)
    with H5Reader(path) as f:
        assert list(f) == sorted(arrays) and len(f) == len(arrays)
        assert all(k in f for k in arrays) and "missing" not in f
        for k, v in arrays.items():
            assert isinstance(f[k], np.memmap) and not f[k].flags.writeable
            _equal(f[k], v)
        with pytest.raises(KeyError, match="missing"):
            f["missing"]


def test_reader_walks_a_root_btree_of_two_levels(tmp_path, rng):
    """2,500 names: h5py's root group B-tree splits into two levels (a node
    takes 32 symbol-table nodes of 4-8 names)."""
    arrays = {f"tile-{i:05d}": rng.integers(0, 65535, (4, 3)).astype("u2")
              for i in range(2500)}
    path = str(tmp_path / "many.h5")
    _h5py_file(path, arrays)
    with H5Reader(path) as f:
        assert f.root_btree_level >= 1
        assert list(f) == sorted(arrays)
        for k, v in arrays.items():
            _equal(f[k], v)


def test_crops_equal_h5py_slices(tmp_path, rng):
    """The sampler's crops, on 1000-px tiles: equal to h5py's slices."""
    arrays = {"ort": (rng.random((1000, 1000)) * 255).astype(np.float32),
              "dem": rng.integers(0, 65535, (1000, 1000)).astype(np.uint16)}
    path = str(tmp_path / "crop.h5")
    _h5py_file(path, arrays)
    with H5Reader(path) as f, h5py.File(path, "r") as g:
        for _ in range(5):
            c = int(rng.integers(500, 998))
            x, y = (int(v) for v in rng.integers(0, 1000 - c + 1, 2))
            sl = np.s_[x : x + c, y : y + c]
            for k in arrays:
                _equal(f[k][sl], g[k][sl])


def test_reader_reads_the_jax_builders_store(tmp_path, rng):
    """The reference-style store: the JAX ``tile_pair`` through h5py, 2 x 3
    tiles of 1000 px (uint16 DEM, float32 ortho)."""
    ort = (rng.random((1500, 2000)) * 255).astype(np.float32)
    dem = (rng.random((1500, 2000)) * 4000 - 2000).astype(np.float32)
    path, dct = str(tmp_path / "store.hdf5"), {}
    with h5py.File(path, "w") as h5:
        jax_tile_pair(ort, dem, "R", h5, dct)
    assert len(dct) == 2 * 3
    with H5Reader(path) as f, h5py.File(path, "r") as g:
        assert sorted(f) == sorted(g.keys())
        for dem_key, ort_key in dct.values():
            for k in (dem_key, ort_key):
                _equal(f[k], g[k][()])
        assert f[dem_key].dtype == np.uint16


@pytest.mark.parametrize("dtype", DTYPES)
def test_h5py_reads_the_writers_files(tmp_path, rng, dtype):
    arrays = _arrays(rng, dtype)
    arrays["scalar"] = np.array(2.5, dtype)
    arrays["empty"] = np.zeros((0, 3), dtype)
    arrays["strided"] = (rng.random((6, 8)) * 100).astype(dtype)[::2, 1::3]
    path = str(tmp_path / "w.h5")
    with H5Writer(path) as f:
        for k, v in arrays.items():
            f[k] = v
    assert not os.path.exists(path + ".tmp")
    with h5py.File(path, "r") as g:
        assert sorted(g.keys()) == sorted(arrays)
        for k, v in arrays.items():
            _equal(g[k][()], v)
    with H5Reader(path) as f:
        for k, v in arrays.items():
            _equal(f[k], v)


def test_h5py_reads_a_written_two_level_btree(tmp_path, rng):
    """2,500 names make the writer's root B-tree two levels deep; h5py
    finds every name and byte, and so does the reader."""
    arrays = {f"R-dem-{i}": rng.integers(0, 255, (3, 2)).astype("u1")
              for i in range(2500)}
    path = str(tmp_path / "many.h5")
    with H5Writer(path) as f:
        for k, v in arrays.items():
            f[k] = v
    with h5py.File(path, "r") as g:
        assert sorted(g.keys()) == sorted(arrays)
        for k, v in arrays.items():
            _equal(g[k][()], v)
    with H5Reader(path) as f:
        assert f.root_btree_level == 1 and len(f) == 2500
        for k, v in arrays.items():
            _equal(f[k], v)


def test_writer_replaces_the_file_only_when_closed(tmp_path, rng):
    """Written to ``path.tmp``, renamed on close; an exception inside
    ``with`` leaves the previous file as it was and no temporary."""
    path = str(tmp_path / "s.h5")
    _h5py_file(path, {"old": np.arange(3, dtype=np.int32)})
    with pytest.raises(RuntimeError, match="cut"):
        with H5Writer(path) as f:
            f["new"] = np.ones(4, np.float32)
            assert os.path.exists(path + ".tmp")
            raise RuntimeError("cut")
    assert not os.path.exists(path + ".tmp")
    with h5py.File(path, "r") as g:
        assert list(g.keys()) == ["old"]
    with H5Writer(path) as f:
        f["new"] = np.ones(4, np.float32)
    with h5py.File(path, "r") as g:
        assert list(g.keys()) == ["new"]


@pytest.mark.parametrize("name,value,error", [
    ("a/b", np.ones(2), ValueError),
    ("", np.ones(2), ValueError),
    ("dup", np.ones(2), ValueError),
    ("text", np.array(["x"]), TypeError),
    ("complex", np.ones(2, np.complex64), TypeError),
])
def test_writer_refuses_what_it_cannot_write(tmp_path, name, value, error):
    with H5Writer(str(tmp_path / "r.h5")) as f:
        f["dup"] = np.zeros(2)
        with pytest.raises(error):
            f[name] = value


def _compact(path):
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((4,))
        h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_FLOAT, space, dcpl)


def _dataset(**kw):
    def make(path):
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=np.ones((8, 8), np.float32), **kw)
    return make


def _file(**kw):
    def make(path):
        _h5py_file(path, {"x": np.ones(3, np.float32)}, **kw)
    return make


UNSUPPORTED = {   # case -> (writer, the error names)
    "chunked": (_dataset(chunks=(4, 4)), "chunked layout"),
    "gzip": (_dataset(compression="gzip"), r"filtered \(deflate"),
    "compact": (_compact, "compact layout"),
    "big-endian": (_dataset(dtype=">f4"), "big-endian"),
    "string": (lambda p: _h5py_file(p, {"x": np.array([b"ab"])}),
               "string datatype"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_datasets_raise_named_errors(tmp_path, case):
    make, match = UNSUPPORTED[case]
    path = str(tmp_path / f"{case}.h5")
    make(path)
    with H5Reader(path) as f:
        assert "x" in f
        with pytest.raises(HDF5FormatError, match=match):
            f["x"]


@pytest.mark.parametrize("kw,match", [
    (dict(libver="latest"), "superblock version 3"),
    (dict(track_order=True), "version-2 object header"),
])
def test_unsupported_files_raise_named_errors(tmp_path, kw, match):
    path = str(tmp_path / "new.h5")
    _file(**kw)(path)
    with pytest.raises(HDF5FormatError, match=match):
        H5Reader(path)


def test_not_hdf5_raises(tmp_path):
    path = tmp_path / "keys.pkl"
    path.write_bytes(pickle.dumps({"a": 1}) * 10)
    with pytest.raises(HDF5FormatError, match="no HDF5 signature"):
        H5Reader(str(path))
