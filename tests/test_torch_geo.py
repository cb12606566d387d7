"""The port's GeoTIFF I/O against the JAX package's.

LZW: the port's native codec, its plain Python version and the JAX codec
give the same bytes and decode each other.  TIFF: files written by one
package read back bit-exactly in the other, for every dtype, compression
and predictor the engine uses, and the two writers give the same bytes.
"""

import os
import struct

import numpy as np
import pytest

from moonsuperresolution_tpu.geo import lzw as jlzw
from moonsuperresolution_tpu.geo import tiff as jtiff
from moonsuperresolution_tpu_torch.geo import lzw, tiff

GT = (12.5, 2.0, 0.0, -7.25, 0.0, -2.0)
NODATA = -32768.0

LZW_CASES = {
    "empty": b"",
    "one byte": b"A",
    "repeats": b"TOBEORNOTTOBEORTOBEORNOT" * 100,
    "all bytes": bytes(range(256)) * 50,
    # enough entropy to exhaust the 12-bit table and force Clear codes
    # (one per ~6 KB of random bytes)
    "table overflow": np.random.default_rng(0).integers(
        0, 256, 60_000, dtype=np.uint8).tobytes(),
}


@pytest.mark.parametrize("case", list(LZW_CASES))
def test_lzw_codecs_agree(case):
    d = LZW_CASES[case]
    encoded = {"port": lzw.encode(d), "port plain": lzw.encode_plain(d),
               "jax": jlzw.encode(d)}
    assert encoded["port"] == encoded["port plain"] == encoded["jax"]
    for dec in (lzw.decode, lzw.decode_plain, jlzw.decode):
        assert dec(encoded["port"], len(d)) == d


def test_lzw_corrupt_stream_raises():
    # code 300 (0b100101100) as the first code: past the literals, and no
    # string has been defined yet
    with pytest.raises(ValueError, match="corrupt"):
        lzw.decode(bytes([0x96, 0x00, 0x00]), 64)


def _formats():
    for dtype in (np.float32, np.uint16, np.uint8):
        yield dtype, "none", 1
        for comp in ("lzw", "deflate"):
            for pred in (1, 2, 3) if dtype == np.float32 else (1, 2):
                yield dtype, comp, pred


def _raster(rng, dtype, shape=(137, 251)):
    if np.dtype(dtype).kind == "f":
        return (rng.standard_normal(shape) * 300 + 1500).astype(dtype)
    return rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)


@pytest.mark.parametrize("dtype,comp,pred", list(_formats()))
def test_tiff_cross_read_bit_exact(tmp_path, rng, dtype, comp, pred):
    x = _raster(rng, dtype)
    a, b = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    kw = dict(geo_transform=GT, projection="WKT", nodata=NODATA,
              compress=comp, predictor=pred, rows_per_strip=16)
    tiff.write_geotiff(a, x, **kw)
    jtiff.write_geotiff(b, x, **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for path in (a, b):
        for read in (tiff.read_geotiff, jtiff.read_geotiff):
            g = read(path)
            assert g.data.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(g.data.squeeze(), x)
            assert (g.geo_transform, g.projection, g.nodata) == (
                GT, "WKT", NODATA)


@pytest.mark.parametrize("layout", ["bigtiff", "multiband", "windowed"])
def test_tiff_layouts_cross_read(tmp_path, rng, layout):
    shape = (64, 80, 3) if layout == "multiband" else (300, 400)
    x = rng.random(shape).astype(np.float32)
    p = str(tmp_path / "t.tif")
    tiff.write_geotiff(p, x, GT, "P", bigtiff=layout == "bigtiff")
    with tiff.TiffReader(p) as r, jtiff.TiffReader(p) as jr:
        assert r.big == (layout == "bigtiff")
        for y0, y1 in ((0, shape[0]), (37, 61), (0, 1),
                       (shape[0] - 1, shape[0])):
            np.testing.assert_array_equal(r.read_rows(y0, y1), x[y0:y1])
            np.testing.assert_array_equal(jr.read_rows(y0, y1), x[y0:y1])


def _write_tiled(path, data, tile):
    """An uncompressed tile-organised float32 TIFF (the layout of the WAC
    global mosaic), written by hand."""
    h, w = data.shape
    ta, td = -(-w // tile), -(-h // tile)
    blobs = []
    for i in range(td):
        for j in range(ta):
            blk = np.zeros((tile, tile), data.dtype)
            part = data[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
            blk[:part.shape[0], :part.shape[1]] = part
            blobs.append(blk.tobytes())
    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, 8))
        offs = []
        for blob in blobs:
            offs.append(f.tell())
            f.write(blob)
        off_pos = f.tell()
        f.write(struct.pack(f"<{len(offs)}I", *offs))
        cnt_pos = f.tell()
        f.write(struct.pack(f"<{len(blobs)}I", *map(len, blobs)))
        tags = sorted([(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 32),
                       (259, 3, 1, 1), (262, 3, 1, 1), (277, 3, 1, 1),
                       (284, 3, 1, 1), (339, 3, 1, 3), (322, 4, 1, tile),
                       (323, 4, 1, tile), (324, 4, len(offs), off_pos),
                       (325, 4, len(blobs), cnt_pos)])
        ifd = f.tell()
        f.write(struct.pack("<H", len(tags)))
        for tag, ft, cnt, val in tags:
            f.write(struct.pack("<HHI", tag, ft, cnt))
            f.write(struct.pack("<H", val) + b"\0\0" if ft == 3
                    else struct.pack("<I", val))
        f.write(struct.pack("<I", 0))
        f.seek(4)
        f.write(struct.pack("<I", ifd))


def _write_big_endian(path, data):
    """An uncompressed big-endian (MM) uint16 TIFF, written by hand."""
    h, w = data.shape
    payload = data.astype(">u2").tobytes()
    tags = sorted([(256, 3, 1, w), (257, 3, 1, h), (258, 3, 1, 16),
                   (259, 3, 1, 1), (262, 3, 1, 1), (277, 3, 1, 1),
                   (278, 3, 1, h), (273, 4, 1, 8 + 2 + 10 * 12 + 4),
                   (279, 4, 1, len(payload)), (339, 3, 1, 1)])
    with open(path, "wb") as f:
        f.write(struct.pack(">2sHI", b"MM", 42, 8))
        f.write(struct.pack(">H", len(tags)))
        for tag, ft, cnt, val in tags:
            f.write(struct.pack(">HHI", tag, ft, cnt))
            f.write(struct.pack(">H", val) + b"\0\0" if ft == 3
                    else struct.pack(">I", val))
        f.write(struct.pack(">I", 0))
        f.write(payload)


@pytest.mark.parametrize("kind", ["tiled", "big-endian"])
def test_foreign_layouts_read(tmp_path, rng, kind):
    p = str(tmp_path / "f.tif")
    if kind == "tiled":
        data = (rng.random((50, 70)) * 100).astype(np.float32)
        _write_tiled(p, data, 16)
    else:
        data = np.arange(48, dtype=np.uint16).reshape(6, 8) * 100
        _write_big_endian(p, data)
    with tiff.TiffReader(p) as r:
        assert r.tiled == (kind == "tiled")
        np.testing.assert_array_equal(r.read(), data)
        np.testing.assert_array_equal(r.read_rows(2, 5), data[2:5])


@pytest.mark.parametrize("dtype,h,w", [(np.float32, 333, 217),
                                       (np.uint16, 97, 512)])
def test_stream_writer_matches_batch_writer(tmp_path, rng, dtype, h, w):
    """TiffStreamWriter (incremental strips, IFD at close) gives the bytes
    of write_geotiff, and of the JAX package's stream writer."""
    data = _raster(rng, dtype, (h, w))
    a = str(tmp_path / "batch.tif")
    tiff.write_geotiff(a, data, GT, "P", -1.0)
    for i, writer in enumerate((tiff.TiffStreamWriter,
                                jtiff.TiffStreamWriter)):
        b = str(tmp_path / f"stream{i}.tif")
        with writer(b, w, h, dtype, GT, "P", -1.0) as sw:
            y = 0
            for step in (1, 7, 50, 100, 64, 64, 64, 64):
                sw.write_rows(data[y : y + step])
                y = min(h, y + step)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    sw = tiff.TiffStreamWriter(str(tmp_path / "short.tif"), 8, 10, np.float32)
    sw.write_rows(np.zeros((4, 8), np.float32))
    with pytest.raises(ValueError, match="declared"):
        sw.close()


def test_native_build_lands_in_the_build_dir():
    from moonsuperresolution_tpu_torch import build

    lzw.encode(b"x")
    assert os.path.exists(build.lib_path("lzw"))
    assert "lzw" not in build.sources()  # nvcc builds only the .cu kernels
