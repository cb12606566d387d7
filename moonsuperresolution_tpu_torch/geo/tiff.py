"""GeoTIFF reader/writer without GDAL (the port's own copy of
moonsuperresolution_tpu/geo/tiff.py; numpy only).

The reference uses GDAL for all raster I/O (process_full_tiles.py:352-357,
674-711: LZW + PREDICTOR, geo-transform, projection, per-band nodata).  This
module implements the needed TIFF subset natively:

- classic TIFF and BigTIFF (auto-selected for >4 GB rasters)
- strip organisation, windowed (row-range) reads for huge rasters; tiled
  files are read too
- compression: none, LZW (native C++ codec, geo/lzw.py), DEFLATE (zlib)
- predictors: 1 (none), 2 (integer horizontal differencing, word-wise per
  sample width like libtiff), 3 (floating-point byte-split differencing)
- dtypes: uint8/16/32, int16/32, float32/64; 1..N contiguous bands
- GeoTIFF tags: ModelPixelScale + ModelTiepoint (north-up geo-transform),
  GeoKeyDirectory with a citation key carrying the projection WKT,
  GDAL_NODATA

The geo-transform uses the GDAL 6-tuple convention
(origin_x, pix_w, 0, origin_y, 0, -pix_h).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import BinaryIO, Optional

import numpy as np

from moonsuperresolution_tpu_torch.geo import lzw

# TIFF tag ids
T_WIDTH, T_HEIGHT = 256, 257
T_BITSPERSAMPLE, T_COMPRESSION, T_PHOTOMETRIC = 258, 259, 262
T_STRIPOFFSETS, T_SAMPLESPERPIXEL, T_ROWSPERSTRIP, T_STRIPBYTECOUNTS = (
    273, 277, 278, 279,
)
T_PLANARCONFIG, T_PREDICTOR, T_SAMPLEFORMAT = 284, 317, 339
T_TILEWIDTH, T_TILELENGTH, T_TILEOFFSETS, T_TILEBYTECOUNTS = 322, 323, 324, 325
T_MODELPIXELSCALE, T_MODELTIEPOINT = 33550, 33922
T_GEOKEYDIR, T_GEOASCII = 34735, 34737
T_GDAL_NODATA = 42113

# TIFF field types
FT_BYTE, FT_ASCII, FT_SHORT, FT_LONG, FT_RATIONAL = 1, 2, 3, 4, 5
FT_DOUBLE, FT_LONG8 = 12, 16
_FT_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
            11: 4, 12: 8, 16: 8, 17: 8, 18: 8}

_SF_UINT, _SF_INT, _SF_FLOAT = 1, 2, 3

_DTYPES = {
    (8, _SF_UINT): np.uint8, (16, _SF_UINT): np.uint16, (32, _SF_UINT): np.uint32,
    (16, _SF_INT): np.int16, (32, _SF_INT): np.int32,
    (32, _SF_FLOAT): np.float32, (64, _SF_FLOAT): np.float64,
}


@dataclasses.dataclass
class GeoTiff:
    data: np.ndarray                       # [H, W] or [H, W, C]
    geo_transform: tuple = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
    projection: str = ""
    nodata: Optional[float] = None


# ---------------------------------------------------------------------------
# predictors
# ---------------------------------------------------------------------------


def _predict2_encode(rows: np.ndarray) -> np.ndarray:
    """Integer horizontal differencing per sample (modular), word-wise for the
    sample's width — float32 is differenced as its uint32 bit pattern, which
    is how libtiff treats 32-bit samples under predictor 2."""
    kind = rows.dtype
    as_uint = rows.view(f"u{kind.itemsize}") if kind.kind in "fiu" else rows
    out = as_uint.copy()
    out[:, 1:] = as_uint[:, 1:] - as_uint[:, :-1]
    return out.view(kind)


def _predict2_decode(rows: np.ndarray) -> np.ndarray:
    kind = rows.dtype
    as_uint = rows.view(f"u{kind.itemsize}")
    out = np.cumsum(as_uint, axis=1, dtype=as_uint.dtype)
    return out.view(kind)


def _predict3_encode(rows: np.ndarray) -> bytes:
    """Floating-point predictor (libtiff fpDiff): per row, split samples into
    big-endian byte planes, then byte-wise horizontal differencing."""
    h, w = rows.shape
    bps = rows.dtype.itemsize
    be = rows.astype(rows.dtype.newbyteorder(">"))
    by = be.view(np.uint8).reshape(h, w, bps)
    planes = by.transpose(0, 2, 1).reshape(h, w * bps)  # [H, bps*W] byte planes
    diff = planes.copy()
    diff[:, 1:] = planes[:, 1:] - planes[:, :-1]
    return diff.tobytes()


def _predict3_decode(raw: bytes, h: int, w: int, dtype) -> np.ndarray:
    bps = np.dtype(dtype).itemsize
    planes = np.frombuffer(raw, np.uint8).reshape(h, bps, w).copy()
    acc = np.cumsum(planes.reshape(h, bps * w), axis=1, dtype=np.uint8)
    by = acc.reshape(h, bps, w).transpose(0, 2, 1)
    be = np.ascontiguousarray(by).view(np.dtype(dtype).newbyteorder(">"))
    return be.reshape(h, w).astype(dtype)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _sample_format(dtype) -> int:
    k = np.dtype(dtype).kind
    return {"u": _SF_UINT, "i": _SF_INT, "f": _SF_FLOAT}[k]


def write_geotiff(
    path: str,
    data: np.ndarray,
    geo_transform=(0.0, 1.0, 0.0, 0.0, 0.0, -1.0),
    projection: str = "",
    nodata: Optional[float] = None,
    compress: str = "lzw",          # none | lzw | deflate
    predictor: Optional[int] = None,  # default: 2 for ints, 3 for floats
    rows_per_strip: Optional[int] = None,
    bigtiff: Optional[bool] = None,
) -> None:
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[:, :, None]
    assert data.ndim == 3, data.shape
    h, w, c = data.shape
    dtype = data.dtype
    if (w and geo_transform[2]) or geo_transform[4]:
        raise ValueError("only north-up geo-transforms are supported")

    if predictor is None:
        predictor = 1 if compress == "none" else (
            3 if dtype.kind == "f" else 2)
    if rows_per_strip is None:
        row_bytes = w * c * dtype.itemsize
        rows_per_strip = max(1, min(h, (1 << 20) // max(row_bytes, 1)))
    n_strips = -(-h // rows_per_strip)

    raw_size = data.nbytes
    if bigtiff is None:
        bigtiff = raw_size > (3800 << 20)

    comp_id = {"none": 1, "lzw": 5, "deflate": 8}[compress]

    def encode_strip(s: int) -> bytes:
        y0 = s * rows_per_strip
        y1 = min(h, y0 + rows_per_strip)
        rows = data[y0:y1].reshape(y1 - y0, w * c)
        return _encode_rows(rows, dtype, predictor, comp_id)

    # Strips are independent; the native LZW codec releases the GIL (ctypes
    # call), so a thread pool scales compression across cores — the save
    # phase of a full 15000x70000 map triple is minutes single-threaded.
    n_workers = min(os.cpu_count() or 1, n_strips)
    if n_workers > 1 and comp_id != 1:
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(n_workers) as pool:
            strips = list(pool.map(encode_strip, range(n_strips)))
    else:
        strips = [encode_strip(s) for s in range(n_strips)]

    tags = _geo_tags(w, h, c, dtype, comp_id, predictor, rows_per_strip,
                     geo_transform, projection, nodata)

    with open(path, "wb") as f:
        _write_tiff(f, tags, strips, bigtiff)


def _encode_rows(rows: np.ndarray, dtype, predictor: int,
                 comp_id: int) -> bytes:
    """Predictor-encode + compress one strip's rows ([rows, W*C])."""
    if predictor == 2:
        raw = _predict2_encode(rows).tobytes()
    elif predictor == 3:
        raw = _predict3_encode(rows.view(dtype))
    else:
        raw = rows.tobytes()
    if comp_id == 5:
        raw = lzw.encode(raw)
    elif comp_id == 8:
        raw = zlib.compress(raw, 6)
    return raw


def _geo_tags(w, h, c, dtype, comp_id, predictor, rows_per_strip,
              geo_transform, projection, nodata):
    tags = []  # (tag, field_type, count, values|bytes)
    tags.append((T_WIDTH, FT_LONG, 1, [w]))
    tags.append((T_HEIGHT, FT_LONG, 1, [h]))
    tags.append((T_BITSPERSAMPLE, FT_SHORT, c, [dtype.itemsize * 8] * c))
    tags.append((T_COMPRESSION, FT_SHORT, 1, [comp_id]))
    tags.append((T_PHOTOMETRIC, FT_SHORT, 1, [1]))
    tags.append((T_SAMPLESPERPIXEL, FT_SHORT, 1, [c]))
    tags.append((T_ROWSPERSTRIP, FT_LONG, 1, [rows_per_strip]))
    tags.append((T_PLANARCONFIG, FT_SHORT, 1, [1]))
    if predictor != 1:
        tags.append((T_PREDICTOR, FT_SHORT, 1, [predictor]))
    tags.append((T_SAMPLEFORMAT, FT_SHORT, c, [_sample_format(dtype)] * c))
    gt = geo_transform
    tags.append((T_MODELPIXELSCALE, FT_DOUBLE, 3, [gt[1], -gt[5], 0.0]))
    tags.append((T_MODELTIEPOINT, FT_DOUBLE, 6,
                 [0.0, 0.0, 0.0, gt[0], gt[3], 0.0]))
    if projection:
        ascii_params = projection + "|"
        # GeoKeyDirectory v1.1: one key, GTCitationGeoKey (1026) -> ascii.
        tags.append((T_GEOKEYDIR, FT_SHORT, 8,
                     [1, 1, 0, 1, 1026, T_GEOASCII, len(ascii_params), 0]))
        tags.append((T_GEOASCII, FT_ASCII, len(ascii_params) + 1,
                     ascii_params.encode() + b"\0"))
    if nodata is not None:
        nd = (f"{nodata}").encode() + b"\0"
        tags.append((T_GDAL_NODATA, FT_ASCII, len(nd), nd))
    return tags


class TiffStreamWriter:
    """Incremental single-band GeoTIFF writer with bounded memory.

    Rows stream in via :meth:`write_rows`; strips are predictor-encoded and
    compressed (thread pool across ready strips) and written sequentially;
    the IFD is emitted at close and the header patched to point at it —
    the resulting file is byte-layout-compatible with ``write_geotiff``'s
    (strip data first, IFD last).  Built for the streaming inference engine,
    where output maps are produced one tile-row at a time and must never be
    resident in full.
    """

    def __init__(self, path, width, height, dtype,
                 geo_transform=(0.0, 1.0, 0.0, 0.0, 0.0, -1.0),
                 projection: str = "", nodata: Optional[float] = None,
                 compress: str = "lzw", predictor: Optional[int] = None,
                 rows_per_strip: Optional[int] = None,
                 bigtiff: Optional[bool] = None):
        if (width and geo_transform[2]) or geo_transform[4]:
            raise ValueError("only north-up geo-transforms are supported")
        self.w, self.h = width, height
        self.dtype = np.dtype(dtype)
        self.comp_id = {"none": 1, "lzw": 5, "deflate": 8}[compress]
        if predictor is None:
            predictor = 1 if compress == "none" else (
                3 if self.dtype.kind == "f" else 2)
        self.predictor = predictor
        if rows_per_strip is None:
            row_bytes = width * self.dtype.itemsize
            rows_per_strip = max(1, min(height,
                                        (1 << 20) // max(row_bytes, 1)))
        self.rps = rows_per_strip
        raw_size = width * height * self.dtype.itemsize
        self.bigtiff = raw_size > (3800 << 20) if bigtiff is None else bigtiff
        self.tags = _geo_tags(width, height, 1, self.dtype, self.comp_id,
                              predictor, rows_per_strip, geo_transform,
                              projection, nodata)
        self.f = open(path, "wb")
        if self.bigtiff:
            self.f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, 0))
            self._ifd_offset_pos = 8
        else:
            self.f.write(struct.pack("<2sHI", b"II", 42, 0))
            self._ifd_offset_pos = 4
        self._offsets: list[int] = []
        self._counts: list[int] = []
        self._pending: list[np.ndarray] = []
        self._pending_rows = 0
        self._rows_written = 0

    def write_rows(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, self.dtype)
        if rows.ndim == 3:
            assert rows.shape[2] == 1, rows.shape
            rows = rows[:, :, 0]
        assert rows.shape[1] == self.w, rows.shape
        self._pending.append(rows)
        self._pending_rows += rows.shape[0]
        self._rows_written += rows.shape[0]
        assert self._rows_written <= self.h, "wrote past declared height"
        self._flush(final=self._rows_written == self.h)

    def _flush(self, final: bool) -> None:
        ready = []
        while self._pending_rows >= self.rps or (final and
                                                 self._pending_rows > 0):
            take = min(self.rps, self._pending_rows)
            chunks, got = [], 0
            while got < take:
                head = self._pending[0]
                need = take - got
                if head.shape[0] <= need:
                    chunks.append(self._pending.pop(0))
                    got += head.shape[0]
                else:
                    chunks.append(head[:need])
                    self._pending[0] = head[need:]
                    got += need
            self._pending_rows -= take
            ready.append(np.concatenate(chunks, axis=0)
                         if len(chunks) > 1 else chunks[0])
        if not ready:
            return
        if len(ready) > 1 and self.comp_id != 1:
            import concurrent.futures

            with concurrent.futures.ThreadPoolExecutor(
                min(os.cpu_count() or 1, len(ready))
            ) as pool:
                blobs = list(pool.map(
                    lambda r: _encode_rows(r, self.dtype, self.predictor,
                                           self.comp_id), ready))
        else:
            blobs = [_encode_rows(r, self.dtype, self.predictor, self.comp_id)
                     for r in ready]
        for blob in blobs:
            pos = self.f.tell()
            if pos % 2:
                self.f.write(b"\0")
                pos += 1
            self._offsets.append(pos)
            self._counts.append(len(blob))
            self.f.write(blob)

    def close(self) -> None:
        if self._rows_written != self.h:
            raise ValueError(
                f"wrote {self._rows_written} rows, declared {self.h}")
        off_ft = FT_LONG8 if self.bigtiff else FT_LONG
        tags = list(self.tags)
        tags.append((T_STRIPOFFSETS, off_ft, len(self._offsets),
                     self._offsets))
        tags.append((T_STRIPBYTECOUNTS, off_ft, len(self._counts),
                     self._counts))
        tags.sort(key=lambda t: t[0])
        inline_size = 8 if self.bigtiff else 4
        payload = {}
        for i, (tag, ft, count, values) in enumerate(tags):
            raw = _pack_values(ft, values)
            if len(raw) > inline_size:
                pos = self.f.tell()
                if pos % 2:
                    self.f.write(b"\0")
                    pos += 1
                self.f.write(raw)
                payload[i] = pos
        ifd_pos = self.f.tell()
        if ifd_pos % 2:
            self.f.write(b"\0")
            ifd_pos += 1
        if self.bigtiff:
            self.f.write(struct.pack("<Q", len(tags)))
        else:
            self.f.write(struct.pack("<H", len(tags)))
        for i, (tag, ft, count, values) in enumerate(tags):
            self.f.write(struct.pack("<HH", tag, ft))
            self.f.write(struct.pack("<Q" if self.bigtiff else "<I", count))
            if i in payload:
                self.f.write(struct.pack("<Q" if self.bigtiff else "<I",
                                         payload[i]))
            else:
                raw = _pack_values(ft, values)
                self.f.write(raw.ljust(inline_size, b"\0"))
        self.f.write(struct.pack("<Q" if self.bigtiff else "<I", 0))
        self.f.seek(self._ifd_offset_pos)
        self.f.write(struct.pack("<Q" if self.bigtiff else "<I", ifd_pos))
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # An exception escaped the with-body: the row count is expected
            # to be short, so just release the file handle — raising the
            # "wrote N rows" ValueError here would mask the original error.
            self.f.close()
            return
        self.close()


def _pack_values(ft: int, values, endian="<") -> bytes:
    if isinstance(values, (bytes, bytearray)):
        return bytes(values)
    fmt = {FT_SHORT: "H", FT_LONG: "I", FT_DOUBLE: "d", FT_LONG8: "Q",
           FT_BYTE: "B"}[ft]
    return struct.pack(f"{endian}{len(values)}{fmt}", *values)


def _write_tiff(f: BinaryIO, tags, strips, bigtiff: bool) -> None:
    if bigtiff:
        f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, 16))
        ifd_offset_pos = 8
        off_ft, entry_fmt = FT_LONG8, "<HHQ"
        count_size, inline_size, entry_size = 8, 8, 20
    else:
        f.write(struct.pack("<2sHI", b"II", 42, 8))
        ifd_offset_pos = 4
        off_ft, entry_fmt = FT_LONG, "<HHI"
        count_size, inline_size, entry_size = 4, 4, 12

    # Write strip data first.
    strip_offsets, strip_counts = [], []
    for s in strips:
        pos = f.tell()
        if pos % 2:
            f.write(b"\0")
            pos += 1
        strip_offsets.append(pos)
        strip_counts.append(len(s))
        f.write(s)

    tags = list(tags)
    tags.append((T_STRIPOFFSETS, off_ft, len(strips), strip_offsets))
    tags.append((T_STRIPBYTECOUNTS, off_ft, len(strips), strip_counts))
    tags.sort(key=lambda t: t[0])

    # Out-of-line tag payloads.
    payload = {}
    for i, (tag, ft, count, values) in enumerate(tags):
        raw = _pack_values(ft, values)
        if len(raw) > inline_size:
            pos = f.tell()
            if pos % 2:
                f.write(b"\0")
                pos += 1
            f.write(raw)
            payload[i] = pos

    ifd_pos = f.tell()
    if ifd_pos % 2:
        f.write(b"\0")
        ifd_pos += 1
    if bigtiff:
        f.write(struct.pack("<Q", len(tags)))
    else:
        f.write(struct.pack("<H", len(tags)))
    for i, (tag, ft, count, values) in enumerate(tags):
        f.write(struct.pack("<HH", tag, ft))
        f.write(struct.pack("<Q" if bigtiff else "<I", count))
        if i in payload:
            f.write(struct.pack("<Q" if bigtiff else "<I", payload[i]))
        else:
            raw = _pack_values(ft, values)
            f.write(raw.ljust(inline_size, b"\0"))
    f.write(struct.pack("<Q" if bigtiff else "<I", 0))  # next IFD

    f.seek(ifd_offset_pos)
    f.write(struct.pack("<Q" if bigtiff else "<I", ifd_pos))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class TiffReader:
    """Streaming reader with windowed row access for huge rasters."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        head = self.f.read(8)
        self.endian = "<" if head[:2] == b"II" else ">"
        version = struct.unpack(self.endian + "H", head[2:4])[0]
        self.big = version == 43
        if self.big:
            self.f.seek(8)
            (ifd,) = struct.unpack(self.endian + "Q", self.f.read(8))
        else:
            (ifd,) = struct.unpack(self.endian + "I", head[4:8])
        self.tags = self._read_ifd(ifd)
        self._parse()

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _read_ifd(self, pos):
        e = self.endian
        self.f.seek(pos)
        if self.big:
            (n,) = struct.unpack(e + "Q", self.f.read(8))
            entry_size, count_fmt, off_fmt = 20, "Q", "Q"
        else:
            (n,) = struct.unpack(e + "H", self.f.read(2))
            entry_size, count_fmt, off_fmt = 12, "I", "I"
        raw = self.f.read(n * entry_size)
        tags = {}
        for i in range(n):
            ent = raw[i * entry_size : (i + 1) * entry_size]
            tag, ft = struct.unpack(e + "HH", ent[:4])
            (count,) = struct.unpack(e + count_fmt, ent[4 : 4 + (8 if self.big else 4)])
            inline = ent[4 + (8 if self.big else 4) :]
            size = _FT_SIZE.get(ft, 1) * count
            if size <= len(inline):
                data = inline[:size]
            else:
                (off,) = struct.unpack(e + off_fmt, inline[: (8 if self.big else 4)])
                here = self.f.tell()
                self.f.seek(off)
                data = self.f.read(size)
                self.f.seek(here)
            tags[tag] = self._decode_values(ft, count, data)
        return tags

    def _decode_values(self, ft, count, data):
        e = self.endian
        if ft == FT_ASCII:
            return data.rstrip(b"\0").decode("latin-1")
        fmt = {FT_BYTE: "B", FT_SHORT: "H", FT_LONG: "I", FT_DOUBLE: "d",
               FT_LONG8: "Q", 8: "h", 9: "i", 11: "f", 17: "q"}.get(ft)
        if fmt is None:
            return data
        return list(struct.unpack(f"{e}{count}{fmt}", data[: count * _FT_SIZE[ft]]))

    def _parse(self):
        t = self.tags
        self.width = t[T_WIDTH][0]
        self.height = t[T_HEIGHT][0]
        self.samples = t.get(T_SAMPLESPERPIXEL, [1])[0]
        bits = t.get(T_BITSPERSAMPLE, [8])[0]
        sf = t.get(T_SAMPLEFORMAT, [_SF_UINT])[0]
        self.dtype = np.dtype(_DTYPES[(bits, sf)])
        # big-endian (MM) files: samples are byte-swapped before predictor
        # accumulation, matching libtiff's swab-then-predict order.
        self._file_dtype = (
            self.dtype.newbyteorder(">") if self.endian == ">" else self.dtype
        )
        self.compression = t.get(T_COMPRESSION, [1])[0]
        self.predictor = t.get(T_PREDICTOR, [1])[0]
        self.tiled = T_TILEOFFSETS in t
        if self.tiled:
            self.tile_w = t[T_TILEWIDTH][0]
            self.tile_h = t[T_TILELENGTH][0]
            self.tile_offsets = t[T_TILEOFFSETS]
            self.tile_counts = t[T_TILEBYTECOUNTS]
            self.tiles_across = -(-self.width // self.tile_w)
            self.tiles_down = -(-self.height // self.tile_h)
        else:
            self.rows_per_strip = t.get(T_ROWSPERSTRIP, [self.height])[0]
            self.strip_offsets = t[T_STRIPOFFSETS]
            self.strip_counts = t[T_STRIPBYTECOUNTS]
        # geo
        scale = t.get(T_MODELPIXELSCALE)
        tie = t.get(T_MODELTIEPOINT)
        if scale and tie:
            self.geo_transform = (tie[3], scale[0], 0.0, tie[4], 0.0, -scale[1])
        else:
            self.geo_transform = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
        self.projection = t.get(T_GEOASCII, "").rstrip("|") if isinstance(
            t.get(T_GEOASCII, ""), str) else ""
        nd = t.get(T_GDAL_NODATA)
        self.nodata = float(nd) if isinstance(nd, str) and nd else None

    def _strip(self, idx: int) -> np.ndarray:
        """Decode one strip -> [rows, W*C] array."""
        y0 = idx * self.rows_per_strip
        rows = min(self.rows_per_strip, self.height - y0)
        return self._decode_block(self.strip_offsets[idx],
                                  self.strip_counts[idx], rows, self.width)

    def _decode_block(self, offset: int, count: int, rows: int,
                      cols: int) -> np.ndarray:
        """Decode one strip/tile payload -> [rows, cols*C] array."""
        self.f.seek(offset)
        raw = self.f.read(count)
        expected = rows * cols * self.samples * self.dtype.itemsize
        if self.compression == 5:
            raw = lzw.decode(raw, expected)
        elif self.compression == 8:
            raw = zlib.decompress(raw)
        elif self.compression != 1:
            raise ValueError(f"unsupported compression {self.compression}")
        if self.predictor == 3:
            return _predict3_decode(raw, rows, cols * self.samples, self.dtype)
        arr = np.frombuffer(raw, self._file_dtype).reshape(
            rows, cols * self.samples
        )
        if self._file_dtype != self.dtype:
            arr = arr.astype(self.dtype)
        if self.predictor == 2:
            arr = _predict2_decode(arr)
        return arr

    def _tile(self, ti: int, tj: int) -> np.ndarray:
        idx = ti * self.tiles_across + tj
        return self._decode_block(self.tile_offsets[idx],
                                  self.tile_counts[idx],
                                  self.tile_h, self.tile_w)

    def _read_rows_tiled(self, y0: int, y1: int) -> np.ndarray:
        out = np.zeros((y1 - y0, self.width * self.samples), self.dtype)
        t0 = y0 // self.tile_h
        t1 = (y1 - 1) // self.tile_h
        spp = self.samples
        for ti in range(t0, t1 + 1):
            ty0 = ti * self.tile_h
            a = max(y0, ty0)
            b = min(y1, ty0 + self.tile_h)
            for tj in range(self.tiles_across):
                tile = self._tile(ti, tj)
                x0 = tj * self.tile_w
                ww = min(self.tile_w, self.width - x0)
                out[a - y0 : b - y0, x0 * spp : (x0 + ww) * spp] = tile[
                    a - ty0 : b - ty0, : ww * spp
                ]
        return out

    def read_rows(self, y0: int, y1: int) -> np.ndarray:
        """Read rows [y0, y1) -> [y1-y0, W] or [y1-y0, W, C]."""
        if self.tiled:
            block = self._read_rows_tiled(y0, y1)
        else:
            s0 = y0 // self.rows_per_strip
            s1 = (y1 - 1) // self.rows_per_strip
            parts = [self._strip(s) for s in range(s0, s1 + 1)]
            block = np.concatenate(parts, axis=0)
            off = y0 - s0 * self.rows_per_strip
            block = block[off : off + (y1 - y0)]
        if self.samples > 1:
            return block.reshape(y1 - y0, self.width, self.samples)
        return block.reshape(y1 - y0, self.width)

    def read(self) -> np.ndarray:
        return self.read_rows(0, self.height)


def read_geotiff(path: str) -> GeoTiff:
    with TiffReader(path) as r:
        return GeoTiff(
            data=r.read(),
            geo_transform=r.geo_transform,
            projection=r.projection,
            nodata=r.nodata,
        )
