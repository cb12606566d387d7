"""A numpy reader and writer of the HDF5 subset that holds the tile store
(counterpart of the JAX package's h5py calls, data/sampler.py and
data/h5_builder.py).  Nothing else in the port touches the file format.

The subset is what h5py writes for ``h5[name] = ndarray`` at the root of a
file with the library's default (earliest) format, which is how the
reference's ``MoonORTO2DEM.hdf5`` was made (make_h5.py via h5py):

- superblock version 0 (or 1), the root group's symbol-table entry in it;
- the root group: a symbol table (version-1 B-tree of group nodes, at any
  depth, whose leaves are symbol-table nodes "SNOD", and a local heap of
  names);
- each dataset: a version-1 object header (continuation messages followed)
  with a dataspace, a datatype (little-endian fixed-point or IEEE float)
  and a version-3 contiguous, unfiltered data layout.

``H5Reader`` maps the file once, read-only; ``f[name]`` is an ``np.memmap``
view at the dataset's data address, so a crop reads only its rows.  Whatever
lies outside the subset (a chunked, compact or filtered layout, new-style or
dense links, big-endian data, superblock version 2 or 3, ...) raises
``HDF5FormatError`` naming what it found; the reader never returns bytes it
did not understand.

``H5Writer`` appends each ``f[name] = ndarray`` to ``path + ".tmp"`` as it
comes; ``close()`` writes the object headers, the local heap, the SNODs and
the B-tree, then the superblock, and renames the file to ``path``.  h5py
reads the result back: the same names, dtypes, shapes and bytes.
"""

from __future__ import annotations

import os
import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
_FREE_NULL = 1               # a local heap with no free block (H5HL_FREE_NULL)
# Message types (HDF5 file format specification, IV.A.2).
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL, _LAYOUT = 0x1, 0x2, 0x3, 0x5, 0x8
_FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0xB, 0x10, 0x11
_FILTER_NAMES = {1: "deflate (gzip)", 2: "shuffle", 3: "fletcher32",
                 4: "szip", 5: "nbit", 6: "scaleoffset"}
_LAYOUT_NAMES = {0: "compact", 1: "contiguous", 2: "chunked", 3: "virtual"}
_CLASS_NAMES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                6: "compound", 7: "reference", 8: "enum",
                9: "variable-length", 10: "array"}
# IEEE float layouts by size: (sign bit, exponent location, exponent size,
# mantissa location, mantissa size, exponent bias).
_IEEE = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
         8: (63, 52, 11, 0, 52, 1023)}
# The writer's group B-tree and symbol-table-node ranks (h5py's defaults):
# an SNOD holds up to 2 * LEAF_K names, a B-tree node up to 2 * NODE_K
# children.
LEAF_K, NODE_K = 4, 16


class HDF5FormatError(ValueError):
    """The file lies outside the HDF5 subset that this module reads."""


def _uint(b: bytes, pos: int, size: int) -> int:
    return int.from_bytes(b[pos : pos + size], "little")


class H5Reader:
    """Read-only mapping of a tile store: ``f[name]`` (an ``np.memmap``),
    ``name in f``, iteration over the names in the file's (sorted) order,
    ``len(f)``, ``f.close()`` and ``with``."""

    def __init__(self, path: str):
        self.path = path
        self._mm = np.memmap(path, np.uint8, "r")
        self._datasets: dict[str, tuple] = {}
        try:
            root_header = self._superblock()
            btree, heap = self._root_symbol_table(root_header)
            names = self._heap_names(heap)
            self.root_btree_level = None
            self._entries = {}
            for name_off, header in self._btree_entries(btree, None):
                self._entries[names(name_off)] = header
        except HDF5FormatError:
            self.close()
            raise

    # ------------------------------------------------------------ parsing

    def _bytes(self, pos: int, n: int) -> bytes:
        if pos < 0 or pos + n > len(self._mm):
            raise HDF5FormatError(f"{self.path}: reads {n} bytes at {pos}, "
                                  f"past the end of the file")
        return bytes(self._mm[pos : pos + n])

    def _superblock(self) -> int:
        b = self._bytes(0, 24)
        if b[:8] != SIGNATURE:
            raise HDF5FormatError(f"{self.path}: no HDF5 signature at offset "
                                  "0 (a user block is not supported)")
        version = b[8]
        if version not in (0, 1):
            raise HDF5FormatError(f"{self.path}: superblock version {version}"
                                  " (only 0 and 1 are supported)")
        self.so, self.sl = b[13], b[14]          # sizes of offsets, lengths
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise HDF5FormatError(f"{self.path}: offsets of {self.so} and "
                                  f"lengths of {self.sl} bytes")
        self.undef = (1 << (8 * self.so)) - 1
        pos = 24 + (4 if version == 1 else 0)
        base = _uint(self._bytes(pos, self.so), 0, self.so)
        if base != 0:
            raise HDF5FormatError(f"{self.path}: base address {base}")
        entry = pos + 4 * self.so                 # the root's symbol entry
        return _uint(self._bytes(entry + self.so, self.so), 0, self.so)

    def _messages(self, addr: int) -> list[tuple[int, int, bytes]]:
        """(type, flags, data) of every message of the version-1 object
        header at ``addr``, continuation blocks followed."""
        head = self._bytes(addr, 16)
        if head[:4] == b"OHDR":
            raise HDF5FormatError(f"{self.path}: version-2 object header at "
                                  f"{addr}")
        if head[0] != 1:
            raise HDF5FormatError(f"{self.path}: object header version "
                                  f"{head[0]} at {addr}")
        count = _uint(head, 2, 2)
        blocks = [(addr + 16, _uint(head, 8, 4))]
        out = []
        while blocks and len(out) < count:
            pos, size = blocks.pop(0)
            block = self._bytes(pos, size)
            p = 0
            while p + 8 <= size and len(out) < count:
                mtype, msize, flags = (_uint(block, p, 2),
                                       _uint(block, p + 2, 2), block[p + 4])
                data = block[p + 8 : p + 8 + msize]
                p += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append((_uint(data, 0, self.so),
                                   _uint(data, self.so, self.sl)))
                out.append((mtype, flags, data))
        return out

    def _root_symbol_table(self, addr: int) -> tuple[int, int]:
        msgs = {t: d for t, _, d in self._messages(addr)}
        if _SYMBOL_TABLE in msgs:
            d = msgs[_SYMBOL_TABLE]
            return _uint(d, 0, self.so), _uint(d, self.so, self.so)
        if _LINK_INFO in msgs:
            info = msgs[_LINK_INFO]
            heap = _uint(info, 10 if info[1] & 1 else 2, self.so)
            kind = "new-style" if heap == self.undef else "dense"
            raise HDF5FormatError(f"{self.path}: the root group keeps {kind} "
                                  "links (a link-info message), not a symbol "
                                  "table")
        raise HDF5FormatError(f"{self.path}: the root group has no symbol "
                              "table")

    def _heap_names(self, addr: int):
        head = self._bytes(addr, 8 + 2 * self.sl + self.so)
        if head[:4] != b"HEAP":
            raise HDF5FormatError(f"{self.path}: no local heap at {addr}")
        size = _uint(head, 8, self.sl)
        data = self._bytes(_uint(head, 8 + 2 * self.sl, self.so), size)

        def name(off: int) -> str:
            end = data.find(b"\0", off)
            if off >= size or end < 0:
                raise HDF5FormatError(f"{self.path}: name offset {off} "
                                      "outside the local heap")
            return data[off:end].decode("utf-8")
        return name

    def _btree_entries(self, addr: int, level):
        """(name offset, object header address) of every symbol under the
        group B-tree node at ``addr``, in key order."""
        so, sl = self.so, self.sl
        head = self._bytes(addr, 8 + 2 * so)
        if head[:4] != b"TREE" or head[4] != 0:
            raise HDF5FormatError(f"{self.path}: no group B-tree node at "
                                  f"{addr}")
        node_level, n = head[5], _uint(head, 6, 2)
        if level is not None and node_level != level:
            raise HDF5FormatError(f"{self.path}: B-tree node at {addr} has "
                                  f"level {node_level}, expected {level}")
        if self.root_btree_level is None:
            self.root_btree_level = node_level
        body = self._bytes(addr + 8 + 2 * so, n * (sl + so) + sl)
        for i in range(n):
            child = _uint(body, i * (sl + so) + sl, so)
            if node_level:
                yield from self._btree_entries(child, node_level - 1)
            else:
                yield from self._snod_entries(child)

    def _snod_entries(self, addr: int):
        so = self.so
        head = self._bytes(addr, 8)
        if head[:4] != b"SNOD":
            raise HDF5FormatError(f"{self.path}: no symbol table node at "
                                  f"{addr}")
        n, size = _uint(head, 6, 2), 2 * so + 24
        body = self._bytes(addr + 8, n * size)
        for i in range(n):
            yield _uint(body, i * size, so), _uint(body, i * size + so, so)

    def _dataset(self, name: str) -> tuple:
        """(dtype, shape, address, nbytes) of the dataset ``name``."""
        if name in self._datasets:
            return self._datasets[name]
        msgs = self._messages(self._entries[name])
        types = {t for t, _, _ in msgs}
        if _SYMBOL_TABLE in types or _LINK_INFO in types:
            raise HDF5FormatError(f"{self.path}: {name!r} is a group, not a "
                                  "dataset")
        for mtype, flags, data in msgs:
            if flags & 2 and mtype in (_DATASPACE, _DATATYPE, _FILTERS,
                                       _LAYOUT):
                raise HDF5FormatError(f"{self.path}: {name!r} has a shared "
                                      f"message of type {mtype:#x}")
            if mtype == _FILTERS:
                raise HDF5FormatError(
                    f"{self.path}: {name!r} is filtered "
                    f"({', '.join(self._filter_names(data))})")
        got = {t: d for t, _, d in msgs}
        for mtype, what in ((_DATASPACE, "dataspace"),
                            (_DATATYPE, "datatype"), (_LAYOUT, "layout")):
            if mtype not in got:
                raise HDF5FormatError(f"{self.path}: {name!r} has no {what} "
                                      "message")
        shape = self._shape(name, got[_DATASPACE])
        dtype = self._dtype(name, got[_DATATYPE])
        lay = got[_LAYOUT]
        if lay[0] != 3:
            raise HDF5FormatError(f"{self.path}: {name!r} has a version-"
                                  f"{lay[0]} data layout (only 3)")
        if lay[1] != 1:
            raise HDF5FormatError(
                f"{self.path}: {name!r} has a "
                f"{_LAYOUT_NAMES.get(lay[1], f'class-{lay[1]}')} layout "
                "(only contiguous)")
        addr = _uint(lay, 2, self.so)
        nbytes = _uint(lay, 2 + self.so, self.sl)
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if want and (addr == self.undef or nbytes != want
                     or addr + nbytes > len(self._mm)):
            raise HDF5FormatError(
                f"{self.path}: {name!r} holds {nbytes} bytes at {addr}, its "
                f"{dtype}{list(shape)} needs {want} inside the file")
        self._datasets[name] = (dtype, shape, addr, want)
        return self._datasets[name]

    def _shape(self, name, d: bytes) -> tuple:
        version, rank = d[0], d[1]
        if version == 1:
            pos = 8
        elif version == 2:
            if d[3] == 2:
                raise HDF5FormatError(f"{self.path}: {name!r} has a null "
                                      "dataspace")
            pos = 4
        else:
            raise HDF5FormatError(f"{self.path}: {name!r} has a version-"
                                  f"{version} dataspace")
        return tuple(_uint(d, pos + i * self.sl, self.sl) for i in range(rank))

    def _dtype(self, name, d: bytes) -> np.dtype:
        cls, bits, size = d[0] & 0x0F, d[1], _uint(d, 4, 4)
        if cls == 0:                                  # fixed-point
            if bits & 1:
                raise HDF5FormatError(f"{self.path}: {name!r} is big-endian")
            if (_uint(d, 8, 2), _uint(d, 10, 2)) != (0, 8 * size) \
                    or size not in (1, 2, 4, 8):
                raise HDF5FormatError(f"{self.path}: {name!r} is a "
                                      f"{size}-byte integer with padding")
            return np.dtype(f"<{'i' if bits & 8 else 'u'}{size}")
        if cls == 1:                                  # IEEE float
            if bits & 0x41:
                raise HDF5FormatError(f"{self.path}: {name!r} is big-endian "
                                      "(or VAX) floating point")
            layout = (d[2], d[12], d[13], d[14], d[15], _uint(d, 16, 4))
            if size not in _IEEE or layout != _IEEE[size] \
                    or (_uint(d, 8, 2), _uint(d, 10, 2)) != (0, 8 * size):
                raise HDF5FormatError(f"{self.path}: {name!r} is a {size}-"
                                      "byte float that is not IEEE")
            return np.dtype(f"<f{size}")
        raise HDF5FormatError(f"{self.path}: {name!r} has a "
                              f"{_CLASS_NAMES.get(cls, f'class-{cls}')} "
                              "datatype")

    @staticmethod
    def _filter_names(d: bytes) -> list[str]:
        version, n = d[0], d[1]
        pos, out = (8 if version == 1 else 2), []
        for _ in range(n):
            fid = _uint(d, pos, 2)
            out.append(_FILTER_NAMES.get(fid, f"filter {fid}"))
            if version == 1 or fid >= 256:
                name_len, nvals = _uint(d, pos + 2, 2), _uint(d, pos + 6, 2)
            else:
                name_len, nvals = 0, _uint(d, pos + 4, 2)
            if version == 1:
                pos += 8 + name_len + 4 * nvals + (4 if nvals % 2 else 0)
            else:
                pos += (8 if fid >= 256 else 6) + name_len + 4 * nvals
        return out

    # ------------------------------------------------------------ mapping

    def __getitem__(self, name: str) -> np.ndarray:
        name = name.lstrip("/")
        if name not in self._entries:
            raise KeyError(f"{name!r} is not in {self.path}")
        dtype, shape, addr, nbytes = self._dataset(name)
        if not nbytes:
            return np.empty(shape, dtype)
        return self._mm[addr : addr + nbytes].view(dtype).reshape(shape)

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and name.lstrip("/") in self._entries

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def close(self) -> None:
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ------------------------------------------------------------------ writer


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _datatype(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "iu":
        return struct.pack("<B3BIHH", 0x10, 8 if dtype.kind == "i" else 0,
                           0, 0, size, 0, 8 * size)
    sign, eloc, esize, mloc, msize, bias = _IEEE[size]
    return struct.pack("<B3BIHH4BI", 0x11, 0x20, sign, 0, size, 0, 8 * size,
                       eloc, esize, mloc, msize, bias)


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


class H5Writer:
    """``f[name] = ndarray`` at the root of a new HDF5 file that h5py reads
    back.  Integer (1, 2, 4, 8 bytes) and IEEE float (2, 4, 8 bytes) data;
    each array's bytes go to ``path + ".tmp"`` when it is assigned, and
    ``close()`` (or leaving ``with``) writes the group's structures and
    renames the file to ``path``.  Leaving ``with`` on an exception removes
    the temporary file and leaves ``path`` as it was."""

    def __init__(self, path: str):
        self.path = path
        self.tmp = f"{path}.tmp"
        self.f = open(self.tmp, "wb")
        self.f.write(b"\0" * 96)              # the superblock, written last
        self.items: dict[str, tuple] = {}     # name -> (dtype, shape, addr)

    def __setitem__(self, name: str, value) -> None:
        if not isinstance(name, str) or not name or "/" in name \
                or "\0" in name:
            raise ValueError(f"dataset name {name!r}: a non-empty name "
                             "without '/' at the root")
        if name in self.items:
            raise ValueError(f"{name!r} already exists in {self.path}")
        arr = np.asarray(value)
        kind, size = arr.dtype.kind, arr.dtype.itemsize
        if kind not in "iuf" or (kind == "f" and size not in _IEEE):
            raise TypeError(f"{name!r}: dtype {arr.dtype} is not an integer "
                            "or an IEEE float")
        arr = arr.astype(arr.dtype.newbyteorder("<"), order="C", copy=False)
        addr = UNDEF
        if arr.nbytes:
            addr = self.f.tell()
            self.f.write(arr.reshape(-1).view(np.uint8).data)
        self.items[name] = (arr.dtype, arr.shape, addr)

    def _dataset_header(self, dtype, shape, addr) -> bytes:
        rank = len(shape)
        space = struct.pack("<BBB5x", 1, rank, 1 if rank else 0) \
            + struct.pack(f"<{2 * rank}Q", *shape, *shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        return _object_header([
            _message(_DATASPACE, space),
            _message(_DATATYPE, _datatype(dtype), flags=1),
            _message(_FILL, bytes([2, 2, 2, 1, 0, 0, 0, 0]), flags=1),
            _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, addr, nbytes))])

    def close(self) -> None:
        if self.f is None:
            return
        try:
            self._finish(self.f)
        except BaseException:
            self.abort()
            raise
        self.f.close()
        self.f = None
        os.replace(self.tmp, self.path)

    def abort(self) -> None:
        """Drops the file being written; ``path`` stays as it was."""
        if self.f is not None:
            self.f.close()
            self.f = None
            os.remove(self.tmp)

    def _finish(self, f) -> None:
        f.seek(0, os.SEEK_END)
        f.write(b"\0" * (-f.tell() % 8))
        names = sorted(self.items, key=lambda s: s.encode("utf-8"))

        # The local heap's data: "" at offset 0, then each name, 8-aligned.
        heap_data, name_off = bytearray(8), {}
        for name in names:
            name_off[name] = len(heap_data)
            heap_data += _pad8(name.encode("utf-8") + b"\0")

        headers = {}
        for name in names:
            headers[name] = f.tell()
            f.write(self._dataset_header(*self.items[name]))

        # Symbol-table nodes: the sorted names in nearly equal runs of at
        # most 2 * LEAF_K (each at least LEAF_K once there are that many).
        snod_size = 8 + 2 * LEAF_K * 40
        runs = _balanced(names, 2 * LEAF_K)
        children = []                          # (address, last name)
        for run in runs:
            addr = f.tell()
            node = struct.pack("<4sBxH", b"SNOD", 1, len(run)) + b"".join(
                struct.pack("<QQI4x16x", name_off[n], headers[n], 0)
                for n in run)
            f.write(node + b"\0" * (snod_size - len(node)))
            children.append((addr, run[-1]))

        # The group B-tree, built bottom up; every node at its full size.
        node_size = 24 + (2 * NODE_K + 1) * 8 + 2 * NODE_K * 8
        level = 0
        while True:
            groups = _balanced(children, 2 * NODE_K) or [[]]
            base = f.tell()
            addrs = [base + i * node_size for i in range(len(groups))]
            nxt, left_key = [], 0
            for i, group in enumerate(groups):
                left = addrs[i - 1] if i else UNDEF
                right = addrs[i + 1] if i + 1 < len(groups) else UNDEF
                body = struct.pack("<Q", left_key)
                for addr, last in group:
                    body += struct.pack("<QQ", addr, name_off[last])
                node = struct.pack("<4sBBHQQ", b"TREE", 0, level, len(group),
                                   left, right) + body
                f.write(node + b"\0" * (node_size - len(node)))
                if group:
                    left_key = name_off[group[-1][1]]
                    nxt.append((addrs[i], group[-1][1]))
            if len(groups) == 1:
                root_btree = addrs[0]
                break
            children, level = nxt, level + 1

        heap = f.tell()
        f.write(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data),
                            _FREE_NULL, heap + 32) + bytes(heap_data))
        root = f.tell()
        f.write(_object_header([_message(
            _SYMBOL_TABLE, struct.pack("<QQ", root_btree, heap))]))
        eof = f.tell()
        f.seek(0)
        f.write(SIGNATURE + struct.pack(
            "<8BHHI4Q", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, NODE_K, 0,
            0, UNDEF, eof, UNDEF)
            + struct.pack("<QQI4xQQ", 0, root, 1, root_btree, heap))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()


def _balanced(items: list, most: int) -> list[list]:
    """``items`` in consecutive runs of at most ``most``, as nearly equal in
    length as they can be."""
    if not items:
        return []
    n = -(-len(items) // most)
    q, r = divmod(len(items), n)
    out, pos = [], 0
    for i in range(n):
        k = q + (i < r)
        out.append(items[pos : pos + k])
        pos += k
    return out

