"""TIFF-variant LZW codec (counterpart of moonsuperresolution_tpu/geo/lzw.py).

``encode`` and ``decode`` call the native codec ``csrc/lzw.cpp``, built with
g++ at first use (``build.build_host``).  ``encode_plain`` and
``decode_plain`` are its plain Python version, used by the tests.  There is
no fallback from the one to the other: a failed build or a failed native
call raises.

TIFF LZW specifics: MSB-first bit packing, code width grows 9->12 bits with
the *early-change* convention (width bumps one code early), ClearCode=256,
EOI=257.
"""

from __future__ import annotations

import ctypes

from moonsuperresolution_tpu_torch import build

_CLEAR = 256
_EOI = 257


def _lib() -> ctypes.CDLL:
    lib = build.load("lzw")
    if lib.lzw_decode.argtypes is None:
        for fn in (lib.lzw_decode, lib.lzw_encode):
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                           ctypes.POINTER(ctypes.c_char), ctypes.c_longlong]
    return lib


def decode(data: bytes, expected_size: int) -> bytes:
    """Decode up to ``expected_size`` bytes of one LZW strip."""
    out = ctypes.create_string_buffer(expected_size)
    n = _lib().lzw_decode(data, len(data), out, expected_size)
    if n < 0:
        raise ValueError("corrupt LZW stream")
    return out.raw[:n]


def encode(data: bytes) -> bytes:
    # worst case: 12 bits per input byte, plus Clear and EOI codes
    cap = len(data) + (len(data) >> 1) + 1024
    out = ctypes.create_string_buffer(cap)
    n = _lib().lzw_encode(data, len(data), out, cap)
    if n < 0:
        raise RuntimeError(f"LZW encode overflowed its {cap}-byte buffer")
    return out.raw[:n]


# --------------------------------------------------------------------------
# Plain Python version
# --------------------------------------------------------------------------


def decode_plain(data: bytes, expected_size: int) -> bytes:
    out = bytearray()
    table: list[bytes] = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    bitpos = 0
    nbits = 9
    prev: bytes | None = None
    total_bits = len(data) * 8
    while bitpos + nbits <= total_bits:
        byte_idx = bitpos >> 3
        chunk = int.from_bytes(data[byte_idx : byte_idx + 4].ljust(4, b"\0"),
                               "big")
        code = (chunk >> (32 - nbits - (bitpos & 7))) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == _EOI:
            break
        if code == _CLEAR:
            reset()
            nbits = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # early-change: bump width one entry early
        if len(table) + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
        if len(out) >= expected_size:
            break
    return bytes(out)


def encode_plain(data: bytes) -> bytes:
    out = bytearray()
    acc = 0
    accbits = 0

    def put(code: int, nbits: int):
        nonlocal acc, accbits
        acc = (acc << nbits) | code
        accbits += nbits
        while accbits >= 8:
            accbits -= 8
            out.append((acc >> accbits) & 0xFF)

    table: dict[bytes, int] = {bytes([i]): i for i in range(256)}
    next_code = 258
    nbits = 9
    put(_CLEAR, nbits)
    w = b""
    for b in data:
        c = bytes([b])
        wc = w + c
        if wc in table:
            w = wc
            continue
        put(table[w], nbits)
        table[wc] = next_code
        next_code += 1
        # early change on the encoder side too
        if next_code + 1 > (1 << nbits):
            if nbits < 12:
                nbits += 1
            else:
                put(_CLEAR, nbits)
                table = {bytes([i]): i for i in range(256)}
                next_code = 258
                nbits = 9
        w = c
    if w:
        put(table[w], nbits)
    put(_EOI, nbits)
    if accbits:
        out.append((acc << (8 - accbits)) & 0xFF)
    return bytes(out)
