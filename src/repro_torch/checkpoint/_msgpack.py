"""The msgpack subset a checkpoint's ``.meta`` sidecar holds, written and
read without the ``msgpack`` package.

Types: maps with str keys, arrays (lists or tuples), str, int, float,
bool and None.  :func:`packb` gives the bytes ``msgpack.packb(obj)``
gives with its defaults (the smallest int encoding, fixstr / str8 / 16 /
32, fixarray / array16 / 32, fixmap / map16 / 32, every float as a
float64 ``0xcb``); :func:`unpackb` reads them back as ``msgpack.unpackb``
does (maps as dicts, arrays as lists; a float32 ``0xca`` too).  Any other
type raises TypeError, an int outside [-2**63, 2**64) OverflowError, and
bytes that are not one whole object of the subset ValueError.
"""
from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _head(out: bytearray, n: int, fix: int, fix_max: int, wide: tuple):
    """A length header: ``fix | n`` below ``fix_max``, else the first of
    ``wide``'s (code, struct format, limit) whose limit ``n`` is under."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in wide:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack's 32-bit lengths")


def _pack(o, out: bytearray) -> None:
    if o is None:
        out.append(0xC0)
    elif o is True or o is False:
        out.append(0xC3 if o else 0xC2)
    elif isinstance(o, int):
        _pack_int(o, out)
    elif isinstance(o, float):
        out.append(0xCB)
        out += struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode("utf-8")
        _head(out, len(b), 0xA0, 32, ((0xD9, ">B", 1 << 8),
                                      (0xDA, ">H", 1 << 16),
                                      (0xDB, ">I", 1 << 32)))
        out += b
    elif isinstance(o, dict):
        _head(out, len(o), 0x80, 16, ((0xDE, ">H", 1 << 16),
                                      (0xDF, ">I", 1 << 32)))
        for k, v in o.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r}: the subset takes str keys")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(o, (list, tuple)):
        _head(out, len(o), 0x90, 16, ((0xDC, ">H", 1 << 16),
                                      (0xDD, ">I", 1 << 32)))
        for v in o:
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(o).__name__!r} object")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128 or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
        return
    if n > 0:
        wide = ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64))
        fits = lambda limit: n < limit
    else:
        wide = ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63))
        fits = lambda limit: n >= -limit
    for code, fmt, limit in wide:
        if fits(limit):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError("Integer value out of range")


#: fixed-width codes: (struct format, byte count)
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1),
            0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
            0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4),
            0xD3: (">q", 8)}
#: length-prefixed codes: (kind, struct format of the length, its bytes)
_SIZED = {0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2),
          0xDB: ("str", ">I", 4), 0xDC: ("array", ">H", 2),
          0xDD: ("array", ">I", 4), 0xDE: ("map", ">H", 2),
          0xDF: ("map", ">I", 4)}


def unpackb(data: bytes):
    data = bytes(data)
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError("unpack(b) received extra data.")
    return obj


def _take(data: bytes, pos: int, n: int) -> int:
    if pos + n > len(data):
        raise ValueError("Unpack failed: incomplete input")
    return pos + n


def _unpack(data: bytes, pos: int):
    end = _take(data, pos, 1)
    c = data[pos]
    pos = end
    if c < 0x80 or c >= 0xE0:
        return struct.unpack(">b", bytes([c]))[0] if c >= 0xE0 else c, pos
    if c == 0xC0:
        return None, pos
    if c in (0xC2, 0xC3):
        return c == 0xC3, pos
    if c in _SCALARS:
        fmt, n = _SCALARS[c]
        end = _take(data, pos, n)
        return struct.unpack(fmt, data[pos:end])[0], end
    if 0xA0 <= c < 0xC0:
        kind, n = "str", c & 0x1F
    elif 0x90 <= c < 0xA0:
        kind, n = "array", c & 0x0F
    elif 0x80 <= c < 0x90:
        kind, n = "map", c & 0x0F
    elif c in _SIZED:
        kind, fmt, w = _SIZED[c]
        end = _take(data, pos, w)
        n, pos = struct.unpack(fmt, data[pos:end])[0], end
    else:
        raise ValueError(f"msgpack code 0x{c:02x} is outside the subset")
    if kind == "str":
        end = _take(data, pos, n)
        return data[pos:end].decode("utf-8"), end
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _unpack(data, pos)
            out.append(v)
        return out, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        if not isinstance(k, str):
            raise ValueError(f"{type(k).__name__} is not allowed for map "
                             f"key")
        out[k], pos = _unpack(data, pos)
    return out, pos
