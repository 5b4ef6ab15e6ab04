"""A small MessagePack encoder/decoder for checkpoint manifests.

Manifests hold maps, arrays, strings, byte strings, bools, nil, floats and
integers — nothing else — so this module implements exactly those types
instead of depending on the ``msgpack`` package. The encoding follows the
MessagePack spec with the choices ``msgpack.packb(obj, use_bin_type=True)``
makes, byte for byte:

  - every integer takes the smallest form: positive/negative fixint, then
    ``uint8..uint64`` (0xcc-0xcf) for positives and ``int8..int64``
    (0xd0-0xd3) for negatives; digests are u64 and often exceed 2**63, so
    0xcf carries them;
  - floats are always float64 (0xcb);
  - ``str`` is UTF-8 with the str8 form (0xd9) enabled, ``bytes`` use the
    bin family (0xc4-0xc6);
  - lists and tuples encode as arrays, dicts as maps, in iteration order.

Decoding mirrors ``msgpack.unpackb(data, raw=False, strict_map_key=False)``:
arrays come back as lists, strings as ``str``, and map keys may be any
hashable decoded value (the cluster manifest keys hosts by int).
"""
from __future__ import annotations

import struct
from typing import Any


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """Header of a length-prefixed value (fix form, then 8/16/32-bit)."""
    c8, c16, c32 = codes
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif c8 and n < 1 << 8:
        out += struct.pack(">BB", c8, n)
    elif n < 1 << 16:
        out += struct.pack(">BH", c16, n)
    elif n < 1 << 32:
        out += struct.pack(">BI", c32, n)
    else:
        raise ValueError(f"msgpack length {n} too large")


def _pack_int(x: int, out: bytearray) -> None:
    if x < -(1 << 5):
        if x < -(1 << 63):
            raise OverflowError(f"integer {x} out of msgpack range")
        if x < -(1 << 31):
            out += struct.pack(">Bq", 0xD3, x)
        elif x < -(1 << 15):
            out += struct.pack(">Bi", 0xD2, x)
        elif x < -(1 << 7):
            out += struct.pack(">Bh", 0xD1, x)
        else:
            out += struct.pack(">Bb", 0xD0, x)
    elif x < 1 << 7:
        out += struct.pack(">b", x)  # positive or negative fixint
    elif x < 1 << 8:
        out += struct.pack(">BB", 0xCC, x)
    elif x < 1 << 16:
        out += struct.pack(">BH", 0xCD, x)
    elif x < 1 << 32:
        out += struct.pack(">BI", 0xCE, x)
    elif x < 1 << 64:
        out += struct.pack(">BQ", 0xCF, x)
    else:
        raise OverflowError(f"integer {x} out of msgpack range")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 15, (0, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def unpackb(data: bytes) -> Any:
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"extra data after msgpack object ({len(data) - pos} bytes)")
    return obj


# fixed-width scalar forms: code -> (struct format, byte count)
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# length-prefixed forms: code -> (kind, length struct format, byte count)
_SIZED = {
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def _unpack(buf: memoryview, pos: int) -> tuple[Any, int]:
    code = buf[pos]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0xA0 <= code <= 0xBF:
        return _sized("str", code & 0x1F, buf, pos)
    if 0x90 <= code <= 0x9F:
        return _sized("array", code & 0x0F, buf, pos)
    if 0x80 <= code <= 0x8F:
        return _sized("map", code & 0x0F, buf, pos)
    if code == 0xC0:
        return None, pos
    if code == 0xC2:
        return False, pos
    if code == 0xC3:
        return True, pos
    if code in _SCALARS:
        fmt, n = _SCALARS[code]
        return struct.unpack_from(fmt, buf, pos)[0], pos + n
    if code in _SIZED:
        kind, fmt, n = _SIZED[code]
        length = struct.unpack_from(fmt, buf, pos)[0]
        return _sized(kind, length, buf, pos + n)
    raise ValueError(f"unsupported msgpack type code {code:#x}")


def _sized(kind: str, n: int, buf: memoryview, pos: int) -> tuple[Any, int]:
    if kind == "str":
        return str(buf[pos : pos + n], "utf-8"), pos + n
    if kind == "bin":
        return bytes(buf[pos : pos + n]), pos + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            out.append(v)
        return out, pos
    d = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        d[k] = v
    return d, pos
