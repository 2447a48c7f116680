"""A MessagePack codec for the tiny-cuda-nn snapshot format.

The CUDA original writes its snapshots with nlohmann's ``json::to_msgpack``
and reads them with ``json::from_msgpack``; the JAX package uses the
``msgpack`` package for them (``tcnn_tpu/utils/cuda_import.py:60-66``,
``cuda_export.py:161-165``), which the port does not depend on.  This
codec covers the part of MessagePack those use: nil, bool, int, float32
and float64, str, bin, array and map (no ext types).

``packb`` writes what ``msgpack.packb(obj, use_bin_type=True)`` writes:
the smallest int form, float64 for every float, str8 and bin for byte
strings.  ``unpackb`` also reads float32, which nlohmann writes where a
value is exact in it.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int, codes) -> None:
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack: length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -0x20 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if obj < top:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: integer {obj} too large")
        else:
            for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                                   (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
                if obj >= low:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: integer {obj} too small")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


_FIXED = {  # code: (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {0xD9: 1, 0xDA: 2, 0xDB: 4, 0xC4: 1, 0xC5: 2, 0xC6: 4,
        0xDC: 2, 0xDD: 4, 0xDE: 2, 0xDF: 4}


def unpackb(data: bytes) -> Any:
    """Decodes one object; raises ValueError on anything else, trailing
    bytes included."""
    data = bytes(data)
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError(f"msgpack: {len(data) - pos} trailing bytes")
    return obj


def _take(data: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    if pos + n > len(data):
        raise ValueError("msgpack: truncated data")
    return data[pos:pos + n], pos + n


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    raw, pos = _take(data, pos, 1)
    code = raw[0]
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0x80 <= code <= 0x8F:
        return _unpack_map(data, pos, code & 0x0F)
    if 0x90 <= code <= 0x9F:
        return _unpack_array(data, pos, code & 0x0F)
    if 0xA0 <= code <= 0xBF:
        raw, pos = _take(data, pos, code & 0x1F)
        return raw.decode("utf-8"), pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        fmt, size = _FIXED[code]
        raw, pos = _take(data, pos, size)
        return struct.unpack(fmt, raw)[0], pos
    if code in _LEN:
        size = _LEN[code]
        raw, pos = _take(data, pos, size)
        n = int.from_bytes(raw, "big")
        if code in (0xDC, 0xDD):
            return _unpack_array(data, pos, n)
        if code in (0xDE, 0xDF):
            return _unpack_map(data, pos, n)
        raw, pos = _take(data, pos, n)
        return (raw.decode("utf-8") if code in (0xD9, 0xDA, 0xDB) else raw), pos
    raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")


def _unpack_array(data: bytes, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, pos = _unpack(data, pos)
        out.append(v)
    return out, pos


def _unpack_map(data: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        v, pos = _unpack(data, pos)
        out[k] = v
    return out, pos
