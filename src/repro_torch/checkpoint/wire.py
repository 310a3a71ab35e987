"""The msgpack subset the checkpoint files use, with the standard library.

The JAX package writes its checkpoints with `msgpack.packb(x,
use_bin_type=True)` and reads them with `msgpack.unpackb(b, raw=False,
strict_map_key=False)`.  The port reads and writes the same files without
that package (a machine it runs on need not have it): `packb` makes the
choices msgpack makes, so the same object gives the same bytes, and
`unpackb` gives what msgpack gives back.

Types: nil, bool, int (the smallest form: positive ints as fixint or
uint8/16/32/64, negative as fixint or int8/16/32/64), float (written as
float64; float32 is read too), str (utf-8), bytes (bin), list and tuple
(array) and dict (map), each in its fix/8/16/32 forms.  Map keys may be any
of these that hash (the reference's array records have bytes keys).  The
ext types and anything else raise: `WireError` on encode, `WireError` on
truncated or malformed bytes when decoding.
"""
from __future__ import annotations

import struct
from typing import Any, Callable

# bin payloads at least this large are written straight from their buffer
_DIRECT = 1 << 20


class WireError(ValueError):
    """Bytes that are not a whole msgpack object of the subset, or an
    object the subset cannot encode."""


def packb(obj: Any) -> bytes:
    """`obj` as msgpack bytes, as `msgpack.packb(obj, use_bin_type=True)`
    gives them."""
    parts: list[bytes] = []
    dump(obj, lambda b: parts.append(bytes(b)))
    return b"".join(parts)


def dump(obj: Any, write: Callable[[Any], Any]) -> None:
    """`packb(obj)` handed to `write` in pieces: a large bin payload (a
    checkpoint's array data) goes to `write` as a view of its own buffer,
    never copied into the packed stream first."""
    out = bytearray()
    _pack(obj, out, write)
    write(out)


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """The header of a sized type: the fix form below fix_max, else the 8
    (where the type has one), 16 or 32-bit length form."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise WireError(f"object of {n} elements or bytes is too large")


def _pack(obj: Any, out: bytearray, write) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        _head(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        if len(data) >= _DIRECT:
            write(out)
            out.clear()
            write(data)
        else:
            out += data
    elif type(obj) in (list, tuple):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out, write)
    elif type(obj) is dict:
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out, write)
            _pack(v, out, write)
    else:
        raise WireError(f"cannot serialize {type(obj).__name__!r}")


def _pack_int(x: int, out: bytearray) -> None:
    if -0x20 <= x < 0x80:
        out += struct.pack(">b", x) if x < 0 else struct.pack(">B", x)
    elif x > 0:
        for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                               (0xCE, ">BI", 0xFFFFFFFF),
                               (0xCF, ">BQ", 0xFFFFFFFFFFFFFFFF)):
            if x <= top:
                out += struct.pack(fmt, code, x)
                return
        raise WireError(f"int {x} does not fit uint64")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                               (0xD2, ">Bi", -0x80000000),
                               (0xD3, ">Bq", -0x8000000000000000)):
            if x >= low:
                out += struct.pack(fmt, code, x)
                return
        raise WireError(f"int {x} does not fit int64")


# fixed-size forms: code -> (struct format, size)
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1),
          0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
          0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
# sized forms: code -> (kind, struct format of the length)
_SIZED = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def unpackb(data, *, bin_views: bool = False) -> Any:
    """The object in `data`, as `msgpack.unpackb(data, raw=False,
    strict_map_key=False)` gives it (arrays as lists).  With `bin_views`
    a bin comes back as a memoryview into `data` instead of a bytes copy.
    Raises WireError on truncated, malformed or trailing bytes."""
    view = memoryview(data).cast("B")
    obj, pos = _unpack(view, 0, bin_views)
    if pos != len(view):
        raise WireError(f"{len(view) - pos} bytes after the object")
    return obj


def _take(view: memoryview, pos: int, n: int) -> memoryview:
    if pos + n > len(view):
        raise WireError(f"truncated: {n} bytes wanted at offset {pos}, "
                        f"{len(view) - pos} left")
    return view[pos:pos + n]


def _unpack(view: memoryview, pos: int, views: bool) -> tuple[Any, int]:
    code = _take(view, pos, 1)[0]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0x80 <= code <= 0x8F:
        return _unpack_map(view, pos, code & 0x0F, views)
    if 0x90 <= code <= 0x9F:
        return _unpack_array(view, pos, code & 0x0F, views)
    if 0xA0 <= code <= 0xBF:
        return _unpack_str(view, pos, code & 0x1F)
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack(fmt, _take(view, pos, size))[0], pos + size
    if code in _SIZED:
        kind, fmt = _SIZED[code]
        size = struct.calcsize(fmt)
        n = struct.unpack(fmt, _take(view, pos, size))[0]
        pos += size
        if kind == "str":
            return _unpack_str(view, pos, n)
        if kind == "bin":
            raw = _take(view, pos, n)
            return (raw if views else bytes(raw)), pos + n
        if kind == "array":
            return _unpack_array(view, pos, n, views)
        return _unpack_map(view, pos, n, views)
    raise WireError(f"type byte 0x{code:02x} at offset {pos - 1} is not "
                    "in the subset")


def _unpack_str(view: memoryview, pos: int, n: int) -> tuple[str, int]:
    raw = bytes(_take(view, pos, n))
    try:
        return raw.decode("utf-8"), pos + n
    except UnicodeDecodeError as e:
        raise WireError(f"str at offset {pos} is not utf-8: {e}") from e


def _unpack_array(view: memoryview, pos: int, n: int,
                  views: bool) -> tuple[list, int]:
    _take(view, pos, n)          # each element takes at least one byte
    out = []
    for _ in range(n):
        x, pos = _unpack(view, pos, views)
        out.append(x)
    return out, pos


def _unpack_map(view: memoryview, pos: int, n: int,
                views: bool) -> tuple[dict, int]:
    _take(view, pos, 2 * n)
    out = {}
    for _ in range(n):
        k, pos = _unpack(view, pos, False)   # keys hash: bytes, not views
        v, pos = _unpack(view, pos, views)
        try:
            out[k] = v
        except TypeError as e:
            raise WireError(f"unhashable map key {type(k).__name__}") from e
    return out, pos
