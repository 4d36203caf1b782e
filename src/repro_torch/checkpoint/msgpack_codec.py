"""The msgpack subset the checkpoint layer writes, without the ``msgpack``
package.

``packb`` encodes dict, str, bytes (and any other bytes-like buffer:
``bytearray``, ``memoryview``), int, list and tuple, each in msgpack's
smallest form, so its bytes equal ``msgpack.packb(obj,
use_bin_type=True)``:

  map     fixmap (< 16 entries), map16, map32
  str     fixstr (< 32 bytes), str8, str16, str32 (utf-8)
  bin     bin8, bin16, bin32
  array   fixarray (< 16 entries), array16, array32
  int     positive fixint, uint8-64 for n >= 0; negative fixint, int8-64
          for n < 0

``pack_to`` writes the same bytes to a binary file piece by piece: a
bin payload goes to the file straight from its buffer, so nothing grows
as the file does.  ``unpackb`` decodes every form of those types that
``msgpack.unpackb(raw=False)`` accepts (any width, not only the
smallest) and raises ``ValueError`` naming the byte on any other type
(nil, bool, float, ext), on a truncated buffer, on trailing bytes and
on a map key that is not a str or bytes.  A bin comes back as a
``memoryview`` slice of the input, not a copy (it compares equal to the
``bytes`` msgpack returns).
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO, Callable

_BUFFERS = (bytes, bytearray, memoryview)


def _int_header(n: int) -> bytes:
    if isinstance(n, bool):
        raise TypeError("bool is outside the checkpoint subset")
    if n >= 0:
        if n < 0x80:
            return bytes((n,))
        if n <= 0xFF:
            return b"\xcc" + bytes((n,))
        if n <= 0xFFFF:
            return b"\xcd" + struct.pack(">H", n)
        if n <= 0xFFFFFFFF:
            return b"\xce" + struct.pack(">I", n)
        if n <= 0xFFFFFFFFFFFFFFFF:
            return b"\xcf" + struct.pack(">Q", n)
        raise OverflowError(f"int {n} does not fit in 64 bits")
    if n >= -32:
        return struct.pack(">b", n)
    if n >= -0x80:
        return b"\xd0" + struct.pack(">b", n)
    if n >= -0x8000:
        return b"\xd1" + struct.pack(">h", n)
    if n >= -0x80000000:
        return b"\xd2" + struct.pack(">i", n)
    if n >= -0x8000000000000000:
        return b"\xd3" + struct.pack(">q", n)
    raise OverflowError(f"int {n} does not fit in 64 bits")


def _sized(n: int, fix: int, fix_limit: int, tags: tuple) -> bytes:
    """Header of a str / array / map of ``n`` items (fix form below
    ``fix_limit``; ``tags`` are the 8-, 16- and 32-bit forms' bytes, the
    first None where there is no 8-bit form)."""
    if n < fix_limit:
        return bytes((fix | n,))
    if tags[0] is not None and n <= 0xFF:
        return bytes((tags[0], n))
    if n <= 0xFFFF:
        return bytes((tags[1],)) + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return bytes((tags[2],)) + struct.pack(">I", n)
    raise ValueError(f"{n} items exceed msgpack's 32-bit length")


def pack_map_header(n: int) -> bytes:
    """The header of a map of ``n`` entries (its keys and values follow)."""
    return _sized(n, 0x80, 16, (None, 0xDE, 0xDF))


def _bin_header(n: int) -> bytes:
    return _sized(n, 0, 0, (0xC4, 0xC5, 0xC6))


def _emit(obj: Any, out: Callable[[Any], Any]) -> None:
    if isinstance(obj, int):
        out(_int_header(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out(_sized(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB)))
        out(raw)
    elif isinstance(obj, _BUFFERS):
        view = memoryview(obj).cast("B")
        out(_bin_header(view.nbytes))
        out(view)
    elif isinstance(obj, dict):
        out(pack_map_header(len(obj)))
        for k, v in obj.items():
            _emit(k, out)
            _emit(v, out)
    elif isinstance(obj, (list, tuple)):
        out(_sized(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in obj:
            _emit(v, out)
    else:
        raise TypeError(f"{type(obj).__name__} is outside the checkpoint "
                        f"subset (dict, str, bytes, int, list)")


def packb(obj: Any) -> bytes:
    parts: list = []
    _emit(obj, parts.append)
    return b"".join(parts)


def pack_to(f: BinaryIO, obj: Any) -> None:
    """Write ``packb(obj)`` to ``f`` without joining it in memory."""
    _emit(obj, f.write)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
# type byte → (kind, width of its length field)
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4)}


class _Reader:
    def __init__(self, buf):
        self.view = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > self.view.nbytes:
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at "
                             f"offset {self.pos} of {self.view.nbytes}")
        out = self.view[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        pos = self.pos
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b in _UINT:
            return self.unpack(_UINT[b])
        if 0xA0 <= b < 0xC0:
            kind, n = "str", b & 0x1F
        elif 0x90 <= b < 0xA0:
            kind, n = "array", b & 0x0F
        elif 0x80 <= b < 0x90:
            kind, n = "map", b & 0x0F
        elif b in _SIZED:
            kind, width = _SIZED[b]
            n = self.unpack(_LEN[width])
        else:
            raise ValueError(f"msgpack type byte 0x{b:02x} at offset {pos} "
                             f"is outside the checkpoint subset (dict, str, "
                             f"bytes, int, list)")
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return self.take(n)
        if kind == "array":
            return [self.read() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, (str, memoryview)):
                raise ValueError(f"map key of type {type(k).__name__} at "
                                 f"offset {pos} (str or bytes only)")
            out[k if isinstance(k, str) else bytes(k)] = self.read()
        return out


def unpackb(buf) -> Any:
    """Decode one msgpack object that fills ``buf``."""
    r = _Reader(buf)
    obj = r.read()
    if r.pos != r.view.nbytes:
        raise ValueError(f"{r.view.nbytes - r.pos} trailing bytes after the "
                         f"msgpack object")
    return obj
