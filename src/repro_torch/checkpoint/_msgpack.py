"""The MessagePack forms the checkpoint format uses, written and read
without the ``msgpack`` package (the card's machine does not have it).

The writer emits exactly what ``msgpack.packb(obj, use_bin_type=True)``
emits: ``None``/``bool``; an ``int`` in its smallest form (non-negative as
positive fixint or uint 8/16/32/64, negative as negative fixint or int
8/16/32/64); a ``float`` as float 64; ``str`` as fixstr/str 8/16/32;
``bytes``, ``bytearray`` and ``memoryview`` as bin 8/16/32; ``list`` and
``tuple`` as fixarray/array 16/32; ``dict`` as fixmap/map 16/32 in
insertion order.  Anything else raises ``TypeError``, as msgpack does.
:func:`pack` streams to a ``write`` callable, so a multi-GB bin goes out
as one buffer without a copy into a joined ``bytes``.

The reader takes every form ``msgpack.unpackb(raw=False,
strict_map_key=False)`` takes (float 32 and the ext forms too, the latter
as :class:`ExtType`) from any buffer (``bytes`` or a memory map); with
``zero_copy=True`` a bin comes back as a ``memoryview`` of the buffer.  A
truncated or malformed buffer, or bytes after the object, raises
:class:`UnpackError`.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple

_S_B, _S_H, _S_I, _S_Q = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_S_b, _S_h, _S_i, _S_q = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_S_f, _S_d = struct.Struct(">f"), struct.Struct(">d")


class UnpackError(ValueError):
    """The buffer is not one well-formed MessagePack object."""


class ExtType(NamedTuple):
    """An ext value (type code, payload), as msgpack's ``ExtType``."""
    code: int
    data: bytes


# -- writer ----------------------------------------------------------------

def _int_bytes(n: int) -> bytes:
    if 0 <= n < 0x80:
        return _S_B.pack(n)
    if -0x20 <= n < 0:
        return _S_b.pack(n)
    if 0x80 <= n <= 0xFF:
        return b"\xcc" + _S_B.pack(n)
    if -0x80 <= n < 0:
        return b"\xd0" + _S_b.pack(n)
    if 0xFF < n <= 0xFFFF:
        return b"\xcd" + _S_H.pack(n)
    if -0x8000 <= n < -0x80:
        return b"\xd1" + _S_h.pack(n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return b"\xce" + _S_I.pack(n)
    if -0x80000000 <= n < -0x8000:
        return b"\xd2" + _S_i.pack(n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + _S_Q.pack(n)
    if -0x8000000000000000 <= n < -0x80000000:
        return b"\xd3" + _S_q.pack(n)
    raise OverflowError("Integer value out of range")


def _sized_header(n: int, fix: int, fix_max: int, tags) -> bytes:
    """Header of a length-prefixed form: the fix form below ``fix_max``
    (when the form has one), else the 8/16/32-bit length forms."""
    if fix_max and n < fix_max:
        return _S_B.pack(fix | n)
    t8, t16, t32 = tags
    if t8 is not None and n <= 0xFF:
        return bytes((t8, n))
    if n <= 0xFFFF:
        return bytes((t16,)) + _S_H.pack(n)
    if n <= 0xFFFFFFFF:
        return bytes((t32,)) + _S_I.pack(n)
    raise ValueError(f"length {n} does not fit a 32-bit MessagePack size")


def str_header(n: int) -> bytes:
    return _sized_header(n, 0xA0, 32, (0xD9, 0xDA, 0xDB))


def bin_header(n: int) -> bytes:
    return _sized_header(n, 0, 0, (0xC4, 0xC5, 0xC6))


def array_header(n: int) -> bytes:
    return _sized_header(n, 0x90, 16, (None, 0xDC, 0xDD))


def map_header(n: int) -> bytes:
    return _sized_header(n, 0x80, 16, (None, 0xDE, 0xDF))


def pack(obj: Any, write: Callable[[Any], Any]) -> None:
    """Write ``obj`` through ``write`` (a file's ``write``, say)."""
    if obj is None:
        write(b"\xc0")
    elif isinstance(obj, bool):
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        write(_int_bytes(obj))
    elif isinstance(obj, (bytes, bytearray)):
        write(bin_header(len(obj)))
        write(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        write(str_header(len(raw)))
        write(raw)
    elif isinstance(obj, memoryview):
        write(bin_header(obj.nbytes))
        write(obj)
    elif isinstance(obj, float):
        write(b"\xcb" + _S_d.pack(obj))
    elif isinstance(obj, (list, tuple)):
        write(array_header(len(obj)))
        for x in obj:
            pack(x, write)
    elif isinstance(obj, dict):
        write(map_header(len(obj)))
        for k, v in obj.items():
            pack(k, write)
            pack(v, write)
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    pack(obj, out.extend)
    return bytes(out)


# -- reader ----------------------------------------------------------------

class _Reader:
    def __init__(self, buf, zero_copy: bool):
        self.mv = memoryview(buf).cast("B")
        self.n = len(self.mv)
        self.pos = 0
        self.zero_copy = zero_copy

    def take(self, k: int) -> memoryview:
        end = self.pos + k
        if end > self.n:
            raise UnpackError(f"truncated: need {k} bytes at offset "
                              f"{self.pos}, {self.n - self.pos} left")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def num(self, s: struct.Struct):
        return s.unpack(self.take(s.size))[0]

    def raw(self, k: int):
        data = self.take(k)
        if self.zero_copy:
            return data
        out = bytes(data)
        data.release()
        return out

    def text(self, k: int) -> str:
        data = self.take(k)
        try:
            return str(data, "utf-8")
        except UnicodeDecodeError as e:
            raise UnpackError(f"invalid utf-8 string: {e}") from e
        finally:
            data.release()

    def ext(self, k: int) -> ExtType:
        code = self.num(_S_b)
        data = self.take(k)
        out = ExtType(code, bytes(data))
        data.release()
        return out

    def array(self, k: int) -> list:
        return [self.obj() for _ in range(k)]

    def map(self, k: int) -> dict:
        out = {}
        for _ in range(k):
            key = self.obj()
            try:
                out[key] = self.obj()
            except TypeError as e:  # an unhashable key (list, dict)
                raise UnpackError(f"unhashable map key: {e}") from e
        return out

    def obj(self):
        t = self.num(_S_B)
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.text(t & 0x1F)
        if 0xD4 <= t <= 0xD8:
            return self.ext(1 << (t - 0xD4))
        form = _FORMS.get(t)
        if form is None:
            raise UnpackError(f"invalid type byte 0x{t:02x} at offset "
                              f"{self.pos - 1}")
        return form(self)


_FORMS = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: r.raw(r.num(_S_B)),
    0xC5: lambda r: r.raw(r.num(_S_H)),
    0xC6: lambda r: r.raw(r.num(_S_I)),
    0xC7: lambda r: r.ext(r.num(_S_B)),
    0xC8: lambda r: r.ext(r.num(_S_H)),
    0xC9: lambda r: r.ext(r.num(_S_I)),
    0xCA: lambda r: r.num(_S_f),
    0xCB: lambda r: r.num(_S_d),
    0xCC: lambda r: r.num(_S_B),
    0xCD: lambda r: r.num(_S_H),
    0xCE: lambda r: r.num(_S_I),
    0xCF: lambda r: r.num(_S_Q),
    0xD0: lambda r: r.num(_S_b),
    0xD1: lambda r: r.num(_S_h),
    0xD2: lambda r: r.num(_S_i),
    0xD3: lambda r: r.num(_S_q),
    0xD9: lambda r: r.text(r.num(_S_B)),
    0xDA: lambda r: r.text(r.num(_S_H)),
    0xDB: lambda r: r.text(r.num(_S_I)),
    0xDC: lambda r: r.array(r.num(_S_H)),
    0xDD: lambda r: r.array(r.num(_S_I)),
    0xDE: lambda r: r.map(r.num(_S_H)),
    0xDF: lambda r: r.map(r.num(_S_I)),
}


def unpackb(buf, zero_copy: bool = False):
    """The one object in ``buf``.  With ``zero_copy`` every bin is a
    ``memoryview`` into ``buf``; the caller releases them before it closes
    the buffer (a memory map refuses to close while views are alive)."""
    r = _Reader(buf, zero_copy)
    try:
        out = r.obj()
        if r.pos != r.n:
            raise UnpackError(f"{r.n - r.pos} bytes of extra data after "
                              "the object")
        return out
    except RecursionError as e:
        raise UnpackError("nesting too deep") from e
    finally:
        r.mv.release()
