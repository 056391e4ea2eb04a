"""The msgpack subset that ``flax.serialization`` writes, by hand.

The card's Python has no ``msgpack`` package, and the port must read and
write the checkpoints tpudist writes. This module is the counterpart of
``flax.serialization.msgpack_serialize`` and ``msgpack_restore``, over
``struct`` and numpy, for exactly what flax puts in a checkpoint:

- maps with str keys, arrays (Python lists), nil, bool, int (the smallest
  encoding), float (float64, ``0xcb``), str, and bin (8/16/32) inside
  the array payloads;
- ext type 1, an ndarray: the payload is the msgpack triple
  ``(shape, dtype name, C-order bytes)``;
- ext type 3, a numpy scalar, written as a 0-d ndarray;
- flax's chunked leaves: an array of more than ``MAX_CHUNK_SIZE`` bytes
  in a map becomes ``{"__msgpack_chunked_array__": True, "shape": {...},
  "chunks": {...}}`` of flat pieces.

For the same tree the bytes equal flax's, so sha256 sidecars agree. Flax
rebuilds every dict through ``jax.tree_util.tree_map`` before packing, so
keys are written sorted at every level (the chunk maps, made after that,
keep their own order). ``strict_types=True`` makes a tuple unwritable:
optax's tuples reach the file as dicts keyed ``"0"``, ``"1"``, ...

Leaves may be numpy arrays, numpy scalars or torch tensors (on any
device, any strides: each is copied to the host in logical C order only
when the encoder reaches it). ``iter_msgpack``
yields the encoding piece by piece, array payloads as views of those host
copies, so a writer can stream a checkpoint to disk without holding it.

The decoder returns numpy arrays, read-only views of the buffer it was
given (writable when the buffer is). numpy has no bfloat16: a
``"bfloat16"`` leaf comes back as a ``torch.bfloat16`` tensor over its
16-bit patterns, as flax's ``_dtype_from_name`` hands on jax's dtype.
"""

from __future__ import annotations

import struct
from typing import Any, Iterator

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


# -- encoder ---------------------------------------------------------------------

def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0 < n <= 0xFF:
        return struct.pack(">BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0 < n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < 0:
        return struct.pack(">Bh", 0xD1, n)
    if 0 < n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < 0:
        return struct.pack(">Bi", 0xD2, n)
    if 0 < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < 0:
        return struct.pack(">Bq", 0xD3, n)
    raise OverflowError(f"int {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    """The header of a str/bin/array/map of ``n`` items or bytes: the fix
    form when there is one and ``n`` fits it, else the 8/16/32-bit form
    (``codes``; ``None`` where the kind has no 8-bit form)."""
    if fix is not None and n <= fix_max:
        return struct.pack("B", fix | n)
    c8, c16, c32 = codes
    if c8 is not None and n <= 0xFF:
        return struct.pack(">BB", c8, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", c16, n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"msgpack object of {n} items or bytes is too large")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, -1, (0xC4, 0xC5, 0xC6))


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 0x0F, (None, 0xDC, 0xDD))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 0x0F, (None, 0xDE, 0xDF))


def _ext_header(code: int, n: int) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        head = struct.pack("B", fixext[n])
    elif n <= 0xFF:
        head = struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xC8, n)
    else:
        head = struct.pack(">BI", 0xC9, n)
    return head + struct.pack("b", code)


def _host(x) -> tuple[np.ndarray, str]:
    """``(C-ordered host array, dtype name)``. A torch tensor is copied to
    the host in its logical C order (a channels_last or transposed view
    included); bfloat16 travels as its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = x if x.flags.c_contiguous else np.array(x, order="C")
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes cannot be written "
                         "as msgpack ndarrays")
    return arr, arr.dtype.name


def _ndarray_pieces(arr: np.ndarray, name: str, code: int) -> list:
    """ext ``code`` holding ``(shape, name, bytes)``: its header and the
    payload's pieces, the array's bytes as a view."""
    data = memoryview(arr.reshape(-1).view(np.uint8))
    head = (_array_header(3) + _array_header(arr.ndim)
            + b"".join(_int(int(d)) for d in arr.shape) + _str(name)
            + _bin_header(data.nbytes))
    return [_ext_header(code, len(head) + data.nbytes) + head, data]


def _leaf(obj, in_map: bool) -> list:
    """The pieces of a scalar or array leaf."""
    t = type(obj)
    if obj is None:
        return [b"\xc0"]
    if t is bool:
        return [b"\xc3" if obj else b"\xc2"]
    if t is int:
        return [_int(obj)]
    if t is float:
        return [struct.pack(">Bd", 0xCB, obj)]
    if t is str:
        return [_str(obj)]
    if isinstance(obj, np.generic):
        return _ndarray_pieces(*_host(np.asarray(obj)), EXT_NPSCALAR)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        arr, name = _host(obj)
        if in_map and arr.nbytes > MAX_CHUNK_SIZE:
            return _chunked_pieces(arr, name)
        return _ndarray_pieces(arr, name, EXT_NDARRAY)
    raise TypeError(f"cannot write {t.__name__} as msgpack (the subset "
                    f"flax writes; a tuple must be a dict or a list)")


def _chunked_pieces(arr: np.ndarray, name: str) -> list:
    """flax's ``_chunk``: a map, in insertion order, of the shape and the
    flat pieces of at most ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    starts = range(0, flat.size, size)
    out = [_map_header(3) + _str(CHUNKED) + b"\xc3",
           _str("shape") + _map_header(arr.ndim)]
    out += [_str(str(i)) + _int(int(d)) for i, d in enumerate(arr.shape)]
    out.append(_str("chunks") + _map_header(len(starts)))
    for i, s in enumerate(starts):
        out.append(_str(str(i)))
        out += _ndarray_pieces(flat[s:s + size], name, EXT_NDARRAY)
    return out


def _iter(obj, in_map: bool) -> Iterator:
    t = type(obj)
    if t is dict:
        yield _map_header(len(obj))
        for key in sorted(obj):
            if type(key) is not str:
                raise TypeError(f"msgpack map keys must be str, got "
                                f"{type(key).__name__} {key!r}")
            yield _str(key)
            yield from _iter(obj[key], True)
    elif t is list:
        yield _array_header(len(obj))
        for item in obj:
            yield from _iter(item, False)
    else:
        yield from _leaf(obj, in_map)


def iter_msgpack(tree) -> Iterator:
    """The encoding of ``tree``, piece by piece (``bytes`` headers and
    ``memoryview`` array payloads), walked lazily: a device tensor is
    copied to the host only when it is reached. Joined, the pieces are
    ``flax.serialization.msgpack_serialize(tree)``."""
    return _iter(tree, True)


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    return b"".join(iter_msgpack(tree))


# -- decoder ---------------------------------------------------------------------

class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack: wanted {n} bytes at "
                             f"offset {self.pos} of {len(self.buf)}")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
                 0xDC: ">H", 0xDD: ">I",                  # array
                 0xDE: ">H", 0xDF: ">I",                  # map
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}      # ext
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if 0xD9 <= b <= 0xDB:
                return str(self.take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return [self.read() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        scalar = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                  0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                  0xD2: ">i", 0xD3: ">q"}
        if b in scalar:
            return self.unpack(scalar[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} at offset "
                         f"{self.pos - 1} is outside the subset flax writes")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is outside the subset "
                             f"flax writes (1 ndarray, 3 numpy scalar)")
        inner = _Reader(payload)
        shape, name, data = inner._ndarray_triple()
        arr = _from_bytes(data, name, shape)
        return arr if code == EXT_NDARRAY else arr[()]

    def _ndarray_triple(self):
        """``(shape, dtype name, bytes view)``: the triple read with
        ``raw=True``, the data left as a view of the buffer."""
        if self.unpack("B") != 0x93:
            raise ValueError("msgpack ndarray payload is not a 3-array")
        shape = self.read()
        name = self.read()
        b = self.unpack("B")
        widths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b not in widths:
            raise ValueError("msgpack ndarray payload's data is not bin")
        data = self.take(self.unpack(widths[b]))
        if isinstance(name, bytes):
            name = name.decode()
        return tuple(shape), name, data


def _from_bytes(data: memoryview, name: str, shape: tuple):
    if name == "bfloat16":
        bits = np.frombuffer(data, np.int16).reshape(shape)
        if not bits.flags.writeable:
            bits = bits.copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(data, np.dtype(name)).reshape(shape)


def _unchunk(node: dict):
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    parts = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if parts and isinstance(parts[0], torch.Tensor):
        return torch.cat(parts).reshape(shape)
    return np.concatenate(parts).reshape(shape)


def _unchunk_in_place(node):
    """flax's ``_unchunk_array_leaves_in_place``: maps only."""
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        for key, val in node.items():
            if isinstance(val, dict):
                node[key] = _unchunk_in_place(val)
    return node


def msgpack_restore(encoded) -> Any:
    """``flax.serialization.msgpack_restore(encoded)``: the tree with
    numpy leaves (bfloat16 as ``torch.bfloat16``). ``encoded`` may be
    ``bytes`` or a writable ``bytearray``/``memoryview``; the arrays are
    views of it."""
    reader = _Reader(encoded)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} trailing "
                         f"bytes after the object")
    return _unchunk_in_place(tree)
