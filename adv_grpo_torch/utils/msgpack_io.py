"""flax ``serialization.to_bytes`` files in plain Python: no ``msgpack``, no
``flax``.

The offline PickScore finetune writes its parameters this way
(``pickscore_finetuned.msgpack``) and the trainer's ``weight_path`` warm
start reads them. The layout is flax's:

  * a tree of msgpack maps with str keys; a list or tuple is a map keyed
    "0", "1", ... (flax's ``to_state_dict``);
  * an array leaf is ext type 1 whose payload is the msgpack array
    ``[shape, dtype name, raw C-order bytes]`` (the bytes as bin); a numpy
    scalar is ext type 3 with the same payload;
  * the scalars msgpack has: nil, bool, int, float, str, bin.

flax splits an array above 2**30 bytes into a chunked map; no parameter
tree here has one (CLIP-H's largest tensor is 0.2 GB), so writing one
raises and reading one returns flax's map as it is.

Reading maps the file and takes every array as ``np.frombuffer`` of a slice
of it, so a payload is never parsed byte by byte nor the file copied;
writing streams each array from its own buffer. A tree the JAX
``serialization.from_bytes`` restores is one whose maps match its target's.
"""

from __future__ import annotations

import io
import mmap
import os
import struct
from typing import Any, BinaryIO

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_ARRAY_BYTES = 2 ** 30  # above this flax writes an array in chunks

_TORCH_NAMES = {torch.float32: "float32", torch.float16: "float16", torch.float64: "float64",
                torch.bfloat16: "bfloat16", torch.int32: "int32", torch.int64: "int64",
                torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
                torch.bool: "bool"}


# ───────────────────────────── reading ─────────────────────────────────────


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends at byte {len(self.buf)}, {n} bytes wanted at "
                             f"{self.pos}: truncated file")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        if b in sized:
            n = self.unpack(sized[b])
            if b in (0xC4, 0xC5, 0xC6):
                return self.take(n)  # bin: a view, never copied
            if b in (0xC7, 0xC8, 0xC9):
                return self._ext(self.unpack(">b"), n)
            if b in (0xD9, 0xDA, 0xDB):
                return self._str(n)
            return self._array(n) if b in (0xDC, 0xDD) else self._map(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            code = self.unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack object")

    def _str(self, n):
        return str(self.take(n), "utf-8")

    def _array(self, n):
        return [self.read() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, code, n):
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not an array (flax writes 1 and 3)")
        end = self.pos + n
        payload = self.read()
        if self.pos != end or not (isinstance(payload, list) and len(payload) == 3):
            raise ValueError(f"ext {code} payload of {n} bytes is not [shape, dtype, bytes]")
        shape, dtype, data = payload
        arr = _array_from(data, str(dtype), tuple(shape))
        return arr[()] if code == EXT_NPSCALAR else arr


def _array_from(data: memoryview, dtype: str, shape):
    if dtype == "bfloat16":  # numpy has no bfloat16: a torch tensor over the same bytes
        raw = np.frombuffer(data, np.int16)
        if not raw.flags.writeable:  # bytes in memory; a mapped file is writable
            raw = raw.copy()
        return torch.from_numpy(raw).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(data, np.dtype(dtype)).reshape(shape)


def loads(data) -> Any:
    """The tree of msgpack ``data`` (bytes, bytearray, memoryview or mmap):
    dicts, numpy arrays (bfloat16: torch tensors) viewing ``data``, numpy
    scalars and Python scalars. Trailing bytes and truncation raise."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return tree


def load(path: str) -> Any:
    """The tree of the file at ``path`` (:func:`loads` on a copy-on-write
    map of it: the arrays read the file's pages, nothing is copied whole)."""
    with open(path, "rb") as f:
        if not f.seek(0, 2):
            raise ValueError(f"{path} is empty")
        view = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return loads(view)


def check_map(path: str) -> None:
    """Parse the file at ``path`` through (the arrays as views, nothing
    kept); its top level must be a non-empty map, else ``ValueError``
    (``FileNotFoundError`` without a file)."""
    tree = load(path)
    if not isinstance(tree, dict) or not tree:
        raise ValueError(f"{path} is not a flax .msgpack of parameters: its top level is "
                         f"{type(tree).__name__}, not a non-empty map")


# ───────────────────────────── writing ─────────────────────────────────────


def _header(out: BinaryIO, n: int, fix: int, fix_max: int, codes) -> None:
    if fix is not None and n <= fix_max:
        out.write(bytes([fix | n]))
    elif n < 1 << 8 and codes[0] is not None:
        out.write(bytes([codes[0], n]))
    elif n < 1 << 16:
        out.write(bytes([codes[1]]) + struct.pack(">H", n))
    elif n < 1 << 32:
        out.write(bytes([codes[2]]) + struct.pack(">I", n))
    else:
        raise ValueError(f"a msgpack object of {n} bytes or entries is too large")


def _int(out: BinaryIO, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.write(bytes([v]))
    elif -32 <= v < 0:
        out.write(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.write(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"int {v} is too large for msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.write(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"int {v} is too small for msgpack")


def _str(out: BinaryIO, s: str) -> None:
    raw = s.encode("utf-8")
    _header(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out.write(raw)


def _buffer(x):
    """(dtype name, shape, a C-order buffer of x's bytes) of an array leaf."""
    if torch.is_tensor(x):
        t = x.detach().contiguous().cpu()
        name = _TORCH_NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"no flax dtype name for {t.dtype}")
        flat = t.reshape(-1)
        raw = (flat.view(torch.int16) if t.dtype == torch.bfloat16 else flat).numpy()
        return name, tuple(t.shape), memoryview(raw).cast("B")
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise TypeError(f"object and structured dtypes do not serialize ({a.dtype})")
    return a.dtype.name, a.shape, memoryview(a.reshape(-1)).cast("B")


def _ndarray(out: BinaryIO, x, code: int) -> None:
    name, shape, raw = _buffer(x)
    inner = io.BytesIO()
    inner.write(b"\x93")  # the array [shape, dtype name, bytes]
    _header(inner, len(shape), 0x90, 15, (None, 0xDC, 0xDD))
    for d in shape:
        _int(inner, int(d))
    _str(inner, name)
    _header(inner, raw.nbytes, None, -1, (0xC4, 0xC5, 0xC6))
    head = inner.getvalue()
    n = len(head) + raw.nbytes
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.write(bytes([fixext[n], code]))
    elif n < 1 << 8:
        out.write(bytes([0xC7, n, code]))
    elif n < 1 << 16:
        out.write(bytes([0xC8]) + struct.pack(">H", n) + bytes([code]))
    elif n < 1 << 32:
        out.write(bytes([0xC9]) + struct.pack(">I", n) + bytes([code]))
    else:
        raise ValueError(f"an array payload of {n} bytes is too large for msgpack")
    out.write(head)
    out.write(raw)


def dump(tree, out: BinaryIO) -> None:
    """Write ``tree`` to the stream ``out`` in flax's layout: dicts (keys
    made str, written in sorted order as flax writes them) and lists /
    tuples (maps keyed "0", "1", ...), torch tensors
    and numpy arrays (ext 1), numpy scalars (ext 3), None, bool, int, float,
    str, bytes."""
    if isinstance(tree, dict):
        items = {str(k): v for k, v in tree.items()}
        if len(items) != len(tree):
            raise ValueError(f"dict keys {list(tree)} have no unique string form")
        _header(out, len(items), 0x80, 15, (None, 0xDE, 0xDF))
        for key in sorted(items):  # flax's tree_map writes the keys sorted
            _str(out, key)
            dump(items[key], out)
    elif isinstance(tree, (list, tuple)):
        dump({str(i): v for i, v in enumerate(tree)}, out)
    elif torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        nbytes = (tree.numel() * tree.element_size() if torch.is_tensor(tree) else tree.nbytes)
        if nbytes > MAX_ARRAY_BYTES:
            raise ValueError(f"an array of {nbytes} bytes: flax would write it in chunks, "
                             "which this module does not")
        _ndarray(out, tree, EXT_NDARRAY)
    elif isinstance(tree, np.generic):
        _ndarray(out, np.asarray(tree), EXT_NPSCALAR)
    elif tree is None:
        out.write(b"\xc0")
    elif isinstance(tree, bool):
        out.write(b"\xc3" if tree else b"\xc2")
    elif isinstance(tree, int):
        _int(out, tree)
    elif isinstance(tree, float):
        out.write(b"\xcb" + struct.pack(">d", tree))
    elif isinstance(tree, str):
        _str(out, tree)
    elif isinstance(tree, (bytes, bytearray, memoryview)):
        raw = memoryview(tree).cast("B")
        _header(out, raw.nbytes, None, -1, (0xC4, 0xC5, 0xC6))
        out.write(raw)
    else:
        raise TypeError(f"{type(tree).__name__} does not serialize")


def dumps(tree) -> bytes:
    """:func:`dump` into bytes."""
    out = io.BytesIO()
    dump(tree, out)
    return out.getvalue()


def save(path: str, tree) -> int:
    """Write ``tree`` to ``path`` (through a temporary name); returns the
    bytes written."""
    with open(path + ".tmp", "wb") as f:
        dump(tree, f)
        n = f.tell()
    os.replace(path + ".tmp", path)
    return n
