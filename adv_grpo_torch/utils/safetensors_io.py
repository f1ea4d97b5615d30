"""A reader and writer of the safetensors format, in numpy and torch only.

The layout (https://github.com/huggingface/safetensors, "Format"): an
unsigned 64-bit little-endian header length N; N bytes of a UTF-8 JSON
object mapping each tensor name to ``{"dtype", "shape", "data_offsets":
[begin, end]}`` (byte offsets into the data that follows, which the tensors
fill end to end, little-endian and C-ordered), with an optional
``"__metadata__"`` map of strings to strings; then the data. The writer pads
the header with spaces to a multiple of 8 bytes and orders the tensors as
the reference writer does (by its dtype order, I64, F32, BF16, F16, then by
name), so every tensor starts on a boundary of its own element size and the
file is byte for byte the reference's.

Covered dtypes: F32, F16, BF16 and I64 (LoRA adapters and model weights).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I64": torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}
_ORDER = {"I64": 0, "F32": 1, "BF16": 2, "F16": 3}  # the reference's dtype order, descending


def _as_tensor(name: str, value) -> torch.Tensor:
    if isinstance(value, (np.ndarray, np.generic)):
        value = torch.from_numpy(np.array(value, order="C"))
    if not isinstance(value, torch.Tensor):
        raise TypeError(f"{name}: expected a torch tensor or a numpy array, got "
                        f"{type(value).__name__}")
    if value.dtype not in _NAMES:
        raise ValueError(f"{name}: dtype {value.dtype} is not one of "
                         f"{sorted(_DTYPES)} (safetensors F32, F16, BF16, I64)")
    return value.detach().to("cpu").contiguous()


def save_file(tensors: Mapping[str, Union[torch.Tensor, np.ndarray]], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (name -> torch tensor or numpy array) to ``path``."""
    items = {name: _as_tensor(name, v) for name, v in tensors.items()}
    order = sorted(items, key=lambda n: (_ORDER[_NAMES[items[n].dtype]], n))
    header: Dict[str, object] = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise TypeError("safetensors metadata maps strings to strings")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name in order:
        t = items[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in order:
            t = items[name]
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())


def read_header(path: str):
    """(the header as a dict, the data's start offset in the file, the file
    size); raises ``ValueError`` on a file too short for its header."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        (n,) = struct.unpack("<Q", raw)
        if 8 + n > size:
            raise ValueError(f"{path}: truncated: the header claims {n} bytes, the file "
                             f"holds {size - 8} after the length")
        header = json.loads(f.read(n).decode())
    return header, 8 + n, size


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of the file at ``path``, on ``device``. Raises
    ``ValueError`` on a truncated file, an unknown dtype or offsets that do
    not match a tensor's shape.

    The header is checked whole before any data is read; then each tensor is
    read on its own (``readinto`` its own buffer, in file order) and moved to
    ``device``, so the host holds the file's tensors once, or one tensor at a
    time when ``device`` is not the CPU."""
    header, start, size = read_header(path)
    header.pop("__metadata__", None)
    entries = []
    for name, info in header.items():
        code = info.get("dtype")
        if code not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {code!r}; this reader "
                             f"covers {sorted(_DTYPES)}")
        dtype, shape = _DTYPES[code], tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        want = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        if end - begin != want or begin < 0:
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} {code} needs {want} "
                             f"bytes, its offsets [{begin}, {end}] give {end - begin}")
        if start + end > size:
            raise ValueError(f"{path}: truncated: tensor {name!r} ends at byte {start + end}, "
                             f"the file holds {size}")
        entries.append((begin, name, dtype, shape, want))
    out = {}
    with open(path, "rb") as f:
        for begin, name, dtype, shape, want in sorted(entries, key=lambda e: e[0]):
            buf = torch.empty(want, dtype=torch.uint8)
            if want:
                f.seek(start + begin)
                if f.readinto(memoryview(buf.numpy())) != want:
                    raise ValueError(f"{path}: truncated while reading tensor {name!r}")
            out[name] = buf.view(dtype).reshape(shape).to(device)
    return {name: out[name] for name in header}
