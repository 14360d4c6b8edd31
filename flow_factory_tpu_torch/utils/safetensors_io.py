"""Reading and writing the safetensors format without the ``safetensors`` package.

The port's checkpoints use the same files the JAX package writes through
``safetensors.numpy`` (``models/abc.py``), but the port may run where that
package is not installed, so it reads and writes the format itself:

* 8 bytes: the header's length N, a little-endian u64;
* N bytes: a JSON object ``{name: {"dtype", "shape", "data_offsets":
  [begin, end]}, "__metadata__": {str: str}}`` (the metadata optional),
  padded with spaces to a multiple of 8 when written; any N is read;
* the tensors' raw little-endian bytes, ``data_offsets`` counted from the
  first byte after the header.

:func:`save_file` and :func:`load_file` take and give ``torch.Tensor``.
"""
from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, Mapping, Optional, Union

import torch

#: safetensors dtype names ↔ torch dtypes, in the order the safetensors
#: package lays tensors out in a file
DTYPES: Dict[str, torch.dtype] = {
    "I64": torch.int64,
    "F64": torch.float64,
    "F32": torch.float32,
    "I32": torch.int32,
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}
_RANK = {dt: i for i, dt in enumerate(DTYPES.values())}
#: the format's own cap on the header (100 MB)
MAX_HEADER_BYTES = 100_000_000


def save_file(tensors: Mapping[str, torch.Tensor], path: Union[str, os.PathLike],
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device, any layout) to ``path`` as the
    safetensors package writes them: the data ordered by dtype (``DTYPES``)
    and then by name, each tensor's bytes contiguous."""
    order = sorted(tensors, key=lambda k: (_RANK.get(tensors[k].dtype, -1), k))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + size]}
        offset += size
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))


def load_file(path: Union[str, os.PathLike], device: Union[str, torch.device] = "cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of ``path`` on ``device``, in the header's order; the
    offsets and sizes are checked against the file."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError("not a safetensors file: shorter than its 8-byte header length")
        (n,) = struct.unpack("<Q", head)
        if n > min(MAX_HEADER_BYTES, size - 8):
            raise ValueError(f"safetensors header length {n} exceeds the file ({size} bytes)")
        header = json.loads(f.read(n).decode("utf-8"))
        if not isinstance(header, dict):
            raise ValueError("safetensors header is not a JSON object")
        data = bytearray(size - 8 - n)
        f.readinto(data)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{name}: unsupported safetensors dtype {info['dtype']!r}")
        shape = [int(d) for d in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        numel = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= len(data) or end - begin != numel * itemsize:
            raise ValueError(f"{name}: data_offsets {[begin, end]} do not fit shape {shape} of {info['dtype']} "
                             f"in {len(data)} data bytes")
        t = (torch.frombuffer(data, dtype=dtype, count=numel, offset=begin).reshape(shape) if numel
             else torch.empty(shape, dtype=dtype))
        out[name] = t.to(device)
    return out
