"""The safetensors file format, read and written without the library.

A file is an 8-byte little-endian header length, a JSON header and the
raw little-endian bytes of every tensor. The header maps each name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
bytes after the header) and may hold ``"__metadata__"``, a map of
strings. The writer pads the header with spaces to a multiple of 8 and
lays the tensors out by falling item size, then name, so every tensor
starts aligned to its item size; the reader takes any layout that
covers the byte buffer.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Mapping, Optional, Tuple

import torch

__all__ = ["read_safetensors", "write_safetensors", "DTYPES"]

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time)
    and string ``metadata`` to ``path``."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors "
                            "name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                f.write(memoryview(t.to("cpu").contiguous().reshape(-1)
                                   .view(torch.uint8).numpy()))


def read_safetensors(path: str, device=None
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """(tensors, metadata) of the file at ``path``. The file is mapped
    copy-on-write; tensors are views into the map on the CPU, or copies
    on ``device``."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    metadata = header.pop("__metadata__", None) or {}
    base = 8 + n
    if header:
        ends = sorted(tuple(v["data_offsets"]) for v in header.values())
        covered = 0
        for b, e in ends:
            if b != covered or e < b:
                raise ValueError(f"{path}: tensor data is not contiguous")
            covered = e
        if base + covered != len(buf):
            raise ValueError(f"{path}: {len(buf) - base} bytes of data, "
                             f"the header covers {covered}")
    out = {}
    for name, info in header.items():
        dtype = DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        b, e = info["data_offsets"]
        count = (e - b) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            t = torch.empty(shape, dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=count,
                                 offset=base + b).reshape(shape)
        out[name] = t if device is None else t.to(device)
    return out, metadata
