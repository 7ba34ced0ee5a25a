"""Reader and writer of safetensors files, with no package beyond numpy and torch.

The format: an 8-byte little-endian header length N, N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}`, offsets relative to the end of the header), then the raw tensor
buffers, row-major. The JAX package reads and writes these files through the
`safetensors` package; the card this port runs on does not have it.

- `read_header(path)` -> (entries, data start, metadata), after checking
  every entry against the file: known dtype, a byte range that matches its
  shape, inside the file, and no two ranges that overlap.
- `SafetensorsFile(path)`: lazy per-tensor reads over a read-only memory
  map. `numpy(name)` is a zero-copy view for every dtype numpy has;
  `tensor(name)` a torch tensor for every dtype, BF16 included
  (`torch.frombuffer`, so no ml_dtypes); `float32(name)` a float32 numpy copy.
- `save_file(flat, path)` writes numpy arrays or torch tensors, each made
  contiguous first: a transposed view's buffer would otherwise be written
  with its stale strides.
- `load_file(path)` -> {name: numpy array} copies (BF16 as its raw uint16
  bits, which is how the JAX package's own format stores bfloat16).
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# safetensors dtype -> (numpy dtype or None where numpy has none, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (None, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "U16": (np.uint16, None),
    "BOOL": (np.bool_, torch.bool),
}
_ITEMSIZE = {"F64": 8, "F32": 4, "F16": 2, "BF16": 2, "I64": 8, "I32": 4, "I16": 2, "I8": 1, "U8": 1,
             "U16": 2, "BOOL": 1}
_FROM_NUMPY = {np.dtype(np_dt): name for name, (np_dt, _) in _DTYPES.items() if np_dt is not None}
_FROM_TORCH = {t_dt: name for name, (_, t_dt) in _DTYPES.items() if t_dt is not None}
_MAX_HEADER = 100 * 1024 * 1024


def read_header(path) -> Tuple[Dict[str, Dict[str, Any]], int, Dict[str, str]]:
    """-> ({name: {"dtype", "shape", "data_offsets"}}, byte offset of the
    data, metadata). Raises ValueError on a header the file cannot hold."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (n,) = struct.unpack("<Q", raw)
        if n > min(size - 8, _MAX_HEADER):
            raise ValueError(f"{path}: header of {n} bytes in a file of {size}")
        header = json.loads(f.read(n))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    start, data_len = 8 + n, size - 8 - n
    ranges = []
    for name, e in header.items():
        if not isinstance(e, dict):
            raise ValueError(f"{path}: tensor {name!r} has a malformed entry {e!r}")
        dtype, shape, offs = e.get("dtype"), e.get("shape"), e.get("data_offsets")
        if dtype not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unknown dtype {dtype!r}")
        if (not isinstance(shape, list) or not all(isinstance(d, int) and d >= 0 for d in shape)
                or not isinstance(offs, list) or len(offs) != 2):
            raise ValueError(f"{path}: tensor {name!r} has a malformed entry {e}")
        begin, end = offs
        if not 0 <= begin <= end <= data_len:
            raise ValueError(f"{path}: tensor {name!r} bytes [{begin}, {end}) run past the data "
                             f"({data_len} bytes)")
        if end - begin != int(np.prod(shape, dtype=np.int64)) * _ITEMSIZE[dtype]:
            raise ValueError(f"{path}: tensor {name!r} holds {end - begin} bytes for shape {shape} "
                             f"of {dtype}")
        ranges.append((begin, end, name))
    ranges.sort()
    reach, owner = 0, None  # the furthest end so far, and its tensor
    for begin, end, name in ranges:
        if begin < end:  # an empty tensor takes no bytes and overlaps nothing
            if begin < reach:
                raise ValueError(f"{path}: tensors {owner!r} and {name!r} overlap")
            reach, owner = end, name
    return header, start, metadata


class SafetensorsFile:
    """Lazy reads of the tensors of one file, over a read-only memory map."""

    def __init__(self, path):
        self.path = str(path)
        self.entries, self._start, self.metadata = read_header(self.path)
        self._map: Optional[mmap.mmap] = None
        if os.path.getsize(self.path) > self._start:
            with open(self.path, "rb") as f:
                self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)

    def keys(self):
        return self.entries.keys()

    def __contains__(self, name) -> bool:
        return name in self.entries

    def _bytes(self, name: str) -> memoryview:
        begin, end = self.entries[name]["data_offsets"]
        if begin == end:
            return memoryview(b"")
        return memoryview(self._map)[self._start + begin:self._start + end]

    def numpy(self, name: str) -> np.ndarray:
        """Zero-copy, read-only view of a tensor (not for BF16)."""
        e = self.entries[name]
        np_dt = _DTYPES[e["dtype"]][0]
        if np_dt is None:
            raise TypeError(f"{name}: numpy has no {e['dtype']}; use tensor() or float32()")
        return np.frombuffer(self._bytes(name), dtype=np_dt).reshape(e["shape"])

    def tensor(self, name: str) -> torch.Tensor:
        """A torch tensor of the stored dtype (a copy)."""
        e = self.entries[name]
        t_dt = _DTYPES[e["dtype"]][1]
        if t_dt is None:
            raise TypeError(f"{name}: no torch dtype for {e['dtype']}; use numpy()")
        buf = self._bytes(name)
        if not len(buf):
            return torch.empty(e["shape"], dtype=t_dt)
        # frombuffer warns on a read-only buffer: copy the bytes once
        return torch.frombuffer(bytearray(buf), dtype=t_dt).reshape(e["shape"])

    def float32(self, name: str) -> np.ndarray:
        """float32 numpy copy; BF16 and F16 widen exactly."""
        if self.entries[name]["dtype"] == "BF16":
            return self.tensor(name).float().numpy()
        return self.numpy(name).astype(np.float32)


def _contiguous(a: np.ndarray) -> np.ndarray:
    """Row-major copy unless already row-major (0-d arrays stay 0-d)."""
    return a if a.flags["C_CONTIGUOUS"] else np.array(a, order="C")


def _raw(x) -> Tuple[str, np.ndarray]:
    """(safetensors dtype, row-major numpy array of the bytes to write)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _FROM_TORCH:
            raise TypeError(f"save_file: no safetensors dtype for {t.dtype}")
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return _FROM_TORCH[t.dtype], bits.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # an ml_dtypes leaf of the JAX package
        return "BF16", _contiguous(a).view(np.uint16)
    if a.dtype not in _FROM_NUMPY:
        raise TypeError(f"save_file: no safetensors dtype for {a.dtype}")
    return _FROM_NUMPY[a.dtype], _contiguous(a)


def save_file(flat: Mapping[str, Any], path) -> None:
    """Write {name: array or tensor} as one safetensors file, buffers in
    name order, the header padded with spaces to 8 bytes. Each buffer is
    made contiguous and written in turn, so no second copy of the whole
    set is held."""
    header: Dict[str, Any] = {}
    offset = 0
    for name in sorted(flat):
        dtype, data = _raw(flat[name])
        header[name] = {"dtype": dtype, "shape": list(data.shape),
                        "data_offsets": [offset, offset + data.nbytes]}
        offset += data.nbytes
        del data
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in sorted(flat):
            f.write(_raw(flat[name])[1].reshape(-1).view(np.uint8).data)
    os.replace(tmp, path)


def load_file(path) -> Dict[str, np.ndarray]:
    """Every tensor of a file as a numpy copy; BF16 as its uint16 bits."""
    f = SafetensorsFile(path)
    out = {}
    for name, e in f.entries.items():
        if e["dtype"] == "BF16":
            out[name] = f.tensor(name).view(torch.int16).numpy().view(np.uint16)
        else:
            out[name] = f.numpy(name).copy()
    return out
