"""The safetensors file format, read and written with numpy alone.

The JAX package reads and writes checkpoints through the ``safetensors``
package, which the port must not need. A file is:

- an 8-byte little-endian header length N;
- N bytes of UTF-8 JSON, padded with spaces so the data starts on an
  8-byte boundary: ``{"__metadata__": {str: str}, name: {"dtype": "F32",
  "shape": [...], "data_offsets": [begin, end]}, ...}``, the offsets
  relative to the start of the data;
- the raw little-endian bytes of every tensor.

bfloat16 has no numpy dtype of its own. Arrays of it carry ``BF16``:
``ml_dtypes.bfloat16`` where that package is installed (the dtype the JAX
package's arrays have), else a one-field structured dtype over ``<u2``.
Both hold the bits unchanged, and transposes, stacks, splits and
concatenations move them as they are.
"""

import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

try:
    import ml_dtypes
    BF16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # keep the bits, not the arithmetic
    BF16 = np.dtype([("bfloat16", "<u2")])

_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "BF16": BF16, "I64": np.dtype("<i8"), "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"), "I8": np.dtype("i1"), "U64": np.dtype("<u8"),
    "U32": np.dtype("<u4"), "U16": np.dtype("<u2"), "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
}
_MAX_HEADER = 100 * 1024 * 1024

ArrayLike = Union[np.ndarray, torch.Tensor]


def is_bf16(a) -> bool:
    """True for a numpy array or dtype of bfloat16 (either form)."""
    dt = a if isinstance(a, np.dtype) else np.asarray(a).dtype
    return dt == BF16 or dt.name == "bfloat16"


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy, bfloat16 as ``BF16`` (the bits)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def numpy_to_tensor(a: np.ndarray, copy: bool = True) -> torch.Tensor:
    """A CPU tensor over a C-contiguous copy of ``a`` (bfloat16 kept);
    ``copy=False`` shares ``a``'s memory where it is already C-contiguous
    and writeable."""
    a = np.array(a, order="C", copy=True) if copy or not (
        a.flags.c_contiguous and a.flags.writeable) else a
    if is_bf16(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _dtype_name(a: np.ndarray) -> str:
    if is_bf16(a):
        return "BF16"
    for name, dt in _DTYPES.items():
        if a.dtype == dt:
            return name
    raise ValueError(f"safetensors has no dtype for {a.dtype}")


def _as_array(x: ArrayLike) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x)
    a = np.asarray(x)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a


def save_file(tensors: Dict[str, ArrayLike], path: str,
              metadata: Optional[Dict[str, str]] = None):
    """Write ``tensors`` (numpy arrays or tensors, by name) to ``path``;
    ``metadata`` becomes the ``__metadata__`` map of strings."""
    arrays = {k: _as_array(v) for k, v in tensors.items()}
    header: Dict[str, object] = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in metadata.items()):
            raise ValueError("safetensors metadata must map str to str")
        header["__metadata__"] = dict(metadata)
    off = 0
    for name in sorted(arrays):
        a = arrays[name]
        header[name] = {"dtype": _dtype_name(a), "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-(8 + len(raw)) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in sorted(arrays):
            a = np.ascontiguousarray(arrays[name])
            if a.nbytes:
                f.write(memoryview(a.reshape(-1).view(np.uint8)))


class SafeOpen:
    """Lazy reader (the ``safetensors.safe_open`` of the JAX package's
    streamed paths): the header is parsed once, ``get_tensor`` reads one
    tensor with ``seek`` + ``readinto``. Use as a context manager or
    ``close()`` it."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._entries, self._metadata, self._start = self._parse()
        except Exception:
            self._f.close()
            raise

    def _fail(self, why: str):
        raise ValueError(f"invalid safetensors file {self.path}: {why}")

    def _parse(self):
        size = os.fstat(self._f.fileno()).st_size
        head = self._f.read(8)
        if len(head) < 8:
            self._fail("truncated before the header length")
        n = int.from_bytes(head, "little")
        if n > _MAX_HEADER or 8 + n > size:
            self._fail(f"header of {n} bytes runs past the end of the "
                       f"file ({size} bytes)")
        try:
            header = json.loads(self._f.read(n).decode("utf-8"))
        except ValueError as e:
            self._fail(f"unreadable header ({e})")
        if not isinstance(header, dict):
            self._fail("header is not a JSON object")
        metadata = header.pop("__metadata__", None) or {}
        data = size - 8 - n
        entries = {}
        for name, e in header.items():
            try:
                dt = _DTYPES[e["dtype"]]
                shape = tuple(int(s) for s in e["shape"])
                begin, end = (int(o) for o in e["data_offsets"])
            except (KeyError, TypeError, ValueError):
                self._fail(f"bad entry for {name!r}: {e!r}")
            if any(s < 0 for s in shape):
                self._fail(f"negative shape {shape} for {name!r}")
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            if not 0 <= begin <= end or end - begin != nbytes:
                self._fail(f"offsets [{begin}, {end}) of {name!r} do not "
                           f"hold {shape} {e['dtype']}")
            if end > data:
                self._fail(f"{name!r} ends at {end}, past the data "
                           f"({data} bytes): truncated")
            entries[name] = (dt, shape, begin, end)
        last = 0
        for name, (_, _, begin, end) in sorted(
                entries.items(), key=lambda kv: (kv[1][2], kv[1][3])):
            if begin < last:
                self._fail(f"{name!r} overlaps the tensor before it")
            last = max(last, end)
        return entries, metadata, 8 + n

    def keys(self):
        return list(self._entries)

    def metadata(self) -> Dict[str, str]:
        return dict(self._metadata)

    def spec(self, name: str):
        """(numpy dtype, shape) of a tensor, without reading it."""
        dt, shape, _, _ = self._entries[name]
        return dt, shape

    def get_tensor(self, name: str) -> np.ndarray:
        dt, shape, begin, end = self._entries[name]
        out = np.empty(shape, dtype=dt)
        if end > begin:
            self._f.seek(self._start + begin)
            buf = memoryview(out.reshape(-1).view(np.uint8))
            if self._f.readinto(buf) != end - begin:
                self._fail(f"{name!r} is truncated")
        return out

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of ``path`` as a numpy array, by name."""
    with SafeOpen(path) as f:
        return {k: f.get_tensor(k) for k in f.keys()}
