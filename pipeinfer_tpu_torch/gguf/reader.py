"""GGUF file reader: mmap-based, zero-copy tensor access.

TPU-native counterpart of the reference's C GGUF loader
(ref: ggml.c `gguf_init_from_file`, llama.cpp:1805-1938 `llama_model_loader`).
We keep the reference's mmap strategy — tensor payloads are exposed as numpy
views into the mapped file so a multi-host launch only faults in the pages a
host actually uploads to its devices (ref: README.md:130-140 use_mmap notes).
"""

from __future__ import annotations

import dataclasses
import mmap
import struct
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGUF_MAGIC,
    GGUF_DEFAULT_ALIGNMENT,
    SUPPORTED_GGUF_VERSIONS,
    GGMLQuantType,
    GGUFValueType,
    Keys,
    QUANT_BLOCK_INFO,
    type_size,
)

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_SCALAR_NP = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


@dataclasses.dataclass
class GGUFTensorInfo:
    """Directory entry for one tensor.

    ``shape`` is in numpy/row-major order (outermost first); the on-disk GGUF
    dims are stored innermost-first (ggml ``ne`` order) and reversed on read.
    """

    name: str
    shape: tuple[int, ...]
    qtype: GGMLQuantType
    offset: int  # relative to data section start
    n_bytes: int


class _Cursor:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> memoryview:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError("truncated GGUF file")
        self.pos += n
        return out

    def scalar(self, fmt: str):
        size = struct.calcsize(fmt)
        (val,) = struct.unpack(fmt, self.read(size))
        return val

    def string(self) -> str:
        n = self.scalar("<Q")
        return bytes(self.read(n)).decode("utf-8", errors="replace")

    def value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            return self.string()
        if vtype == GGUFValueType.ARRAY:
            elem_type = GGUFValueType(self.scalar("<I"))
            count = self.scalar("<Q")
            if elem_type == GGUFValueType.STRING:
                return [self.string() for _ in range(count)]
            if elem_type == GGUFValueType.ARRAY:
                return [self.value(GGUFValueType.ARRAY) for _ in range(count)]
            if elem_type == GGUFValueType.BOOL:
                raw = np.frombuffer(self.read(count), dtype=np.uint8)
                return raw.astype(bool)
            npdt = _SCALAR_NP[elem_type]
            nbytes = count * np.dtype(npdt).itemsize
            return np.frombuffer(self.read(nbytes), dtype=npdt).copy()
        return self.scalar(_SCALAR_FMT[vtype])


class GGUFReader:
    """Parse a GGUF v2/v3 file; metadata eagerly, tensor data as lazy mmap views."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file: BinaryIO = open(self.path, "rb")
        self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._mv = memoryview(self._mmap)

        cur = _Cursor(self._mv)
        magic = cur.scalar("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
        self.version = cur.scalar("<I")
        if self.version not in SUPPORTED_GGUF_VERSIONS:
            raise ValueError(f"{path}: unsupported GGUF version {self.version}")
        n_tensors = cur.scalar("<Q")
        n_kv = cur.scalar("<Q")

        self.metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = cur.string()
            vtype = GGUFValueType(cur.scalar("<I"))
            self.metadata[key] = cur.value(vtype)

        self.alignment = int(self.metadata.get(Keys.ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))

        self.tensors: dict[str, GGUFTensorInfo] = {}
        order: list[GGUFTensorInfo] = []
        for _ in range(n_tensors):
            name = cur.string()
            n_dims = cur.scalar("<I")
            ne = [cur.scalar("<Q") for _ in range(n_dims)]
            qtype = GGMLQuantType(cur.scalar("<I"))
            offset = cur.scalar("<Q")
            shape = tuple(reversed(ne))  # ggml ne[] is innermost-first
            n_elems = int(np.prod(ne)) if ne else 1
            info = GGUFTensorInfo(name, shape, qtype, offset, type_size(qtype, n_elems))
            self.tensors[name] = info
            order.append(info)
        self.tensor_order = order

        data_start = cur.pos
        pad = (-data_start) % self.alignment
        self.data_offset = data_start + pad

    # -- metadata helpers ---------------------------------------------------

    @property
    def architecture(self) -> str:
        return str(self.metadata.get(Keys.ARCHITECTURE, ""))

    def field(self, key_template: str, default=None, arch: str | None = None):
        key = key_template.format(arch=arch or self.architecture)
        return self.metadata.get(key, default)

    # -- tensor access ------------------------------------------------------

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Raw quantized payload as a uint8 view into the mmap (zero-copy)."""
        info = self.tensors[name]
        start = self.data_offset + info.offset
        return np.frombuffer(self._mv[start : start + info.n_bytes], dtype=np.uint8)

    def tensor(self, name: str, dequant: bool = True) -> np.ndarray:
        """Tensor as numpy array. F32/F16/I* are zero-copy views; quantized
        types are dequantized to float32 when ``dequant`` (else raw bytes)."""
        info = self.tensors[name]
        raw = self.tensor_bytes(name)
        if info.qtype == GGMLQuantType.F32:
            return raw.view(np.float32).reshape(info.shape)
        if info.qtype == GGMLQuantType.F16:
            return raw.view(np.float16).reshape(info.shape)
        if info.qtype == GGMLQuantType.I8:
            return raw.view(np.int8).reshape(info.shape)
        if info.qtype == GGMLQuantType.I16:
            return raw.view(np.int16).reshape(info.shape)
        if info.qtype == GGMLQuantType.I32:
            return raw.view(np.int32).reshape(info.shape)
        if not dequant:
            return raw
        from ..quant import formats

        flat = formats.dequantize(raw, info.qtype)
        return flat.reshape(info.shape)

    def close(self):
        """Release the mapping. If zero-copy tensor views are still alive the
        mmap stays open until they are garbage-collected (safe: pages are
        read-only); we just close the fd."""
        try:
            self._mv.release()
            self._mmap.close()
        except BufferError:
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return (
            f"GGUFReader({self.path}, v{self.version}, arch={self.architecture!r}, "
            f"{len(self.tensors)} tensors, {len(self.metadata)} kv)"
        )
