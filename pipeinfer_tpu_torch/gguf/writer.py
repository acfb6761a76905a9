"""GGUF file writer.

TPU-native counterpart of the reference's gguf-py writer + C `gguf_write_*`
API (ref: ggml.h:2045-2120, gguf-py/gguf/gguf_writer.py behavior — independent
implementation of the public v3 format). Used by the HF converter, the
quantize tool, and for building tiny test-fixture models.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from .constants import (
    GGUF_MAGIC,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_VERSION,
    GGMLQuantType,
    GGUFValueType,
    Keys,
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

_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}


def _infer_vtype(value: Any) -> GGUFValueType:
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return GGUFValueType.BOOL
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, int):
        if value < 0:
            return GGUFValueType.INT64 if value < -(2**31) else GGUFValueType.INT32
        return GGUFValueType.UINT64 if value >= 2**32 else GGUFValueType.UINT32
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, np.generic):
        return _NP_TO_VTYPE[value.dtype]
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(value)}")


class GGUFWriter:
    def __init__(self, path: str | Path, arch: str, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLQuantType, bytes]] = []
        self.arch = arch
        self.add_kv(Keys.ARCHITECTURE, arch)
        if alignment != GGUF_DEFAULT_ALIGNMENT:
            self.add_kv(Keys.ALIGNMENT, np.uint32(alignment))

    # -- metadata -----------------------------------------------------------

    def add_kv(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        self._kv.append((key, vtype or _infer_vtype(value), value))

    def add_arch_kv(self, key_template: str, value: Any):
        self.add_kv(key_template.format(arch=self.arch), value)

    # -- tensors ------------------------------------------------------------

    def add_tensor(
        self,
        name: str,
        data: np.ndarray | bytes,
        shape: Sequence[int] | None = None,
        qtype: GGMLQuantType | None = None,
    ):
        """Add a tensor. For float arrays, qtype defaults from dtype; for
        pre-quantized payloads pass raw ``bytes`` plus shape and qtype."""
        if isinstance(data, bytes):
            if shape is None or qtype is None:
                raise ValueError("raw payload needs explicit shape and qtype")
            payload = data
            shape = tuple(shape)
        else:
            data = np.ascontiguousarray(data)
            shape = tuple(data.shape)
            if qtype is None:
                qtype = {
                    np.dtype(np.float32): GGMLQuantType.F32,
                    np.dtype(np.float16): GGMLQuantType.F16,
                    np.dtype(np.int8): GGMLQuantType.I8,
                    np.dtype(np.int16): GGMLQuantType.I16,
                    np.dtype(np.int32): GGMLQuantType.I32,
                }[data.dtype]
                payload = data.tobytes()
            elif qtype in (GGMLQuantType.F32, GGMLQuantType.F16):
                dt = np.float32 if qtype == GGMLQuantType.F32 else np.float16
                payload = data.astype(dt).tobytes()
            else:
                from ..quant import formats
                from .constants import QUANT_BLOCK_INFO

                block_elems = QUANT_BLOCK_INFO[qtype][0]
                if shape and shape[-1] % block_elems != 0:
                    raise ValueError(
                        f"{name}: innermost dim {shape[-1]} is not a multiple of "
                        f"{qtype.name} block size {block_elems}"
                    )
                payload = formats.quantize(data.astype(np.float32).reshape(-1), qtype).tobytes()
        expected = type_size(qtype, int(np.prod(shape)) if shape else 1)
        if len(payload) != expected:
            raise ValueError(f"{name}: payload {len(payload)}B != expected {expected}B")
        self._tensors.append((name, shape, qtype, payload))

    # -- serialization ------------------------------------------------------

    def _write_str(self, f, s: str):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f, vtype: GGUFValueType, value: Any):
        if vtype == GGUFValueType.STRING:
            self._write_str(f, value)
        elif vtype == GGUFValueType.ARRAY:
            arr = value
            if isinstance(arr, np.ndarray):
                if arr.dtype == bool:
                    elem = GGUFValueType.BOOL
                else:
                    elem = _NP_TO_VTYPE[arr.dtype]
            elif len(arr) == 0:
                elem = GGUFValueType.INT32
            else:
                elem = _infer_vtype(arr[0])
            f.write(struct.pack("<I", int(elem)))
            f.write(struct.pack("<Q", len(arr)))
            if isinstance(arr, np.ndarray) and elem != GGUFValueType.STRING:
                if elem == GGUFValueType.BOOL:
                    f.write(arr.astype(np.uint8).tobytes())
                else:
                    f.write(np.ascontiguousarray(arr).tobytes())
            else:
                for v in arr:
                    self._write_value(f, elem, v)
        else:
            f.write(struct.pack(_SCALAR_FMT[vtype], value))

    def write(self):
        with open(self.path, "wb") as f:
            f.write(struct.pack("<I", GGUF_MAGIC))
            f.write(struct.pack("<I", GGUF_VERSION))
            f.write(struct.pack("<Q", len(self._tensors)))
            f.write(struct.pack("<Q", len(self._kv)))
            for key, vtype, value in self._kv:
                self._write_str(f, key)
                f.write(struct.pack("<I", int(vtype)))
                self._write_value(f, vtype, value)

            offset = 0
            for name, shape, qtype, payload in self._tensors:
                self._write_str(f, name)
                ne = tuple(reversed(shape))  # ggml ne[] order: innermost first
                f.write(struct.pack("<I", len(ne)))
                for d in ne:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<I", int(qtype)))
                f.write(struct.pack("<Q", offset))
                offset += len(payload) + (-len(payload)) % self.alignment

            pad = (-f.tell()) % self.alignment
            f.write(b"\x00" * pad)
            for _, _, _, payload in self._tensors:
                f.write(payload)
                f.write(b"\x00" * ((-len(payload)) % self.alignment))
