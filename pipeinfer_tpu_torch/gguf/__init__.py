"""GGUF reader/writer (copied from pipeinfer_tpu.gguf; numpy only)."""

from .constants import GGMLQuantType, GGUFValueType, Keys, QK_K, type_size  # noqa: F401
from .reader import GGUFReader, GGUFTensorInfo  # noqa: F401
from .writer import GGUFWriter  # noqa: F401
