"""Block-quant formats and planar repacking (copied from pipeinfer_tpu.quant,
numpy paths only)."""

from . import formats  # noqa: F401
