"""Synthetic models (copied from pipeinfer_tpu.tools.testmodel)."""
