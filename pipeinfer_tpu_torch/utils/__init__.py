"""Debugging aids (copied from pipeinfer_tpu.utils)."""
