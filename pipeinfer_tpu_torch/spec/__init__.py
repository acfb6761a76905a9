"""Speculative decoding: the async PipeInfer controller, its fused and
device-corrected runs, and the host drafting helpers."""

from .params import SpecParams  # noqa: F401
