"""Sampling chain (copied from pipeinfer_tpu.sampling.samplers)."""

from .samplers import SamplingParams, SamplerState, sample, sample_with_candidates  # noqa: F401
