"""Sampling chain and GBNF grammars (copied from pipeinfer_tpu.sampling)."""

from .samplers import SamplingParams, SamplerState, sample, sample_with_candidates  # noqa: F401
