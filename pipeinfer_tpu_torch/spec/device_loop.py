"""The device-loop engine's sampler envelope.

Only ``supported`` is ported so far (spec/corrected.py gates on it); the
device-loop engine itself (pipeinfer_tpu.spec.device_loop.DeviceLoopEngine)
waits in ROADMAP.md.
"""

from __future__ import annotations


def supported(sampling, grammar=None) -> bool:
    """Single-sequence, stateless-sampler generations only: greedy, or a
    pure (temp, top_k, top_p, min_p) chain — penalties/mirostat/grammar
    keep the async controller's host verification. Stochastic mode samples
    the TARGET on the device through the same chain, so top_k must be a
    real bound (the device sampler works within the top-64 candidates) and
    tfs/typical must be off."""
    no_pen = sampling.penalty_last_n == 0 or (
        sampling.penalty_repeat == 1.0
        and sampling.penalty_freq == 0.0
        and sampling.penalty_present == 0.0
    )
    base_ok = (
        no_pen
        and sampling.mirostat == 0
        and not sampling.logit_bias
        and grammar is None
    )
    if not base_ok:
        return False
    if sampling.temp <= 0:
        return True
    return (
        0 < sampling.top_k <= 64
        and sampling.tfs_z >= 1.0
        and sampling.typical_p >= 1.0
    )
