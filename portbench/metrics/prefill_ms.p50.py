"""Admission: the median host time of an admission prefill in the window,
from the benchmark's span around DeviceLoopServer._admit (it returns once
the target's prefill rows are on the host)."""

import numpy as np


def read(run):
    ms = [1e3 * (t1 - t0) for t0, t1, _ in run.rec.admits if run.t_open <= t0 < run.t_close]
    return float(np.percentile(ms, 50)) if ms else None
