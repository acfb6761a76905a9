"""Device: the share of the traced slice in which no kernel ran (the union
of the profiler's kernel intervals, as tools/profile_decode.py takes it),
in percent."""


def read(run):
    k = run.kernels
    if not k.events or k.window_s <= 0:
        return None
    return 100.0 * (1.0 - k.busy_s() / k.window_s)
