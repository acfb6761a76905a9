"""Context and model step: device kernels in the traced slice per output
token committed in it."""


def read(run):
    k = run.kernels
    n = run.tokens_between(k.t0, k.t1)
    return len(k.events) / n if n and k.events else None
