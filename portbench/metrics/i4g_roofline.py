"""Kernel ops/qmatmul.py + csrc/qmatmul_i4g.cu: the least time of the i4g
calls made in the traced slice (shapes from the Python entry, bytes and
operations by roofline.i4g_work, against the int8 peak) over the device
time of the kernels that qmatmul_i4g.cu defines, in percent."""


def read(run):
    rl = run.roofline
    t = run.kernels.by_source(run.port_kernels).get("qmatmul_i4g", 0.0)
    if not t or not run.i4g_calls:
        return None
    least = sum(rl.least_s(*rl.i4g_work(m, n, kp), rl.PEAK_INT8_OPS) for m, n, kp in run.i4g_calls)
    return 100.0 * least / t
