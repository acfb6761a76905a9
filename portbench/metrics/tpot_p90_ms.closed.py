"""Device loops, under a closed loop: the 90th percentile over the
requests due in the window of the mean time between their tokens
(run.end_to_end's TPOT tail), read beside the judged tokens per second
and not judged."""


def read(run):
    from portbench.run import end_to_end

    return end_to_end(run.timed, run.t_open, run.t_close)["tpot_p90_ms"]
