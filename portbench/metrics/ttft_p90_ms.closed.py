"""Admission, under a closed loop: the 90th percentile of the time from
each request's submission to its first token over every request due in
the window (run.end_to_end's TTFT tail). Past capacity a queue grows and
shrinks with the order in which requests complete, so this tail is read
beside the judged tokens per second and not judged."""


def read(run):
    from portbench.run import end_to_end

    return end_to_end(run.timed, run.t_open, run.t_close)["ttft_p90_ms"]
