"""Device loops: tokens committed per lane-round, from the lanes'
SpecStats (each round commits its accepted drafts plus one token; rounds
run after a lane's request was complete are left out) and the tokens each
finished lane request committed after its first."""


def read(run):
    depth = int(run.spec["n_draft"])
    tokens = rounds = 0
    for h in run.rec.handles:
        if not h.done or h.error:
            continue
        tokens += len(h.tokens) - 1
        rounds += h.stats.n_rounds - h.stats.n_drafted_unverified // depth
    return tokens / rounds if rounds else None
