"""Kernel ops/cell_attention.py + csrc/cell_attention.cu: the least time
of the attention work of the traced slice over the device time of the
kernels that cell_attention.cu defines, in percent.

The work is counted from the benchmark's records of the device lanes:
each admission prefills its prompts in the target and the draft (each row
sees its own prompt's earlier cells); each dispatch runs `rounds` rounds
in which every live lane verifies n_draft + 1 rows in every target layer
and drafts n_draft single rows in every draft layer, each row seeing the
lane's committed context (its count at dispatch: the rows' own new cells
are left out, so the work is never counted high). Bytes are q and out
rows and the K/V of the visible cells, FLOPs 4 H D per visible pair
(roofline.cell_attn_work), against the bf16 peak."""


def read(run):
    rl, mb = run.roofline, run.mb
    k = run.kernels
    t = k.by_source(run.port_kernels).get("cell_attention", 0.0)
    if not t:
        return None
    shape = (mb.n_heads, mb.n_kv_heads, mb.head_dim)
    layers = mb.n_layers + mb.draft_layers
    depth = int(run.spec["n_draft"])
    least = 0.0
    for t0, _, lens in run.rec.admits:
        if k.t0 <= t0 < k.t1:
            rows = sum(lens)
            pairs = sum(n * (n + 1) // 2 for n in lens)
            least += layers * rl.least_s(*rl.cell_attn_work(rows, rows, pairs, *shape),
                                         rl.PEAK_BF16_FLOPS)
    for t0, ctxs in run.rec.dispatches:
        if not (k.t0 <= t0 < k.t1) or not ctxs:
            continue
        vis = sum(ctxs)
        verify = rl.least_s(*rl.cell_attn_work(len(ctxs) * (depth + 1), vis, (depth + 1) * vis,
                                               *shape), rl.PEAK_BF16_FLOPS)
        draft = rl.least_s(*rl.cell_attn_work(len(ctxs), vis, vis, *shape), rl.PEAK_BF16_FLOPS)
        least += run.rounds * (mb.n_layers * verify + depth * mb.draft_layers * draft)
    return 100.0 * least / t if least else None
