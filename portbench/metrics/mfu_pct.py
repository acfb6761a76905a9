"""Whole step: the target model's FLOPs of the prompt tokens prefilled and
the output tokens committed in the window (roofline.token_flops: 2 per
weight of its products and 4 H D per cell of attention in every layer, at
each token's context) over the window's seconds times the card's int8
dense peak (its products are s8; no format of the chip runs faster), in
percent. A request's prompt counts where its first token came in the
window; its first token comes from that prefill and is not counted again."""


def read(run):
    rl, mb = run.roofline, run.mb
    flops = 0.0
    per_ctx = 4.0 * mb.n_layers * mb.n_heads * mb.head_dim
    w = 2.0 * rl.matmul_params(mb)
    for tr in run.timed:
        p = len(tr.planned.prompt)
        for i, s in enumerate(tr.stamps):
            if not (run.t_open <= s < run.t_close):
                continue
            if i == 0:
                flops += p * w + per_ctx * p * (p + 1) / 2
            else:
                flops += w + per_ctx * (p + i)
    secs = run.t_close - run.t_open
    return 100.0 * flops / (secs * rl.PEAK_INT8_OPS) if flops else None
