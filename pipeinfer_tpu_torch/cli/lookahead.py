"""`python -m pipeinfer_tpu_torch.cli.lookahead` — lookahead decoding from the command line
(ref: examples/lookahead/lookahead.cpp CLI + the encoded/decoded/W/N/G
stats block :462-476). Model-free speculation: no draft model argument.

Port of pipeinfer_tpu.cli.lookahead, on `--device` (cuda unless asked
for the CPU)."""

from __future__ import annotations

import argparse
import sys

from ..spec.lookahead import LookaheadDecoder
from .args import add_gen_args, add_model_args, add_sampling_args, read_prompt, sampling_from_args
from .main import build_context


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-lookahead", description=__doc__.split("\n\n")[0])
    add_model_args(p)
    add_gen_args(p)
    add_sampling_args(p)
    p.add_argument("-W", "--window", type=int, default=15, help="lookahead window width")
    p.add_argument("-N", "--ngram", type=int, default=5, help="n-gram size")
    p.add_argument("-G", "--ngram-pool", type=int, default=15,
                   help="max verification n-grams per token")
    args = p.parse_args(argv)

    ctx, tok = build_context(args.model, args.ctx_size, args.cache_dtype, device=args.device)
    sampling = sampling_from_args(args)
    # sparse logits head unless a sampler feature needs full vocab rows
    topk = None if sampling.mirostat else 128
    eng = LookaheadDecoder(
        ctx, sampling,
        W=args.window, N=args.ngram, G=args.ngram_pool,
        eos_id=tok.vocab.eos_id, topk=topk,
    )
    ids = tok.encode(read_prompt(args), add_bos=True)
    if not args.no_display_prompt:
        sys.stdout.write(tok.decode(ids))
        sys.stdout.flush()

    from ..tokenizer.stream import StreamDecoder

    sdec = StreamDecoder(tok)

    def stream(t):
        sys.stdout.write(sdec.feed(t))
        sys.stdout.flush()

    eng.generate(ids, args.n_predict, ignore_eos=args.ignore_eos, stream=stream)
    sys.stdout.write("\n")
    err = lambda s: print(s, file=sys.stderr)  # noqa: E731
    err(f"W = {args.window}")
    err(f"N = {args.ngram}")
    err(f"G = {args.ngram_pool}")
    err(f"n_predict = {eng.stats.n_predict}")
    err(f"n_accept  = {eng.stats.n_accept}")
    ctx.print_timings(err)
    return 0


if __name__ == "__main__":
    sys.exit(main())
