"""`python -m pipeinfer_tpu_torch.cli.main` — single-model generation
(ref: examples/main/main.cpp): tokenize -> prefill -> sample/decode loop ->
detokenize, with the full sampler chain and streaming output.

Port of pipeinfer_tpu.cli.main's non-interactive path, with the prompt
cache (--prompt-cache, runtime/state.py) and LoRA adapters applied at load
(--lora, --lora-scaled; tools/lora.py). The interactive, instruct and
ChatML modes, infill, run dumps and profiling are not ported yet
(ROADMAP.md queue 1, "The rest of the JAX package's surface"): asking for
one exits with an error that says so.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..gguf.reader import GGUFReader
from ..models import load_model
from ..runtime import state as rstate
from ..runtime.context import Batch, InferenceContext
from ..sampling.samplers import SamplerState
from ..tokenizer import tokenizer_from_gguf
from .args import add_gen_args, add_model_args, add_sampling_args, read_prompt, sampling_from_args

_SURFACE = "ROADMAP.md queue 1, \"The rest of the JAX package's surface\""


def build_context(model_path: str, n_cells: int, cache_dtype: str = "bf16",
                  need_tokenizer=True, device="cuda",
                  lora: list[tuple[str, float]] | None = None):
    """(InferenceContext, tokenizer or None) for a GGUF model on `device`,
    with each (adapter path, scale) of `lora` merged into its weights."""
    # LoRA deltas target the SPLIT projection slots: apply before fusing
    params, cfg = load_model(model_path, device=device, fuse=False if lora else None)
    if lora:
        from ..models.loader import default_fuse, fuse_projections
        from ..tools.lora import apply_lora

        for adapter_path, scale in lora:
            params = apply_lora(params, adapter_path, scale)
        if default_fuse(device):
            fuse_projections(params)  # an adapted (dense) slot keeps its group split
    tok = None
    with GGUFReader(model_path) as r:
        try:
            tok = tokenizer_from_gguf(r)
        except (KeyError, ValueError):
            if need_tokenizer:
                raise SystemExit(f"error: {model_path} has no tokenizer vocabulary")
    ctx = InferenceContext(
        params,
        cfg,
        n_cells=n_cells,
        cache_dtype=torch.bfloat16 if cache_dtype == "bf16" else torch.float32,
        device=device,
    )
    return ctx, tok


def generate(ctx, tok, sampler: SamplerState, prompt_ids, n_predict, *,
             ignore_eos=False, stream=None, cached_prefix=0, n_keep=-1,
             stop_check=None):
    """Greedy/sampled generation on sequence 0. Returns token ids.

    cached_prefix > 0 skips prefilling that many prompt tokens (their cells
    were restored from a session file). When the cell array fills, the
    context SLIDES: the first n_keep positions stay, half of the rest is
    discarded and the tail shifts down with K re-rotation (ref: main.cpp
    context swapping n_keep/n_discard + llama_kv_cache_seq_shift; infinite
    generation via --keep)."""
    batch = Batch()
    start = min(cached_prefix, len(prompt_ids) - 1)  # always decode the last
    for i in range(start, len(prompt_ids)):
        batch.add(prompt_ids[i], i, 0, want_logits=(i == len(prompt_ids) - 1))
    logits = ctx.decode(batch)[-1]
    out = []
    n_past = len(prompt_ids)
    for _ in range(n_predict):
        token = _sample_step(sampler, logits)
        out.append(token)
        if stream:
            stream(token)
        if not ignore_eos and token == tok.vocab.eos_id:
            break
        if stop_check is not None and stop_check():
            break  # reverse prompt hit in non-interactive mode (ref: main -r)
        if ctx.n_free_cells < 1:
            # context full: slide the window (ref: main.cpp "context
            # swapping" — keep n_keep, discard half of the rest)
            keep = len(prompt_ids) if n_keep < 0 else min(n_keep, n_past - 2)
            n_discard = max(1, (n_past - keep) // 2)
            ctx.seq_rm(0, keep, keep + n_discard)
            ctx.seq_shift(0, keep + n_discard, n_past, -n_discard)
            n_past -= n_discard
        batch.clear()
        batch.add(token, n_past, 0)
        logits = ctx.decode(batch)[0]
        n_past += 1
    return out


def _sample_step(sampler: SamplerState, logits: np.ndarray) -> int:
    from ..sampling.samplers import sample

    token = sample(sampler, logits)
    sampler.accept(token)
    return token


def load_prompt_cache(ctx, path: str, ids: list[int]) -> int:
    """Restore the session file at `path` (if there is one) into ctx and
    return how many leading prompt tokens it already holds: at most
    len(ids) - 1, so the last prompt token is decoded again for fresh
    logits; cells past that prefix are dropped (ref: examples/main session
    logic). A file of another shape is ignored with a note on stderr."""
    import os

    if not os.path.exists(path):
        return 0
    try:
        cached = rstate.load_state(ctx, path) or []
    except ValueError as e:
        print(f"prompt-cache ignored: {e}", file=sys.stderr)
        return 0
    if cached[: len(ids)] != ids[: len(cached)]:
        ctx.clear_cache()
        return 0
    cached_prefix = min(len(cached), len(ids) - 1)
    ctx.seq_rm(0, cached_prefix, -1)
    return cached_prefix


def refuse_unported(args) -> None:
    """Exit with an error naming the first option asked for that the port
    does not have yet (rather than silently running something else)."""
    asked = [
        ("-i/--interactive", args.interactive), ("--interactive-first", args.interactive_first),
        ("--instruct", args.instruct), ("--chatml", args.chatml),
        ("--fim-prefix/--fim-suffix (infill)",
         args.fim_prefix is not None or args.fim_suffix is not None),
        ("--logdir", bool(args.logdir)), ("--profile", bool(args.profile)),
    ]
    for name, on in asked:
        if on:
            raise SystemExit(f"error: {name} is not ported to pipeinfer_tpu_torch yet "
                             f"({_SURFACE})")


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer", description=__doc__.split("\n\n")[0])
    add_model_args(p)
    add_gen_args(p)
    add_sampling_args(p)
    # the JAX package's options, so the same command lines parse; those not
    # ported yet are refused in refuse_unported
    p.add_argument("-i", "--interactive", action="store_true",
                   help="interactive chat (not ported yet)")
    p.add_argument("--interactive-first", action="store_true",
                   help="interactive mode, waiting for input immediately (not ported yet)")
    p.add_argument("-r", "--reverse-prompt", action="append", default=[],
                   help="stop when this string is generated (repeatable; ref: main -r "
                   "antiprompt)")
    p.add_argument("--instruct", action="store_true",
                   help="Alpaca instruction mode (not ported yet)")
    p.add_argument("--chatml", action="store_true", help="ChatML mode (not ported yet)")
    # read only by the interactive loop: accepted for command-line
    # compatibility, with no effect until that loop is ported
    compat = "interactive only; accepted for command-line compatibility, no effect"
    p.add_argument("--in-prefix", default="", help=f"string prepended to user input ({compat})")
    p.add_argument("--in-suffix", default="", help=f"string appended to user input ({compat})")
    p.add_argument("--in-prefix-bos", dest="input_prefix_bos", action="store_true",
                   help=f"prefix user input with BOS ({compat})")
    p.add_argument("--color", action="store_true", help=f"colorize user input ({compat})")
    p.add_argument("--fim-prefix", default=None, help="fill-in-middle prefix (not ported yet)")
    p.add_argument("--fim-suffix", default=None, help="fill-in-middle suffix (not ported yet)")
    p.add_argument("--prompt-cache", default="",
                   help="session file: reuse its matching prompt prefix, save the run to it")
    p.add_argument("--lora", action="append", default=[], metavar="GGUF",
                   help="apply a LoRA adapter at load (ref: --lora; repeatable)")
    p.add_argument("--lora-scaled", action="append", default=[], nargs=2,
                   metavar=("GGUF", "S"), help="LoRA adapter with scale S (repeatable)")
    p.add_argument("--keep", type=int, default=-1,
                   help="tokens to keep when the context window slides "
                   "(-1 = whole prompt; ref: main --keep)")
    p.add_argument("--logdir", default="", help="YAML run dump directory (not ported yet)")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="trace the run to DIR (not ported yet)")
    args = p.parse_args(argv)
    refuse_unported(args)

    lora = [(f, 1.0) for f in args.lora] + [(f, float(s)) for f, s in args.lora_scaled]
    ctx, tok = build_context(args.model, args.ctx_size, args.cache_dtype, device=args.device,
                             lora=lora)
    sp = sampling_from_args(args)
    sampler = SamplerState(params=sp)
    if args.grammar or args.grammar_file:
        from ..sampling.grammar import grammar_state_from_gbnf

        text = args.grammar or open(args.grammar_file).read()
        sampler.grammar = grammar_state_from_gbnf(text, tok)

    ids = tok.encode(read_prompt(args), add_bos=True)
    if not ids:
        ids = [tok.vocab.bos_id]
    for t in ids:
        sampler.accept(t, apply_grammar=False)
    if not args.no_display_prompt:
        sys.stdout.write(tok.decode(ids))
        sys.stdout.flush()

    from ..tokenizer.stream import StreamDecoder

    sdec = StreamDecoder(tok)
    gen_tail = [""]

    def stream(token_id):
        piece = sdec.feed(token_id)
        gen_tail[0] = (gen_tail[0] + piece)[-256:]
        sys.stdout.write(piece)
        sys.stdout.flush()

    def hit_reverse_prompt():
        t = gen_tail[0]
        return any(
            t.find(ap, max(0, len(t) - len(ap) - 2)) != -1
            for ap in args.reverse_prompt
        )

    cached_prefix = load_prompt_cache(ctx, args.prompt_cache, ids) if args.prompt_cache else 0
    out = generate(
        ctx, tok, sampler, ids, args.n_predict,
        ignore_eos=args.ignore_eos, stream=stream, cached_prefix=cached_prefix,
        n_keep=args.keep, stop_check=hit_reverse_prompt if args.reverse_prompt else None,
    )
    if args.prompt_cache:
        rstate.save_state(ctx, args.prompt_cache, tokens=ids + out)
    sys.stdout.write("\n")
    ctx.print_timings(lambda s: print(s, file=sys.stderr))
    return 0


if __name__ == "__main__":
    sys.exit(main())
