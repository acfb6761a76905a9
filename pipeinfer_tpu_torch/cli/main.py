"""`python -m pipeinfer_tpu_torch.cli.main` — single-model generation
(ref: examples/main/main.cpp): tokenize -> prefill -> sample/decode loop ->
detokenize, with the full sampler chain and streaming output.

Port of pipeinfer_tpu.cli.main: one-shot generation with the prompt cache
(--prompt-cache, runtime/state.py) and LoRA adapters applied at load
(--lora, --lora-scaled; tools/lora.py), the interactive, instruct and
ChatML chat loop (interactive_loop), fill-in-middle prompts (--fim-prefix,
--fim-suffix; cli/infill.py), YAML run dumps (--logdir, utils/rundump.py)
and a profiler trace of the run (--profile DIR: torch.profiler over the
CPU and, on the card, CUDA activity, written to DIR for TensorBoard or
Perfetto, where the JAX package writes jax.profiler's trace).
"""

from __future__ import annotations

import argparse
import contextlib
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


def build_context(model_path: str, n_cells: int, cache_dtype: str = "bf16",
                  need_tokenizer=True, device="cuda",
                  lora: list[tuple[str, float]] | None = None):
    """(InferenceContext, tokenizer or None) for a GGUF model on `device`,
    with each (adapter path, scale) of `lora` merged into its weights."""
    from ..utils.compile_cache import enable

    enable()  # the kernels' build directory (PIPEINFER_CACHE_DIR), as the JAX CLI's cache
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


def _slide_if_full(ctx, n_past: int, n_keep: int, need: int = 1) -> int:
    """Context sliding: keep the first n_keep positions, discard half of the
    rest, shift the tail down re-rotating K (ref: main.cpp context swapping
    + llama_kv_cache_seq_shift)."""
    while ctx.n_free_cells < need and n_past > n_keep + 2:
        n_discard = max(need, (n_past - n_keep) // 2)
        ctx.seq_rm(0, n_keep, n_keep + n_discard)
        ctx.seq_shift(0, n_keep + n_discard, n_past, -n_discard)
        n_past -= n_discard
    return n_past


_ANSI_USER = "\x1b[32m"  # green user input (ref: console.cpp user_input)
_ANSI_RESET = "\x1b[0m"


def interactive_loop(ctx, tok, sampler: SamplerState, prompt_ids, args, *,
                     input_fn=None, write=None) -> list[int]:
    """Interactive / instruct / chatml chat loop — the reference `main`
    state machine (ref: examples/main/main.cpp:497-860): generate until a
    reverse prompt, EOS, or the per-turn token budget, then read a user
    line, wrap it with the mode's prefixes/suffixes, queue it for decode,
    and continue. An empty input line passes control back to the model;
    EOF (ctrl-D) exits. Returns all generated token ids.

    input_fn/write are injectable for tests (default: stdin/stdout)."""
    if write is None:
        def write(s):
            sys.stdout.write(s)
            sys.stdout.flush()
    real_stdin = input_fn is None
    color = getattr(args, "color", False) and real_stdin
    if input_fn is None:
        def input_fn():
            if color:
                sys.stdout.write(_ANSI_USER)
                sys.stdout.flush()
            try:
                return input()
            finally:
                if color:
                    sys.stdout.write(_ANSI_RESET)
                    sys.stdout.flush()

    from ..tokenizer.stream import StreamDecoder

    sdec = StreamDecoder(tok)
    enc = lambda s: tok.encode(s, add_bos=False)  # noqa: E731

    # mode prefixes/suffixes (ref: main.cpp:337-345)
    inp_pfx = enc("\n\n### Instruction:\n\n")
    inp_sfx = enc("\n\n### Response:\n\n")
    cml_pfx = enc("\n<|im_start|>user\n")
    cml_sfx = enc("<|im_end|>\n<|im_start|>assistant\n")

    antiprompts = list(getattr(args, "reverse_prompt", []) or [])
    if args.instruct:
        antiprompts.append("### Instruction:\n\n")
    elif getattr(args, "chatml", False):
        antiprompts.append("<|im_start|>user\n")

    n_keep = len(prompt_ids) if args.keep < 0 else args.keep
    if args.instruct or getattr(args, "chatml", False):
        n_keep = len(prompt_ids)  # ref: main.cpp:331-333

    pending = list(prompt_ids)  # embd_inp queue: prompt, then each user turn
    out_ids: list[int] = []
    n_past = 0
    logits = None
    tail = ""  # rolling generated-text tail for reverse-prompt search
    is_interacting = bool(
        args.interactive_first or args.instruct or getattr(args, "chatml", False)
    )
    was_antiprompt = is_interacting  # instruct/chatml: first turn needs no pfx
    n_remain = args.n_predict

    # ctrl-C returns control to the user instead of killing the process
    # (ref: main.cpp sigint_handler)
    interrupted = [False]
    sig_ctx = contextlib.nullcontext()
    if real_stdin:
        import signal

        class _SigintScope(contextlib.AbstractContextManager):
            def __enter__(self):
                self.prev = signal.signal(
                    signal.SIGINT, lambda *_: interrupted.__setitem__(0, True)
                )
                return self

            def __exit__(self, *exc):
                signal.signal(signal.SIGINT, self.prev)
                return False

        sig_ctx = _SigintScope()

    with sig_ctx:
        while True:
            if pending:
                n_past = _slide_if_full(ctx, n_past, n_keep, need=len(pending))
                batch = Batch()
                for i, t in enumerate(pending):
                    batch.add(t, n_past + i, 0,
                              want_logits=(i == len(pending) - 1))
                    sampler.accept(t, apply_grammar=False)
                logits = ctx.decode(batch)[-1]
                n_past += len(pending)
                pending = []
            elif not is_interacting:
                token = _sample_step(sampler, logits)
                out_ids.append(token)
                piece = sdec.feed(token)
                write(piece)
                tail = (tail + piece)[-256:]
                n_remain -= 1
                # the sampled token always enters the context — the next
                # user turn continues after it (ref: main.cpp decodes embd
                # at the top of the loop)
                n_past = _slide_if_full(ctx, n_past, n_keep)
                batch = Batch()
                batch.add(token, n_past, 0)
                logits = ctx.decode(batch)[0]
                n_past += 1

                hit_anti = False
                for ap in antiprompts:
                    start = max(0, len(tail) - len(ap) - 2)
                    if tail.find(ap, start) != -1:
                        hit_anti = True
                        break
                if hit_anti:
                    is_interacting = was_antiprompt = True
                elif token == tok.vocab.eos_id and not args.ignore_eos:
                    # EOS: interactive injects the first reverse prompt and
                    # returns control (ref: main.cpp:752-768)
                    if not (args.instruct or getattr(args, "chatml", False)) \
                            and antiprompts:
                        pending.extend(enc(antiprompts[0]))
                        was_antiprompt = True
                    write("\n")
                    is_interacting = True
                elif n_remain == 0 and args.n_predict >= 0:
                    is_interacting = True
                elif interrupted[0]:
                    interrupted[0] = False
                    write("\n")
                    is_interacting = True

            if is_interacting and not pending:
                if args.instruct or getattr(args, "chatml", False):
                    write("\n> ")
                if args.in_prefix:
                    write(args.in_prefix)
                try:
                    buf = input_fn()
                except EOFError:
                    break
                if buf is None:
                    break
                if len(buf) >= 1 and buf.strip():
                    turn: list[int] = []
                    if getattr(args, "input_prefix_bos", False):
                        turn.append(tok.vocab.bos_id)
                    if args.instruct and not was_antiprompt:
                        turn.extend(inp_pfx)
                    if getattr(args, "chatml", False) and not was_antiprompt:
                        turn.extend(cml_pfx)
                    if args.in_prefix:
                        turn.extend(enc(args.in_prefix))
                    turn.extend(enc(buf))
                    if args.in_suffix:
                        write(args.in_suffix)
                        turn.extend(enc(args.in_suffix))
                    if args.instruct:
                        turn.extend(inp_sfx)
                    if getattr(args, "chatml", False):
                        turn.extend(cml_sfx)
                    pending.extend(turn)
                # empty line: pass control back with no new input
                was_antiprompt = False
                is_interacting = False
                n_remain = args.n_predict
    return out_ids


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


def profile_to(trace_dir: str, device: torch.device):
    """A torch.profiler context over the CPU and (on a CUDA device) the
    card's activity, which writes its trace into trace_dir when it exits
    (the JAX package opens jax.profiler.trace(trace_dir) here)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts, on_trace_ready=tensorboard_trace_handler(trace_dir))


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer", description=__doc__.split("\n\n")[0])
    add_model_args(p)
    add_gen_args(p)
    add_sampling_args(p)
    p.add_argument("-i", "--interactive", action="store_true",
                   help="interactive chat: generation pauses at reverse "
                   "prompts / EOS / ctrl-C and reads user input "
                   "(ref: main.cpp interactive mode)")
    p.add_argument("--interactive-first", action="store_true",
                   help="interactive mode, waiting for input immediately")
    p.add_argument("-r", "--reverse-prompt", action="append", default=[],
                   help="return control to the user when this string is "
                   "generated (repeatable; ref: main -r antiprompt)")
    p.add_argument("--instruct", action="store_true",
                   help="Alpaca instruction mode: wraps each input in "
                   "'### Instruction/### Response' (ref: main --instruct)")
    p.add_argument("--chatml", action="store_true",
                   help="ChatML mode: wraps each input in <|im_start|> "
                   "chat markers (ref: main --chatml)")
    p.add_argument("--in-prefix", default="",
                   help="string prepended to each user input (interactive)")
    p.add_argument("--in-suffix", default="",
                   help="string appended to each user input (interactive)")
    p.add_argument("--in-prefix-bos", dest="input_prefix_bos", action="store_true",
                   help="prefix each user input with BOS")
    p.add_argument("--color", action="store_true",
                   help="colorize user input (interactive)")
    p.add_argument("--fim-prefix", default=None,
                   help="fill-in-middle: code before the cursor "
                   "(see also cli.infill; ref: examples/infill)")
    p.add_argument("--fim-suffix", default=None,
                   help="fill-in-middle: code after the cursor")
    p.add_argument("--prompt-cache", default="",
                   help="session file: reuse its matching prompt prefix, save the run to it")
    p.add_argument("--lora", action="append", default=[], metavar="GGUF",
                   help="apply a LoRA adapter at load (ref: --lora; repeatable)")
    p.add_argument("--lora-scaled", action="append", default=[], nargs=2,
                   metavar=("GGUF", "S"), help="LoRA adapter with scale S (repeatable)")
    p.add_argument("--keep", type=int, default=-1,
                   help="tokens to keep when the context window slides "
                   "(-1 = whole prompt; ref: main --keep)")
    p.add_argument("--logdir", default="",
                   help="write a YAML run dump to this directory "
                   "(ref: main --logdir dump_non_result_info_yaml)")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="trace the run with torch.profiler (CPU and CUDA activity) into "
                   "DIR, viewable in TensorBoard/Perfetto (the GGML_PERF counterpart, "
                   "ref: llama.cpp:5720-5724)")
    args = p.parse_args(argv)

    lora = [(f, 1.0) for f in args.lora] + [(f, float(s)) for f, s in args.lora_scaled]
    ctx, tok = build_context(args.model, args.ctx_size, args.cache_dtype, device=args.device,
                             lora=lora)
    sp = sampling_from_args(args)
    sampler = SamplerState(params=sp)
    if args.grammar or args.grammar_file:
        from ..sampling.grammar import grammar_state_from_gbnf

        text = args.grammar or open(args.grammar_file).read()
        sampler.grammar = grammar_state_from_gbnf(text, tok)

    prompt = read_prompt(args)
    if args.fim_prefix is not None or args.fim_suffix is not None:
        v = tok.vocab
        if v.fim_pre < 0 or v.fim_suf < 0 or v.fim_mid < 0:
            raise SystemExit("error: this model's vocab has no fill-in-middle tokens")
        ids = (
            [v.bos_id, v.fim_pre]
            + tok.encode(args.fim_prefix or "", add_bos=False)
            + [v.fim_suf]
            + tok.encode(args.fim_suffix or "", add_bos=False)
            + [v.fim_mid]
        )
    else:
        ids = tok.encode(prompt, add_bos=True)
    if not ids:
        ids = [tok.vocab.bos_id]
    interactive = (args.interactive or args.interactive_first or args.instruct
                   or args.chatml)
    if not interactive:
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
    prof = contextlib.nullcontext()
    if args.profile:
        prof = profile_to(args.profile, ctx.device)
    with prof:
        if interactive:
            if args.prompt_cache and cached_prefix:
                print("note: --prompt-cache prefix reuse is ignored in "
                      "interactive mode", file=sys.stderr)
                ctx.clear_cache()
            out = interactive_loop(ctx, tok, sampler, ids, args)
        else:
            out = generate(
                ctx, tok, sampler, ids, args.n_predict,
                ignore_eos=args.ignore_eos, stream=stream, cached_prefix=cached_prefix,
                n_keep=args.keep, stop_check=hit_reverse_prompt if args.reverse_prompt else None,
            )
    if args.profile:
        print(f"profile trace -> {args.profile}", file=sys.stderr)
    if args.prompt_cache:
        rstate.save_state(ctx, args.prompt_cache, tokens=ids + out)
    sys.stdout.write("\n")
    ctx.print_timings(lambda s: print(s, file=sys.stderr))
    if args.logdir:
        from ..utils.rundump import dump_run_yaml

        path = dump_run_yaml(args.logdir, args=vars(args), prompt_ids=ids,
                             output_ids=out, output_text=tok.decode(out), ctx=ctx)
        print(f"run dump: {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
