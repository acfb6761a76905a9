"""`python -m pipeinfer_tpu_torch.cli.speculative` — asynchronous pipelined
speculation driver (ref: examples/speculative/speculative.cpp CLI + metrics
:693-730; --sync is the lock-step baseline of examples/speculative_orig).

Port of pipeinfer_tpu.cli.speculative: the async PipeInfer controller
(device-corrected with -np 1 and a device-expressible sampler, host-
verified trees otherwise), the device-resident loop (spec/device_loop.py;
what --engine auto picks where it applies) and the lock-step baseline.
--stages N pipelines the target over N stages (parallel/stages.py), which
share the one device of --device; the draft stays a single context, and a
staged target keeps the controller.
"""

from __future__ import annotations

import argparse
import sys

from ..spec import device_loop
from ..spec.controller import PipeInferController
from ..spec.params import SpecParams
from ..spec.sync_spec import SyncSpeculator
from .args import (
    add_gen_args,
    add_model_args,
    add_sampling_args,
    add_spec_args,
    read_prompt,
    sampling_from_args,
)
from .main import build_context
from .pipeline import build_staged_context, parse_split


def spec_from_args(args) -> SpecParams:
    return SpecParams(
        n_draft=args.n_draft,
        n_parallel=args.n_parallel,
        p_accept=args.p_accept,
        p_split=args.p_split,
        p_recovery=args.p_recovery,
        p_decay=args.p_decay,
        max_inflight=args.max_inflight,
        corr_rounds=getattr(args, "corr_rounds", SpecParams.corr_rounds),
        device_verify=not getattr(args, "no_device_verify", False),
    )


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-speculative", description=__doc__.split("\n\n")[0])
    add_model_args(p, draft=True)
    add_gen_args(p)
    add_sampling_args(p)
    add_spec_args(p)
    p.add_argument("--sync", action="store_true", help="lock-step baseline (speculative_orig)")
    p.add_argument("--device-loop", action="store_true",
                   help="device-resident speculative loop: R rounds per dispatch with "
                   "verification on the device (greedy or stateless temp/top-k/top-p "
                   "chains only; falls back to the async controller otherwise)")
    p.add_argument("--engine", choices=("auto", "controller", "device-loop", "sync"),
                   default=None,
                   help="engine selection; 'auto' picks the device-resident loop whenever "
                   "its support envelope applies (one-device target, -np 1, stateless "
                   "sampler, no grammar) and the async controller otherwise. Default: "
                   "controller, or whatever --sync/--device-loop request")
    p.add_argument("--loop-rounds", type=int, default=8,
                   help="speculative rounds per device-loop dispatch")
    p.add_argument("--stages", type=int, default=1,
                   help="pipeline the target over N stages (the full PipeInfer "
                   "topology; the draft stays one context)")
    p.add_argument("--layer-split", default="",
                   help="stage weights for --stages (e.g. 0.1,0.45,0.45)")
    p.add_argument("-dkvc", "--dump-kv-cache", action="store_true",
                   help="print per-cell KV occupancy after generation "
                   "(ref: dump_kv_cache_view_seqs, the rollback debug aid)")
    args = p.parse_args(argv)
    if args.engine == "sync":
        args.sync = True
    elif args.engine == "device-loop":
        args.device_loop = True
    elif args.engine == "controller":
        args.sync = args.device_loop = False

    sp = spec_from_args(args)
    sampling = sampling_from_args(args)
    grammar_text = None
    if args.grammar or args.grammar_file:
        grammar_text = args.grammar or open(args.grammar_file).read()
    if args.engine == "auto" and not args.sync:
        # on-device verification wherever it applies; tree drafting
        # (-np > 1) and staged targets keep the controller
        args.device_loop = (args.stages == 1 and sp.n_parallel == 1
                            and device_loop.supported(sampling, grammar_text))

    if args.stages > 1:
        ctx_tgt, tok = build_staged_context(args.model, args.ctx_size, args.cache_dtype,
                                            args.stages, parse_split(args.layer_split),
                                            device=args.device)
        print(f"target pipeline: {args.stages} stages, ranges {ctx_tgt.ranges}",
              file=sys.stderr)
    else:
        ctx_tgt, tok = build_context(args.model, args.ctx_size, args.cache_dtype,
                                     device=args.device)
    ctx_dft, _ = build_context(args.model_draft, args.ctx_size, args.cache_dtype,
                               need_tokenizer=False, device=args.device)
    if ctx_tgt.cfg.n_vocab != ctx_dft.cfg.n_vocab:
        print(
            f"warning: target vocab {ctx_tgt.cfg.n_vocab} != draft vocab {ctx_dft.cfg.n_vocab}",
            file=sys.stderr,
        )
    grammar = None
    if grammar_text is not None:
        from ..sampling.grammar import grammar_state_from_gbnf

        grammar = grammar_state_from_gbnf(grammar_text, tok)

    ids = tok.encode(read_prompt(args), add_bos=True)
    if not args.no_display_prompt:
        sys.stdout.write(tok.decode(ids))
        sys.stdout.flush()

    from ..tokenizer.stream import StreamDecoder

    sdec = StreamDecoder(tok)

    def stream(t):
        sys.stdout.write(sdec.feed(t))
        sys.stdout.flush()

    if args.device_loop and (args.stages > 1 or not device_loop.supported(sampling, grammar)):
        print("warning: --device-loop unsupported for this config (multi-stage target / "
              "stateful sampler chain); using the async controller", file=sys.stderr)
        args.device_loop = False
    metrics = None
    if args.sync:
        engine = SyncSpeculator(
            ctx_tgt, ctx_dft, sampling, sp, eos_id=tok.vocab.eos_id, grammar=grammar
        )
    elif args.device_loop:
        engine = device_loop.DeviceLoopEngine(ctx_tgt, ctx_dft, sampling, sp,
                                              eos_id=tok.vocab.eos_id, rounds=args.loop_rounds)
    else:
        engine = PipeInferController(
            ctx_tgt, ctx_dft, sampling, sp, eos_id=tok.vocab.eos_id, grammar=grammar
        )
        metrics = engine.metrics
    engine.generate(ids, args.n_predict, ignore_eos=args.ignore_eos, stream=stream)
    stats = engine.stats

    sys.stdout.write("\n")
    err = lambda s: print(s, file=sys.stderr)  # noqa: E731
    # ref: speculative.cpp:712-730 stdout metrics
    err(f"n_draft   = {sp.n_draft}")
    err(f"n_predict = {stats.n_predict}")
    err(f"n_drafted = {stats.n_drafted}")
    err(f"n_accept  = {stats.n_accept}")
    err(f"accept    = {100.0 * stats.accept_rate:.3f}%")
    if stats.n_drafted_unverified:
        err(f"accept (decided) = {100.0 * stats.accept_rate_decided:.3f}% "
            f"({stats.n_drafted_unverified} drafts never verified)")
    if args.device_loop:
        # decode time lives inside the device loop's dispatches — the
        # context's per-dispatch timings only see the prefill; report the
        # engine's
        err(f"encode    = {len(ids) / max(engine.t_prefill, 1e-9):.2f} t/s")
        err(f"decode    = {stats.n_predict / max(engine.t_decode, 1e-9):.2f} t/s "
            f"(device loop, {stats.n_rounds} rounds)")
    if metrics is not None:
        err(f"runs      = {metrics.n_runs} ({metrics.n_canceled_runs} canceled)")
        err(f"dead work = {100.0 * metrics.dead_work_frac:.1f}% of dispatched tokens")
        err(f"encode    = {metrics.encode_tps:.2f} t/s")
        err(f"decode    = {metrics.decode_tps:.2f} t/s")
        err(f"avg itl   = {metrics.avg_itl * 1e3:.1f} ms")
        err(f"ttft      = {metrics.ttft_s * 1e3:.1f} ms (incl. prefill; "
            f"{metrics.ttft_decode_s * 1e3:.1f} ms decode-only)")
        if args.results_csv:
            # ref: speculative.cpp:693-710 results.csv append
            from pathlib import Path

            label = f"{Path(args.model).stem}:PipeInfer"
            with open(args.results_csv, "a") as f:
                f.write(metrics.csv_row(label) + "\n")
    ctx_tgt.print_timings(err)
    if args.dump_kv_cache:
        from ..utils import kv_view

        err("target KV cells:")
        err(kv_view.dump_seqs(ctx_tgt))
        err(f"view: {kv_view.view(ctx_tgt)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
