"""`python -m pipeinfer_tpu_torch.cli.speculative` — asynchronous pipelined
speculation driver (ref: examples/speculative/speculative.cpp CLI + metrics
:693-730; --sync is the lock-step baseline of examples/speculative_orig).

Port of pipeinfer_tpu.cli.speculative for its one-device engines: the
async PipeInfer controller (device-corrected with -np 1 and a device-
expressible sampler, host-verified trees otherwise) and the lock-step
baseline. The device-loop engine (ROADMAP.md queue 1 item 6) and staged
targets (queue 8) are not ported yet: asking for them, including through
--engine auto where it would pick the device loop, exits with an error
instead of running another engine.
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

_DEVICE_LOOP = "ROADMAP.md queue 1 item 6"
_STAGES = "ROADMAP.md queue 8"


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
                   help=f"device-resident speculative loop (not ported yet: {_DEVICE_LOOP})")
    p.add_argument("--engine", choices=("auto", "controller", "device-loop", "sync"),
                   default=None,
                   help="engine selection; 'auto' would pick the device-resident loop "
                   "where it applies (not ported yet, so auto exits there) and the async "
                   "controller otherwise. Default: controller, or what --sync asks for")
    p.add_argument("--loop-rounds", type=int, default=8,
                   help="speculative rounds per device-loop dispatch (accepted for "
                   "command-line compatibility; no effect until the device loop is ported)")
    p.add_argument("--stages", type=int, default=1,
                   help=f"pipeline the target over N stages (not ported yet: {_STAGES})")
    p.add_argument("--layer-split", default="",
                   help="stage weights for --stages (accepted for command-line "
                   "compatibility; no effect until stages are ported)")
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
    if args.stages > 1:
        raise SystemExit(f"error: --stages > 1 is not ported to pipeinfer_tpu_torch yet "
                         f"({_STAGES})")
    if args.device_loop:
        raise SystemExit(f"error: the device-loop engine is not ported to pipeinfer_tpu_torch "
                         f"yet ({_DEVICE_LOOP})")

    sp = spec_from_args(args)
    sampling = sampling_from_args(args)
    grammar_text = None
    if args.grammar or args.grammar_file:
        grammar_text = args.grammar or open(args.grammar_file).read()
    if (args.engine == "auto" and not args.sync and sp.n_parallel == 1
            and grammar_text is None and device_loop.supported(sampling)):
        # the JAX package's auto pick would be the device loop here
        raise SystemExit(f"error: --engine auto picks the device-loop engine for this "
                         f"configuration, which is not ported to pipeinfer_tpu_torch yet "
                         f"({_DEVICE_LOOP}); use --engine controller")

    ctx_tgt, tok = build_context(args.model, args.ctx_size, args.cache_dtype, device=args.device)
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

    if args.sync:
        engine = SyncSpeculator(
            ctx_tgt, ctx_dft, sampling, sp, eos_id=tok.vocab.eos_id, grammar=grammar
        )
        metrics = None
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
