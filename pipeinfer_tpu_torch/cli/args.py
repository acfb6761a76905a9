"""Shared CLI argument surface — the counterpart of gpt_params + its parser
(ref: common/common.h:45-133, common/common.cpp:104-900), including the
PipeInfer speculation knobs (ref: common.h:54-65 p_accept/p_split/
p_recovery/p_decay/n_draft/n_parallel and README.md:191-220 tuning docs).

Copied from pipeinfer_tpu.cli.args, plus ``--device`` (cuda or cpu): the
port's counterpart of choosing the JAX platform."""

from __future__ import annotations

import argparse

from ..sampling.samplers import SamplingParams
from ..spec.params import SpecParams


def add_model_args(p: argparse.ArgumentParser, draft: bool = False):
    p.add_argument("-m", "--model", required=True, help="target model GGUF path")
    if draft:
        p.add_argument("-md", "--model-draft", required=True, help="draft model GGUF path")
    p.add_argument("-c", "--ctx-size", type=int, default=1024, help="KV cells per sequence pool")
    p.add_argument("--cache-dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (cpu: the kernels' plain PyTorch versions)")


def add_gen_args(p: argparse.ArgumentParser):
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("-f", "--file", help="read prompt from file")
    p.add_argument("-n", "--n-predict", type=int, default=64)
    p.add_argument("--ignore-eos", action="store_true")
    p.add_argument("--no-display-prompt", action="store_true")


def add_sampling_args(p: argparse.ArgumentParser):
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--min-p", type=float, default=0.05)
    p.add_argument("--tfs", type=float, default=1.0)
    p.add_argument("--typical", type=float, default=1.0)
    p.add_argument("--repeat-penalty", type=float, default=1.1)
    p.add_argument("--repeat-last-n", type=int, default=64)
    p.add_argument("--frequency-penalty", type=float, default=0.0)
    p.add_argument("--presence-penalty", type=float, default=0.0)
    p.add_argument("--mirostat", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--mirostat-tau", type=float, default=5.0)
    p.add_argument("--mirostat-eta", type=float, default=0.1)
    p.add_argument("--grammar", default="", help="GBNF grammar to constrain sampling")
    p.add_argument("--grammar-file", default="")
    p.add_argument("-s", "--seed", type=int, default=-1)


def add_spec_args(p: argparse.ArgumentParser):
    """PipeInfer speculation knobs (ref: common.h:54-65)."""
    p.add_argument("--draft", type=int, default=5, dest="n_draft", help="draft tree depth")
    p.add_argument("-np", "--n-parallel", type=int, default=3, help="max tree branches")
    p.add_argument("-pa", "--p-accept", type=float, default=0.3, help="draft continue threshold")
    p.add_argument("-ps", "--p-split", type=float, default=0.75, help="branch split threshold")
    p.add_argument("-pr", "--p-recovery", type=float, default=0.0, help="accept-threshold recovery rate")
    p.add_argument("-pd", "--p-decay", type=float, default=0.0, help="accept-threshold decay per rejection")
    p.add_argument("--max-inflight", type=int, default=4, help="max concurrent speculative runs")
    p.add_argument("--corr-rounds", type=int, default=SpecParams.corr_rounds,
                   help="speculative rounds per device-corrected dispatch "
                   "(controller engine; 1 = one round per dispatch)")
    p.add_argument("--no-device-verify", action="store_true",
                   help="force host verification (assume-chaining + "
                   "cancellation) even for device-expressible samplers")
    p.add_argument("--results-csv", default="", help="append run metrics (ref results.csv)")


def sampling_from_args(args) -> SamplingParams:
    return SamplingParams(
        temp=args.temp,
        top_k=args.top_k,
        top_p=args.top_p,
        min_p=args.min_p,
        tfs_z=args.tfs,
        typical_p=args.typical,
        penalty_repeat=args.repeat_penalty,
        penalty_last_n=args.repeat_last_n,
        penalty_freq=args.frequency_penalty,
        penalty_present=args.presence_penalty,
        mirostat=args.mirostat,
        mirostat_tau=args.mirostat_tau,
        mirostat_eta=args.mirostat_eta,
        seed=args.seed,
    )


def read_prompt(args) -> str:
    if getattr(args, "file", None):
        with open(args.file) as f:
            return f.read()
    return args.prompt
