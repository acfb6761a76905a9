"""`python -m pipeinfer_tpu_torch.cli.pipeline` — single model across
pipeline stages (ref: examples/mpi/mpi.cpp, the "Sequential" benchmark
baseline): generation over a layer-split pipeline with a weighted
--layer-split, driven by the host-side stage engine instead of mpirun
ranks.

Port of pipeinfer_tpu.cli.pipeline. The stages share the one device of
`--device` (cuda unless asked for the CPU), as the JAX package's stages
do when it has fewer devices than stages. Stages on several cards, and
tensor-parallel stages, are StagedInferenceContext(devices=..., tp=...)
from Python: the JAX package's CLIs expose neither."""

from __future__ import annotations

import argparse
import sys

import torch

from ..gguf.reader import GGUFReader
from ..models import load_model
from ..parallel.stages import StagedInferenceContext
from ..runtime.context import Batch
from ..sampling.samplers import SamplerState, sample
from ..tokenizer import tokenizer_from_gguf
from .args import add_gen_args, add_model_args, add_sampling_args, read_prompt, sampling_from_args


def parse_split(text: str) -> list[float] | None:
    """--layer-split's comma-separated stage weights, or None when empty."""
    return [float(x) for x in text.split(",") if x] or None


def build_staged_context(model_path: str, n_cells: int, cache_dtype: str, n_stages: int,
                         split: list[float] | None, device="cuda"):
    """(StagedInferenceContext of n_stages stages on `device`, tokenizer)
    for a GGUF model."""
    from ..utils.compile_cache import enable

    enable()  # the kernels' build directory (PIPEINFER_CACHE_DIR), as the JAX CLI's cache
    params, cfg = load_model(model_path, device=device)
    with GGUFReader(model_path) as r:
        tok = tokenizer_from_gguf(r)
    ctx = StagedInferenceContext(
        params, cfg, n_cells=n_cells, devices=[device] * n_stages, split=split,
        cache_dtype=torch.bfloat16 if cache_dtype == "bf16" else torch.float32,
    )
    return ctx, tok


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-pipeline", description=__doc__.split("\n\n")[0])
    add_model_args(p)
    add_gen_args(p)
    add_sampling_args(p)
    p.add_argument(
        "--layer-split",
        default="",
        help="comma-separated stage weights (the --mpi-layer-split fractions,"
        " e.g. 0.1,0.45,0.45); default = an even split",
    )
    p.add_argument("--stages", type=int, default=0,
                   help="number of stages (default: one per --layer-split weight, else 1)")
    args = p.parse_args(argv)

    split = parse_split(args.layer_split)
    n_stages = args.stages or 1
    if split and len(split) != n_stages:
        n_stages = len(split)
    ctx, tok = build_staged_context(args.model, args.ctx_size, args.cache_dtype, n_stages, split,
                                    device=args.device)
    print(
        f"pipeline: {n_stages} stages, layer ranges {ctx.ranges} over "
        f"{[str(d) for d in ctx.devices]}",
        file=sys.stderr,
    )

    sampler = SamplerState(params=sampling_from_args(args))
    ids = tok.encode(read_prompt(args), add_bos=True)
    for t in ids:
        sampler.accept(t, apply_grammar=False)
    if not args.no_display_prompt:
        sys.stdout.write(tok.decode(ids))
        sys.stdout.flush()

    b = Batch()
    for i, t in enumerate(ids):
        b.add(t, i, 0, want_logits=(i == len(ids) - 1))
    logits = ctx.decode(b)[-1]
    pos = len(ids)
    from ..tokenizer.stream import StreamDecoder

    sdec = StreamDecoder(tok)
    for _ in range(args.n_predict):
        t = sample(sampler, logits)
        sampler.accept(t)
        sys.stdout.write(sdec.feed(t))
        sys.stdout.flush()
        if not args.ignore_eos and t == tok.vocab.eos_id:
            break
        b.clear()
        b.add(t, pos, 0)
        logits = ctx.decode(b)[0]
        pos += 1
    sys.stdout.write("\n")
    ctx.print_timings(lambda s: print(s, file=sys.stderr))
    return 0


if __name__ == "__main__":
    sys.exit(main())
