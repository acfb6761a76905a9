#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pipeinfer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each failing the run (non-zero exit, no result line) on a miss:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the hand-written kernels in pipeinfer_tpu_torch/csrc/ (one nvcc
   per source, all started together) into build/cuda/;
3. kernel phases: every kernel of the main path against its plain PyTorch
   version on the card, at the main path's shapes, with the tolerance
   stated; its time, the plain version's, one PyTorch call's as a
   yardstick (timed here only, never used by the port) and the least time
   the card could take (bytes at 3.35 TB/s or operations at the peak rate
   of their type, whichever is larger); the split-K matmuls (i4g, i8g,
   i8, k_major, k4) called twice on the same inputs must give bitwise
   equal outputs;
4. the main path at full width: first the host runtime of the model load
   (native.py: csrc/repack.cpp built by g++ into build/native/), its
   library's path and one Q4_K repack of the 7B's w_down shape timed
   against the numpy repack, the planes bitwise equal; then the
   llama-2-7B-shaped Q4_K bench pair (random weights from a seed, built
   into build/bench/ and reused), loaded tensor by tensor (load s
   and the load's peak GiB), plain greedy decode and then
   PipeInferController in device-corrected greedy mode on the same
   prompt; the streams must be identical and every kernel's launch count
   over the controller run above 0;
5. sample, on the 2-layer live llama at 7B width (testmodel.
   build_llama_live over the 7B target, cached beside it; the engines'
   copy with its output norm scaled by SAMPLE_LOGIT_SCALE), held by
   tools/sample_check: the device sampler under the CLI's default chain
   (0.8, 40, 0.95, 0.05), 65536 draws from one logits row and from 8,
   against top_probs by a chi-square (p >= 1e-3, nothing outside the kept
   set), each of sample_check.SAMPLER_FAULTS failing it on the 8 rows;
   cli.speculative with no sampling flags (penalties on, -np 3) printing
   cli.main's text for -s 1234, and a fused stochastic controller (-np 1,
   no penalties, device_verify off) against plain sampled decoding, where
   a stream that parts must be explained by the verify rows' CDF shift
   (sample_check.part_report); then the corrected controller, the
   DeviceLoopEngine and 4 BatchedDeviceLoop lanes (and, at n = 1024, the
   fused run if it parted) at temp 0.8 against sequential target sampling
   by the randomized PIT / KS test over a teacher-forced pass of all
   runs, a token of each a step (D <= 1.95 / sqrt(n) at n = 2048, mean
   entropy >= 1 bit, i4g and
   cell attention launched), the target sampled at temp 1.0 through the
   BatchedDeviceLoop
   failing it, and tok/s and acceptance at temp 0.8 beside greedy;
6. the i8g path: the same on the toy-scale Q6_K pair, where every matmul
   goes through the i8g kernel;
7. the CLI: `cli.main` and `cli.speculative --engine controller -np 1`
   called in process on the 7B Q4_K pair (its target cut to CLI_DEPTH
   layers: six loads of it) under PIPEINFER_WEIGHT_LAYOUT=
   k_major, then i8, then k4, must print identical text, and each
   layout's kernel and the cell-attention kernel must have launched in the
   speculative run; on the toy pair under the default layout, `--engine
   sync` and the default `-np 3` print the same text as `cli.main`, and so
   does one `python -m pipeinfer_tpu_torch.cli.speculative` subprocess;
8. serve, on the 7B Q4_K pair: i4g and i8g at the batched loops' M = 4
   and 36 (wqkv, w_down) and cell attention at T = 4 with its rows on
   sequence slots 60-63 (63 is the sign bit of an int32 seq word), each
   against its plain version; then the server of
   `pipeinfer_tpu_torch.serving.server.serve(..., draft_path=...,
   device_lanes=4)` on port 0, whose loaded weights also drive
   DeviceLoopEngine (its stream == plain greedy, tok/s beside plain and
   the controller) and BatchedDeviceLoop (4 prompts, each stream == its
   own plain greedy stream); then 6 concurrent /completion requests (4
   greedy, 1 with repeat_penalty 1.1, 1 greedy joining after the first
   streamed tokens): greedy content == the text `cli.main` generates for
   the prompt, the penalty request == plain decoding under its sampler, no
   `error`, both engines served, the engine thread alive; last,
   DeviceLoopEngine on the toy Q6_K pair (every matmul through i8g, as a
   Q4_K_M file's Q6_K tensors) against plain greedy.
9. arch, on the MPT-7B pair (mosaicml/mpt-7b's widths, Q4_K with a Q6_K
   head, ALiBi; its target as deep as its 5-layer draft; built into
   build/bench/ with a 2-layer live model whose attn_output and ffn_down
   are non-zero): i4g at M = 1, 8 and 128 over each of its 4-bit
   tensors, i8g at M = 1 and 8 over its 50432-row head
   and cell attention at its heads with ALiBi over a bf16 and an f32
   cache, each against its plain version and timed; the live model
   (9-token prefill, 8 single-token steps on the cell kernel) on the card
   against the port on the CPU within tools/live_check.LIVE_RTOL, and each
   of live_check.FAULTS on the card past that bar; plain greedy, the
   corrected controller, the controller over a 2- and a 4-stage
   StagedInferenceContext and LookaheadDecoder (W 15, N 5, G 15) emit one
   stream, each launching i4g, i8g and (but lookahead) cell attention, and
   the host decode loop over 1, 2 and 4 stages is timed; cli.main,
   cli.speculative --stages 2, cli.pipeline and cli.lookahead print one
   text, and so does a `python -m
   pipeinfer_tpu_torch.cli.pipeline` subprocess; eight other
   architectures at toy width (f32 weights) on the card against the CPU.
10. tools: i4g at M = 512 over the 7B's fused wqkv, w_down and head and
   i8g at M = 512 over the toy Q6_K pair's fused gate+up and head, each
   against its plain version with the bitwise repeat and timed; on the
   full-depth 7B Q4_K target, loaded once: perplexity over two 512-token
   windows of text drawn from the synthetic vocabulary (i4g at M = 512),
   bench's pp512 and tg128, the batched_bench grid (pp 128, tg 32, pl 1,
   2, 4, 8, shared prompt), beam search with 1 beam (== plain greedy) and 4
   (sorted by score), 4 batched greedy continuations (each == plain
   greedy), one embedding (unit norm) and the session state saved and
   restored over a bf16 and an f32 cache (the restored context's 16
   greedy steps give the live one's tokens and bitwise equal logits);
   perplexity on the toy Q6_K target (i8g at M = 512); cli.main
   --prompt-cache twice (the same text, the second run skipping the cached
   prefix); shapebench --model 7b --draft 1.1b (k_major); last a 2-layer
   live llama at 7B width (non-zero attn_output and ffn_down): perplexity
   at n_ctx 128 and an embedding on the card against the CPU within
   tools/live_check's bars, and each of live_check.MASK_FAULTS past them.
11. train, on the 2-layer live llama at 7B width (finetune's dense_params
   of its i4g planes on the card, 667 M f32 parameters): lm_loss and its
   gradient at B = 2, T = 64 on the card against the CPU within
   live_check.TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL, one other f32 order
   beside it and each of live_check.TRAIN_FAULTS past the bars; finetune's
   `train`, 20 steps at B = 4, T = 128 (the loss below 0.9x step 0's,
   tokens/s, peak GiB), then checkpointed after step 9 and resumed in a
   fresh `train` (steps 10-19 within 1e-4 of the uninterrupted run's);
   train_lora at rank 8 (the loss below 0.9x); cli.main --lora on the
   live llama (i4g, cell attention) and, under k_major, --lora and the
   export_lora-merged file printing the same text; last the trained model
   quantized to Q4_K by tools.quantize, its perplexity of the corpus (i4g)
   below the untrained model's, and cli.main -c 1024 on it. The training
   runs themselves launch no kernel (torch matmuls, as the JAX package's
   training calls no Pallas kernel).
12. llava, at LLaVA-1.5-7B width: a random CLIP ViT-L/14-336 tower and
   LLaVA-1.5 projector (testmodel.build_mmproj, cached in build/bench/) on
   the card against the port on the CPU for a square and a non-square
   image within tools/live_check.CLIP_RTOL, one other f32 order beside it
   and each of live_check.CLIP_FAULTS past it, the encode timed against
   its f32 bound; on the 2-layer live llama at 7B width, decode_embd of
   tok_embd rows bitwise equal to the token path in a whole bucket and
   within live_check.PAD_SHARE of i4g's rounding in a padded one, then
   cli.llava's prompt around the image's 576 embeddings (decode_embd at
   T = 2048) and 32 greedy tokens (i4g and cell attention counted), the first generated
   position's logits against the CPU within live_check.LIVE_RTOL, the same
   image giving the same stream and another image another; `python -m
   pipeinfer_tpu_torch.cli.llava` on a PNG printing that stream; the
   server with --mmproj answering image requests with that text, a
   request naming an image not sent with 400, and serve() with --mmproj
   and --draft exiting.
13. chat, on the 7B target cut to CLI_DEPTH layers: interactive_loop's
   first turn == generate, then -i, --interactive-first, --instruct,
   --chatml, --in-prefix/--in-suffix/--in-prefix-bos and a reverse prompt
   over two scripted turns, and a small pool on which _slide_if_full must
   shift; cli.main -i --color on a scripted stdin; on a copy of the
   target with FIM ids, cli.infill with --logdir and --profile (the YAML
   and a torch.profiler trace) and cli.main --fim-prefix/--fim-suffix.
14. dcn, on the 7B target cut to DCN_DEPTH layers: the cross-process
   pipeline (parallel/dcn.py), launch_local_cluster starting two stage
   workers on the card and RemoteStagedContext holding stage 0 and the
   draft: over the f32 wire the prompt's and 8 steps' logits equal one
   process's within DCN_TOL; PipeInferController over the 3 processes
   emits plain greedy's stream, accepting drafts and canceling runs in
   flight; over the bf16 wire the logits stay within DCN_BF16_TOL, not
   bit-equal, and the controller completes; every worker exits 0 with its
   launch line showing i4g, and the head launched i4g and cell attention;
   tok/s beside one process's controller and 3-stage target, not gated.
15. multi, every mesh entry on parallel.mesh.default_devices (cuda:i %
   device_count: one card repeats cuda:0): i4g at M = 1 over the 7B's
   4-bit tensors at their tp = 2 and 4 shard widths and cell attention at
   the shard-local heads (H = KVH = 16 and 8) against their plain
   versions, timed; on the 2-layer live llama at 7B width,
   InferenceContext(mesh=tp_mesh(2 and 4 entries)) against one device
   over the prompt and 8 steps within live_check.LIVE_RTOL, the shards gathered
   backwards past it; PipeInferController over StagedInferenceContext(4
   entries, tp=2) (2 stages x 2-way TP of the target cut to DCN_DEPTH
   layers) emitting plain greedy's stream with i4g and cell attention
   launched, tok/s beside the tp = 1 two-stage target; the fused pp 2 x
   tp 2 x dp 2 step with 2 microbatches on the live llama against one
   device within MULTI_PF_RTOL; and two processes on the card over gloo
   running that step on a global_mesh, each within MULTI_MH_RTOL of the
   one-process step.
The main, serve and tools phases share one load of the full-depth 7B
pair's files, the in-process CLIs of one weight layout one load of its
target cut to CLI_DEPTH layers, and the arch phase one load of the MPT
pair (share_pair_loads); a subprocess loads its own.

The last lines printed are the card line, one JSON line with a record per
kernel, and {"ok": true, "device": {...}}. Details of every shape go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BPS = 3.35e12  # H100 SXM device memory rate (data sheet)
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}  # dense, data sheet
L2_BYTES = 50 * 2**20
SEED = 1234


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def gpu_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Device time per call: a spin kernel holds the GPU while the host
    queues `iters` calls, so CUDA events time the calls back to back
    rather than the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # ~25 ms of GPU clock, several times what the host takes to queue the
    # calls (a plain version's few hundred launches included): a run times
    # some 800 calls, which a 0.1 s spin made 80 s of waiting
    torch.cuda._sleep(50_000_000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def copies_for(n: int) -> int:
    """Copies of an operand to cycle through so each call finds it cold
    (the decode step streams every weight from device memory once)."""
    return max(1, math.ceil(2 * L2_BYTES / max(n, 1)))


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

I4G_SHAPES = {  # (N, K) of every 4-bit tensor of the 7B pair
    "wqkv": (12288, 4096), "wo": (4096, 4096), "wgu": (22016, 4096),
    "w_down": (4096, 11008), "output": (32000, 4096),
}
I8G_SHAPES = {  # (N, K) of every tensor a Q6_K or Q8_0 7B file sends to i8g, and the toy's
    **I4G_SHAPES, "toy_wo": (1024, 1024), "toy_w_down": (1024, 2816),
}
I4G_MS = (1, 8, 9, 33)  # 8: the verify bucket (draft 5 gives T = 6, padded to 8)
# the batched loops' rows: 4 lanes' draft steps, and their target pass at
# the server's --n-draft 8: 4 * (8 + 1)
SERVE_MS = (4, 36)
SERVE_SHAPES = ("wqkv", "w_down")
MATMUL_RTOL = 1e-4  # of max|plain|: exact integer dots, f32 order of the scaled sums
ATTN_ATOL = 1e-4  # f32 online vs one-pass softmax, summation order


def _rand_i4g(n, k, dev, g):
    import torch

    kp = -(-k // 256) * 256
    qs = torch.randint(0, 256, (kp // 2, n), dtype=torch.uint8, device=dev, generator=g)
    step = torch.rand(kp // 128, n, device=dev, generator=g) * 0.01 + 1e-3
    wmin = -torch.rand(kp // 128, n, device=dev, generator=g) * 0.08
    return qs, step, wmin


def _split_planes(layout: str, n: int, k: int, dev, g, copies: int = 1) -> list:
    """`copies` random weight planes of an i4g or i8g tensor [N, K]."""
    import torch

    if layout == "i4g":
        return [_rand_i4g(n, k, dev, g) for _ in range(copies)]
    kp = -(-k // 512) * 512
    return [(torch.randint(-127, 128, (kp, n), dtype=torch.int8, device=dev, generator=g),
             torch.rand(kp // 512, n, device=dev, generator=g) * 1e-3 + 1e-4)
            for _ in range(copies)]


def _split_inputs(layout: str, x, planes):
    """(kernel, plain version, its argument tuples, one per plane, counter
    name, int8 operations) of one i4g or i8g call on x, as qmatmul makes
    them."""
    import torch

    from pipeinfer_tpu_torch.ops import qmatmul as Q

    m, n = x.shape[0], planes[0][0].shape[1]
    if layout == "i4g":
        kp = planes[0][0].shape[0] * 2
        xq, sx = Q.quantize_activations(x, kp, Q.I4G_HALF)
        xsum = xq.reshape(m, kp // 128, 128).sum(dim=2, dtype=torch.int32).float()
        return (Q.i4g_matmul, Q._i4g_plain, [(xq, xsum, sx, *p) for p in planes], "i4g_matmul",
                2 * m * n * kp)
    kp = planes[0][0].shape[0]
    xq, sx = Q.quantize_activations(x, kp, Q.I8G_SLAB)
    return Q.i8g_matmul, Q._i8g_plain, [(xq, sx, *p) for p in planes], "i8g_matmul", 2 * m * n * kp


def _split_qt(layout: str, planes: tuple, n: int, k: int):
    """The QuantTensor [N, K] of one set of i4g or i8g planes (for the
    dequantized yardstick)."""
    from pipeinfer_tpu_torch.ops import qmatmul as Q

    if layout == "i4g":
        qs, step, wmin = planes
        return Q.QuantTensor(qs, None, step, wmin, qtype=None, shape=(n, k), layout="i4g")
    return Q.QuantTensor(planes[0], None, planes[1], planes[1][:0], qtype=None, shape=(n, k),
                         layout="i8g")


def _check_repeat(kern, plain, args, label: str, kw=None) -> tuple[float, float]:
    """Two kernel calls on the same inputs bitwise equal, and within
    MATMUL_RTOL of max|plain| of the plain version. Returns (max error,
    max|plain|)."""
    import torch

    kw = kw or {}
    got = kern(*args, **kw)
    again = kern(*args, **kw)
    want = plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two calls on the same inputs differ by up to "
                             f"{(got - again).abs().max().item()}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not err <= MATMUL_RTOL * scale:
        raise AssertionError(f"{label}: max err {err} > {MATMUL_RTOL} * {scale}")
    return err, scale


def _cut(kern) -> dict | None:
    """The cut of the wrapper's last launch, for the log (None for a tree
    from before the wrapper kept it, so the script can time the older
    kernel)."""
    plan = getattr(kern, "last_plan", None)
    return None if plan is None else plan._asdict()


def phase_qmatmul(records: dict, details: list):
    import torch

    from pipeinfer_tpu_torch.ops import qmatmul as Q

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rep = {}
    for layout, shapes in (("i4g", I4G_SHAPES), ("i8g", I8G_SHAPES)):
        worst = 0.0
        for name, (n, k) in shapes.items():
            planes = _split_planes(layout, n, k, dev, g, copies_for(
                n * k // 2 if layout == "i4g" else -(-k // 512) * 512 * n))
            # [K, N], for the yardstick only
            w_bf16 = Q.dequant_T(_split_qt(layout, planes[0], n, k), torch.bfloat16)
            for m in I4G_MS:
                x = torch.randn(m, k, device=dev, generator=g)
                kern, plain, ins, name_k, ops = _split_inputs(layout, x, planes)
                err, scale = _check_repeat(kern, plain, ins[0], f"{name_k} {name} M={m}")
                cut = _cut(kern)
                worst = max(worst, err)
                it = iter(range(1 << 30))
                k_ms = gpu_ms(lambda: kern(*ins[next(it) % len(ins)]), iters=20)
                p_ms = gpu_ms(lambda: plain(*ins[0]), iters=3, warmup=1)
                xb = x.to(torch.bfloat16)
                lib_ms = gpu_ms(lambda: xb @ w_bf16, iters=20)
                b_ms, b_by = bound(nbytes(*ins[0]) + m * n * 4, ops, "int8")
                row = dict(kernel=name_k, tensor=name, N=n, K=k, M=m, max_abs_err=err,
                           tol=MATMUL_RTOL * scale, ms=k_ms, plain_ms=p_ms, yardstick_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by, plan=cut)
                details.append(row)
                log(f"{name_k:11s} {name:7s} [{n}x{k}] M={m:2d}: err {err:.3g} "
                    f"(tol {MATMUL_RTOL * scale:.3g})  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
                    f"  bf16 GEMM {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
                    + ("" if cut is None else f"  [{cut['splits']} splits of "
                       + (f"{cut['slabs']} slabs" if layout == "i4g" else f"{cut['chunks']} chunks")
                       + f", {cut['blocks']} blocks, row tile {cut['rows']}]"))
                if name == "w_down" and m == 1:
                    rep[name_k] = row
            del planes, w_bf16
        rep[("i4g_matmul" if layout == "i4g" else "i8g_matmul")]["max_abs_err"] = worst
    for name_k, src, tpu in (
        ("i4g_matmul", "pipeinfer_tpu_torch/csrc/qmatmul_i4g.cu",
         "pipeinfer_tpu/ops/qmatmul.py:784"),
        ("i8g_matmul", "pipeinfer_tpu_torch/csrc/qmatmul_i8g.cu",
         "pipeinfer_tpu/ops/qmatmul.py:923"),
    ):
        r = rep[name_k]
        records[name_k] = dict(
            name=name_k, route="cuda", source=src, replaces=tpu, launches=0,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            # no PyTorch call computes this function (s8 activations, 4/8-bit
            # weights with per-slab scales); a dense bf16 GEMM on the
            # dequantized weight is reported apart as a yardstick
            library_ms=None, yardstick_ms=r["yardstick_ms"],
            yardstick="torch.matmul bf16 on the dequantized weight",
            shape=f"M=1 N={r['N']} K={r['K']} (w_down)")


EXACT_FORMATS = {  # formats timed at every 7B shape; the rest at EXTRA_SHAPE
    "k_major": ("Q4_K", "Q6_K", "Q8_0"), "i8": ("Q4_K", "Q6_K", "Q8_0"), "k4": ("Q4_K", "Q4_0"),
}
EXTRA_FORMATS = ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K", "Q5_K")  # k_major only
EXTRA_SHAPE = {"wo": (4096, 4096)}
EXACT_RECORDS = {  # kernel -> (layout, format of its record, source, TPU kernel)
    "kmajor_matmul": ("k_major", "Q4_K", "pipeinfer_tpu_torch/csrc/qmatmul_kmajor.cu",
                      "pipeinfer_tpu/ops/qmatmul.py:544"),
    "i8_matmul": ("i8", "Q4_K", "pipeinfer_tpu_torch/csrc/qmatmul_i8.cu",
                  "pipeinfer_tpu/ops/qmatmul.py:661"),
    "k4_matmul": ("k4", "Q4_K", "pipeinfer_tpu_torch/csrc/qmatmul_k4.cu",
                  "pipeinfer_tpu/ops/qmatmul.py:682"),
}


def _rand_exact(layout: str, qname: str, n: int, k: int, dev, g):
    """A random QuantTensor of an exact layout on the card: random bytes are
    valid quants of every format, scales and biases random and positive
    (Q8_0: no bias)."""
    import torch

    from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
    from pipeinfer_tpu_torch.ops import qmatmul as Q
    from pipeinfer_tpu_torch.quant.pack import FORMAT_INFO

    qtype = GGMLQuantType[qname]
    bits, grp = FORMAT_INFO[qtype]

    def u8(rows):
        return torch.randint(0, 256, (rows, n), dtype=torch.uint8, device=dev, generator=g)

    def f32(rows, scale):
        return torch.rand(rows, n, device=dev, generator=g) * scale + scale / 10

    if layout == "k4":
        r2 = -(-k // 2 // 256) * 256
        qs = u8(r2)
        qs[k // 2:] = 0
        planes = [f32(r2 // 32, 0.01), f32(r2 // 32, 0.01), f32(r2 // 32, 0.08),
                  f32(r2 // 32, 0.08)]
        for p in planes:
            p[k // 64:] = 0
        return Q.QuantTensor(qs, None, planes[0], planes[2], qtype, (n, k), "k4",
                             planes[1], planes[3])
    scales = f32(k // grp, 0.01)
    bias = torch.zeros_like(scales) if qtype == GGMLQuantType.Q8_0 else f32(k // grp, 0.08)
    if layout == "i8":
        lo, hi = (-127, 128) if bits == 8 else (0, 1 << bits)
        qs = torch.randint(lo, hi, (k, n), dtype=torch.int8, device=dev, generator=g)
        return Q.QuantTensor(qs, None, scales, bias, qtype, (n, k), "i8")
    if bits == 8:
        qs = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=dev, generator=g)
    else:
        qs = u8(k // Q._QS_ROWS[bits])
    qh = u8(k // Q._QH_DIV[bits]) if bits in Q._QH_DIV else None
    return Q.QuantTensor(qs, qh, scales, bias, qtype, (n, k), "k_major")


def _exact_inputs(layout: str, x, qt):
    """(kernel, plain version, its arguments) for one call of an exact
    layout's kernel on x, as qmatmul would make them."""
    import torch

    from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
    from pipeinfer_tpu_torch.ops import qmatmul as Q

    xb = x.to(torch.bfloat16)
    if layout == "k_major":
        bias = None if qt.qtype == GGMLQuantType.Q8_0 else qt.bias
        return (Q.kmajor_matmul, lambda *a: Q._kmajor_plain(*a, qt.bits, qt.group),
                (xb, qt.qs, qt.qh, qt.scales, bias), dict(bits=qt.bits, group=qt.group))
    if layout == "i8":
        has_bias = qt.qtype != GGMLQuantType.Q8_0
        xg = Q._group_sums(x, qt.group) if has_bias else None
        return (Q.i8_matmul, lambda *a: Q._i8_plain(*a, qt.group),
                (xb, xg, qt.qs, qt.scales, qt.bias if has_bias else None), dict(group=qt.group))
    return (Q.k4_matmul, Q._k4_plain,
            (xb, Q._group_sums(x, 32), qt.qs, qt.scales, qt.scales2, qt.bias, qt.bias2), {})


def phase_exact(records: dict, details: list):
    """The k_major, i8 and k4 kernels against their plain versions at the
    7B shapes (and k_major's other formats at one shape), at M = 1, 8 (the
    verify bucket), 9 and 33, with two calls on the same inputs bitwise
    equal (their split-K merges in split order)."""
    import torch

    from pipeinfer_tpu_torch.ops import qmatmul as Q

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst: dict = {}
    rep: dict = {}
    plan = [(layout, q, I4G_SHAPES) for layout, qs in EXACT_FORMATS.items() for q in qs] \
        + [("k_major", q, EXTRA_SHAPE) for q in EXTRA_FORMATS]
    for layout, qname, shapes in plan:
        for name, (n, k) in shapes.items():
            one = _rand_exact(layout, qname, n, k, dev, g)
            qts = [one] + [_rand_exact(layout, qname, n, k, dev, g)
                           for _ in range(copies_for(one.nbytes()) - 1)]
            w_bf16 = Q.dequant_T(one, torch.bfloat16)  # [K, N], for the yardstick only
            for m in I4G_MS:
                x = torch.randn(m, k, device=dev, generator=g)
                calls = [_exact_inputs(layout, x, qt) for qt in qts]
                kern, plain, args, kw = calls[0]
                err, scale = _check_repeat(kern, plain, args,
                                           f"{kern.__name__} {qname} {name} M={m}", kw)
                cut = _cut(kern)
                key = kern.__name__
                worst[key] = max(worst.get(key, 0.0), err)
                it = iter(range(1 << 30))

                def timed():
                    _, _, a, kwa = calls[next(it) % len(calls)]
                    kern(*a, **kwa)

                k_ms = gpu_ms(timed, iters=20)
                p_ms = gpu_ms(lambda: plain(*args), iters=3, warmup=1)
                xb = x.to(torch.bfloat16)
                lib_ms = gpu_ms(lambda: xb @ w_bf16, iters=20)
                moved = [a for a in args if a is not None]
                if layout == "k4":  # K/2 byte rows and K/64 scale rows; the padding is never read
                    moved = [*moved[:2], moved[2][:k // 2], *(p[:k // 64] for p in moved[3:])]
                b_ms, b_by = bound(nbytes(*moved) + m * n * 4, 2 * m * n * k, "bf16")
                row = dict(kernel=key, layout=layout, qtype=qname, tensor=name, N=n, K=k, M=m,
                           max_abs_err=err, tol=MATMUL_RTOL * scale, ms=k_ms, plain_ms=p_ms,
                           yardstick_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, plan=cut)
                details.append(row)
                log(f"{key:13s} {qname:4s} {name:7s} [{n}x{k}] M={m:2d}: err {err:.3g} "
                    f"(tol {MATMUL_RTOL * scale:.3g})  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
                    f"  bf16 GEMM {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
                    + ("" if cut is None else f"  [{cut['splits']} splits of {cut['chunks']} "
                       f"chunks, {cut['blocks']} blocks, row tile {cut['rows']}]"))
                if name == "w_down" and m == 1 and qname == EXACT_RECORDS[key][1]:
                    rep[key] = row
            del qts, one, w_bf16, calls
    for key, (layout, qname, src, tpu) in EXACT_RECORDS.items():
        r = rep[key]
        records[key] = dict(
            name=key, route="cuda", source=src, replaces=tpu, launches=0,
            max_abs_err=worst[key], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            # no PyTorch call takes these packed planes; a dense bf16 GEMM on
            # the dequantized weight (the same output) is reported apart
            library_ms=None, yardstick_ms=r["yardstick_ms"],
            yardstick="torch.matmul bf16 on the dequantized weight",
            shape=f"M=1 N={r['N']} K={r['K']} (w_down, {qname})")
        if r["plan"] is not None:
            records[key]["plan"] = {f: r["plan"][f] for f in ("splits", "chunks", "blocks")}


ATTN_TIMED = [  # (H, KVH, D, C, hot, T) timed against the plain version and SDPA
    # the 7B pair's heads at a 4096-cell pool (the record's shape: T = 1, hot = 0)
    *[(32, 32, 128, 4096, hot, t) for hot in (0, 2048) for t in (1, 4, 33)],
    # the 1024-cell pools of run_pair and the CLI runs, with their hot marks
    *[(32, 32, 128, 1024, hot, t) for hot in (0, 512) for t in (1, 4)],
    # the toy pair's heads (GQA, G = 2)
    *[(16, 8, 64, 1024, 0, t) for t in (1, 4)],
]
ATTN_CHECKED = [(32, 32, 128, 1024, 0, 4)]  # correctness only: ALiBi, seq ids 0 and 40


def _attn_cache(kvh, d, c, dev, g):
    """bf16 K and V [L, KVH, C, D], made one layer at a time, with enough
    layers L that cycling them finds each one cold in L2 even at hot = C/2."""
    import torch

    n_l = max(4, copies_for(2 * kvh * (c // 2) * d * 2))
    kv = torch.empty(2, n_l, kvh, c, d, dtype=torch.bfloat16, device=dev)
    for i in range(2):
        for layer in range(n_l):
            kv[i, layer] = torch.randn(kvh, c, d, device=dev, generator=g)
    return kv[0], kv[1]


def attend_head_width_100(dev, g) -> dict:
    """`attend` on the card for a head width the cell kernel does not take
    (D = 100, OpenLLaMA-3B's heads) at a 512-cell pool: it must take the
    dense path, without launching the kernel, and match that path on the
    CPU."""
    import torch

    from pipeinfer_tpu_torch.ops import cell_attention as CA
    from pipeinfer_tpu_torch.runtime import kv_cache as KV

    t, h, d, c, used = 1, 32, 100, 512, 300
    cache = KV.create(2, c, h, d, device=dev)
    cache.k.copy_(torch.randn(cache.k.shape, device=dev, generator=g))
    cache.v.copy_(torch.randn(cache.v.shape, device=dev, generator=g))
    cache.pos[:used] = torch.arange(used, dtype=torch.int32, device=dev)
    cache.seq[:used, 0] = 1
    q = torch.randn(t, h, d, device=dev, generator=g)
    tok_pos = torch.full((t,), used, dtype=torch.int32, device=dev)
    tok_seq = torch.zeros(t, dtype=torch.int32, device=dev)
    valid = torch.ones(t, dtype=torch.bool, device=dev)
    if KV.use_cell_kernel(t, h, h, d, c, 0, True):
        raise AssertionError("attend would send D = 100 to the cell kernel")
    before = CA.cell_attention.launches
    got = KV.attend(q, cache, 1, KV.attn_mask(cache, tok_pos, tok_seq), tok_pos, tok_seq, valid,
                    scale=d ** -0.5)
    torch.cuda.synchronize()
    if CA.cell_attention.launches != before:
        raise AssertionError("attend launched the cell kernel for D = 100")
    cpu = KV.KVCache(cache.k.cpu(), cache.v.cpu(), cache.pos.cpu(), cache.seq.cpu())
    want = KV.attend(q.cpu(), cpu, 1, KV.attn_mask(cpu, tok_pos.cpu(), tok_seq.cpu()),
                     tok_pos.cpu(), tok_seq.cpu(), valid.cpu(), scale=d ** -0.5)
    err = (got.cpu() - want).abs().max().item()
    if not (got.shape == (t, h, d) and err <= ATTN_ATOL):
        raise AssertionError(f"attend D = 100: shape {tuple(got.shape)}, max err {err}")
    log(f"attend D=100 H=32 C=512 on the card: dense path, err {err:.3g} against the CPU "
        f"(tol {ATTN_ATOL})")
    return dict(kernel="attend_dense", T=t, H=h, D=d, C=c, max_abs_err=err, tol=ATTN_ATOL)


def phase_attention(records: dict, details: list):
    import torch
    import torch.nn.functional as F

    from pipeinfer_tpu_torch.ops import cell_attention as CA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    w = 2
    rep = None
    worst = 0.0
    cache_key = kc = vc = None
    for (h, kvh, d, c, hot, t), timed in [(s, True) for s in ATTN_TIMED] + \
            [(s, False) for s in ATTN_CHECKED]:
        if (kvh, d, c) != cache_key:
            kc = vc = None
            torch.cuda.empty_cache()
            kc, vc = _attn_cache(kvh, d, c, dev, g)
            cache_key = (kvh, d, c)
        n_l = kc.shape[0]
        used = hot or c
        pos = torch.full((c,), -1, dtype=torch.int32, device=dev)
        pos[:used] = torch.arange(used, dtype=torch.int32, device=dev)
        seq = torch.zeros(c, w, dtype=torch.int32, device=dev)
        seq[:used, 0] = 1 | (torch.randint(0, 2, (used,), device=dev, generator=g) << 1).int()
        q = torch.randn(t, h, d, device=dev, generator=g)
        tok_pos = torch.randint(used // 2, used, (t,), device=dev, generator=g).int()
        tok_seq = torch.randint(0, 2, (t,), device=dev, generator=g).int()
        alibi = None
        if not timed:  # seq id 40 (bit 8 of word 1) on every other cell, ALiBi on
            seq[:used:2, 1] = 1 << 8
            tok_seq[::2] = 40
            alibi = torch.linspace(0.01, 0.5, h, device=dev)
        valid = torch.ones(t, dtype=torch.bool, device=dev)
        if t > 1:
            valid[-1] = False
        args = (q, kc, vc, pos, seq, tok_pos, tok_seq, valid)
        kw = dict(scale=d ** -0.5, hot=hot, alibi=alibi)
        got = CA.cell_attention(*args, layer=1, **kw)
        want = CA._cell_attention_plain(q, kc, vc, pos, seq, tok_pos, tok_seq, valid, 1,
                                        d ** -0.5, alibi, used)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        cut = CA.plan(t, h, kvh, d, used)
        shape = f"T={t:2d} H={h} KVH={kvh} D={d} C={c} hot={hot:4d}"
        if not err <= ATTN_ATOL:
            raise AssertionError(f"cell_attention {shape}: max err {err}")
        worst = max(worst, err)
        cut_s = (f"{cut.n_splits} splits of {cut.split} cells, {cut.row_tiles} row tiles of "
                 f"{cut.rows}, grid {cut.blocks} blocks")
        if not timed:
            details.append(dict(kernel="cell_attention", T=t, C=c, hot=hot, H=h, KVH=kvh, D=d,
                                alibi=True, max_abs_err=err, tol=ATTN_ATOL, n_splits=cut.n_splits,
                                split=cut.split, blocks=cut.blocks))
            log(f"cell_attention {shape} ALiBi, seq ids 0/40: err {err:.3g} (tol {ATTN_ATOL})"
                f"  [{cut_s}]")
            continue
        it = iter(range(1 << 30))
        k_ms = gpu_ms(lambda: CA.cell_attention(*args, layer=next(it) % n_l, **kw))
        p_ms = gpu_ms(lambda: CA._cell_attention_plain(
            q, kc, vc, pos, seq, tok_pos, tok_seq, valid, 1, d ** -0.5, None, used),
            iters=3, warmup=1)
        # library call: SDPA over the same layers (cycled like the kernel's)
        # with the visibility as an additive mask built outside the timed call
        mask = torch.where(
            ((seq[:used].long()[:, (tok_seq // 32).long()] >> (tok_seq % 32).long()[None])
             & 1).T.bool() & (pos[None, :used] <= tok_pos[:, None]) & (pos[None, :used] >= 0)
            & valid[:, None], 0.0, -1e9).to(torch.bfloat16)
        qb = q.to(torch.bfloat16).transpose(0, 1)[None]  # [1, H, T, D]
        kv = [(kc[i, :, :used][None], vc[i, :, :used][None]) for i in range(n_l)]
        it2 = iter(range(1 << 30))

        def sdpa():
            kl, vl = kv[next(it2) % n_l]
            return F.scaled_dot_product_attention(qb, kl, vl, attn_mask=mask,
                                                  enable_gqa=kvh != h)

        lib_ms = gpu_ms(sdpa)
        io = 2 * kvh * used * d * 2 + nbytes(q, tok_pos, tok_seq, valid) + used * 4 * (1 + w) \
            + t * h * d * 4
        b_ms, b_by = bound(io, 4 * t * h * used * d, "f32")
        row = dict(kernel="cell_attention", T=t, C=c, hot=hot, H=h, KVH=kvh, D=d,
                   max_abs_err=err, tol=ATTN_ATOL, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, n_splits=cut.n_splits, split=cut.split,
                   row_tiles=cut.row_tiles, blocks=cut.blocks)
        details.append(row)
        log(f"cell_attention {shape}: err {err:.3g} (tol {ATTN_ATOL})  kernel {k_ms:.4f} ms"
            f"  plain {p_ms:.4f} ms  SDPA {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
            f"  [{cut_s}]")
        if (h, c, t, hot) == (32, 4096, 1, 0):
            rep = row
    del kc, vc
    details.append(attend_head_width_100(dev, g))
    records["cell_attention"] = dict(
        name="cell_attention", route="cuda", source="pipeinfer_tpu_torch/csrc/cell_attention.cu",
        replaces="pipeinfer_tpu/ops/cell_attention.py:27", launches=0, max_abs_err=worst,
        ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
        bound_by=rep["bound_by"], library_ms=rep["library_ms"],
        library="F.scaled_dot_product_attention bf16 with an additive mask",
        shape=f"T=1 H=KVH=32 D=128 C=4096 (whole pool), {rep['n_splits']} splits")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def run_pair(label: str, scale: str, qtype_name: str, eps: float, n_predict: int,
             counters: dict) -> dict:
    import numpy as np
    import torch

    from pipeinfer_tpu_torch import native
    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
    from pipeinfer_tpu_torch.spec.controller import PipeInferController
    from pipeinfer_tpu_torch.spec.params import SpecParams
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair

    t_path, d_path = cached_bench_pair(ROOT / "build" / "bench", scale, qtype_name, eps, log=log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tparams, tcfg = load_model(t_path)
    dparams, dcfg = load_model(d_path)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{label}] loaded {tcfg.n_layers}L target + {dcfg.n_layers}L draft "
        f"(n_embd {tcfg.n_embd}, n_ff {tcfg.n_ff}, vocab {tcfg.n_vocab}) in {t_load:.1f} s, "
        f"peak {load_peak:.2f} GiB, repacked by {native.get_lib()._name}")

    rng = np.random.default_rng(SEED)
    prompt = [1] + rng.integers(3, tcfg.n_vocab, 31).tolist()
    n_cells = 1024  # >= 512 and a multiple of it: draft steps take the flash kernel
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    sp = SpecParams(n_draft=8, n_parallel=1, p_accept=0.1, p_split=0.9, max_inflight=4)

    def plain(n):
        return _greedy(InferenceContext(tparams, tcfg, n_cells=n_cells), prompt, n)

    def controller(n):
        c = PipeInferController(InferenceContext(tparams, tcfg, n_cells=n_cells),
                                InferenceContext(dparams, dcfg, n_cells=n_cells),
                                greedy, sp, eos_id=-1)
        t1 = time.perf_counter()
        out = c.generate(list(prompt), n, ignore_eos=True)
        return c, out, time.perf_counter() - t1

    plain(8)  # warm-up: kernel libraries, cuBLAS and allocator state
    controller(16)
    want, t_plain = plain(n_predict)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    c, got, t_ctrl = controller(n_predict)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    if got != want:
        first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"[{label}] controller stream differs from plain greedy at token "
                             f"{first}: {got[first:first + 8]} vs {want[first:first + 8]}")
    st, m = c.stats, c.metrics
    res = dict(label=label, scale=scale, qtype=qtype_name, eps=eps, n_predict=n_predict,
               prompt_len=len(prompt), n_cells=n_cells, load_s=t_load, load_peak_gib=load_peak,
               plain_tok_s=(n_predict - 1) / t_plain,
               controller_tok_s=n_predict / t_ctrl, controller_s=t_ctrl,
               mode="corrected" if c.use_corrected else ("fused" if c.use_fused else "host"),
               acceptance=st.n_accept / max(st.n_drafted, 1), n_drafted=st.n_drafted,
               n_accept=st.n_accept, runs=m.n_runs, canceled=m.n_canceled_runs,
               depths=c.depth_counts, launches=launches,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[{label}] streams identical over {n_predict} tokens; plain greedy "
        f"{res['plain_tok_s']:.1f} tok/s, controller ({res['mode']}) "
        f"{res['controller_tok_s']:.1f} tok/s, acceptance {res['acceptance']:.3f} "
        f"({st.n_accept}/{st.n_drafted}), runs {m.n_runs}, depths {c.depth_counts}")
    log(f"[{label}] launches over the controller run: {launches}")
    del tparams, dparams, c
    gc.collect()
    torch.cuda.empty_cache()
    return res


NATIVE_SHAPE = (4096, 11008)  # the 7B's w_down [N, K], Q4_K
NATIVE_ORDER = ("numpy", "auto", "auto", "numpy")  # timed in turns; the median of each kept


def run_native_repack() -> dict:
    """The host half of the model load: the native runtime (native.py,
    built by g++ into build/native/ at first use) against the numpy
    repack on one Q4_K payload of the 7B's w_down shape (random nibbles and
    6-bit scales, finite f16 super-block scales, from SEED), each timed on
    this machine's host; the planes must be bitwise equal."""
    import numpy as np

    from pipeinfer_tpu_torch import native
    from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
    from pipeinfer_tpu_torch.quant import pack

    t0 = time.perf_counter()
    lib = native.get_lib()
    lib_s = time.perf_counter() - t0
    n, k = NATIVE_SHAPE
    rng = np.random.default_rng(SEED)
    raw = rng.integers(0, 256, (n, k // 256, 144), dtype=np.uint8)
    d = (np.abs(rng.standard_normal((n, k // 256, 2))) * 0.01).astype(np.float16)
    raw[..., :4] = d.view(np.uint8)
    raw = raw.reshape(-1)
    times: dict = {}
    planes: dict = {}
    for backend in NATIVE_ORDER:
        t0 = time.perf_counter()
        planes[backend] = pack.pack(raw, GGMLQuantType.Q4_K, (n, k), backend=backend)
        times.setdefault(backend, []).append(time.perf_counter() - t0)
    for f in ("qs", "scales", "bias"):
        a, b = getattr(planes["auto"], f), getattr(planes["numpy"], f)
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"[main] native repack's {f} plane differs from numpy's")
    med = {b: float(np.median(t)) for b, t in times.items()}
    log(f"[main] native runtime {lib._name} (ready in {lib_s:.2f} s); Q4_K repack of "
        f"[{n}x{k}] on the host: numpy {med['numpy']:.4f} s, native {med['auto']:.4f} s "
        f"({med['numpy'] / med['auto']:.1f}x), planes bitwise equal")
    return dict(label="native_repack", lib=lib._name, lib_s=lib_s, shape=[n, k], qtype="Q4_K",
                numpy_s=times["numpy"], native_s=times["auto"], numpy_median_s=med["numpy"],
                native_median_s=med["auto"], host_cpus=os.cpu_count())


# ---------------------------------------------------------------------------
# sample: the sampled main path (tools/sample_check)
# ---------------------------------------------------------------------------

SAMPLE_DRAWS = 65536  # draws of each device-sampler check
SAMPLE_ROWS = 8  # logits rows of the many-row check (spec_round samples many rows at once)
# the checks' model: the live llama with its output norm scaled, which
# scales its logits (std about 0.5 -> 1.5, the margin token of the head
# from about 2.8 to 8.5): at the plain live llama's nearly flat top 40 the
# temperature moves the chain's distribution too little for a KS test at
# n = 2048 to see the temp-1.0 fault, and the top-p gate cuts too few
# tokens for the window and gate faults to show
SAMPLE_LOGIT_SCALE = 3.0
SAMPLE_N = 256  # tokens per engine run
SAMPLE_DEPTH = 2  # drafted tokens a round: its verify pass decodes 3 rows
SAMPLE_SEEDS = 8  # runs per engine: 8 x 256 = 2048 tokens (BatchedDeviceLoop: 2 x 4 lanes)
SAMPLE_SIDE_SEEDS = 4  # runs of the fused path, held by the PIT test where it parts: 1024
SAMPLE_EXACT_N = 128  # tokens of the fused run held to plain sampled decoding
SAMPLE_LANES = 4
SAMPLE_N_CELLS = 1024  # >= 512: the draft steps take the cell kernel (the 4 lanes: 2048)
SAMPLE_CLI_N = 64  # tokens of the default-flag CLI calls


def _sample_sampler(rows) -> dict:
    """(a) The device sampler alone on the card: SAMPLE_DRAWS draws from
    one logits row and from SAMPLE_ROWS rows, each against top_probs by
    the chi-square; each of sample_check.SAMPLER_FAULTS must fail it."""
    from pipeinfer_tpu_torch.runtime.context import _device_draft_sample
    from pipeinfer_tpu_torch.tools import sample_check as SC

    res, failed = {}, []
    samplers = {"device": _device_draft_sample,
                **{f: SC.sampler_fault(f) for f in SC.SAMPLER_FAULTS}}
    t0 = time.perf_counter()
    for name, fn in samplers.items():
        for label, r in (("one_row", rows[-1:]), (f"{rows.shape[0]}_rows", rows)):
            out = SC.sampler_check(fn, r, SAMPLE_DRAWS, SC.CHAIN, seed=SEED)
            res[f"{name}/{label}"] = out
            out["passes"] = out["p"] >= SC.CHI2_MIN_P and out["outside"] == 0
            # every fault must fail the many-row check; on one row a fault
            # that leaves that row's kept set and weights alone cannot show
            if (name == "device" and not out["passes"]) or (
                    name != "device" and label != "one_row" and out["passes"]):
                failed.append(f"{name} on {label}: p {out['p']:.3g}, outside {out['outside']}")
    took = time.perf_counter() - t0
    ids, probs = SC.exact(rows[-1].float().cpu().numpy(), SC.CHAIN)
    log(f"[sample] device sampler, {SAMPLE_DRAWS} draws under {SC.CHAIN} at V = "
        f"{rows.shape[1]} (the row keeps {len(ids)} tokens, {SC.entropy_bits(probs):.3f} bits): "
        + "; ".join(f"{k} chi2 {v['stat']:.1f} dof {v['dof']} p {v['p']:.3g} outside "
                    f"{v['outside']}" for k, v in res.items()) + f" ({took:.1f} s)")
    return dict(label="sample_sampler", draws=SAMPLE_DRAWS, chain=SC.CHAIN, checks=res,
                failed=failed, seconds=took)


def _sample_engines(counters: dict, params, cfg, prompts: list, records: dict,
                    with_fused: bool) -> tuple:
    """(b) The device-sampled engines at temp 0.8 against sequential
    target sampling by the PIT/KS test, and with_fused the host-verified
    fused run; the temp-1.0 fault through the BatchedDeviceLoop; tok/s and
    acceptance beside greedy."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
    from pipeinfer_tpu_torch.spec.controller import PipeInferController
    from pipeinfer_tpu_torch.spec.device_loop import DeviceLoopEngine
    from pipeinfer_tpu_torch.spec.device_multi import BatchedDeviceLoop
    from pipeinfer_tpu_torch.spec.params import SpecParams
    from pipeinfer_tpu_torch.tools import sample_check as SC

    def ctx(n_cells=SAMPLE_N_CELLS):
        return InferenceContext(params, cfg, n_cells=n_cells)

    sp = SpecParams(n_draft=SAMPLE_DEPTH, n_parallel=1, p_accept=0.0, max_inflight=4)

    def controller(sampling, n, **kw):
        c = PipeInferController(ctx(), ctx(), sampling, dataclasses.replace(sp, **kw), eos_id=-1)
        if c.use_corrected == bool(kw):
            raise AssertionError(f"[sample] the controller took the wrong path ({kw})")
        return [(prompts[0], c.generate(list(prompts[0]), n, ignore_eos=True))], c.stats

    def device_loop(sampling, n):
        e = DeviceLoopEngine(ctx(), ctx(), sampling, sp, eos_id=-1, rounds=4)
        return [(prompts[0], e.generate(list(prompts[0]), n, ignore_eos=True))], e.stats

    def batched(sampling, n):
        e = BatchedDeviceLoop(ctx(2 * SAMPLE_N_CELLS), ctx(2 * SAMPLE_N_CELLS), sampling, sp,
                              n_streams=SAMPLE_LANES, eos_id=-1, rounds=4)
        outs = e.generate_many(prompts[:SAMPLE_LANES], n, ignore_eos=True)
        return list(zip(prompts, outs)), types.SimpleNamespace(
            n_accept=sum(s.stats.n_accept for s in e.streams),
            n_drafted=sum(s.stats.n_drafted for s in e.streams))

    engines = {"corrected": (controller, SAMPLE_SEEDS),
               "device_loop": (device_loop, SAMPLE_SEEDS),
               "batched": (batched, SAMPLE_SEEDS // SAMPLE_LANES)}
    if with_fused:  # two runs in flight at most: fewer canceled chains to pay for
        engines["fused"] = (lambda s, n: controller(s, n, device_verify=False, max_inflight=2),
                            SAMPLE_SIDE_SEEDS)
    controller(SC.chain_params(seed=0), 16)  # warm-up: allocator and library state

    def pit_runs(fn, n_seeds, fault=False):
        runs, lanes, took, acc, dr = [], [], 0.0, 0, 0
        launches = dict.fromkeys(counters, 0)  # the engine's runs only, not the teacher pass
        for seed in range(n_seeds):
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            with SC.target_temp_fault() if fault else contextlib.nullcontext():
                got, st = fn(SC.chain_params(seed=SEED + seed), SAMPLE_N)
            torch.cuda.synchronize()
            took += time.perf_counter() - t0
            for k, c in counters.items():
                launches[k] += c.launches
            acc, dr = acc + st.n_accept, dr + st.n_drafted
            runs += got
            lanes += range(len(got))
        # every run teacher-forced at once, one token of each a step: a
        # step's rows round as the engines' verify passes of a few rows do
        rows = SC.teacher_rows(ctx(sum(len(p) + len(s) for p, s in runs) + 64), runs, step=1,
                               topk=128)
        rng, lane_pits = np.random.default_rng(SEED), {}
        for lane, (_, stream), r in zip(lanes, runs, rows):
            lane_pits.setdefault(lane, []).append(SC.pit(stream, r, SC.CHAIN, rng))
        tokens = sum(len(s) for _, s in runs)
        out = SC.ks_check([p for ps in lane_pits.values() for p in ps])
        out.update(tok_s=tokens / took, acceptance=acc / max(dr, 1), n_accept=acc, n_drafted=dr,
                   launches=launches, seeds=n_seeds)
        if len(lane_pits) > 1:
            out["lanes"] = {lane: SC.ks_check(ps) for lane, ps in lane_pits.items()}
        return out

    res, failed = {}, []
    for name, (fn, n_seeds) in engines.items():
        out = res[name] = pit_runs(fn, n_seeds)
        lanes = out.get("lanes", {})
        if not (out["ok"] and all(v["ok"] for v in lanes.values())
                and (name == "fused" or out["n"] >= 2048)):
            failed.append(f"{name}: D {out['D']:.4f} (bar {out['bar']:.4f}, n {out['n']}), "
                          f"{out['entropy_bits']:.3f} bits, lanes "
                          + ", ".join(f"{v['D']:.4f} / {v['bar']:.4f}" for v in lanes.values()))
        for k in ("i4g_matmul", "cell_attention"):
            if out["launches"][k] == 0:
                failed.append(f"{name} never launched {k}")
        log(f"[sample] {name:11s} temp 0.8: KS D {out['D']:.4f} (bar {out['bar']:.4f} at n "
            f"{out['n']}), mean entropy {out['entropy_bits']:.3f} bits, {out['outside']} tokens "
            f"outside the teacher rows' kept sets"
            + ("; lanes " + ", ".join(f"D {v['D']:.4f} / {v['bar']:.4f}" for v in lanes.values())
               if lanes else "")
            + f"; {out['tok_s']:.1f} tok/s, acceptance {out['acceptance']:.3f}; launches i4g "
            f"{out['launches']['i4g_matmul']}, cell attention {out['launches']['cell_attention']}")
    fault = res["fault_target_temp_1"] = pit_runs(batched, SAMPLE_SEEDS // SAMPLE_LANES,
                                                  fault=True)
    if fault["passes_ks"]:
        failed.append(f"the temp-1.0 fault passes the KS bar: D {fault['D']:.4f} "
                      f"(bar {fault['bar']:.4f})")
    log(f"[sample] batched under the temp-1.0 fault: KS D {fault['D']:.4f} (bar "
        f"{fault['bar']:.4f} at n {fault['n']})")
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    for name, fn in (("corrected", controller), ("device_loop", device_loop)):
        t0 = time.perf_counter()
        _, st = fn(greedy, SAMPLE_N)
        torch.cuda.synchronize()
        res[name]["greedy"] = dict(tok_s=SAMPLE_N / (time.perf_counter() - t0),
                                   acceptance=st.n_accept / max(st.n_drafted, 1))
        log(f"[sample] {name:11s} greedy: {res[name]['greedy']['tok_s']:.1f} tok/s, acceptance "
            f"{res[name]['greedy']['acceptance']:.3f} (temp 0.8: {res[name]['tok_s']:.1f}, "
            f"{res[name]['acceptance']:.3f})")
    for k, rec in records.items():
        rec["launches_sample"] = {name: v["launches"][k] for name, v in res.items()}
    return res, failed


def _sample_exact(counters: dict, live, params, cfg, prompt: list) -> tuple:
    """(c) The host-verified paths, exact: the default-flag cli.speculative
    against cli.main with one seed, and a fused stochastic controller
    (-np 1, no penalties, device_verify off) against plain sampled
    decoding. Where a stream parts, sample_check.part_report says whether
    the verify rows' logits moved the draw across a CDF boundary."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.cli import main as cli_main
    from pipeinfer_tpu_torch.cli import speculative as cli_spec
    from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
    from pipeinfer_tpu_torch.sampling import samplers
    from pipeinfer_tpu_torch.sampling.samplers import SamplerState
    from pipeinfer_tpu_torch.spec import controller
    from pipeinfer_tpu_torch.spec.controller import PipeInferController
    from pipeinfer_tpu_torch.spec.params import SpecParams
    from pipeinfer_tpu_torch.tools import sample_check as SC

    def tokens(calls):
        return [samplers.sample(s.copy(), row) for s, row in calls]

    def compare(label, calls_a, calls_b):
        ta, tb = tokens(calls_a), tokens(calls_b)
        if ta == tb:
            return dict(parted=False, draws=len(ta))
        k = next((i for i, (a, b) in enumerate(zip(ta, tb)) if a != b), min(len(ta), len(tb)))
        rep = SC.part_report(calls_a, calls_b, k)
        log(f"[sample] {label}: the streams part at draw {k}: u {rep['u']:.6f}, distance to "
            f"the nearest CDF boundary {rep['distance']:.3g}, the verify row's CDF shift "
            f"{rep['shift']:.3g} ({'explained' if rep['explained'] else 'NOT explained'})")
        return dict(parted=True, draws=len(ta), **rep)

    res, failed = {}, []
    argv = ["-m", str(live), "-p", CLI_PROMPT, "-n", str(SAMPLE_CLI_N), "-s", "1234"]
    with _layout(None):
        with SC.recorded_draws(samplers, controller) as calls_main:
            want, t_main = _cli_text(cli_main.main, argv)
        for c in counters.values():
            c.launches = 0
        err = io.StringIO()
        with SC.recorded_draws(samplers, controller) as calls_spec:
            got, t_spec = _cli_text(cli_spec.main, argv + ["-md", str(live)], err)
        launches = {k: c.launches for k, c in counters.items()}
    stats = dict(line.split("=", 1) for line in err.getvalue().splitlines()
                 if line.startswith(("n_drafted", "n_accept")))
    # greedy's stream (the same penalties at temp 0) parts from the sampled
    # one at the first draw that is not the greedy pick of its row
    not_argmax = [i for i, (t, (s, row)) in enumerate(zip(tokens(calls_main), calls_main))
                  if t != samplers.sample(SamplerState(params=dataclasses.replace(
                      s.params, temp=0.0), prev=list(s.prev)), row)]
    cli = dict(chars=len(want), main_s=t_main, speculative_s=t_spec, launches=launches,
               first_not_argmax=not_argmax[0] if not_argmax else None,
               n_not_argmax=len(not_argmax),
               stats={k.strip(): v.strip() for k, v in stats.items()},
               **compare("cli default", calls_main, calls_spec))
    res["cli_default"] = cli
    if got != want and not cli.get("explained"):
        failed.append(f"cli.speculative with default flags printed {got[-120:]!r}, cli.main "
                      f"{want[-120:]!r}")
    if not not_argmax:
        failed.append("cli.main with default sampling drew every token as greedy would")
    log(f"[sample] cli.main and cli.speculative, default sampling, -s 1234: "
        f"{'the same' if got == want else 'DIFFERENT'} {len(want)} characters ({len(not_argmax)} "
        f"of {len(calls_main)} draws not their row's argmax, the first at draw "
        f"{cli['first_not_argmax']}); {cli['stats']}; "
        f"{t_main:.1f} s and {t_spec:.1f} s; launches {launches}")

    # the fused stochastic run against plain sampled decoding, in process
    sampling = SC.chain_params(seed=1234)
    n = SAMPLE_EXACT_N
    ctx = InferenceContext(params, cfg, n_cells=SAMPLE_N_CELLS)
    with SC.recorded_draws(samplers, controller) as calls_plain:
        st = SamplerState(params=sampling)
        b = Batch()
        for i, t in enumerate(prompt):
            st.accept(t, apply_grammar=False)
            b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
        logits = ctx.decode(b)[-1]
        plain = []
        for pos in range(len(prompt), len(prompt) + n):
            plain.append(samplers.sample(st, logits))
            st.accept(plain[-1])
            b = Batch()
            b.add(plain[-1], pos, 0)
            logits = ctx.decode(b)[0]
    sp = SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=3, device_verify=False)
    for c in counters.values():
        c.launches = 0
    with SC.recorded_draws(samplers, controller) as calls_fused:
        eng = PipeInferController(InferenceContext(params, cfg, n_cells=SAMPLE_N_CELLS),
                                  InferenceContext(params, cfg, n_cells=SAMPLE_N_CELLS),
                                  sampling, sp, eos_id=-1)
        if not eng.use_fused or eng.use_corrected:
            raise AssertionError("[sample] the fused host-verified path was not taken")
        fused = eng.generate(list(prompt), n, ignore_eos=True)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    rec = dict(n=n, equal=fused == plain, n_accept=eng.stats.n_accept,
               n_drafted=eng.stats.n_drafted, launches=launches,
               **compare("fused stochastic", calls_plain, calls_fused))
    res["fused"] = rec
    if fused != plain and not rec.get("explained"):
        failed.append("the fused stochastic run differs from plain sampled decoding and the "
                      "verify rows do not explain it")
    log(f"[sample] fused stochastic (-np 1, device Gumbel drafts, host verification) "
        f"{'==' if fused == plain else '!='} plain sampled decoding over {n} tokens; "
        f"acceptance {eng.stats.n_accept}/{eng.stats.n_drafted}; launches {launches}")
    del ctx, eng
    return res, failed


def run_sample(counters: dict, records: dict) -> list:
    """The sample phase (see the module docstring): the live llama at 7B
    width, loaded once; the engines' copy has its output norm scaled by
    SAMPLE_LOGIT_SCALE."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.tools import sample_check as SC
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair, cached_llama_live

    t_path, _ = cached_bench_pair(ROOT / "build" / "bench", "7b", "Q4_K", 0.02, log=log)
    live = cached_llama_live(t_path, log=log)
    params, cfg = load_model(live)
    sparams = dict(params, output_norm=params["output_norm"] * SAMPLE_LOGIT_SCALE)
    rng = np.random.default_rng(SEED)
    prompts = [[1] + rng.integers(3, cfg.n_vocab, 31).tolist() for _ in range(SAMPLE_LANES)]
    rows = SC.teacher_rows(InferenceContext(sparams, cfg, n_cells=SAMPLE_N_CELLS),
                           [(prompts[0][:-SAMPLE_ROWS], prompts[0][-SAMPLE_ROWS:])])[0]
    own = [SC.exact(r / SAMPLE_LOGIT_SCALE) for r in rows]  # the live llama's own chain
    log(f"[sample] live llama ({cfg.n_layers}L, n_embd {cfg.n_embd}, vocab {cfg.n_vocab}): "
        f"its own rows' logits std {rows.std() / SAMPLE_LOGIT_SCALE:.3f}, max per row "
        f"{', '.join(f'{m:.3f}' for m in rows.max(axis=1) / SAMPLE_LOGIT_SCALE)}, the chain "
        f"keeping {', '.join(str(len(i)) for i, _ in own)} tokens at "
        f"{', '.join(f'{SC.entropy_bits(p):.2f}' for _, p in own)} bits; output norm x "
        f"{SAMPLE_LOGIT_SCALE}: std {rows.std():.3f}, max {rows.max():.3f}")
    rows = torch.from_numpy(rows).cuda()
    t0 = time.perf_counter()
    runs = [_sample_sampler(rows)]
    t1 = time.perf_counter()
    exact_res, failed_c = _sample_exact(counters, live, sparams, cfg, prompts[0])
    runs.append(dict(label="sample_exact", **exact_res))
    t2 = time.perf_counter()
    # a fused stream that parts from plain sampling is held to it by the PIT test
    engines, failed_b = _sample_engines(counters, sparams, cfg, prompts, records,
                                        with_fused=exact_res["fused"]["parted"])
    log(f"[sample] the sampler {t1 - t0:.1f} s, the exact paths {t2 - t1:.1f} s, the "
        f"engines {time.perf_counter() - t2:.1f} s")
    runs.append(dict(label="sample_engines", n=SAMPLE_N, seeds=SAMPLE_SEEDS,
                     logit_scale=SAMPLE_LOGIT_SCALE, engines=engines))
    failed = runs[0]["failed"] + failed_b + failed_c
    del params, sparams, rows
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("[sample] " + "; ".join(failed))
    return runs


# ---------------------------------------------------------------------------
# the CLI entry points
# ---------------------------------------------------------------------------

CLI_DEPTH = 4  # layers of the target in the CLI runs that load it many times (drafts keep 5)
CLI_PROMPT = "Once upon a time, there was a little robot who wanted to see the sea. Every day"
CLI_GREEDY = ["--temp", "0", "--repeat-penalty", "1.0", "--repeat-last-n", "0", "--ignore-eos",
              "-c", "1024"]


def _cli_text(entry, argv, err: io.StringIO | None = None) -> tuple[str, float]:
    """stdout of one in-process CLI call, and its seconds (load included);
    its stderr goes to `err` when given."""
    import torch

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), \
            (contextlib.redirect_stderr(err) if err is not None else contextlib.nullcontext()):
        rc = entry(argv)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI {argv[:2]}... exited {rc}")
    gc.collect()
    torch.cuda.empty_cache()
    return buf.getvalue(), took


@contextlib.contextmanager
def _layout(layout: str | None):
    old = os.environ.pop("PIPEINFER_WEIGHT_LAYOUT", None)
    if layout:
        os.environ["PIPEINFER_WEIGHT_LAYOUT"] = layout
    try:
        yield
    finally:
        os.environ.pop("PIPEINFER_WEIGHT_LAYOUT", None)
        if old is not None:
            os.environ["PIPEINFER_WEIGHT_LAYOUT"] = old


def run_cli_layout(label, layout, pair, n_predict, counters, kernel) -> dict:
    """cli.main, then cli.speculative (controller, -np 1) under one weight
    layout: identical text, and `kernel` and cell attention launched in
    the speculative run (counts set to 0 just before it)."""
    from pipeinfer_tpu_torch.cli import main as cli_main
    from pipeinfer_tpu_torch.cli import speculative as cli_spec

    t_path, d_path = map(str, pair)
    common = ["-m", t_path, "-p", CLI_PROMPT, "-n", str(n_predict), *CLI_GREEDY]
    with _layout(layout):
        want, t_main = _cli_text(cli_main.main, common)
        for fn in counters.values():
            fn.launches = 0
        got, t_spec = _cli_text(cli_spec.main, common + ["-md", d_path, "--engine", "controller",
                                                         "-np", "1"])
        launches = {k: fn.launches for k, fn in counters.items()}
    if got != want:
        raise AssertionError(f"[{label}] cli.speculative printed {got[-200:]!r}, cli.main "
                             f"{want[-200:]!r}")
    for k in (kernel, "cell_attention"):
        if launches[k] == 0:
            raise AssertionError(f"[{label}] cli.speculative never launched {k}")
    log(f"[{label}] cli.main and cli.speculative print the same {len(want)} characters "
        f"({t_main:.1f} s and {t_spec:.1f} s, loads included); launches {launches}")
    return dict(label=label, layout=layout, target=t_path, n_predict=n_predict, chars=len(want),
                main_s=t_main, speculative_s=t_spec, launches=launches, text_tail=want[-120:],
                text_sha256=hashlib.sha256(want.encode()).hexdigest())


def run_cli_engines(pair, n_predict) -> dict:
    """Under the default layout: --engine sync, the default -np 3 and a
    `python -m pipeinfer_tpu_torch.cli.speculative` subprocess print what
    cli.main prints."""
    from pipeinfer_tpu_torch.cli import main as cli_main
    from pipeinfer_tpu_torch.cli import speculative as cli_spec

    t_path, d_path = map(str, pair)
    common = ["-m", t_path, "-p", CLI_PROMPT, "-n", str(n_predict), *CLI_GREEDY]
    spec = common + ["-md", d_path]
    res = {}
    with _layout(None):
        want, res["main_s"] = _cli_text(cli_main.main, common)
        for name, extra in (("sync", ["--engine", "sync"]), ("trees_np3", [])):
            got, res[f"{name}_s"] = _cli_text(cli_spec.main, spec + extra)
            if got != want:
                raise AssertionError(f"[cli {name}] printed {got[-200:]!r}, cli.main "
                                     f"{want[-200:]!r}")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pipeinfer_tpu_torch.cli.speculative",
                               *spec, "--engine", "controller", "-np", "1"], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        res["subprocess_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m pipeinfer_tpu_torch.cli.speculative exited "
                             f"{proc.returncode}:\n{proc.stderr[-2000:]}")
    if proc.stdout != want:
        raise AssertionError(f"[cli subprocess] printed {proc.stdout[-200:]!r}, cli.main "
                             f"{want[-200:]!r}")
    log(f"[cli toy] --engine sync, -np 3 and the module subprocess print cli.main's "
        f"{len(want)} characters ({res})")
    return dict(label="cli_engines", target=t_path, n_predict=n_predict, chars=len(want), **res)


# ---------------------------------------------------------------------------
# serving: the device-verified engines and the server
# ---------------------------------------------------------------------------

SERVE_PROMPTS = [  # 4 greedy requests, 1 with repeat_penalty 1.1, 1 greedy joining late
    "Once upon a time, there was a little robot who wanted to see the sea.",
    "The quick brown fox jumps over the lazy dog, and then",
    "In the beginning the universe was created. This has made a lot of people",
    "Every day the baker opened the shop before sunrise and",
    "The little robot said to the sea:",
    "At the end of the long road there stood a house where",
]
SERVE_N = 48  # tokens per request
LANE_SLOTS = (60, 61, 62, 63)  # the server's 4 lanes: the top of the 64 slots


def check_serve_shapes(details: list):
    """The kernels at the shapes the batched loops give them: i4g and i8g at
    M = 4 (a draft step of 4 lanes) and 36 (their target pass) on the 7B
    wqkv and w_down, with the bitwise repeat; cell attention at T = 4 with
    one row on each of the slots 60-63 over cells those slots own, against
    its plain version and against a softmax over each row's own cells."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.ops import cell_attention as CA
    from pipeinfer_tpu_torch.runtime import kv_cache as KV

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    for layout in ("i4g", "i8g"):
        for name in SERVE_SHAPES:
            n, k = I4G_SHAPES[name]
            planes = _split_planes(layout, n, k, dev, g)
            for m in SERVE_MS:
                x = torch.randn(m, k, device=dev, generator=g)
                kern, plain, ins, name_k, _ = _split_inputs(layout, x, planes)
                err, scale = _check_repeat(kern, plain, ins[0], f"{name_k} {name} M={m}")
                cut = _cut(kern)
                details.append(dict(kernel=name_k, tensor=name, N=n, K=k, M=m, max_abs_err=err,
                                    tol=MATMUL_RTOL * scale, plan=cut, phase="serve"))
                log(f"{name_k:11s} {name:7s} [{n}x{k}] M={m:2d}: err {err:.3g} "
                    f"(tol {MATMUL_RTOL * scale:.3g}), two calls bitwise equal"
                    + ("" if cut is None else f"  [{cut['splits']} splits, {cut['blocks']} "
                       f"blocks, row tile {cut['rows']}]"))
            del planes

    h, d, c, used = 32, 128, 2048, 900
    rng = np.random.default_rng(SEED)
    owner = rng.choice(np.array(LANE_SLOTS), used)
    pos_np = np.full(c, -1, np.int32)
    for s in LANE_SLOTS:  # each slot's cells hold its positions 0, 1, 2, ...
        pos_np[:used][owner == s] = np.arange(int((owner == s).sum()))
    rows = np.zeros((c, KV.SEQ_WORDS), np.uint32)
    rows[:used] = KV.host_rows([[int(o)] for o in owner])
    kc, vc = _attn_cache(h, d, c, dev, g)
    pos = torch.from_numpy(pos_np).to(dev)
    seq = torch.from_numpy(rows.view(np.int32)).to(dev)
    tok_seq = torch.tensor(LANE_SLOTS, dtype=torch.int32, device=dev)
    tok_pos = torch.tensor([int((owner == s).sum()) - 1 - 7 * i for i, s in enumerate(LANE_SLOTS)],
                           dtype=torch.int32, device=dev)
    valid = torch.ones(4, dtype=torch.bool, device=dev)
    q = torch.randn(4, h, d, device=dev, generator=g)
    scale = d ** -0.5
    for hot in (0, 1024):
        got = CA.cell_attention(q, kc, vc, pos, seq, tok_pos, tok_seq, valid, layer=1,
                                scale=scale, hot=hot)
        want = CA._cell_attention_plain(q, kc, vc, pos, seq, tok_pos, tok_seq, valid, 1, scale,
                                        None, hot or c)
        own = []  # each row over its own slot's visible cells, selected on the host
        for i, s in enumerate(LANE_SLOTS):
            sel = torch.from_numpy(np.nonzero((owner == s) & (pos_np[:used] <= int(tok_pos[i])))[0]
                                   ).to(dev)
            sc = torch.einsum("hd,hcd->hc", q[i], kc[1][:, sel].float()) * scale
            own.append(torch.einsum("hc,hcd->hd", torch.softmax(sc, dim=-1), vc[1][:, sel].float()))
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_own = (got - torch.stack(own)).abs().max().item()
        if not (err <= ATTN_ATOL and err_own <= ATTN_ATOL):
            raise AssertionError(f"cell_attention T=4 on slots 60-63, hot={hot}: max err {err} "
                                 f"against the plain version, {err_own} against each row's own "
                                 f"cells")
        details.append(dict(kernel="cell_attention", T=4, H=h, KVH=h, D=d, C=c, hot=hot,
                            slots=list(LANE_SLOTS), max_abs_err=err, max_abs_err_own=err_own,
                            tol=ATTN_ATOL, phase="serve"))
        log(f"cell_attention T=4 slots 60-63 C={c} hot={hot}: err {err:.3g} against the plain "
            f"version, {err_own:.3g} against each row's own cells (tol {ATTN_ATOL})")
    # the dense path's mask at the same slots: the card's equals the CPU's
    mask = KV.attn_mask(KV.KVCache(kc, vc, pos, seq), tok_pos, tok_seq)
    cpu = KV.attn_mask(KV.KVCache(kc[:, :, :1], vc[:, :, :1], pos.cpu(), seq.cpu()),
                       tok_pos.cpu(), tok_seq.cpu())
    if not torch.equal(mask.cpu(), cpu):
        raise AssertionError("attn_mask on the card differs from the CPU's at slots 60-63")
    del kc, vc


def _post(port: int, body: dict, stream_started=None) -> dict:
    """One /completion request; a streamed one (stream_started: an Event,
    set at its first piece) comes back as the non-streamed reply would."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/completion",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if not body.get("stream"):
            return json.load(r)
        pieces = []
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            obj = json.loads(line[6:])
            pieces.append(obj.get("content") or "")
            stream_started.set()
            if obj.get("stop"):
                return dict(obj, content="".join(pieces))
    raise AssertionError("stream ended without its final event")


def run_serve(counters: dict, n_predict: int) -> dict:
    """The serve phase on the 7B Q4_K pair (see the module docstring)."""
    import threading

    import torch

    from pipeinfer_tpu_torch.serving.server import serve
    from pipeinfer_tpu_torch.spec.params import SpecParams
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair

    t_path, d_path = cached_bench_pair(ROOT / "build" / "bench", "7b", "Q4_K", 0.02, log=log)
    t0 = time.perf_counter()
    # the server as `python -m pipeinfer_tpu_torch.serving.server --draft D`
    # starts it: --n-draft 8, --max-inflight 3, --device-lanes 4
    spec = SpecParams(n_draft=8, n_parallel=1, p_accept=0.0, max_inflight=3)
    httpd, engine = serve(str(t_path), "127.0.0.1", 0, draft_path=str(d_path), spec_params=spec,
                          device_lanes=4)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    try:
        torch.cuda.synchronize()
        res = _serve_checks(httpd, engine, counters, n_predict, time.perf_counter() - t0)
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.shutdown()
        http_thread.join(timeout=30)
    if engine.thread.is_alive() or http_thread.is_alive():
        raise AssertionError("the server's threads did not stop")
    del httpd, engine
    gc.collect()
    torch.cuda.empty_cache()
    res["launches"]["device_loop_q6k"] = _device_loop_q6k(counters, n_predict)
    res["total_s"] = time.perf_counter() - t0
    return res


def _device_loop_q6k(counters: dict, n_predict: int) -> dict:
    """DeviceLoopEngine on the toy Q6_K pair, whose matmuls all take the
    i8g kernel (as a Q4_K_M file's Q6_K tensors do): its stream equals
    plain greedy, and i8g launched. Returns the launch counts."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
    from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
    from pipeinfer_tpu_torch.spec.device_loop import DeviceLoopEngine
    from pipeinfer_tpu_torch.spec.params import SpecParams
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair

    t_path, d_path = cached_bench_pair(ROOT / "build" / "bench", "toy", "Q6_K", 0.02, log=log)
    tgt, dft = load_model(t_path), load_model(d_path)
    prompt = [1] + np.random.default_rng(SEED).integers(3, tgt[1].n_vocab, 31).tolist()
    c = InferenceContext(*tgt, n_cells=1024)
    b = Batch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    first = int(np.argmax(c.decode(b)[-1]))
    want = [first] + c.draft_chain(first, len(prompt), 0, n_predict - 1, n_cand=0)[0]
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    for c_ in counters.values():
        c_.launches = 0
    eng = DeviceLoopEngine(InferenceContext(*tgt, n_cells=1024), InferenceContext(*dft, n_cells=1024),
                           greedy, SpecParams(n_draft=8), eos_id=-1, rounds=8)
    got = eng.generate(list(prompt), n_predict, ignore_eos=True)
    torch.cuda.synchronize()
    launches = {k: c_.launches for k, c_ in counters.items()}
    if got != want:
        raise AssertionError(f"[serve] DeviceLoopEngine on the toy Q6_K pair differs from plain "
                             f"greedy: {got[:12]} vs {want[:12]}")
    for k in ("i8g_matmul", "cell_attention"):
        if launches[k] == 0:
            raise AssertionError(f"[serve] DeviceLoopEngine on the toy Q6_K pair never launched {k}")
    log(f"[serve] DeviceLoopEngine on the toy Q6_K pair == plain greedy over {n_predict} tokens; "
        f"launches {launches}")
    del tgt, dft, c, eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _serve_checks(httpd, engine, counters: dict, n_predict: int, load_s: float) -> dict:
    """The serve phase's checks over a running --draft server (see the
    module docstring, phase 7). Returns the run's record."""
    import threading

    import numpy as np
    import torch

    from pipeinfer_tpu_torch.cli.main import generate as cli_generate
    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.sampling.samplers import SamplerState, SamplingParams
    from pipeinfer_tpu_torch.serving.server import _sampling_from_body
    from pipeinfer_tpu_torch.spec.controller import PipeInferController
    from pipeinfer_tpu_torch.spec.device_loop import DeviceLoopEngine
    from pipeinfer_tpu_torch.spec.device_multi import BatchedDeviceLoop
    from pipeinfer_tpu_torch.spec.params import SpecParams
    from pipeinfer_tpu_torch.tokenizer.stream import StreamDecoder

    sched, tok = engine.scheduler, engine.tok
    tgt, dft = sched.ctx, sched.engine.dft
    log(f"[serve] server up on port {httpd.server_address[1]} in {load_s:.1f} s (target "
        f"{tgt.cfg.n_layers}L, draft {dft.cfg.n_layers}L, {tgt.n_cells} cells, lanes on slots "
        f"{sched.devsrv.seq_base}-{sched.devsrv.seq_base + sched.devsrv.S - 1})")
    if sched.devsrv is None or sched.devsrv.seq_base != LANE_SLOTS[0]:
        raise AssertionError("the --draft server has no device lanes on slots 60-63")

    def ctx(which):  # fresh contexts over the server's loaded weights (no copy)
        return InferenceContext(which.params, which.cfg, n_cells=1024)

    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)

    def launched(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}

    # 1. DeviceLoopEngine against plain greedy and the controller
    rng = np.random.default_rng(SEED)
    prompt = [1] + rng.integers(3, tgt.cfg.n_vocab, 31).tolist()

    def plain(n):
        return _greedy(ctx(tgt), prompt, n)

    def timed(engine_fn, n):
        e = engine_fn()
        t1 = time.perf_counter()
        out = e.generate(list(prompt), n, ignore_eos=True)
        torch.cuda.synchronize()
        return e, out, time.perf_counter() - t1

    def device_loop():
        return DeviceLoopEngine(ctx(tgt), ctx(dft), greedy, SpecParams(n_draft=8), eos_id=-1,
                                rounds=8)

    def controller():
        return PipeInferController(ctx(tgt), ctx(dft), greedy, SpecParams(
            n_draft=8, n_parallel=1, p_accept=0.1, p_split=0.9, max_inflight=4), eos_id=-1)

    timed(device_loop, 16)  # warm-up
    timed(controller, 16)
    want, t_plain = plain(n_predict)
    _, _, t_ctrl = timed(controller, n_predict)
    (dl, got, t_dl), dl_launches = launched(lambda: timed(device_loop, n_predict))
    if got != want:
        first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"[serve] DeviceLoopEngine differs from plain greedy at token "
                             f"{first}: {got[first:first + 8]} vs {want[first:first + 8]}")
    for k in ("i4g_matmul", "cell_attention"):
        if dl_launches[k] == 0:
            raise AssertionError(f"[serve] DeviceLoopEngine never launched {k}")
    st = dl.stats
    res = dict(label="serve", load_s=load_s, n_predict=n_predict,
               plain_tok_s=(n_predict - 1) / t_plain, controller_tok_s=n_predict / t_ctrl,
               device_loop_tok_s=n_predict / t_dl, device_loop_s=t_dl,
               device_loop_decode_tok_s=st.n_predict / max(dl.t_decode, 1e-9),
               device_loop_acceptance=st.n_accept / max(st.n_drafted, 1),
               device_loop_rounds=st.n_rounds, launches={"device_loop": dl_launches})
    log(f"[serve] DeviceLoopEngine stream == plain greedy over {n_predict} tokens; plain "
        f"{res['plain_tok_s']:.1f} tok/s, controller {res['controller_tok_s']:.1f} tok/s, device "
        f"loop {res['device_loop_tok_s']:.1f} tok/s ({st.n_rounds} rounds, acceptance "
        f"{res['device_loop_acceptance']:.3f}); launches {dl_launches}")

    # 2. the texts cli.main generates for the server's prompts
    bodies = [dict(prompt=p, n_predict=SERVE_N, temperature=0, ignore_eos=True,
                   repeat_penalty=1.0, repeat_last_n=0) for p in SERVE_PROMPTS]
    bodies[4] = dict(prompt=SERVE_PROMPTS[4], n_predict=SERVE_N, temperature=0, ignore_eos=True,
                     repeat_penalty=1.1)
    bodies[0]["stream"] = True
    ids = [tok.encode(p, add_bos=True) for p in SERVE_PROMPTS]
    texts, ref_tokens = [], []
    for i, b in enumerate(bodies):
        sampler = SamplerState(params=_sampling_from_body(b))
        for t in ids[i]:
            sampler.accept(t, apply_grammar=False)
        out = cli_generate(ctx(tgt), tok, sampler, ids[i], SERVE_N, ignore_eos=True)
        sdec = StreamDecoder(tok)
        printed = "".join(sdec.feed(t) for t in out)  # what cli.main prints
        texts.append(printed + sdec.flush())  # and the bytes its decoder still holds
        ref_tokens.append(out)

    # 3. BatchedDeviceLoop: the 4 greedy prompts as 4 streams
    bl = BatchedDeviceLoop(ctx(tgt), ctx(dft), greedy, SpecParams(n_draft=8), n_streams=4,
                           eos_id=-1, rounds=4)
    t1 = time.perf_counter()
    outs, b_launches = launched(lambda: bl.generate_many([list(x) for x in ids[:4]], SERVE_N,
                                                         ignore_eos=True))
    t_batched = time.perf_counter() - t1
    for s in range(4):
        if outs[s] != ref_tokens[s]:
            raise AssertionError(f"[serve] BatchedDeviceLoop stream {s} differs from its plain "
                                 f"greedy stream: {outs[s][:12]} vs {ref_tokens[s][:12]}")
    for k in ("i4g_matmul", "cell_attention"):
        if b_launches[k] == 0:
            raise AssertionError(f"[serve] BatchedDeviceLoop never launched {k}")
    res.update(batched_s=t_batched, batched_tok_s=4 * SERVE_N / t_batched)
    res["launches"]["batched"] = b_launches
    log(f"[serve] BatchedDeviceLoop: 4 streams == their plain greedy streams over {SERVE_N} "
        f"tokens, {res['batched_tok_s']:.1f} tok/s in all; launches {b_launches}")

    # 4. the server: 6 concurrent requests, the last joining after the
    # first streamed piece
    port = httpd.server_address[1]
    replies = [None] * len(bodies)
    errors = []
    started = threading.Event()

    def post(i):
        try:
            if i == len(bodies) - 1 and not started.wait(timeout=600):
                raise AssertionError("no streamed piece arrived")
            replies[i] = _post(port, bodies[i], started)
        except Exception as e:  # reported below: any failed request fails the phase
            errors.append(f"request {i}: {e!r}")

    def serve_all():
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        return any(th.is_alive() for th in threads)

    t1 = time.perf_counter()
    stuck, s_launches = launched(serve_all)
    t_server = time.perf_counter() - t1
    if stuck or errors:
        raise AssertionError(f"[serve] requests failed: {errors or 'a request hung'}")
    if not engine.thread.is_alive():
        raise AssertionError("[serve] the engine thread died")
    for i, (r, want_text) in enumerate(zip(replies, texts)):
        if r.get("error"):
            raise AssertionError(f"[serve] request {i} answered an error: {r['error']}")
        if r["content"] != want_text or r["tokens_predicted"] != SERVE_N:
            raise AssertionError(f"[serve] request {i}: {r['tokens_predicted']} tokens, content "
                                 f"{r['content'][:120]!r}, cli.main's {want_text[:120]!r}")
    deadline = time.perf_counter() + 10
    while (sched.n_device_served, sched.n_host_served) != (5, 1) and \
            time.perf_counter() < deadline:
        time.sleep(0.05)
    served = dict(device_lanes=sched.n_device_served, multi_pipeinfer=sched.n_host_served)
    if served != dict(device_lanes=5, multi_pipeinfer=1):
        raise AssertionError(f"[serve] served counters {served}; want 5 on the device lanes and "
                             f"1 on MultiPipeInfer")
    for k in ("i4g_matmul", "cell_attention"):
        if s_launches[k] == 0:
            raise AssertionError(f"[serve] the server never launched {k}")
    res.update(server_s=t_server, server_tok_s=len(bodies) * SERVE_N / t_server, served=served,
               texts_sha256=[hashlib.sha256(t.encode()).hexdigest() for t in texts])
    res["launches"]["server"] = s_launches
    log(f"[serve] the server answered 6 concurrent requests in {t_server:.1f} s: 5 greedy == "
        f"cli.main's text, the repeat_penalty 1.1 one == plain decoding under its sampler, "
        f"served {served}; launches {s_launches}")
    return res


# ---------------------------------------------------------------------------
# arch: the generic decoder, the staged pipeline and lookahead at MPT-7B width
# ---------------------------------------------------------------------------

ARCH_EPS = 0.02  # the MPT pair's draft disagreement, as for the 7B llama pair
ARCH_CLI_N = 64  # tokens of each arch CLI call
ARCH_DEPTH = 5  # layers of the MPT target: its draft's
ARCH_N_CELLS = 1024
ARCH_I4G = {  # (N, K) of every 4-bit tensor of MPT-7B
    "wqkv": (12288, 4096), "wo": (4096, 4096), "w_up": (16384, 4096), "w_down": (4096, 16384),
}
# plain and draft steps, the verify bucket (draft 8: up to 9 rows, but the
# controller's runs of at most 8), lookahead's verify batch (W 15, N 5, G
# 15: up to 121 rows) padded
ARCH_I4G_MS = (1, 8, 128)
ARCH_HEAD = (50432, 4096)  # MPT-7B's Q6_K head, through i8g
ARCH_HEAD_MS = (1, 8)  # a decode or draft step, the verify bucket
ARCH_ATTN_T = (1, 4)
ARCH_CACHE_DTYPES = ("bf16", "f32")  # --cache-dtype
# The toy architectures keep f32 weights (no s8 rounding): a CPU emulation
# (every matmul perturbed by 3e-7) moved their logits by at most 3.5e-4 of
# max|logit|. The live model's bar, LIVE_RTOL, is tools/live_check's.
TOY_RTOL = 5e-3  # of max|logit|
TOY_ARCHS = {  # name -> (architecture, build_tiny_arch keywords); 2 layers, n_embd 256
    "falcon": ("falcon", dict(n_kv_heads=1)),  # MQA, parallel residual, neox rope
    "falcon40b": ("falcon", dict(n_kv_heads=2, attn_norm_2=True)),  # attn_norm_2, GQA
    "starcoder": ("starcoder", dict(n_kv_heads=1)),  # learned positions, MQA
    "persimmon": ("persimmon", {}),  # Q/K LayerNorm, relu2, partial neox rope
    "refact": ("refact", dict(n_kv_heads=1)),  # ALiBi, RMSNorm, gated SiLU, MQA
    "bloom": ("bloom", {}),  # tok_norm, ALiBi
    "stablelm": ("stablelm", {}),  # partial neox rope, q/k/v biases
    "gptneox": ("gptneox", {}),  # neox rope over a quarter of the head
}


def check_arch_shapes(records: dict, details: list):
    """The kernels at the shapes the arch path gives them: i4g at M = 1, 8
    and 128 over each of MPT-7B's 4-bit tensors, i8g at M = 1 and 8 over
    its 50432-row head, each against its plain version with a bitwise
    repeat; cell attention at MPT-7B's heads over 1024 cells whose
    positions are shuffled against their index, with holes, T = 1 and 4,
    with kv_cache.alibi_slopes(32, 8.0), over a bf16 and an f32 cache
    (reached through attend). Each timed beside its plain version and its
    bound; the rows go to each kernel's record under "arch"."""
    import torch
    import torch.nn.functional as F

    from pipeinfer_tpu_torch.ops import cell_attention as CA
    from pipeinfer_tpu_torch.runtime import kv_cache as KV

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows: dict = {"i4g_matmul": [], "i8g_matmul": [], "cell_attention": []}
    cases = [("i4g", name, nk, m) for name, nk in ARCH_I4G.items() for m in ARCH_I4G_MS] + \
        [("i8g", "output", ARCH_HEAD, m) for m in ARCH_HEAD_MS]
    planes_key = planes = None
    for layout, name, (n, k), m in cases:
        if (layout, name) != planes_key:
            planes = None
            planes = _split_planes(layout, n, k, dev, g, copies_for(
                n * k // 2 if layout == "i4g" else -(-k // 512) * 512 * n))
            planes_key = (layout, name)
        x = torch.randn(m, k, device=dev, generator=g)
        kern, plain, ins, name_k, ops = _split_inputs(layout, x, planes)
        err, scale = _check_repeat(kern, plain, ins[0], f"{name_k} {name} M={m}")
        it = iter(range(1 << 30))
        k_ms = gpu_ms(lambda: kern(*ins[next(it) % len(ins)]), iters=20)
        p_ms = gpu_ms(lambda: plain(*ins[0]), iters=3, warmup=1)
        b_ms, b_by = bound(nbytes(*ins[0]) + m * n * 4, ops, "int8")
        row = dict(kernel=name_k, tensor=f"mpt7b {name}", N=n, K=k, M=m, max_abs_err=err,
                   tol=MATMUL_RTOL * scale, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                   plan=_cut(kern), phase="arch")
        rows[name_k].append(row)
        details.append(row)
        log(f"{name_k:11s} mpt7b {name:7s} [{n}x{k}] M={m:3d}: err {err:.3g} "
            f"(tol {MATMUL_RTOL * scale:.3g}), two calls bitwise equal  kernel {k_ms:.4f} ms"
            f"  plain {p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  cut {_cut(kern)}")
        del ins
    del planes

    h, d, c = 32, 128, ARCH_N_CELLS
    slopes = KV.alibi_slopes(h, 8.0, device=dev)
    # a cache after seq_rm and reuse: positions in no order against the
    # cell index, a run of freed cells between live ones
    pos = torch.randperm(c, device=dev, generator=g).to(torch.int32)
    pos[200:232] = -1
    seq = torch.zeros(c, KV.SEQ_WORDS, dtype=torch.int32, device=dev)
    seq[pos >= 0, 0] = 1
    for dtype_name in ARCH_CACHE_DTYPES:
        dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
        kc, vc = (t.to(dtype) for t in _attn_cache(h, d, c, dev, g))
        n_l = kc.shape[0]
        for t in ARCH_ATTN_T:
            q = torch.randn(t, h, d, device=dev, generator=g)
            tok_pos = torch.arange(c, c + t, dtype=torch.int32, device=dev)
            tok_seq = torch.zeros(t, dtype=torch.int32, device=dev)
            valid = torch.ones(t, dtype=torch.bool, device=dev)
            args = (q, kc, vc, pos, seq, tok_pos, tok_seq, valid)
            # through attend, as a step reaches it: the kernel, for either dtype
            cache = KV.KVCache(kc, vc, pos, seq)
            before = CA.cell_attention.launches
            got = KV.attend(q, cache, 1, KV.attn_mask(cache, tok_pos, tok_seq), tok_pos,
                            tok_seq, valid, scale=d ** -0.5, alibi=slopes)
            if CA.cell_attention.launches != before + 1:
                raise AssertionError(f"attend did not launch the cell kernel on a {dtype_name} "
                                     f"cache at T={t}")
            want = CA._cell_attention_plain(*args, 1, d ** -0.5, slopes, c)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not err <= ATTN_ATOL:
                raise AssertionError(f"cell_attention T={t} MPT-7B heads, ALiBi, {dtype_name} "
                                     f"cache: max err {err}")
            it = iter(range(1 << 30))
            k_ms = gpu_ms(lambda: CA.cell_attention(*args, layer=next(it) % n_l,
                                                    scale=d ** -0.5, alibi=slopes))
            p_ms = gpu_ms(lambda: CA._cell_attention_plain(*args, 1, d ** -0.5, slopes, c),
                          iters=3, warmup=1)
            # library call: SDPA with the visibility and ALiBi bias as one
            # additive mask, in the cache's dtype
            mask = (torch.where((pos >= 0)[None, :], 0.0, -1e9)
                    + slopes[:, None, None] * pos.clamp_min(0).float()[None, None, :])
            mask = mask.expand(h, t, c)[None].to(dtype)
            qb = q.to(dtype).transpose(0, 1)[None]
            kv = [(kc[i][None], vc[i][None]) for i in range(n_l)]
            it2 = iter(range(1 << 30))

            def sdpa():
                kl, vl = kv[next(it2) % n_l]
                return F.scaled_dot_product_attention(qb, kl, vl, attn_mask=mask)

            lib_ms = gpu_ms(sdpa)
            io = 2 * h * c * d * kc.element_size() \
                + nbytes(q, tok_pos, tok_seq, valid, slopes) + c * 4 * (1 + KV.SEQ_WORDS) \
                + t * h * d * 4
            b_ms, b_by = bound(io, 4 * t * h * c * d, "f32")
            row = dict(kernel="cell_attention", T=t, H=h, KVH=h, D=d, C=c, alibi=True,
                       cache=dtype_name, max_abs_err=err, tol=ATTN_ATOL, ms=k_ms, plain_ms=p_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, phase="arch")
            rows["cell_attention"].append(row)
            details.append(row)
            log(f"cell_attention T={t} H=KVH=32 D=128 C={c} ALiBi(32, 8.0) {dtype_name} cache, "
                f"shuffled positions: err {err:.3g} (tol {ATTN_ATOL})  kernel {k_ms:.4f} ms  "
                f"plain {p_ms:.4f} ms  SDPA {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
            del kv
        del kc, vc
    for key, src, tpu in (
        ("i4g_matmul", "pipeinfer_tpu_torch/csrc/qmatmul_i4g.cu", "pipeinfer_tpu/ops/qmatmul.py:784"),
        ("i8g_matmul", "pipeinfer_tpu_torch/csrc/qmatmul_i8g.cu", "pipeinfer_tpu/ops/qmatmul.py:923"),
        ("cell_attention", "pipeinfer_tpu_torch/csrc/cell_attention.cu",
         "pipeinfer_tpu/ops/cell_attention.py:27"),
    ):
        keep = ("M", "N", "K", "T", "C", "cache", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "library_ms")
        arch_rows = [{f: r[f] for f in keep if f in r} for r in rows[key]]
        if key not in records:  # an arch-only run: its first shape stands for the kernel
            r = rows[key][0]
            records[key] = dict(name=key, route="cuda", source=src, replaces=tpu, launches=0,
                                max_abs_err=max(x["max_abs_err"] for x in rows[key]),
                                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                                bound_by=r["bound_by"], library_ms=r.get("library_ms"),
                                shape=f"arch phase, {arch_rows[0]}")
        records[key]["arch"] = arch_rows


def _greedy(ctx, prompt, n, chain: bool = True):
    """Greedy decoding: the prefill's argmax, then n - 1 tokens as one
    on-device chain (chain: InferenceContext.draft_chain without
    candidates) or one host step at a time through ctx.decode (as
    cli.pipeline decodes; any context). Returns (tokens, seconds of the n -
    1 tokens)."""
    import numpy as np

    from pipeinfer_tpu_torch.runtime.context import Batch

    b = Batch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    out = [int(np.argmax(ctx.decode(b)[-1]))]
    t1 = time.perf_counter()
    if chain:
        out += ctx.draft_chain(out[0], len(prompt), 0, n - 1, n_cand=0)[0]
    else:
        for i in range(n - 1):
            b = Batch()
            b.add(out[-1], len(prompt) + i, 0)
            out.append(int(np.argmax(ctx.decode(b)[0])))
    return out, time.perf_counter() - t1


def run_arch_streams(counters: dict, pair, n_predict: int) -> dict:
    """On the MPT pair, loaded once: plain greedy decoding, the
    PipeInferController (device-corrected), the controller over a 2- and a
    4-stage StagedInferenceContext (--layer-split 0.5,0.5 and an even
    4-way split) and LookaheadDecoder (W 15, N 5, G 15) on the main phase's
    prompt; every stream equal to plain greedy's, and i4g, i8g and cell
    attention launched in each run (cell attention not in lookahead's,
    whose steps are 60 or more rows and take the dense path)."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.parallel.stages import StagedInferenceContext
    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
    from pipeinfer_tpu_torch.spec.controller import PipeInferController
    from pipeinfer_tpu_torch.spec.lookahead import LookaheadDecoder
    from pipeinfer_tpu_torch.spec.params import SpecParams

    t0 = time.perf_counter()
    tparams, tcfg = load_model(pair[0])
    dparams, dcfg = load_model(pair[1])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[arch] loaded the {tcfg.arch} pair: {tcfg.n_layers}L target + {dcfg.n_layers}L draft "
        f"(n_embd {tcfg.n_embd}, {tcfg.n_heads} heads, n_ff {tcfg.n_ff}, vocab {tcfg.n_vocab}, "
        f"ALiBi max bias {tcfg.max_alibi_bias}) in {load_s:.1f} s")
    rng = np.random.default_rng(SEED)
    prompt = [1] + rng.integers(3, tcfg.n_vocab, 31).tolist()
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    sp = SpecParams(n_draft=8, n_parallel=1, p_accept=0.1, p_split=0.9, max_inflight=4)

    def ctx(params, cfg):
        return InferenceContext(params, cfg, n_cells=ARCH_N_CELLS)

    def staged(n_stages):
        return StagedInferenceContext(tparams, tcfg, n_cells=ARCH_N_CELLS,
                                      devices=["cuda"] * n_stages, split=[1.0] * n_stages)

    def controller(tgt):
        return PipeInferController(tgt, ctx(dparams, dcfg), greedy, sp, eos_id=-1)

    engines = {
        "controller": lambda: controller(ctx(tparams, tcfg)),
        "staged2": lambda: controller(staged(2)),
        "staged4": lambda: controller(staged(4)),
        "lookahead": lambda: LookaheadDecoder(ctx(tparams, tcfg), greedy, W=15, N=5, G=15,
                                              eos_id=-1, topk=128),
    }
    _greedy(ctx(tparams, tcfg), prompt, 8)  # warm-up: allocator and library state
    controller(ctx(tparams, tcfg)).generate(list(prompt), 16, ignore_eos=True)
    res = dict(label="arch_streams", arch=tcfg.arch, load_s=load_s, n_predict=n_predict,
               prompt_len=len(prompt), n_cells=ARCH_N_CELLS, engines={})
    for c in counters.values():
        c.launches = 0
    want, t_plain = _greedy(ctx(tparams, tcfg), prompt, n_predict)
    res["engines"]["plain"] = dict(tok_s=(n_predict - 1) / t_plain,
                                   launches={k: c.launches for k, c in counters.items()})
    for name, make in engines.items():
        eng = make()
        for c in counters.values():
            c.launches = 0
        t1 = time.perf_counter()
        got = eng.generate(list(prompt), n_predict, ignore_eos=True)
        torch.cuda.synchronize()
        took = time.perf_counter() - t1
        launches = {k: c.launches for k, c in counters.items()}
        if got != want:
            first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(f"[arch] {name} differs from plain greedy at token {first}: "
                                 f"{got[first:first + 8]} vs {want[first:first + 8]}")
        st = eng.stats
        if name == "lookahead":
            row = dict(tok_s=n_predict / took, n_accept=st.n_accept,
                       acceptance=st.n_accept / max(st.n_predict, 1))
        else:
            row = dict(tok_s=n_predict / took, n_accept=st.n_accept, n_drafted=st.n_drafted,
                       acceptance=st.n_accept / max(st.n_drafted, 1), runs=eng.metrics.n_runs,
                       mode="corrected" if eng.use_corrected else
                       ("fused" if eng.use_fused else "host"))
        row["launches"] = launches
        res["engines"][name] = row
        del eng
    # what staging costs on one device: the host decode loop through one
    # context and through 2 and 4 stages (the same launches per layer, plus
    # each stage's mask and metadata writes and its hand-off)
    n_loop = min(32, n_predict)
    makers = {"single": lambda: ctx(tparams, tcfg), "staged2": lambda: staged(2),
              "staged4": lambda: staged(4)}
    loop: dict = {name: [] for name in makers}
    for name in ("single", "staged2", "staged4", "staged4", "staged2", "single"):  # in turns
        got, took = _greedy(makers[name](), prompt, n_loop, chain=False)
        if got != want[:n_loop]:
            raise AssertionError(f"[arch] the {name} decode loop differs from plain greedy")
        loop[name].append((n_loop - 1) / took)
    res["decode_loop_tok_s"] = loop
    log(f"[arch] host decode loop, {n_loop} tokens, in turns: " + ", ".join(
        f"{k} {' / '.join(f'{v:.1f}' for v in vs)} tok/s" for k, vs in loop.items()))
    for name, row in res["engines"].items():
        need = ("i4g_matmul", "i8g_matmul") + (() if name == "lookahead" else ("cell_attention",))
        for k in need:
            if row["launches"][k] == 0:
                raise AssertionError(f"[arch] {name} never launched {k}")
        log(f"[arch] {name:10s} == plain greedy over {n_predict} tokens: {row['tok_s']:.1f} tok/s"
            + (f", acceptance {row['acceptance']:.3f}" if "acceptance" in row else "")
            + (f" ({row['mode']})" if "mode" in row else "")
            + f"; launches i4g {row['launches']['i4g_matmul']}, i8g "
              f"{row['launches']['i8g_matmul']}, cell attention "
              f"{row['launches']['cell_attention']}")
    del tparams, dparams
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_arch_live(counters: dict, live_path) -> dict:
    """The 2-layer MPT model with non-zero attn_output and ffn_down, at full
    width (tools/live_check): a 9-token prefill (dense path, T padded to 32)
    and 8 single-token steps (the cell kernel with ALiBi, 1024 cells) on
    the card, then the same steps through the port on the CPU on the same
    weight planes: the logits within LIVE_RTOL of max|logit|. Then the card
    again under each of live_check.FAULTS, each of which must move the
    logits past that bar."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.tools import live_check as LC

    params, cfg = load_model(live_path)
    toks = LC.live_tokens(cfg.n_vocab, SEED + 5)
    cuda = torch.device("cuda")
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    got = LC.run_live(params, cfg, toks, cuda)
    card_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    want = LC.run_live(params, cfg, toks, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(want).max())
    rel = LC.spread(got, want)
    if not (np.isfinite(got).all() and got.shape == want.shape and rel <= LC.LIVE_RTOL):
        raise AssertionError(f"[arch] live MPT on the card against the CPU: {rel:.4g} of "
                             f"max|logit| {scale} (tol {LC.LIVE_RTOL})")
    if launches["cell_attention"] != LC.STEPS * cfg.n_layers:
        raise AssertionError(f"[arch] live MPT: {launches['cell_attention']} cell-attention "
                             f"launches, want {LC.STEPS * cfg.n_layers} (the single-token steps)")
    # the spread one other f32 order makes, at this width on the card: its
    # own run with every quantized matmul moved by 3e-7, against its plain run
    with LC.perturbed_matmuls():
        order = LC.spread(LC.run_live(params, cfg, toks, cuda), got)
    faults = {}
    for name in LC.FAULTS:
        with LC.fault(name):
            faults[name] = LC.spread(LC.run_live(params, cfg, toks, cuda), want)
    missed = [n for n, v in faults.items() if not v > LC.LIVE_RTOL]
    argmax = float((got.argmax(1) == want.argmax(1)).mean())
    log(f"[arch] live {cfg.n_layers}L MPT (non-zero attn_output): {LC.PREFILL}-token prefill + "
        f"{LC.STEPS} steps, card vs CPU {rel:.4g} of max|logit| {scale:.4g} (tol "
        f"{LC.LIVE_RTOL}), argmax equal on {argmax:.3f} of rows; card {card_s:.1f} s, CPU "
        f"{cpu_s:.1f} s; launches {launches}; another f32 order on the card {order:.4g}")
    log("[arch] live MPT on the card under each fault, against the CPU: " + ", ".join(
        f"{n} {v:.4g}" for n, v in faults.items()) + " of max|logit|")
    if missed:
        raise AssertionError(f"[arch] live MPT: the {LC.LIVE_RTOL} bar lets {missed} through")
    del params
    gc.collect()
    return dict(label="arch_live", n_layers=cfg.n_layers, max_logit=scale, rel_err=rel,
                tol=LC.LIVE_RTOL, argmax_equal=argmax, f32_order=order, faults=faults,
                launches=launches)


def run_arch_toys(counters: dict, out_dir: Path) -> dict:
    """The other architectures at toy widths (2 layers, n_embd 256, f32
    weights from a seed) through a 512-cell context on the card, whose T =
    1 steps take the cell kernel, against the port on the CPU: logits
    within TOY_RTOL of max|logit|."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
    from pipeinfer_tpu_torch.tools import testmodel

    out_dir.mkdir(parents=True, exist_ok=True)
    res = {}
    for name, (arch, kw) in TOY_ARCHS.items():
        path = testmodel.build_tiny_arch(out_dir / f"{name}.gguf", arch, seed=SEED, n_layers=2,
                                         n_embd=256, n_heads=4, n_ff=1024, n_vocab=1024, **kw)
        params, cfg = load_model(path)
        outs, launches = [], None
        for d in ("cuda", "cpu"):
            for c in counters.values():
                c.launches = 0
            ctx = InferenceContext(params, cfg, n_cells=512, device=d)
            b = Batch()
            for i, t in enumerate([1, 17, 200, 33, 5, 9, 71, 8, 99]):
                b.add(t, i, 0)
            rows = [ctx.decode(b)]
            for j in range(8):
                b = Batch()
                b.add(40 + j, 9 + j, 0)
                rows.append(ctx.decode(b))
            outs.append(np.concatenate(rows))
            if launches is None:
                launches = {k: c.launches for k, c in counters.items()}
        scale = float(np.abs(outs[1]).max())
        err = float(np.abs(outs[0] - outs[1]).max())
        if not (np.isfinite(outs[0]).all() and err <= TOY_RTOL * scale):
            raise AssertionError(f"[arch] {name} on the card against the CPU: max err {err} "
                                 f"(max|logit| {scale}, tol {TOY_RTOL} of it)")
        if launches["cell_attention"] != 8 * cfg.n_layers:
            raise AssertionError(f"[arch] {name}: {launches['cell_attention']} cell-attention "
                                 f"launches, want {8 * cfg.n_layers}")
        res[name] = dict(max_abs_err=err, max_logit=scale, rel_err=err / scale,
                         cell_attention=launches["cell_attention"], heads=cfg.n_heads,
                         kv_heads=cfg.n_kv_heads, rope=cfg.rope_mode, rope_dims=cfg.rope_dims,
                         alibi=cfg.max_alibi_bias)
        log(f"[arch] {name:9s} ({cfg.n_heads}/{cfg.n_kv_heads} heads, rope {cfg.rope_mode} "
            f"{cfg.rope_dims}, ALiBi {cfg.max_alibi_bias}): card vs CPU {err / scale:.3g} of "
            f"max|logit| (tol {TOY_RTOL}); cell attention {launches['cell_attention']} launches")
    return dict(label="arch_toys", tol=TOY_RTOL, archs=res)


def run_arch_clis(counters: dict, pair, n_predict: int) -> dict:
    """cli.main, cli.speculative --stages 2 --engine controller -np 1,
    cli.pipeline --layer-split 0.5,0.5 and cli.lookahead, in process on the
    MPT pair as a user runs them (without --device), then one `python -m
    pipeinfer_tpu_torch.cli.pipeline` subprocess: the same text from all
    five."""
    from pipeinfer_tpu_torch.cli import lookahead as cli_lookahead
    from pipeinfer_tpu_torch.cli import main as cli_main
    from pipeinfer_tpu_torch.cli import pipeline as cli_pipeline
    from pipeinfer_tpu_torch.cli import speculative as cli_spec

    t_path, d_path = map(str, pair)
    common = ["-m", t_path, "-p", CLI_PROMPT, "-n", str(n_predict), *CLI_GREEDY]
    split = ["--layer-split", "0.5,0.5"]
    calls = {
        "speculative_stages2": (cli_spec.main, ["-md", d_path, "--stages", "2", "--engine",
                                                "controller", "-np", "1"]),
        "pipeline": (cli_pipeline.main, split),
        "lookahead": (cli_lookahead.main, []),
    }
    res = dict(label="arch_clis", n_predict=n_predict, launches={})
    with _layout(None):
        want, res["main_s"] = _cli_text(cli_main.main, common)
        for name, (entry, extra) in calls.items():
            for c in counters.values():
                c.launches = 0
            got, res[f"{name}_s"] = _cli_text(entry, common + extra)
            res["launches"][name] = {k: c.launches for k, c in counters.items()}
            if got != want:
                raise AssertionError(f"[arch cli {name}] printed {got[-200:]!r}, cli.main "
                                     f"{want[-200:]!r}")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pipeinfer_tpu_torch.cli.pipeline",
                               *common, *split], cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        res["subprocess_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m pipeinfer_tpu_torch.cli.pipeline exited "
                             f"{proc.returncode}:\n{proc.stderr[-2000:]}")
    if proc.stdout != want:
        raise AssertionError(f"[arch cli subprocess] printed {proc.stdout[-200:]!r}, cli.main "
                             f"{want[-200:]!r}")
    res.update(chars=len(want), text_sha256=hashlib.sha256(want.encode()).hexdigest())
    log(f"[arch] cli.main, cli.speculative --stages 2, cli.pipeline, cli.lookahead and the "
        f"pipeline subprocess print the same {len(want)} characters ("
        + ", ".join(f"{k} {v:.1f}" for k, v in res.items() if k.endswith("_s")) + " s)")
    return res


def run_arch(counters: dict, records: dict, n_predict: int) -> list:
    """The arch phase after its kernel checks: the streams, the CLIs, the
    toy architectures and the live model. Returns its run records and adds
    each kernel's launches per arch run to its record."""
    from pipeinfer_tpu_torch.tools.benchpair import cached_mpt_pair

    bench = ROOT / "build" / "bench"
    # the target is built as deep as its draft (the pair's stream does not
    # depend on its depth): the streams and the CLIs, which load it six
    # times, take a few seconds a load
    t_path, d_path, live_path = cached_mpt_pair(bench, ARCH_EPS, n_layers=ARCH_DEPTH, log=log)
    runs = [run_arch_streams(counters, (t_path, d_path), n_predict),
            run_arch_clis(counters, (t_path, d_path), ARCH_CLI_N),
            run_arch_toys(counters, bench / "toy_archs"),
            run_arch_live(counters, live_path)]
    per_run = {f"{name}": row["launches"] for name, row in runs[0]["engines"].items()}
    per_run.update({f"cli_{k}": v for k, v in runs[1]["launches"].items()})
    per_run["live"] = runs[3]["launches"]
    for k, rec in records.items():
        rec["launches_arch"] = {run: n[k] for run, n in per_run.items()}
        if not rec.get("launches"):  # an arch-only run: the MPT controller's count
            rec["launches"] = per_run["controller"][k]
    return runs


# ---------------------------------------------------------------------------
# tools: the tools that run a model and the session state, at 7B width
# ---------------------------------------------------------------------------

TOOLS_M = 512  # rows of a perplexity window and of pp512: the 512 prefill bucket
TOOLS_I4G = ("wqkv", "w_down", "output")  # at M = 512 the fused wqkv and the head take 1 split
# the toy Q6_K pair's widest tensor (its fused gate+up) and its head, through i8g
TOOLS_I8G = {"toy_wgu": (5632, 1024), "toy_output": (32000, 1024)}
TOOLS_N_CELLS = 1024  # what the perplexity CLI makes of n_ctx 512 (+ 8, rounded to 512s)
TOOLS_PROMPT_LEN = 32
TOOLS_BEAM_N, TOOLS_BATCHED_N = 16, 32
TOOLS_STATE_PREFILL, TOOLS_STATE_STEPS, TOOLS_STATE_CELLS = 64, 16, 512
TOOLS_BB = dict(pps=[128], tgs=[32], pls=[1, 2, 4, 8])  # batched_bench's grid
TOOLS_LIVE_CTX = 128  # the live model's perplexity windows
TOOLS_EMBED_LEN = 13  # an odd M


def check_tools_shapes(records: dict, details: list):
    """i4g at M = 512 over the 7B's fused wqkv, w_down and head, i8g at M =
    512 over the toy Q6_K pair's fused gate+up and head: each against its
    plain version at MATMUL_RTOL with the bitwise repeat, timed beside its
    plain version, its bound and a bf16 GEMM on the dequantized weight (the
    yardstick); the rows go to each kernel's record under "tools"."""
    import torch

    from pipeinfer_tpu_torch.ops import qmatmul as Q

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    rows: dict = {"i4g_matmul": [], "i8g_matmul": []}
    m = TOOLS_M
    cases = [("i4g", name, I4G_SHAPES[name]) for name in TOOLS_I4G] + \
        [("i8g", name, nk) for name, nk in TOOLS_I8G.items()]
    for layout, name, (n, k) in cases:
        planes = _split_planes(layout, n, k, dev, g, copies_for(
            n * k // 2 if layout == "i4g" else -(-k // 512) * 512 * n))
        x = torch.randn(m, k, device=dev, generator=g)
        kern, plain, ins, name_k, ops = _split_inputs(layout, x, planes)
        err, scale = _check_repeat(kern, plain, ins[0], f"{name_k} {name} M={m}")
        cut = _cut(kern)
        it = iter(range(1 << 30))
        k_ms = gpu_ms(lambda: kern(*ins[next(it) % len(ins)]), iters=10)
        p_ms = gpu_ms(lambda: plain(*ins[0]), iters=2, warmup=1)
        w_bf16 = Q.dequant_T(_split_qt(layout, planes[0], n, k), torch.bfloat16)
        xb = x.to(torch.bfloat16)
        lib_ms = gpu_ms(lambda: xb @ w_bf16, iters=10)
        b_ms, b_by = bound(nbytes(*ins[0]) + m * n * 4, ops, "int8")
        row = dict(kernel=name_k, tensor=name, N=n, K=k, M=m, max_abs_err=err,
                   tol=MATMUL_RTOL * scale, ms=k_ms, plain_ms=p_ms, yardstick_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, plan=cut, phase="tools")
        rows[name_k].append(row)
        details.append(row)
        log(f"{name_k:11s} {name:10s} [{n}x{k}] M={m}: err {err:.3g} (tol "
            f"{MATMUL_RTOL * scale:.3g}), two calls bitwise equal  kernel {k_ms:.4f} ms  plain "
            f"{p_ms:.4f} ms  bf16 GEMM {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  cut {cut}")
        del planes, ins, w_bf16
    torch.cuda.empty_cache()
    for key, src, tpu in (
        ("i4g_matmul", "pipeinfer_tpu_torch/csrc/qmatmul_i4g.cu", "pipeinfer_tpu/ops/qmatmul.py:784"),
        ("i8g_matmul", "pipeinfer_tpu_torch/csrc/qmatmul_i8g.cu", "pipeinfer_tpu/ops/qmatmul.py:923"),
    ):
        keep = ("tensor", "M", "N", "K", "ms", "plain_ms", "yardstick_ms", "bound_ms", "bound_by",
                "max_abs_err")
        tool_rows = [{f: r[f] for f in keep} for r in rows[key]]
        if key not in records:  # a tools-only run: its first shape stands for the kernel
            r = rows[key][0]
            records[key] = dict(name=key, route="cuda", source=src, replaces=tpu, launches=0,
                                max_abs_err=max(x["max_abs_err"] for x in rows[key]),
                                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                                bound_by=r["bound_by"], library_ms=None,
                                yardstick_ms=r["yardstick_ms"],
                                shape=f"tools phase, {tool_rows[0]}")
        records[key]["tools"] = tool_rows


def _vocab_text(tok, n_pieces: int, seed: int) -> str:
    """Text of n_pieces random pieces of the synthetic vocabulary (past its
    3 control and 256 byte tokens)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return tok.decode(rng.integers(259, tok.vocab.n_vocab, n_pieces).tolist())


def _counted(counters: dict, fn):
    """(fn(), launches of each kernel in it): the counts set to 0 just
    before, read just after."""
    import torch

    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def _state_round_trip(params, cfg, prompt, dtype_name: str, path: Path) -> dict:
    """Prefill `prompt`, save the session, load it into a fresh context of
    the same shape; TOOLS_STATE_STEPS greedy single-token steps (the cell
    kernel over TOOLS_STATE_CELLS cells) from the live and the restored
    context give the same tokens and bitwise equal logits."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.runtime import state as rstate
    from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext

    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32

    def ctx():
        return InferenceContext(params, cfg, n_cells=TOOLS_STATE_CELLS, cache_dtype=dtype)

    live = ctx()
    b = Batch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    first = int(np.argmax(live.decode(b)[-1]))
    t0 = time.perf_counter()
    rstate.save_state(live, path, tokens=prompt)
    save_s = time.perf_counter() - t0
    restored = ctx()
    t0 = time.perf_counter()
    if rstate.load_state(restored, path) != prompt:
        raise AssertionError(f"[tools] state {dtype_name}: the session's tokens differ")
    load_s = time.perf_counter() - t0
    runs = []
    for c in (live, restored):
        tok, out, rows = first, [], []
        for i in range(TOOLS_STATE_STEPS):
            bb = Batch()
            bb.add(tok, len(prompt) + i, 0)
            rows.append(c.decode(bb)[0])
            tok = int(np.argmax(rows[-1]))
            out.append(tok)
        runs.append((out, np.stack(rows)))
    if runs[0][0] != runs[1][0]:
        raise AssertionError(f"[tools] state {dtype_name}: the restored stream {runs[1][0]} "
                             f"differs from the live one {runs[0][0]}")
    diff = float(np.abs(runs[0][1] - runs[1][1]).max())
    if diff != 0.0:
        raise AssertionError(f"[tools] state {dtype_name}: the restored logits differ from the "
                             f"live ones by up to {diff}")
    size = path.stat().st_size
    log(f"[tools] state round trip, {dtype_name} cache, {len(prompt)}-token prefill: save "
        f"{save_s:.2f} s, load {load_s:.2f} s ({size / 2**20:.1f} MiB); {TOOLS_STATE_STEPS} "
        f"greedy steps from the live and the restored context: equal tokens, bitwise equal "
        f"logits")
    return dict(cache=dtype_name, save_s=save_s, load_s=load_s, file_bytes=size,
                tokens=runs[0][0])


def run_tools_7b(counters: dict, t_path: Path, work: Path) -> dict:
    """On the full-depth 7B Q4_K target, loaded once: perplexity over two
    512-token windows (i4g at M = 512), bench's pp512 and tg128, the
    batched_bench grid, beam search with 1 and 4 beams, 4 batched greedy
    continuations, one embedding and the session state round trip over a
    bf16 and an f32 cache."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.cli.main import build_context
    from pipeinfer_tpu_torch.ops import qmatmul as Q
    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
    from pipeinfer_tpu_torch.tools import batched_bench as BB
    from pipeinfer_tpu_torch.tools import bench as B
    from pipeinfer_tpu_torch.tools.batched import batched_generate
    from pipeinfer_tpu_torch.tools.beam_search import beam_search
    from pipeinfer_tpu_torch.tools.embedding import embed_text
    from pipeinfer_tpu_torch.tools.perplexity import perplexity

    t0 = time.perf_counter()
    ctx, tok = build_context(str(t_path), TOOLS_N_CELLS)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    params, cfg = ctx.params, ctx.cfg
    log(f"[tools] loaded the {cfg.n_layers}L 7B target ({ctx.n_cells} cells) in {load_s:.1f} s")
    res = dict(label="tools_7b", load_s=load_s, launches={})

    text = _vocab_text(tok, 2 * TOOLS_M + 96, SEED + 7)
    perplexity(ctx, tok, _vocab_text(tok, TOOLS_M + 32, SEED), n_ctx=TOOLS_M)  # warm-up
    t1 = time.perf_counter()
    (ppl, n), res["launches"]["perplexity"] = _counted(
        counters, lambda: perplexity(ctx, tok, text, n_ctx=TOOLS_M))
    ppl_s = time.perf_counter() - t1
    windows = n // (TOOLS_M - 1 - TOOLS_M // 2)
    cut = Q.i4g_matmul.last_plan
    if not (math.isfinite(ppl) and ppl > 1 and windows >= 2):
        raise AssertionError(f"[tools] perplexity {ppl} over {n} tokens ({windows} windows)")
    if res["launches"]["perplexity"]["i4g_matmul"] == 0 or cut.rows * cut.row_tiles < TOOLS_M:
        raise AssertionError(f"[tools] perplexity did not run i4g at M = {TOOLS_M}: launches "
                             f"{res['launches']['perplexity']}, last cut {cut}")
    res["perplexity"] = dict(ppl=ppl, n_scored=n, windows=windows, seconds=ppl_s,
                             windows_per_s=windows / ppl_s, i4g_cut=cut._asdict())
    log(f"[tools] perplexity (7B Q4_K, n_ctx {TOOLS_M}): ppl = {ppl:.4f} over {n} tokens, "
        f"{windows} windows in {ppl_s:.2f} s ({windows / ppl_s:.2f} windows/s); i4g at M = "
        f"{TOOLS_M} {res['launches']['perplexity']['i4g_matmul']} launches, cut {cut}")

    (pp, tg), res["launches"]["bench"] = _counted(
        counters, lambda: (B.bench_pp(ctx, TOOLS_M, reps=3), B.bench_tg(ctx, 128, reps=3)))
    res["bench"] = {f"pp{TOOLS_M}": pp, "tg128": tg}
    log(f"[tools] bench: pp{TOOLS_M} {pp:.2f} t/s, tg128 {tg:.2f} t/s (best of 3)")

    lines: list = []
    rows, res["launches"]["batched_bench"] = _counted(
        counters, lambda: BB.grid(ctx, TOOLS_BB["pps"], TOOLS_BB["tgs"], TOOLS_BB["pls"], True,
                                  out=lines.append))
    res["batched_bench"] = rows
    for line in lines:
        log(f"[tools] {line}")

    def fresh():
        return InferenceContext(params, cfg, n_cells=TOOLS_N_CELLS)

    rng = np.random.default_rng(SEED)
    prompt = [1] + rng.integers(3, cfg.n_vocab, TOOLS_PROMPT_LEN - 1).tolist()
    want, _ = _greedy(fresh(), prompt, TOOLS_BATCHED_N, chain=False)
    (b1, b4), res["launches"]["beam_search"] = _counted(counters, lambda: (
        beam_search(fresh(), prompt, TOOLS_BEAM_N, n_beams=1, eos_id=-1),
        beam_search(fresh(), prompt, TOOLS_BEAM_N, n_beams=4, eos_id=-1)))
    scores = [s for s, _ in b4]
    if b1[0][1] != want[:TOOLS_BEAM_N]:
        raise AssertionError(f"[tools] the 1-beam stream {b1[0][1]} differs from plain greedy "
                             f"{want[:TOOLS_BEAM_N]}")
    if len(b4) != 4 or scores != sorted(scores, reverse=True):
        raise AssertionError(f"[tools] 4 beams: scores {scores} not sorted best first")
    res["beam_search"] = dict(one_beam_score=b1[0][0], scores=scores,
                              best_equals_greedy=b4[0][1] == want[:TOOLS_BEAM_N])
    log(f"[tools] beam search, {TOOLS_BEAM_N} tokens: 1 beam == plain greedy; 4 beams sorted, "
        f"scores {', '.join(f'{s:.3f}' for s in scores)}")

    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    outs, res["launches"]["batched"] = _counted(
        counters, lambda: batched_generate(fresh(), prompt, TOOLS_BATCHED_N, 4, greedy, eos_id=-1))
    if outs != [want] * 4:
        raise AssertionError(f"[tools] batched: {outs} against plain greedy {want}")
    log(f"[tools] batched: 4 greedy continuations of {TOOLS_BATCHED_N} tokens, each == plain "
        f"greedy")

    emb, res["launches"]["embedding"] = _counted(
        counters, lambda: embed_text(params, cfg, prompt[:TOOLS_EMBED_LEN]))
    norm = float(np.linalg.norm(emb))
    if not (emb.shape == (cfg.n_embd,) and np.isfinite(emb).all() and abs(norm - 1) < 1e-4):
        raise AssertionError(f"[tools] embedding: shape {emb.shape}, norm {norm}")
    res["embedding"] = dict(n_embd=cfg.n_embd, norm=norm, tokens=TOOLS_EMBED_LEN)
    log(f"[tools] embedding of {TOOLS_EMBED_LEN} tokens: [{cfg.n_embd}], norm {norm:.6f}")

    state_prompt = [1] + rng.integers(3, cfg.n_vocab, TOOLS_STATE_PREFILL - 1).tolist()
    res["state"] = []
    for dtype_name in ("bf16", "f32"):
        row, res["launches"][f"state_{dtype_name}"] = _counted(counters, lambda: _state_round_trip(
            params, cfg, state_prompt, dtype_name, work / f"state_{dtype_name}.npz"))
        res["state"].append(row)
    del ctx, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_tools_q6k(counters: dict, path: Path) -> dict:
    """Perplexity over two 512-token windows on the toy Q6_K target: every
    matmul through i8g at M = 512."""
    import torch

    from pipeinfer_tpu_torch.cli.main import build_context
    from pipeinfer_tpu_torch.tools.perplexity import perplexity

    ctx, tok = build_context(str(path), TOOLS_M + 8)
    text = _vocab_text(tok, 2 * TOOLS_M + 96, SEED + 8)
    t0 = time.perf_counter()
    (ppl, n), launches = _counted(counters, lambda: perplexity(ctx, tok, text, n_ctx=TOOLS_M))
    took = time.perf_counter() - t0
    windows = n // (TOOLS_M - 1 - TOOLS_M // 2)
    if not (math.isfinite(ppl) and windows >= 2 and launches["i8g_matmul"] > 0):
        raise AssertionError(f"[tools] toy Q6_K perplexity {ppl}, {windows} windows, launches "
                             f"{launches}")
    log(f"[tools] perplexity (toy Q6_K, n_ctx {TOOLS_M}): ppl = {ppl:.4f} over {n} tokens, "
        f"{windows / took:.2f} windows/s; i8g {launches['i8g_matmul']} launches")
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    return dict(label="tools_q6k", ppl=ppl, n_scored=n, windows=windows, seconds=took,
                windows_per_s=windows / took, launches=launches)


def run_tools_prompt_cache(counters: dict, cli_target: Path, work: Path) -> dict:
    """cli.main --prompt-cache twice on the target cut to CLI_DEPTH layers:
    the same text; the first run prefills the prompt, the second restores
    it and decodes only the last prompt token again."""
    from pipeinfer_tpu_torch.cli import main as cli_main

    f = work / "prompt_cache.npz"
    f.unlink(missing_ok=True)
    argv = ["-m", str(cli_target), "-p", CLI_PROMPT, "-n", "16", *CLI_GREEDY,
            "--prompt-cache", str(f)]
    runs = []
    for _ in range(2):
        err = io.StringIO()
        (text, took), launches = _counted(counters, lambda: _cli_text(cli_main.main, argv, err))
        runs.append((text, took, err.getvalue(), launches))
    if runs[0][0] != runs[1][0]:
        raise AssertionError(f"[tools] --prompt-cache: the second run printed {runs[1][0]!r}, the "
                             f"first {runs[0][0]!r}")
    if "prefill:" not in runs[0][2] or "prefill:" in runs[1][2]:
        raise AssertionError(f"[tools] --prompt-cache: the second run did not skip the cached "
                             f"prefix (stderr {runs[0][2]!r}, then {runs[1][2]!r})")
    log(f"[tools] cli.main --prompt-cache twice ({CLI_DEPTH}-layer target): the same "
        f"{len(runs[0][0])} characters ({runs[0][1]:.1f} s, then {runs[1][1]:.1f} s); the second "
        f"skipped the cached prefix ({runs[1][2].strip().splitlines()[-1]})")
    return dict(label="tools_prompt_cache", chars=len(runs[0][0]), seconds=[r[1] for r in runs],
                stderr=[r[2] for r in runs], launches=runs[1][3])


def run_tools_shapebench(counters: dict) -> dict:
    """shapebench --model 7b --draft 1.1b: the synthesized k_major Q4_K
    models' step and chain times against 3.35 TB/s."""
    from pipeinfer_tpu_torch.tools import shapebench as SB

    res, launches = _counted(counters, lambda: SB.probe(
        SB.SHAPES["7b"], SB.SHAPES["1.1b"], name="7b", n_cells=2048, iters=8))
    if launches["kmajor_matmul"] == 0:
        raise AssertionError(f"[tools] shapebench never launched k_major: {launches}")
    log(f"[tools] shapebench --model 7b --draft 1.1b: {json.dumps(res)}")
    return dict(label="tools_shapebench", **res, launches=launches)


def run_tools_live(counters: dict, live_path: Path) -> dict:
    """The 2-layer live llama at 7B width: perplexity at n_ctx
    TOOLS_LIVE_CTX over two windows and one embedding on the card, against
    the port on the CPU on the same weight planes, within
    live_check.LIVE_PPL_RTOL and LIVE_EMBED_ATOL; the card's own run with
    every matmul moved by 3e-7 shows one other f32 order's spread, and each
    of live_check.MASK_FAULTS on the card must land past the bars."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.gguf.reader import GGUFReader
    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.runtime.context import InferenceContext, _params_to
    from pipeinfer_tpu_torch.tokenizer import tokenizer_from_gguf
    from pipeinfer_tpu_torch.tools import live_check as LC
    from pipeinfer_tpu_torch.tools.embedding import embed_text
    from pipeinfer_tpu_torch.tools.perplexity import perplexity

    params, cfg = load_model(live_path)
    cpu_params = _params_to(params, torch.device("cpu"))
    with GGUFReader(live_path) as r:
        tok = tokenizer_from_gguf(r)
    text = _vocab_text(tok, 2 * TOOLS_LIVE_CTX + 64, SEED + 9)
    ids = tok.encode(text, add_bos=True)[:TOOLS_EMBED_LEN]

    def run(p, device):
        ctx = InferenceContext(p, cfg, n_cells=TOOLS_LIVE_CTX + 8, device=device)
        return perplexity(ctx, tok, text, n_ctx=TOOLS_LIVE_CTX)[0], embed_text(p, cfg, ids)

    (ppl, emb), launches = _counted(counters, lambda: run(params, "cuda"))
    t0 = time.perf_counter()
    ppl_cpu, emb_cpu = run(cpu_params, "cpu")
    cpu_s = time.perf_counter() - t0

    def spread(p, e):
        return abs(p / ppl_cpu - 1), float(np.abs(e - emb_cpu).max())

    rel, emb_err = spread(ppl, emb)
    with LC.perturbed_matmuls():
        p2, e2 = run(params, "cuda")
    order = (abs(p2 / ppl - 1), float(np.abs(e2 - emb).max()))
    faults = {}
    for name in LC.MASK_FAULTS:
        with LC.mask_fault(name):
            faults[name] = spread(*run(params, "cuda"))
    log(f"[tools] live {cfg.n_layers}L llama at 7B width: ppl card {ppl:.6f}, CPU {ppl_cpu:.6f} "
        f"(relative {rel:.3g}, bar {LC.LIVE_PPL_RTOL}); embedding max diff {emb_err:.3g} (bar "
        f"{LC.LIVE_EMBED_ATOL}); another f32 order on the card {order[0]:.3g} / {order[1]:.3g}; "
        f"CPU {cpu_s:.1f} s; launches {launches}")
    log("[tools] live llama on the card under each mask fault, against the CPU (ppl relative / "
        "embedding): " + ", ".join(f"{n} {a:.3g} / {b:.3g}" for n, (a, b) in faults.items()))
    if not (math.isfinite(ppl) and rel <= LC.LIVE_PPL_RTOL and emb_err <= LC.LIVE_EMBED_ATOL):
        raise AssertionError(f"[tools] live llama card against CPU: ppl {rel:.4g} (bar "
                             f"{LC.LIVE_PPL_RTOL}), embedding {emb_err:.4g} (bar "
                             f"{LC.LIVE_EMBED_ATOL})")
    missed = [n for n, (a, b) in faults.items()
              if not (a > LC.LIVE_PPL_RTOL and b > LC.LIVE_EMBED_ATOL)]
    if missed:
        raise AssertionError(f"[tools] live llama: the bars let {missed} through")
    del params, cpu_params
    gc.collect()
    return dict(label="tools_live", ppl=ppl, ppl_cpu=ppl_cpu, ppl_rel=rel, embed_err=emb_err,
                ppl_rtol=LC.LIVE_PPL_RTOL, embed_atol=LC.LIVE_EMBED_ATOL, f32_order=order,
                faults=faults, launches=launches, cpu_s=cpu_s)


def run_tools(counters: dict, records: dict) -> list:
    """The tools phase after its kernel checks. Returns its run records and
    adds each kernel's launches per tools run to its record."""
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair, cached_llama_live, cut_depth

    bench = ROOT / "build" / "bench"
    work = ROOT / "build" / "tools"
    work.mkdir(parents=True, exist_ok=True)
    t_path, _ = cached_bench_pair(bench, "7b", "Q4_K", 0.02, log=log)
    cli_target = cut_depth(t_path, t_path.with_name(f"target_d{CLI_DEPTH}.gguf"), CLI_DEPTH,
                           log=log)
    runs = [run_tools_7b(counters, t_path, work),
            run_tools_q6k(counters, cached_bench_pair(bench, "toy", "Q6_K", 0.02, log=log)[0]),
            run_tools_prompt_cache(counters, cli_target, work),
            run_tools_shapebench(counters),
            run_tools_live(counters, cached_llama_live(t_path, log=log))]
    per_run = {f"7b_{k}": v for k, v in runs[0]["launches"].items()}
    per_run.update({"q6k_perplexity": runs[1]["launches"], "prompt_cache": runs[2]["launches"],
                    "shapebench": runs[3]["launches"], "live": runs[4]["launches"]})
    for k in ("i4g_matmul", "i8g_matmul", "cell_attention", "kmajor_matmul"):
        if not any(n[k] for n in per_run.values()):
            raise AssertionError(f"[tools] no tools run launched {k}")
    for k, rec in records.items():
        rec["launches_tools"] = {run: n[k] for run, n in per_run.items()}
        if not rec.get("launches"):  # a tools-only run: the phase's count
            rec["launches"] = sum(n[k] for n in per_run.values())
    return runs


# ---------------------------------------------------------------------------
# train: fine-tuning, LoRA, quantization of the result and --lora, at 7B width
# ---------------------------------------------------------------------------

TRAIN_GRAD_BT = (2, 64)  # the card-against-CPU gradient check's batch
TRAIN_BT = (4, 128)  # finetune's and lora's defaults
TRAIN_STEPS, TRAIN_CKPT = 20, 10  # the resume restarts at step TRAIN_CKPT
TRAIN_LR = 1e-4  # finetune's default
TRAIN_RESUME_RTOL = 1e-4  # the resumed run's losses against the uninterrupted run's
LORA_RANK, LORA_STEPS, LORA_LR = 8, 20, 5e-3  # tests/test_lora.py's learning rate
TRAIN_PIECES, TRAIN_REPEATS = 256, 8  # the corpus: 256 random vocabulary pieces, 8 times over
TRAIN_PPL_CTX = 128
TRAIN_CLI_N = 32


def _loss_and_grads(params, cfg, toks):
    """(lm_loss, every parameter's gradient) in tree-flatten order."""
    from pipeinfer_tpu_torch.models.train import lm_loss
    from pipeinfer_tpu_torch.tools.finetune import tree_leaves, value_and_grad

    loss, grads = value_and_grad(lambda: lm_loss(params, cfg, toks), tree_leaves(params))
    return float(loss), grads


def _grad_spread(got, want) -> tuple[float, list[float]]:
    """(|loss / loss_ref - 1|, each tensor's max|g - g_ref| / max|g_ref|),
    on the device of `got`."""
    rel = [float((g - w.to(g.device)).abs().max() / w.abs().max())
           for g, w in zip(got[1], want[1])]
    return abs(got[0] / want[0] - 1), rel


def _leaf_names(params) -> list[str]:
    """The params' names in tree_leaves order (sorted keys, layers first)."""
    return [f"layers.{i}.{k}" for i, lp in enumerate(params["layers"]) for k in sorted(lp)] + \
        sorted(k for k in params if k != "layers")


def run_train_grads(counters: dict, dense, cfg, stream) -> dict:
    """lm_loss and its gradient at TRAIN_GRAD_BT on the card against the
    port on the CPU over the card's own dense weights; the card's run with
    every product moved by 3e-7 (another f32 order) and each of
    live_check.TRAIN_FAULTS on the card, each against the CPU."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.runtime.context import _params_to
    from pipeinfer_tpu_torch.tools import live_check as LC
    from pipeinfer_tpu_torch.tools.finetune import batch_at

    b, t = TRAIN_GRAD_BT
    toks = batch_at(stream, np.random.default_rng(SEED).integers(0, len(stream) - t - 1, b), t)
    t0 = time.perf_counter()
    card, launches = _counted(counters, lambda: _loss_and_grads(dense, cfg, toks))
    card_s = time.perf_counter() - t0
    cpu_params = _params_to(dense, torch.device("cpu"))
    t0 = time.perf_counter()
    ref = _loss_and_grads(cpu_params, cfg, toks)
    cpu_s = time.perf_counter() - t0
    del cpu_params
    ref = (ref[0], [g.to(dense["output"].device) for g in ref[1]])  # the spreads on the card
    gc.collect()
    loss_rel, per_tensor = _grad_spread(card, ref)
    spread = (loss_rel, max(per_tensor))
    worst = _leaf_names(dense)[per_tensor.index(spread[1])]
    with LC.perturbed_matmuls():
        loss_o, grads_o = _grad_spread(_loss_and_grads(dense, cfg, toks), card)
    order = (loss_o, max(grads_o))
    faults = {}
    for name in LC.TRAIN_FAULTS:
        with LC.train_fault(name):
            loss_f, grads_f = _grad_spread(_loss_and_grads(dense, cfg, toks), ref)
        faults[name] = (loss_f, max(grads_f))
    log(f"[train] lm_loss and gradient at B = {b}, T = {t}: loss card {card[0]:.6f}, CPU "
        f"{ref[0]:.6f} (relative {spread[0]:.3g}, bar {LC.TRAIN_LOSS_RTOL}); each tensor's max "
        f"|card - CPU| / max|CPU| at most {spread[1]:.3g} ({worst}; bar {LC.TRAIN_GRAD_RTOL}); "
        f"another f32 order on the card {order[0]:.3g} / {order[1]:.3g}; card {card_s:.2f} s, "
        f"CPU {cpu_s:.1f} s")
    log("[train] the training forward under each fault, on the card against the CPU (loss / "
        "gradients): " + ", ".join(f"{n} {a:.3g} / {g:.3g}" for n, (a, g) in faults.items()))
    if not (math.isfinite(card[0]) and spread[0] <= LC.TRAIN_LOSS_RTOL
            and spread[1] <= LC.TRAIN_GRAD_RTOL):
        raise AssertionError(f"[train] card against CPU: loss {spread[0]:.4g} (bar "
                             f"{LC.TRAIN_LOSS_RTOL}), gradients {spread[1]:.4g} (bar "
                             f"{LC.TRAIN_GRAD_RTOL})")
    missed = [n for n, (a, g) in faults.items()
              if not (a > LC.TRAIN_LOSS_RTOL and g > LC.TRAIN_GRAD_RTOL)]
    if missed:
        raise AssertionError(f"[train] the gradient bars let {missed} through")
    return dict(label="train_grads", B=b, T=t, loss=card[0], loss_cpu=ref[0], loss_rel=spread[0],
                grad_rel=spread[1], grad_rel_per_tensor=dict(zip(_leaf_names(dense), per_tensor)),
                loss_rtol=LC.TRAIN_LOSS_RTOL, grad_rtol=LC.TRAIN_GRAD_RTOL,
                f32_order=order, faults=faults, card_s=card_s, cpu_s=cpu_s, launches=launches)


def run_train_finetune(counters: dict, dense, cfg, stream, kv: dict, work: Path) -> dict:
    """finetune.train for TRAIN_STEPS steps at TRAIN_BT (the loss must fall
    below 0.9x step 0's), then the first TRAIN_CKPT steps again with a
    checkpoint (GGUF + .opt.npz) and a fresh `train` resumed from the two
    files, whose steps must be within TRAIN_RESUME_RTOL of the
    uninterrupted run's. Writes the trained model to work/trained.gguf."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.tools.finetune import dense_params, save_gguf, train

    b, t = TRAIN_BT
    kw = dict(seq_len=t, batch=b, lr=TRAIN_LR, log=lambda s: log(f"[train] {s}"), extra_kv=kv)
    stamps = {}

    def stamp(line):  # when step 0's and the last step's losses reached the host
        stamps[line.split(":")[0]] = time.perf_counter()
        log(f"[train] {line}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (trained, full), launches = _counted(counters, lambda: train(
        dense, cfg, stream, steps=TRAIN_STEPS, **dict(kw, log=stamp)))
    took = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = (stamps[f"step {TRAIN_STEPS - 1}"] - stamps["step 0"]) / (TRAIN_STEPS - 1)
    tok_s = b * t / steady
    if not (all(math.isfinite(x) for x in full) and full[-1] < 0.9 * full[0]):
        raise AssertionError(f"[train] finetune's loss did not fall below 0.9x: {full}")
    log(f"[train] finetune, {TRAIN_STEPS} steps of {b} x {t} tokens (lr {TRAIN_LR}): loss "
        f"{full[0]:.4f} -> {full[-1]:.4f} in {took:.2f} s; steps 1-{TRAIN_STEPS - 1} "
        f"{steady * 1e3:.1f} ms each ({tok_s:.0f} tokens/s); peak {peak:.2f} GiB allocated; "
        f"launches {launches}")
    out = work / "trained.gguf"
    t0 = time.perf_counter()
    save_gguf(trained, cfg, out, kv)
    save_s = time.perf_counter() - t0
    del trained
    gc.collect()
    torch.cuda.empty_cache()

    ckpt = work / "ckpt.gguf"
    t0 = time.perf_counter()
    _, first = train(dense, cfg, stream, steps=TRAIN_CKPT, ckpt_every=TRAIN_CKPT,
                     ckpt_path=str(ckpt), **kw)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rp, rcfg = load_model(ckpt, fuse=False)
    rp = dense_params(rp)
    _, rest = train(rp, rcfg, stream, steps=TRAIN_STEPS, resume_opt=str(ckpt) + ".opt.npz", **kw)
    resume_s = time.perf_counter() - t0
    ckpt_bytes = ckpt.stat().st_size + Path(str(ckpt) + ".opt.npz").stat().st_size
    del rp
    for f in (ckpt, Path(str(ckpt) + ".opt.npz")):
        f.unlink()
    gc.collect()
    torch.cuda.empty_cache()
    resumed = np.array(first + rest)
    dev = float(np.abs(resumed / np.array(full) - 1).max())
    log(f"[train] checkpoint after step {TRAIN_CKPT - 1} ({ckpt_bytes / 2**30:.2f} GiB, "
        f"{first_s:.1f} s with its {TRAIN_CKPT} steps), resumed in a fresh train "
        f"({resume_s:.1f} s, the load included): steps {TRAIN_CKPT}-{TRAIN_STEPS - 1} "
        f"{', '.join(f'{x:.4f}' for x in rest[:3])}, ... against the uninterrupted run's "
        f"within {dev:.3g} relative (bar {TRAIN_RESUME_RTOL})")
    if len(rest) != TRAIN_STEPS - TRAIN_CKPT or dev > TRAIN_RESUME_RTOL:
        raise AssertionError(f"[train] the resumed run's losses {first + rest} against the "
                             f"uninterrupted {full}")
    return dict(label="train_finetune", B=b, T=t, lr=TRAIN_LR, losses=full, resumed=first + rest,
                resume_rel=dev, seconds=took, step_ms=steady * 1e3, tokens_per_s=tok_s,
                peak_gib=peak,
                save_s=save_s, ckpt_bytes=ckpt_bytes, first_s=first_s, resume_s=resume_s,
                launches=launches, path=str(out))


def run_train_quantized(counters: dict, trained: Path, text: str, ppl0: float,
                        work: Path) -> dict:
    """The trained model quantized to Q4_K by tools.quantize, its
    perplexity of the corpus on the card (i4g) below the untrained live
    llama's, and cli.main -c 1024 on it launching i4g and cell attention."""
    from pipeinfer_tpu_torch.cli import main as cli_main
    from pipeinfer_tpu_torch.cli.main import build_context
    from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
    from pipeinfer_tpu_torch.tools.perplexity import perplexity
    from pipeinfer_tpu_torch.tools.quantize import quantize_file

    q4k = work / "trained_q4k.gguf"
    t0 = time.perf_counter()
    quantize_file(str(trained), str(q4k), GGMLQuantType.Q4_K)
    quant_s = time.perf_counter() - t0
    trained.unlink()
    ctx, tok = build_context(str(q4k), TRAIN_PPL_CTX + 8)
    (ppl, n), launches = _counted(counters, lambda: perplexity(ctx, tok, text, n_ctx=TRAIN_PPL_CTX))
    del ctx
    log(f"[train] quantized to Q4_K in {quant_s:.1f} s; perplexity of the corpus (n_ctx "
        f"{TRAIN_PPL_CTX}, i4g): trained {ppl:.4f}, untrained {ppl0:.4f} over {n} tokens; "
        f"launches {launches}")
    if not (math.isfinite(ppl) and ppl < ppl0 and launches["i4g_matmul"] > 0):
        raise AssertionError(f"[train] the trained Q4_K model's perplexity {ppl} (untrained "
                             f"{ppl0}), launches {launches}")
    argv = ["-m", str(q4k), "-p", CLI_PROMPT, "-n", str(TRAIN_CLI_N), *CLI_GREEDY]
    (text_out, cli_s), cli_launches = _counted(counters, lambda: _cli_text(cli_main.main, argv))
    if not (cli_launches["i4g_matmul"] and cli_launches["cell_attention"]):
        raise AssertionError(f"[train] cli.main on the trained model: launches {cli_launches}")
    log(f"[train] cli.main -c 1024 on the trained Q4_K model: {len(text_out)} characters in "
        f"{cli_s:.1f} s (load included); launches {cli_launches}")
    q4k.unlink()
    return dict(label="train_quantized", quantize_s=quant_s, ppl=ppl, ppl_untrained=ppl0,
                n_scored=n, launches=launches, cli_s=cli_s, cli_launches=cli_launches,
                cli_tail=text_out[-120:])


def run_train_lora(counters: dict, dense, cfg, stream, live: Path, work: Path) -> dict:
    """train_lora at rank LORA_RANK on the default targets (the loss must
    fall below 0.9x its first); cli.main --lora on the live llama under the
    default layout (i4g, cell attention); under k_major, cli.main --lora
    and cli.main on the export_lora-merged file print the same text."""
    import torch

    from pipeinfer_tpu_torch.cli import main as cli_main
    from pipeinfer_tpu_torch.tools.export_lora import merge_file
    from pipeinfer_tpu_torch.tools.lora import save_adapter, train_lora

    b, t = TRAIN_BT
    t0 = time.perf_counter()
    (lora, losses), launches = _counted(counters, lambda: train_lora(
        dense, cfg, stream, rank=LORA_RANK, seq_len=t, batch=b, steps=LORA_STEPS, lr=LORA_LR,
        log=lambda s: log(f"[train] lora {s}")))
    took = time.perf_counter() - t0
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < 0.9 * losses[0]):
        raise AssertionError(f"[train] train_lora's loss did not fall below 0.9x: {losses}")
    adapter = work / "lora.gguf"
    save_adapter(adapter, lora, rank=LORA_RANK, alpha=16.0)
    del lora
    torch.cuda.empty_cache()
    log(f"[train] train_lora rank {LORA_RANK}, {LORA_STEPS} steps (lr {LORA_LR}): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} in {took:.2f} s "
        f"({LORA_STEPS * b * t / took:.0f} tokens/s); launches {launches}")

    argv = ["-p", CLI_PROMPT, "-n", str(TRAIN_CLI_N), *CLI_GREEDY]
    (text_i4g, s_i4g), l_i4g = _counted(counters, lambda: _cli_text(
        cli_main.main, ["-m", str(live), "--lora", str(adapter), *argv]))
    if not (l_i4g["i4g_matmul"] and l_i4g["cell_attention"]):
        raise AssertionError(f"[train] cli.main --lora (default layout): launches {l_i4g}")
    merged = work / "merged.gguf"
    t0 = time.perf_counter()
    merge_file(str(live), str(merged), [(str(adapter), 1.0)])
    merge_s = time.perf_counter() - t0
    with _layout("k_major"):
        (text_lora, s_lora), l_lora = _counted(counters, lambda: _cli_text(
            cli_main.main, ["-m", str(live), "--lora", str(adapter), *argv]))
        (text_merged, s_merged), l_merged = _counted(counters, lambda: _cli_text(
            cli_main.main, ["-m", str(merged), *argv]))
    merged.unlink()
    log(f"[train] cli.main --lora, default layout: {len(text_i4g)} characters in {s_i4g:.1f} s, "
        f"launches {l_i4g}; k_major: --lora {s_lora:.1f} s, the export_lora-merged file "
        f"{s_merged:.1f} s (merged in {merge_s:.1f} s), the same text: "
        f"{text_lora == text_merged}; launches {l_lora}, {l_merged}")
    if text_lora != text_merged:
        raise AssertionError(f"[train] k_major: --lora printed {text_lora[-200:]!r}, the merged "
                             f"file {text_merged[-200:]!r}")
    if not (l_lora["kmajor_matmul"] and l_merged["kmajor_matmul"]):
        raise AssertionError(f"[train] k_major runs never launched it: {l_lora}, {l_merged}")
    return dict(label="train_lora", rank=LORA_RANK, losses=losses, seconds=took,
                launches=launches, cli_i4g_s=s_i4g, cli_lora_kmajor_s=s_lora,
                cli_merged_kmajor_s=s_merged, merge_s=merge_s, cli_launches=dict(
                    lora_i4g=l_i4g, lora_kmajor=l_lora, merged_kmajor=l_merged),
                text_tail=text_lora[-120:])


def run_train(counters: dict, records: dict) -> list:
    """The train phase on the 2-layer live llama at 7B width. Returns its
    run records and adds each kernel's launches per train run to its
    record."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.gguf.reader import GGUFReader
    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.tokenizer import tokenizer_from_gguf
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair, cached_llama_live
    from pipeinfer_tpu_torch.tools.finetune import dense_params, tree_leaves, vocab_kv
    from pipeinfer_tpu_torch.tools.perplexity import perplexity

    work = ROOT / "build" / "train"
    work.mkdir(parents=True, exist_ok=True)
    t_path, _ = cached_bench_pair(ROOT / "build" / "bench", "7b", "Q4_K", 0.02, log=log)
    live = cached_llama_live(t_path, log=log)
    t0 = time.perf_counter()
    qparams, cfg = load_model(live, fuse=False)  # training reads split slots
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    with GGUFReader(live) as r:
        tok = tokenizer_from_gguf(r)
    text = _vocab_text(tok, TRAIN_PIECES, SEED + 10) * TRAIN_REPEATS
    stream = np.asarray(tok.encode(text, add_bos=True), np.int32)
    ctx = InferenceContext(qparams, cfg, n_cells=TRAIN_PPL_CTX + 8)
    (ppl0, _), l_ppl0 = _counted(counters, lambda: perplexity(ctx, tok, text,
                                                              n_ctx=TRAIN_PPL_CTX))
    del ctx
    t0 = time.perf_counter()
    dense = dense_params(qparams)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    n_params = sum(x.numel() for x in tree_leaves(dense))
    log(f"[train] live {cfg.n_layers}L llama at 7B width loaded in {load_s:.1f} s, dequantized "
        f"to {n_params / 1e6:.0f} M f32 parameters in {dense_s:.2f} s; corpus {len(stream)} "
        f"tokens; untrained perplexity {ppl0:.4f} (launches {l_ppl0})")
    setup = dict(label="train_setup", load_s=load_s, dense_s=dense_s, n_params=n_params,
                 corpus_tokens=len(stream), ppl_untrained=ppl0, launches=l_ppl0)
    runs = [run_train_grads(counters, dense, cfg, stream)]
    runs.append(run_train_finetune(counters, dense, cfg, stream, vocab_kv(live), work))
    runs.append(run_train_lora(counters, dense, cfg, stream, live, work))
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    runs.append(run_train_quantized(counters, Path(runs[1]["path"]), text, ppl0, work))
    per_run = {"untrained_ppl": l_ppl0, "grads": runs[0]["launches"],
               "finetune": runs[1]["launches"], "lora_train": runs[2]["launches"],
               **{f"cli_{k}": v for k, v in runs[2]["cli_launches"].items()},
               "trained_ppl": runs[3]["launches"], "cli_trained": runs[3]["cli_launches"]}
    for k in ("i4g_matmul", "cell_attention", "kmajor_matmul"):
        if not any(n[k] for n in per_run.values()):
            raise AssertionError(f"[train] no train run launched {k}")
    for run in ("grads", "finetune", "lora_train"):
        if any(per_run[run].values()):
            raise AssertionError(f"[train] {run} launched a kernel: {per_run[run]}")
    for k, rec in records.items():
        rec["launches_train"] = {run: n[k] for run, n in per_run.items()}
        if not rec.get("launches"):  # a train-only run: the phase's count
            rec["launches"] = sum(n[k] for n in per_run.values())
    return [setup, *runs]


# ---------------------------------------------------------------------------
# llava: the image path at LLaVA-1.5-7B width
# ---------------------------------------------------------------------------

LLAVA_N = 32  # greedy tokens after the image prompt
LLAVA_N_CELLS = 1024  # the cell pool of the generation (576 image cells + prompt + tokens)
LLAVA_PROMPT = "describe the image in detail."
LLAVA_WIDE = (300, 480)  # a non-square image: padded to 480 x 480, then resized to 336
LLAVA_TOKPATH_T = 32  # tok_embd rows held against the token path: a whole bucket, no padding
LLAVA_TOKPATH_PAD_T = 40  # and in bucket 128, whose 88 padding rows the two paths fill apart


def _llava_images(seed: int) -> dict:
    """A red square image, a green non-square one (each color with +-20 of
    noise a channel) and bright noise. The 2-layer live llama's attention
    averages over the 576 image rows, so images of the same statistics
    (two uniform-noise images) condition its first token alike, within
    0.1% of max|logit| of a tie on the card; these three gave first-token
    margins of 4-8% of max|logit| on an H100 80GB HBM3 (PERF.md)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def solid(rgb, h, w):
        px = np.asarray(rgb, np.int16) + rng.integers(-20, 21, (h, w, 3))
        return np.clip(px, 0, 255).astype(np.uint8)

    return {"square": solid((250, 10, 10), 336, 336),
            "wide": solid((10, 230, 10), *LLAVA_WIDE),
            "other": rng.integers(192, 256, (336, 336, 3), np.uint8)}


def run_llava_tower(cparams, ccfg, images: dict, n_embd: int) -> tuple[dict, dict]:
    """The CLIP ViT-L/14-336 tower and projector on the card against the
    port on the CPU (the same weights moved there), for a square and a
    non-square image, within live_check.CLIP_RTOL of max|embedding|; the
    card's own run in another f32 order, and each of live_check.CLIP_FAULTS
    on the card against the CPU, beside it. The encode's device time
    against its f32 operation bound. Returns (record, card embeddings)."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.models import clip
    from pipeinfer_tpu_torch.runtime.context import _params_to
    from pipeinfer_tpu_torch.tools import live_check as LC
    from pipeinfer_tpu_torch.tools.finetune import tree_leaves

    cpu_params = _params_to(cparams, torch.device("cpu"))
    embds, rel, cpu_s = {}, {}, {}
    for name, img in images.items():
        pixels = clip.preprocess_image(img, ccfg)
        embds[name] = clip.encode_image(cparams, ccfg, pixels)
        if name == "other":
            continue
        t0 = time.perf_counter()
        want = clip.encode_image(cpu_params, ccfg, pixels).numpy()
        cpu_s[name] = time.perf_counter() - t0
        got = embds[name].cpu().numpy()
        if not (np.isfinite(got).all() and got.shape == (ccfg.n_patches, n_embd)):
            raise AssertionError(f"[llava] tower output {got.shape} (finite: "
                                 f"{np.isfinite(got).all()})")
        rel[name] = LC.spread(got, want)
        if name == "square":
            ref, sq_pixels = want, pixels
    with LC.clip_other_order():
        order = LC.spread(clip.encode_image(cparams, ccfg, sq_pixels).cpu().numpy(),
                          embds["square"].cpu().numpy())
    faults = {}
    for name in LC.CLIP_FAULTS:
        with LC.clip_fault(name):
            faults[name] = LC.spread(clip.encode_image(cparams, ccfg, sq_pixels).cpu().numpy(),
                                     ref)
    px = torch.from_numpy(sq_pixels).to(cparams["mm2_w"].device)
    ms = gpu_ms(lambda: clip.encode_image(cparams, ccfg, px), iters=5)
    flops = clip.encode_flops(ccfg, n_embd)
    w_bytes = nbytes(*tree_leaves(cparams))
    b_ms, b_by = bound(w_bytes, flops, "f32")
    log(f"[llava] CLIP tower ({ccfg.n_layers - 1} of {ccfg.n_layers} blocks, {ccfg.n_patches} "
        f"patches) + projector to {n_embd}: card vs CPU "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f" of max|embedding| (bar {LC.CLIP_RTOL}); another f32 order on the card {order:.3g}; "
        f"encode {ms:.3f} ms on the card ({flops / 1e9:.1f} GFLOP, bound {b_ms:.3f} ms by "
        f"{b_by}: {flops / ms / 1e9:.1f} TFLOP/s), CPU "
        + ", ".join(f"{k} {v:.1f} s" for k, v in cpu_s.items()))
    log("[llava] the tower under each fault, card against CPU: "
        + ", ".join(f"{k} {v:.3g}" for k, v in faults.items()))
    if max(rel.values()) > LC.CLIP_RTOL:
        raise AssertionError(f"[llava] the tower on the card against the CPU: {rel} (bar "
                             f"{LC.CLIP_RTOL})")
    missed = [k for k, v in faults.items() if not v > LC.CLIP_RTOL]
    if missed:
        raise AssertionError(f"[llava] the {LC.CLIP_RTOL} bar lets {missed} through")
    if LC.spread(embds["other"].cpu().numpy(), embds["square"].cpu().numpy()) < 0.05:
        raise AssertionError("[llava] two images gave near-equal embeddings")
    del cpu_params
    gc.collect()
    return dict(label="llava_tower", rel_err=rel, rtol=LC.CLIP_RTOL, f32_order=order,
                faults=faults, encode_ms=ms, gflop=flops / 1e9, bound_ms=b_ms, bound_by=b_by,
                cpu_s=cpu_s), embds


def _llava_greedy(params, cfg, tok, embd, device, n: int) -> tuple:
    """cli.llava's prompt around `embd` (prefill_image) and n greedy
    tokens on a fresh LLAVA_N_CELLS-cell context on `device`. Returns (the
    first generated position's logits, the tokens, prefill s, the image's
    decode_embd s, decode s)."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.cli import llava as cli_llava
    from pipeinfer_tpu_torch.cli.llava import DEFAULT_SYSTEM
    from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext

    ctx = InferenceContext(params, cfg, n_cells=LLAVA_N_CELLS, device=device)
    sync = torch.cuda.synchronize if ctx.device.type == "cuda" else (lambda: None)
    took = {}
    real = ctx.decode_embd

    def timed_embd(*a, **kw):
        sync()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        took["embd"] = time.perf_counter() - t0
        return out

    ctx.decode_embd = timed_embd
    sync()
    t0 = time.perf_counter()
    logits, n_past, _ = cli_llava.prefill_image(ctx, tok, embd, DEFAULT_SYSTEM, LLAVA_PROMPT)
    prefill_s = time.perf_counter() - t0
    first, out = np.asarray(logits), []
    t0 = time.perf_counter()
    for i in range(n):
        out.append(int(np.argmax(logits)))
        if i == n - 1:
            break
        b = Batch()
        b.add(out[-1], n_past, 0)
        logits = ctx.decode(b)[0]
        n_past += 1
    sync()
    return first, out, prefill_s, took["embd"], time.perf_counter() - t0


def run_llava_lm(counters: dict, live: Path, embds: dict) -> tuple[dict, object]:
    """On the 2-layer live llama at 7B width: decode_embd of tok_embd rows
    against the token path on the card, bitwise in a whole bucket and
    within live_check.PAD_SHARE of i4g's rounding (the i4g token path
    against k_major's) in a padded one; cli.llava's prompt around the
    square image's 576 embeddings (decode_embd at T = 2048) and LLAVA_N
    greedy tokens on the card (the counted run), the first generated
    position's logits against the port on the CPU (the same planes and
    embeddings) within live_check.LIVE_RTOL; the same image again gives
    the same stream, another image another stream. Returns (record,
    tokenizer)."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.gguf.reader import GGUFReader
    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.models.llama import embed
    from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext, _params_to
    from pipeinfer_tpu_torch.tokenizer import tokenizer_from_gguf
    from pipeinfer_tpu_torch.tools import live_check as LC

    params, cfg = load_model(live)
    with GGUFReader(live) as r:
        tok = tokenizer_from_gguf(r)
    rng = np.random.default_rng(SEED + 20)

    def token_path(p, toks):
        ctx = InferenceContext(p, cfg, n_cells=LLAVA_N_CELLS)
        b = Batch()
        for i, t in enumerate(toks):
            b.add(t, i, 0, want_logits=(i == len(toks) - 1))
        return ctx.decode(b)[-1], ctx.device

    def embd_path(toks):
        ctx = InferenceContext(params, cfg, n_cells=LLAVA_N_CELLS)
        return ctx.decode_embd(embed(torch.tensor(toks, dtype=torch.int32, device=ctx.device),
                                     params["tok_embd"]), 0)

    toks = rng.integers(3, cfg.n_vocab, LLAVA_TOKPATH_T).tolist()
    want, dev = token_path(params, toks)
    tokpath = float(np.abs(embd_path(toks) - want).max())
    log(f"[llava] decode_embd of {len(toks)} tok_embd rows against the token path on the card: "
        f"max|difference| {tokpath:.3g} ({'bitwise equal' if tokpath == 0 else 'not bitwise'})")
    if tokpath != 0:
        raise AssertionError(f"[llava] decode_embd against the token path, a whole bucket: {tokpath}")
    # In a padded bucket the token path's padding rows hold token 0's row and
    # decode_embd's zeros; under i4g they share the valid rows' activation
    # scales, so the two part by a share of i4g's own rounding, measured as the
    # token path's distance from the exact k_major layout on the same rows.
    toks = rng.integers(3, cfg.n_vocab, LLAVA_TOKPATH_PAD_T).tolist()
    want, _ = token_path(params, toks)
    pad = LC.spread(embd_path(toks), want)
    with _layout("k_major"):
        exact_params, _ = load_model(live)
    rounding = LC.spread(want, token_path(exact_params, toks)[0])
    del exact_params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[llava] decode_embd of {len(toks)} tok_embd rows (bucket 128) against the token path on "
        f"the card: {pad:.4g} of max|logit|; the i4g token path against k_major {rounding:.4g}; "
        f"share {pad / rounding:.3g} (bar {LC.PAD_SHARE})")
    if not pad <= LC.PAD_SHARE * rounding:
        raise AssertionError(f"[llava] decode_embd against the padded token path: {pad} of "
                             f"max|logit|, over {LC.PAD_SHARE} of i4g's rounding {rounding}")

    (first, stream, prefill_s, embd_s, dec_s), launches = _counted(
        counters, lambda: _llava_greedy(params, cfg, tok, embds["square"], dev, LLAVA_N))
    again = _llava_greedy(params, cfg, tok, embds["square"], dev, LLAVA_N)[1]
    other = _llava_greedy(params, cfg, tok, embds["other"], dev, LLAVA_N)[1]
    cpu_params = _params_to(params, torch.device("cpu"))
    t0 = time.perf_counter()
    first_cpu, stream_cpu, *_ = _llava_greedy(cpu_params, cfg, tok, embds["square"].cpu(),
                                              torch.device("cpu"), 1)
    cpu_s = time.perf_counter() - t0
    del cpu_params
    gc.collect()
    rel = LC.spread(first, first_cpu)
    top2 = np.sort(first)[-2:]
    gap = float((top2[1] - top2[0]) / np.abs(first).max())
    tok_s = (LLAVA_N - 1) / dec_s
    log(f"[llava] live {cfg.n_layers}L llama at 7B width: prompt + 576 image rows (decode_embd "
        f"at T = 2048: {embd_s * 1e3:.1f} ms) + prompt, prefill {prefill_s * 1e3:.1f} ms; "
        f"{LLAVA_N} greedy tokens at {tok_s:.1f} tok/s; first generated position card vs CPU "
        f"{rel:.4g} of max|logit| (bar {LC.LIVE_RTOL}; argmax {stream[0]} / {stream_cpu[0]}, "
        f"top-2 gap {gap:.3g} of max|logit|, CPU {cpu_s:.1f} s); same image again equal: "
        f"{again == stream}; another image differs: {other != stream}; launches {launches}")
    if not (np.isfinite(first).all() and rel <= LC.LIVE_RTOL):
        raise AssertionError(f"[llava] the first generated position, card against CPU: {rel}")
    if again != stream or other == stream:
        raise AssertionError(f"[llava] image conditioning: {stream} / {again} / {other}")
    for k in ("i4g_matmul", "cell_attention"):
        if not launches[k]:
            raise AssertionError(f"[llava] the image generation never launched {k}: {launches}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(label="llava_lm", tokpath_max_diff=tokpath, tokpath_pad_spread=pad,
                tokpath_pad_rounding=rounding, prefill_s=prefill_s,
                decode_embd_ms=embd_s * 1e3, tok_s=tok_s, rel_err=rel, rtol=LC.LIVE_RTOL,
                top2_gap=gap,
                stream=stream, stream_other=other, cpu_s=cpu_s,
                launches=launches), tok


def _png_bytes(img) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def run_llava_entries(counters: dict, live: Path, mm: Path, images: dict, stream: list[int],
                      tok, work: Path) -> dict:
    """`python -m pipeinfer_tpu_torch.cli.llava` on a PNG the phase writes
    (its stdout the in-process greedy stream, streamed); the server with
    --mmproj: the square image's request (its content the in-process
    greedy stream, detokenized), again (equal), the other image (different),
    a prompt naming an image not sent (400); then serve() with --mmproj
    and --draft (exits with the JAX package's message)."""
    import base64
    import threading
    import urllib.error

    import torch

    from pipeinfer_tpu_torch.cli.llava import DEFAULT_SYSTEM
    from pipeinfer_tpu_torch.serving.server import serve
    from pipeinfer_tpu_torch.tokenizer.stream import StreamDecoder
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair

    sdec = StreamDecoder(tok)
    streamed = "".join(sdec.feed(t) for t in stream)
    text = tok.decode(stream)

    png = work / "square.png"
    png.write_bytes(_png_bytes(images["square"]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pipeinfer_tpu_torch.cli.llava", "-m", str(live),
                           "--mmproj", str(mm), "--image", str(png), "-n", str(LLAVA_N),
                           *CLI_GREEDY[:-2], "-c", str(LLAVA_N_CELLS)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0 or "encoded 576 image tokens" not in proc.stderr:
        raise AssertionError(f"[llava] cli.llava exited {proc.returncode}: {proc.stderr[-800:]}")
    if proc.stdout != streamed + "\n":
        raise AssertionError(f"[llava] cli.llava printed {proc.stdout[-200:]!r}, the in-process "
                             f"run {streamed[-200:]!r}")
    log(f"[llava] python -m pipeinfer_tpu_torch.cli.llava: {cli_s:.1f} s (its loads included), "
        f"the in-process text; {proc.stderr.strip().splitlines()[-1]}")

    t0 = time.perf_counter()
    # the in-process run's pool: another pool size is another cuBLAS shape in
    # the dense prefill, and the first token is a near tie (run_llava_lm)
    httpd, engine = serve(str(live), "127.0.0.1", 0, n_cells=LLAVA_N_CELLS, max_slots=1,
                          mmproj_path=str(mm))
    load_s = time.perf_counter() - t0
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    prompt = f"{DEFAULT_SYSTEM}\nUSER:[img-0]\n{LLAVA_PROMPT}\nASSISTANT:"

    def body(img):
        return {"prompt": prompt, "n_predict": LLAVA_N, "temperature": 0, "ignore_eos": True,
                "repeat_penalty": 1.0, "repeat_last_n": 0,
                "image_data": [{"id": 0, "data": base64.b64encode(_png_bytes(img)).decode()}]}

    try:
        (replies, req_s), launches = _counted(counters, lambda: _timed(lambda: [
            _post(port, body(images["square"])), _post(port, body(images["square"])),
            _post(port, body(images["other"]))]))
        try:
            _post(port, dict(body(images["square"]), prompt="[img-3] what is it?"))
            bad = None
        except urllib.error.HTTPError as e:
            bad = (e.code, json.loads(e.read())["error"])
    finally:
        httpd.shutdown()
        engine.shutdown()
    contents = [r["content"] for r in replies]
    log(f"[llava] server --mmproj (loaded in {load_s:.1f} s): 3 image requests in {req_s:.1f} s, "
        f"same image equal: {contents[0] == contents[1]}, the in-process text: "
        f"{contents[0] == text}, another image differs: {contents[2] != contents[0]}; "
        f"[img-3] not sent: {bad}; launches {launches}")
    if not (contents[0] == contents[1] == text and contents[2] != contents[0]):
        raise AssertionError(f"[llava] server replies {[c[-80:] for c in contents]}")
    if bad is None or bad[0] != 400 or "no image_data with id 3" not in bad[1]:
        raise AssertionError(f"[llava] a request naming a missing image: {bad}")
    gc.collect()
    torch.cuda.empty_cache()
    _, draft = cached_bench_pair(ROOT / "build" / "bench", "7b", "Q4_K", 0.02, log=log)
    try:
        serve(str(live), "127.0.0.1", 0, n_cells=LLAVA_N_CELLS, mmproj_path=str(mm),
              draft_path=str(draft))
        refused = None
    except SystemExit as e:
        refused = str(e.code)
    if refused != "error: --mmproj and --draft cannot be combined yet":
        raise AssertionError(f"[llava] serve with --mmproj and --draft: {refused!r}")
    log(f"[llava] serve with --mmproj and --draft: {refused}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(label="llava_entries", cli_s=cli_s, server_load_s=load_s, requests_s=req_s,
                launches=launches, missing_image=bad, mmproj_with_draft=refused)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def run_llava(counters: dict, records: dict) -> list:
    """The llava phase: the ViT-L/14-336 mmproj (testmodel.build_mmproj,
    cached under build/bench/) and the live llama at 7B width (see the
    module docstring). Returns its run records and adds each kernel's
    launches per llava run to its record."""
    import torch

    from pipeinfer_tpu_torch.models import clip
    from pipeinfer_tpu_torch.tools.benchpair import (cached_bench_pair, cached_llama_live,
                                                     cached_mmproj)

    bench = ROOT / "build" / "bench"
    work = ROOT / "build" / "llava"
    work.mkdir(parents=True, exist_ok=True)
    t_path, _ = cached_bench_pair(bench, "7b", "Q4_K", 0.02, log=log)
    live = cached_llama_live(t_path, log=log)
    mm = cached_mmproj(bench, seed=SEED, log=log)
    t0 = time.perf_counter()
    cparams, ccfg = clip.load_mmproj(mm)
    torch.cuda.synchronize()
    log(f"[llava] mmproj ({mm.stat().st_size / 2**30:.2f} GiB) loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    images = _llava_images(SEED + 21)
    tower, embds = run_llava_tower(cparams, ccfg, images, cparams["mm2_w"].shape[0])
    del cparams
    gc.collect()
    torch.cuda.empty_cache()
    lm, tok = run_llava_lm(counters, live, embds)
    entries = run_llava_entries(counters, live, mm, images, lm["stream"], tok, work)
    per_run = {"generate": lm["launches"], "server": entries["launches"]}
    for k, rec in records.items():
        rec["launches_llava"] = {run: n[k] for run, n in per_run.items()}
        if not rec.get("launches"):  # a llava-only run: the phase's count
            rec["launches"] = sum(n[k] for n in per_run.values())
    return [tower, lm, entries]


# ---------------------------------------------------------------------------
# chat: cli.main's interactive, instruct and ChatML modes, infill, --logdir
# and --profile on the 7B target cut to CLI_DEPTH layers
# ---------------------------------------------------------------------------

CHAT_N = 16  # tokens a turn
CHAT_TURNS = "tell me about the sea\nand then what\n"  # two turns, then EOF
CHAT_SMALL_CELLS = 96  # a pool the 65-token prompt and the turns fill: _slide_if_full shifts


def _chat_args(**kw):
    base = dict(interactive=True, interactive_first=False, instruct=False, chatml=False,
                reverse_prompt=[], in_prefix="", in_suffix="", input_prefix_bos=False, keep=-1,
                n_predict=CHAT_N, ignore_eos=True, color=False)
    base.update(kw)
    return argparse.Namespace(**base)


def _scripted(text: str):
    lines = iter(text.splitlines())

    def fn():
        try:
            return next(lines)
        except StopIteration:
            raise EOFError

    return fn


def run_chat_loops(counters: dict, target: Path) -> dict:
    """interactive_loop on the target loaded once, each run on a fresh
    context: the first turn (EOF at the first read) == cli.main's
    generate; -i, --interactive-first, instruct, ChatML, --in-prefix /
    --in-suffix / --in-prefix-bos and a reverse prompt over two turns; a
    CHAT_SMALL_CELLS-cell pool on which _slide_if_full must shift."""
    from pipeinfer_tpu_torch.cli import main as cli_main
    from pipeinfer_tpu_torch.sampling.samplers import SamplerState, SamplingParams

    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    ctx, tok = cli_main.build_context(str(target), 1024)
    params, cfg = ctx.params, ctx.cfg
    del ctx
    prompt = tok.encode(CLI_PROMPT, add_bos=True)

    def fresh(n_cells=1024):
        return cli_main.InferenceContext(params, cfg, n_cells=n_cells)

    plain = cli_main.generate(fresh(), tok, SamplerState(params=greedy), prompt, CHAT_N,
                              ignore_eos=True)
    anti = tok.decode(plain[2:3])
    cases = {
        "first_turn": (_chat_args(), ""),
        "interactive": (_chat_args(), CHAT_TURNS),
        "interactive_first": (_chat_args(interactive_first=True), CHAT_TURNS),
        "instruct": (_chat_args(instruct=True), CHAT_TURNS),
        "chatml": (_chat_args(chatml=True), CHAT_TURNS),
        "prefix_suffix_bos": (_chat_args(in_prefix="User: ", in_suffix="Bot: ",
                                         input_prefix_bos=True), CHAT_TURNS),
        "reverse_prompt": (_chat_args(reverse_prompt=[anti]), CHAT_TURNS),
        "slide": (_chat_args(keep=4), CHAT_TURNS + "more\nmore\n"),
    }
    slides = []
    real_slide = cli_main._slide_if_full

    def counting_slide(ctx, n_past, n_keep, need=1):
        out = real_slide(ctx, n_past, n_keep, need)
        if out != n_past:
            slides.append(n_past - out)
        return out

    res, launches = {}, {}
    cli_main._slide_if_full = counting_slide
    try:
        for name, (args, turns) in cases.items():
            writes = []
            n_cells = CHAT_SMALL_CELLS if name == "slide" else 1024
            before = len(slides)
            (ids, t_s), launches[name] = _counted(counters, lambda: _timed(
                lambda: cli_main.interactive_loop(
                    fresh(n_cells), tok, SamplerState(params=greedy), prompt, args,
                    input_fn=_scripted(turns), write=writes.append)))
            res[name] = dict(tokens=len(ids), seconds=t_s, slides=len(slides) - before,
                             text_tail="".join(writes)[-80:])
            if name == "first_turn" and ids != plain:
                raise AssertionError(f"[chat] first interactive turn {ids} != generate {plain}")
            if name == "reverse_prompt" and not len(ids) < 3 * CHAT_N:
                raise AssertionError(f"[chat] reverse prompt {anti!r} never stopped a turn")
            if name in ("instruct", "chatml") and "\n> " not in "".join(writes):
                raise AssertionError(f"[chat] {name} never prompted '> '")
            if name == "prefix_suffix_bos" and not ("User: " in "".join(writes)
                                                    and "Bot: " in "".join(writes)):
                raise AssertionError("[chat] --in-prefix / --in-suffix never written")
    finally:
        cli_main._slide_if_full = real_slide
    if not res["slide"]["slides"]:
        raise AssertionError(f"[chat] the {CHAT_SMALL_CELLS}-cell pool never slid")
    log(f"[chat] interactive_loop on the {cfg.n_layers}-layer 7B target: first turn == "
        f"generate ({CHAT_N} tokens); " + "; ".join(
            f"{k} {v['tokens']} tokens {v['seconds']:.2f} s" for k, v in res.items())
        + f"; the {CHAT_SMALL_CELLS}-cell pool slid {res['slide']['slides']} times "
        f"(discarding {slides}); launches per run: "
        + ", ".join(f"{k} i4g {n['i4g_matmul']} cell {n['cell_attention']}"
                    for k, n in launches.items()))
    for k in ("i4g_matmul", "cell_attention"):
        if not launches["interactive"][k]:
            raise AssertionError(f"[chat] the interactive run never launched {k}")
    return dict(label="chat_loops", runs=res, slides=slides, launches=launches)


def run_chat_clis(counters: dict, target: Path, work: Path) -> dict:
    """cli.main -i --color (reading a scripted stdin) with --in-prefix /
    --in-suffix / --in-prefix-bos; on a copy of the target whose
    vocabulary carries FIM ids (testmodel.with_fim_ids), cli.infill with
    --logdir and --profile (the YAML's output tokens, a trace file in DIR)
    and cli.main --fim-prefix / --fim-suffix."""
    import re
    import shutil

    import yaml

    from pipeinfer_tpu_torch.cli import infill as cli_infill
    from pipeinfer_tpu_torch.cli import main as cli_main
    from pipeinfer_tpu_torch.tools.testmodel import with_fim_ids

    real_stdin = sys.stdin
    sys.stdin = io.StringIO(CHAT_TURNS)
    try:
        (chat, chat_s), l_chat = _counted(counters, lambda: _cli_text(cli_main.main, [
            "-m", str(target), "-p", CLI_PROMPT, "-n", str(CHAT_N), *CLI_GREEDY, "-i", "--color",
            "--in-prefix", "User: ", "--in-suffix", "Bot: ", "--in-prefix-bos"]))
    finally:
        sys.stdin = real_stdin
    if not (cli_main._ANSI_USER in chat and "User: " in chat and "Bot: " in chat):
        raise AssertionError(f"[chat] cli.main -i --color printed {chat[-300:]!r}")
    fim = with_fim_ids(target, work / "target_fim.gguf")
    logdir, trace = work / "logs", work / "trace"
    for d in (logdir, trace):  # this run's files only
        shutil.rmtree(d, ignore_errors=True)
    err = io.StringIO()
    (infill, infill_s), l_infill = _counted(counters, lambda: _cli_text(
        cli_infill.main, ["-m", str(fim), "-p", "def fib(n):", "-n", str(CHAT_N), *CLI_GREEDY,
                          "--in-prefix", "def fib(n):", "--in-suffix", "return a",
                          "--logdir", str(logdir), "--profile", str(trace)], err))
    dumps = list(logdir.glob("run-*.yml"))
    doc = yaml.safe_load(dumps[0].read_text()) if len(dumps) == 1 else {}
    traces = list(trace.glob("*.json"))
    trace_text = traces[0].read_text() if traces else ""
    cuda_events = len(re.findall(r'"cat":\s*"kernel"', trace_text))
    kernels_traced = len(re.findall(r'"name":\s*"[^"]*(i4g_kernel|split_kernel)', trace_text))
    if not (len(doc.get("output_tokens", [])) == CHAT_N and f"profile trace -> {trace}"
            in err.getvalue() and traces):
        raise AssertionError(f"[chat] --logdir / --profile: dumps {dumps}, traces {traces}, "
                             f"stderr {err.getvalue()[-300:]!r}")
    (fimtext, fim_s), l_fim = _counted(counters, lambda: _cli_text(
        cli_main.main, ["-m", str(fim), "--fim-prefix", "def fib(n):", "--fim-suffix",
                        "    return a", "-n", str(CHAT_N), *CLI_GREEDY]))
    fim.unlink()
    log(f"[chat] cli.main -i --color with --in-prefix/--in-suffix/--in-prefix-bos: "
        f"{len(chat)} characters in {chat_s:.1f} s; cli.infill with --logdir "
        f"({len(doc['output_tokens'])} output tokens in the YAML) and --profile "
        f"({traces[0].stat().st_size / 2**20:.1f} MiB trace, {cuda_events} CUDA kernel events, "
        f"{kernels_traced} of them the port's i4g and cell-attention kernels) in {infill_s:.1f} s; "
        f"--fim-prefix/--fim-suffix {len(fimtext)} characters in {fim_s:.1f} s")
    for name, n in (("chat", l_chat), ("infill", l_infill), ("fim", l_fim)):
        if not (n["i4g_matmul"] and n["cell_attention"]):
            raise AssertionError(f"[chat] cli run {name} launches {n}")
    return dict(label="chat_clis", chat_s=chat_s, infill_s=infill_s, fim_s=fim_s,
                trace_mib=traces[0].stat().st_size / 2**20, cuda_events=cuda_events,
                port_kernel_events=kernels_traced, yaml_output_tokens=len(doc["output_tokens"]),
                launches=dict(chat=l_chat, infill=l_infill, fim=l_fim))


def run_chat(counters: dict, records: dict) -> list:
    """The chat phase on the 7B Q4_K target cut to CLI_DEPTH layers.
    Returns its run records and adds each kernel's launches per chat run
    to its record."""
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair, cut_depth

    work = ROOT / "build" / "chat"
    work.mkdir(parents=True, exist_ok=True)
    t_path, _ = cached_bench_pair(ROOT / "build" / "bench", "7b", "Q4_K", 0.02, log=log)
    target = cut_depth(t_path, t_path.with_name(f"target_d{CLI_DEPTH}.gguf"), CLI_DEPTH, log=log)
    loops = run_chat_loops(counters, target)
    clis = run_chat_clis(counters, target, work)
    per_run = {**loops["launches"], **{f"cli_{k}": v for k, v in clis["launches"].items()}}
    for k, rec in records.items():
        rec["launches_chat"] = {run: n[k] for run, n in per_run.items()}
        if not rec.get("launches"):
            rec["launches"] = sum(n[k] for n in per_run.values())
    return [loops, clis]


# ---------------------------------------------------------------------------
# dcn: the cross-process pipeline (parallel/dcn.py)
# ---------------------------------------------------------------------------

DCN_DEPTH = 8  # layers of the 7B target, cut as CLI_DEPTH (the stream does not depend on it)
DCN_STAGES = 3  # the head (stage 0 and the draft) and two stage workers, all on the one card
DCN_N_CELLS = 1024  # >= 512: single-token steps take the cell kernel on every stage
DCN_STEPS = 8  # single-token steps after the prompt in the logits checks
DCN_TOL = 2e-4  # tests/test_torch_stages.py's TOL (rtol and atol): the f32 wire adds no rounding
DCN_BF16_TOL = 3e-2  # tests/test_dcn.py's bar (rtol and atol) for the bf16 wire
DCN_BF16_N = 32  # tokens of the controller run over the bf16 wire
DCN_WORKER_DEVICE = "cuda"  # every worker's --device: the card the head runs on


@contextlib.contextmanager
def _dcn_wire(name: str):
    """The head's PIPEINFER_DCN_WIRE (the workers follow it) set to name."""
    old = os.environ.get("PIPEINFER_DCN_WIRE")
    os.environ["PIPEINFER_DCN_WIRE"] = name
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PIPEINFER_DCN_WIRE", None)
        else:
            os.environ["PIPEINFER_DCN_WIRE"] = old


def _dcn_steps(ctx, prompt: list[int], tokens: list[int]) -> list:
    """Every position's logits of the prompt (T = 32, the dense path),
    then one single-token step (T = 1, the cell kernel) per token."""
    import numpy as np

    from pipeinfer_tpu_torch.runtime.context import Batch

    b = Batch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=True)
    out = [np.asarray(ctx.decode(b))]
    for i, t in enumerate(tokens):
        b = Batch()
        b.add(t, len(prompt) + i, 0)
        out.append(np.asarray(ctx.decode(b)))
    return out


def _dcn_spread(got: list, want: list) -> tuple[float, float]:
    """(max |got - want|, the largest amount by which it exceeds
    DCN_TOL * (1 + |want|): <= 0 within the bar)."""
    import numpy as np

    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    over = max(float((np.abs(g - w) - DCN_TOL * (1 + np.abs(w))).max())
               for g, w in zip(got, want))
    return err, over


def _worker_lines(logs: list[Path]) -> list[dict]:
    """Each worker's exit line ("dcn worker: stage i device D launches
    {...}"), parsed."""
    rows = []
    for p in logs:
        lines = [ln for ln in p.read_text().splitlines() if ln.startswith("dcn worker:")]
        if len(lines) != 1:
            raise AssertionError(f"[dcn] {p.name} holds {len(lines)} exit lines:\n"
                                 f"{p.read_text()[-2000:]}")
        head, _, counts = lines[0].partition(" launches ")
        rows.append(dict(line=head, launches=json.loads(counts)))
    return rows


def run_dcn(counters: dict, records: dict, n_predict: int) -> dict:
    """The cross-process PipeInfer pipeline on the 7B Q4_K pair (target cut
    to DCN_DEPTH layers): launch_local_cluster starts DCN_STAGES - 1 stage
    workers on the card (processes of their own, each loading the file),
    RemoteStagedContext keeps stage 0 and the draft here. Checks, each
    failing the run: over the f32 wire the prompt's and DCN_STEPS steps'
    logits equal a single-process InferenceContext's within DCN_TOL; the
    PipeInferController over the remote target emits plain greedy's
    n_predict tokens, accepts drafts and cancels runs in flight; over the
    bf16 wire the logits stay within DCN_BF16_TOL but not bit-equal and the
    controller completes; every worker exits 0, its exit line showing i4g
    launches, and the head launched i4g and cell attention in the
    controller run. tok/s beside the single-process controller
    (device-corrected) and a single-process 3-stage target, not gated."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.parallel import dcn
    from pipeinfer_tpu_torch.parallel.stages import StagedInferenceContext
    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
    from pipeinfer_tpu_torch.spec.controller import PipeInferController
    from pipeinfer_tpu_torch.spec.params import SpecParams
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair, cut_depth

    t_full, d_path = cached_bench_pair(ROOT / "build" / "bench", "7b", "Q4_K", 0.02, log=log)
    t_path = cut_depth(t_full, t_full.with_name(f"target_d{DCN_DEPTH}.gguf"), DCN_DEPTH, log=log)
    log_dir = ROOT / "chiprun_out" / "dcn"
    log_dir.mkdir(parents=True, exist_ok=True)
    logs = [Path(dcn.worker_log(log_dir, i)) for i in range(1, DCN_STAGES)]
    t0 = time.perf_counter()
    workers, head_port, procs = dcn.launch_local_cluster(
        str(t_path), DCN_STAGES, n_cells=DCN_N_CELLS, device=DCN_WORKER_DEVICE, log_dir=log_dir)
    try:
        tparams, tcfg = load_model(t_path)  # while the workers load theirs
        dparams, dcfg = load_model(d_path)
        ctx = dcn.RemoteStagedContext(tparams, tcfg, workers=workers, n_cells=DCN_N_CELLS,
                                      head_port=head_port, connect_timeout=600)
        ctx.ping()
        up_s = time.perf_counter() - t0
        log(f"[dcn] {DCN_STAGES} stages up in {up_s:.1f} s: layers {ctx.ranges} "
            f"({tcfg.n_layers}L target, n_embd {tcfg.n_embd}); workers "
            f"{[p.pid for p in procs]} on {DCN_WORKER_DEVICE}")
        rng = np.random.default_rng(SEED)
        prompt = [1] + rng.integers(3, tcfg.n_vocab, 31).tolist()
        greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
        sp = SpecParams(n_draft=8, n_parallel=1, p_accept=0.1, p_split=0.9, max_inflight=4)

        def single():
            return InferenceContext(tparams, tcfg, n_cells=DCN_N_CELLS)

        def controller(tgt):
            return PipeInferController(tgt, InferenceContext(dparams, dcfg, n_cells=DCN_N_CELLS),
                                       greedy, sp, eos_id=-1)

        # the single-process references: plain greedy, the logits, the controllers
        want, _ = _greedy(single(), prompt, n_predict)
        ref = _dcn_steps(single(), prompt, want[:DCN_STEPS])
        timed = {}
        for name, make in (("single", single), ("staged3", lambda: StagedInferenceContext(
                tparams, tcfg, n_cells=DCN_N_CELLS, devices=["cuda"] * DCN_STAGES))):
            c = controller(make())
            t1 = time.perf_counter()
            got = c.generate(list(prompt), n_predict, ignore_eos=True)
            torch.cuda.synchronize()
            timed[name] = dict(tok_s=n_predict / (time.perf_counter() - t1),
                               mode="corrected" if c.use_corrected else "host",
                               acceptance=c.stats.n_accept / max(c.stats.n_drafted, 1))
            if got != want:
                raise AssertionError(f"[dcn] the {name} controller differs from plain greedy")

        # 1. the f32 wire: logits against the single process
        with _dcn_wire("f32"):
            got = _dcn_steps(ctx, prompt, want[:DCN_STEPS])
        f32_err, f32_over = _dcn_spread(got, ref)
        scale = max(float(np.abs(w).max()) for w in ref)
        if f32_over > 0:
            raise AssertionError(f"[dcn] f32 wire: logits {f32_err:.3e} from the single process, "
                                 f"past {DCN_TOL} (rtol and atol)")

        # 2. the controller over the remote target (f32 wire): warm, then counted
        with _dcn_wire("f32"):
            ctx.clear_cache()
            controller(ctx).generate(list(prompt), 16, ignore_eos=True)
            ctx.clear_cache()
            c = controller(ctx)
            if c.use_fused or c.use_corrected:
                raise AssertionError("[dcn] a remote target engaged the fused or corrected mode")
            before = ctx.ping()
            for k in counters.values():
                k.launches = 0
            t1 = time.perf_counter()
            got = c.generate(list(prompt), n_predict, ignore_eos=True)
            torch.cuda.synchronize()
            t_ctrl = time.perf_counter() - t1
            head = {k: fn.launches for k, fn in counters.items()}
            after = ctx.ping()
        worker_counts = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
        if got != want:
            first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(f"[dcn] the controller over {DCN_STAGES} processes differs from "
                                 f"plain greedy at token {first}: {got[first:first + 8]} vs "
                                 f"{want[first:first + 8]}")
        st, m = c.stats, c.metrics
        if st.n_accept == 0 or m.n_canceled_runs == 0:
            raise AssertionError(f"[dcn] controller accepted {st.n_accept} drafts and canceled "
                                 f"{m.n_canceled_runs} runs: both must be above 0")
        timed["dcn"] = dict(tok_s=n_predict / t_ctrl, mode="host",
                            acceptance=st.n_accept / max(st.n_drafted, 1))

        # 3. the bf16 wire (the default): within its bar, not bit-equal; the controller completes
        with _dcn_wire("bf16"):
            ctx.clear_cache()
            got = _dcn_steps(ctx, prompt, want[:DCN_STEPS])
            bf16_err = max(float(np.abs(g - w).max()) for g, w in zip(got, ref))
            bf16_ok = all(np.allclose(g, w, rtol=DCN_BF16_TOL, atol=DCN_BF16_TOL)
                          for g, w in zip(got, ref))
            ctx.clear_cache()
            cb = controller(ctx)
            t1 = time.perf_counter()
            bf16_toks = cb.generate(list(prompt), DCN_BF16_N, ignore_eos=True)
            t_bf16 = time.perf_counter() - t1
        if not bf16_ok or bf16_err == 0:
            raise AssertionError(f"[dcn] bf16 wire: logits {bf16_err:.3e} from the single "
                                 f"process (bar {DCN_BF16_TOL}, and not 0)")
        if len(bf16_toks) != DCN_BF16_N:
            raise AssertionError(f"[dcn] bf16 wire: the controller gave {len(bf16_toks)} tokens")

        # 4. every worker exits 0 with its launch line
        ctx.shutdown()
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0] * len(procs):
        raise AssertionError(f"[dcn] stage workers exited {rcs}:\n"
                             + "\n".join(p.read_text()[-1500:] for p in logs))
    lines = _worker_lines(logs)
    for i, (row, counts) in enumerate(zip(lines, worker_counts), start=1):
        if row["launches"]["i4g_matmul"] == 0 or counts["i4g_matmul"] == 0:
            raise AssertionError(f"[dcn] worker {i} never launched i4g: {row}")
    for k in ("i4g_matmul", "cell_attention"):
        if head[k] == 0:
            raise AssertionError(f"[dcn] the head never launched {k} in the controller run")
    for k, rec in records.items():
        rec["launches_dcn"] = dict(head=head[k], **{f"worker{i}": n[k] for i, n in
                                                    enumerate(worker_counts, start=1)})
    res = dict(label="dcn", target=str(t_path), n_layers=tcfg.n_layers, ranges=ctx.ranges,
               n_predict=n_predict, prompt_len=len(prompt), n_cells=DCN_N_CELLS, up_s=up_s,
               f32_max_abs_err=f32_err, logit_scale=scale, bf16_max_abs_err=bf16_err,
               bf16_tok_s=DCN_BF16_N / t_bf16, engines=timed, n_accept=st.n_accept,
               n_drafted=st.n_drafted, runs=m.n_runs, canceled=m.n_canceled_runs,
               launches_head=head, launches_workers=worker_counts,
               worker_exit=lines, card=card_line())
    log(f"[dcn] logits over {DCN_STAGES} processes: f32 wire {f32_err:.3e}, bf16 wire "
        f"{bf16_err:.3e} (max |logit| {scale:.2f})")
    log(f"[dcn] controller over {DCN_STAGES} processes == plain greedy over {n_predict} tokens: "
        f"acceptance {st.n_accept}/{st.n_drafted}, runs {m.n_runs}, canceled {m.n_canceled_runs}; "
        f"launches head {head}, workers {worker_counts}")
    log(f"[dcn] tok/s on {res['card']}: " + ", ".join(
        f"{k} {v['tok_s']:.1f} ({v['mode']})" for k, v in timed.items())
        + f"; bf16 wire {res['bf16_tok_s']:.1f}")
    for row in lines:
        log(f"[dcn] {row['line']} launches {row['launches']}")
    del tparams, dparams, ctx, c, cb
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# multi: tensor parallelism, the fused pipeline and two processes
# ---------------------------------------------------------------------------

MULTI_N_CELLS = 1024  # >= 512: single-token steps take the cell kernel on every shard
MULTI_TP = (2, 4)  # the TP widths of the logits check, each against one device
MULTI_PF_RTOL = 0.03  # tests/test_pipefused.py's bar, of max|logit|
MULTI_MH_RTOL = 2e-3  # tests/test_multihost.py's bar, of max|logit|
MULTI_PF = dict(pp=2, tp=2, dp=2, mb=2)  # the fused step's mesh and microbatches
MULTI_PF_T = 9  # prompt tokens of each stream of the fused step
MULTI_WORKER_TIMEOUT = 300  # seconds per multihost worker
MULTI_WORKER_DEVICE = "cuda:0"  # each multihost worker's mesh entries: the one card, repeated
# i4g at M = 1 over the 7B's 4-bit tensors cut tp ways along N
MULTI_I4G = {name: I4G_SHAPES[name] for name in ("wqkv", "wo", "wgu", "w_down", "output")}
MULTI_ATTN = [(16, 128, 1024), (8, 128, 1024)]  # (H = KVH, D, C): the shard-local heads

MULTI_WORKER = """
import sys
import numpy as np
import torch
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.parallel import pipefused as pf
from pipeinfer_tpu_torch.parallel.multihost import global_mesh, init_distributed, shutdown
pid, port, out, model = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
tokens, device = np.load(sys.argv[5]), sys.argv[6]
init_distributed(f"localhost:{port}", num_processes=2, process_id=pid, timeout_s=240)
params, cfg = load_model(model, device=device)
pp, tp, dp, mb = (int(a) for a in sys.argv[7:11])
pc = pf.PipeConfig(n_stages=pp, tp=tp, dp=dp, n_microbatches=mb)
mesh = global_mesh(pp=pp, tp=tp, dp=dp, local_devices=[device] * (pp * tp * dp // 2))
step = pf.build_step(cfg, pc, mesh)
cache = pf.init_cache(cfg, pc, mesh, batch=tokens.shape[0], max_len=64)
logits, _ = step(pf.stack_params(params, cfg, pc, mesh), cache, tokens,
                 np.arange(tokens.shape[1], dtype=np.int32))
np.save(out, logits.cpu().numpy())
shutdown()
print(f"multihost worker {pid}: {mesh}", flush=True)
"""


@contextlib.contextmanager
def _gathered_backwards():
    """Within: every tiled all_gather concatenates its group's shards in
    reverse order (the fault the TP logits bar must catch)."""
    from pipeinfer_tpu_torch.parallel import mesh as M

    real = M.Mesh.all_gather

    def backwards(self, xs, axis, dim, coords=None):
        coords = self.local if coords is None else coords
        out = real(self, xs, axis, dim, coords)
        n = self.shape[axis]
        return [_flip_blocks(o, dim, n) for o in out]

    M.Mesh.all_gather = backwards
    try:
        yield
    finally:
        M.Mesh.all_gather = real


def _flip_blocks(t, dim: int, n: int):
    """t cut into n equal blocks along dim, put back in reverse order."""
    import torch

    return torch.cat(list(reversed(t.chunk(n, dim=dim))), dim=dim)


def check_multi_shapes(details: list):
    """i4g at M = 1 over the 7B's 4-bit tensors at their tp = 2 and 4 shard
    widths and cell attention at the shard-local heads (H = KVH = 16 and
    8, T = 1), each against its plain version (i4g with the bitwise
    repeat), timed beside its bound."""
    import torch

    from pipeinfer_tpu_torch.ops import cell_attention as CA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    for tp in MULTI_TP:
        for name, (n_full, k) in MULTI_I4G.items():
            n = n_full // tp
            planes = _split_planes("i4g", n, k, dev, g, copies_for(n * k // 2))
            x = torch.randn(1, k, device=dev, generator=g)
            kern, plain, ins, name_k, ops = _split_inputs("i4g", x, planes)
            err, scale = _check_repeat(kern, plain, ins[0], f"i4g {name}/tp{tp} M=1")
            it = iter(range(1 << 30))
            ms = gpu_ms(lambda: kern(*ins[next(it) % len(ins)]))
            b_ms, b_by = bound(nbytes(*ins[0]) + 4 * n, ops, "int8")
            cut = _cut(kern)
            details.append(dict(kernel=name_k, tensor=name, tp=tp, N=n, K=k, M=1,
                                max_abs_err=err, tol=MATMUL_RTOL * scale, ms=ms, bound_ms=b_ms,
                                bound_by=b_by, plan=cut, phase="multi"))
            log(f"i4g_matmul {name:7s}/tp{tp} [{n}x{k}] M=1: err {err:.3g} (tol "
                f"{MATMUL_RTOL * scale:.3g}), {ms:.4f} ms (bound {b_ms:.4f} ms, {b_by})"
                + ("" if cut is None else f"  [{cut['splits']} splits, {cut['blocks']} blocks]"))
            del planes, ins
    for h, d, c in MULTI_ATTN:  # every cell visible to the one row, as the record's shape
        kc, vc = _attn_cache(h, d, c, dev, g)
        n_l = kc.shape[0]
        pos = torch.arange(c, dtype=torch.int32, device=dev)
        seq = torch.zeros(c, 2, dtype=torch.int32, device=dev)
        seq[:, 0] = 1
        q = torch.randn(1, h, d, device=dev, generator=g)
        tok = (torch.tensor([c - 1], dtype=torch.int32, device=dev),
               torch.zeros(1, dtype=torch.int32, device=dev),
               torch.ones(1, dtype=torch.bool, device=dev))
        got = CA.cell_attention(q, kc, vc, pos, seq, *tok, layer=1, scale=d ** -0.5, hot=0)
        want = CA._cell_attention_plain(q, kc, vc, pos, seq, *tok, 1, d ** -0.5, None, c)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= ATTN_ATOL:
            raise AssertionError(f"cell_attention H=KVH={h} D={d} C={c}: max err {err}")
        it = iter(range(1 << 30))
        ms = gpu_ms(lambda: CA.cell_attention(q, kc, vc, pos, seq, *tok, layer=next(it) % n_l,
                                              scale=d ** -0.5, hot=0))
        io = 2 * h * c * d * 2 + nbytes(q, *tok) + c * 4 * (1 + seq.shape[1]) + h * d * 4
        b_ms, b_by = bound(io, 4 * h * c * d, "f32")
        details.append(dict(kernel="cell_attention", T=1, H=h, KVH=h, D=d, C=c, max_abs_err=err,
                            tol=ATTN_ATOL, ms=ms, bound_ms=b_ms, bound_by=b_by, phase="multi"))
        log(f"cell_attention T=1 H=KVH={h} D={d} C={c}: err {err:.3g} (tol {ATTN_ATOL}), "
            f"{ms:.4f} ms (bound {b_ms:.4f} ms, {b_by})")
        del kc, vc


def _multi_tp_logits(counters: dict, live: Path) -> dict:
    """The live llama at 7B width: InferenceContext over tp_mesh of 2 and 4
    entries against one device, over the prompt and live_check.STEPS
    single-token steps (the cell kernel at the shard-local heads), within
    live_check.LIVE_RTOL of max|logit| (the live model's card-against-CPU
    bar: on the H100 one other f32 order on one device moves these logits
    0.0138 and TP 0.0108-0.0178, PERF.md); one device with every matmul
    moved by 3e-7 shows that order's spread; the shards gathered in
    reverse order must land past the bar."""
    import numpy as np

    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.parallel.mesh import default_devices
    from pipeinfer_tpu_torch.parallel.tp import tp_mesh
    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.tools import live_check as LC

    params, cfg = load_model(live)
    toks = LC.live_tokens(cfg.n_vocab, SEED + 21)
    prompt, steps = toks[:LC.PREFILL], toks[LC.PREFILL:]

    def run(mesh=None):
        ctx = InferenceContext(params, cfg, n_cells=MULTI_N_CELLS, mesh=mesh)
        return _dcn_steps(ctx, prompt, steps)

    def spread(got, want):
        return max(float(np.abs(g - w).max()) for g, w in zip(got, want)) / scale

    want = run()
    scale = max(float(np.abs(w).max()) for w in want)
    with LC.perturbed_matmuls():
        order = spread(run(), want)
    errs, launches, fault = {}, {}, {}
    for tp in MULTI_TP:
        devs = default_devices(tp)
        got, launches[f"tp{tp}"] = _counted(counters, lambda: run(tp_mesh(devs)))
        errs[f"tp{tp}"] = spread(got, want)
        with _gathered_backwards():
            fault[f"tp{tp}"] = spread(run(tp_mesh(devs)), want)
    log(f"[multi] live {cfg.n_layers}L llama at 7B width over tp_mesh({[str(d) for d in devs]}"
        f"[:tp]): logits against one device {errs} of max|logit| {scale:.2f} (bar "
        f"{LC.LIVE_RTOL}); another f32 order on one device {order:.3g}; shards gathered "
        f"backwards {fault}; launches {launches}")
    bad = {k: v for k, v in errs.items() if not v <= LC.LIVE_RTOL}
    if bad:
        raise AssertionError(f"[multi] TP logits past {LC.LIVE_RTOL}: {bad}")
    missed = [k for k, v in fault.items() if not v > LC.LIVE_RTOL]
    if missed:
        raise AssertionError(f"[multi] the TP bar lets the backwards gather through at {missed}")
    for k, n in launches.items():
        if n["i4g_matmul"] == 0 or n["cell_attention"] == 0:
            raise AssertionError(f"[multi] the {k} context never launched i4g or cell "
                                 f"attention: {n}")
    del params
    return dict(errs=errs, f32_order=order, backwards=fault, logit_scale=scale,
                launches=launches, rtol=LC.LIVE_RTOL)


def _multi_flagship(counters: dict, n_predict: int) -> dict:
    """The controller over StagedInferenceContext(devices=4 entries, tp=2):
    2 stages x 2-way TP of the 7B Q4_K target cut to DCN_DEPTH layers, the
    5-layer draft on its own context; its stream == plain greedy, i4g and
    cell attention launched in it; tok/s beside the controller over the
    tp = 1 two-stage target, not gated."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.parallel.mesh import default_devices
    from pipeinfer_tpu_torch.parallel.stages import StagedInferenceContext
    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
    from pipeinfer_tpu_torch.spec.controller import PipeInferController
    from pipeinfer_tpu_torch.spec.params import SpecParams
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair, cut_depth

    t_full, d_path = cached_bench_pair(ROOT / "build" / "bench", "7b", "Q4_K", 0.02, log=log)
    t_path = cut_depth(t_full, t_full.with_name(f"target_d{DCN_DEPTH}.gguf"), DCN_DEPTH, log=log)
    tparams, tcfg = load_model(t_path)
    dparams, dcfg = load_model(d_path)
    prompt = [1] + np.random.default_rng(SEED).integers(3, tcfg.n_vocab, 31).tolist()
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    sp = SpecParams(n_draft=8, n_parallel=1, p_accept=0.1, p_split=0.9, max_inflight=4)
    want, _ = _greedy(InferenceContext(tparams, tcfg, n_cells=MULTI_N_CELLS), prompt, n_predict)
    devs = default_devices(4)
    timed, launches = {}, None
    for name, make in (
            ("staged2_tp1", lambda: StagedInferenceContext(
                tparams, tcfg, n_cells=MULTI_N_CELLS, devices=devs[:2])),
            ("staged2_tp2", lambda: StagedInferenceContext(
                tparams, tcfg, n_cells=MULTI_N_CELLS, devices=devs, tp=2))):
        tgt = make()
        c = PipeInferController(tgt, InferenceContext(dparams, dcfg, n_cells=MULTI_N_CELLS),
                                greedy, sp, eos_id=-1)
        if c.use_fused or c.use_corrected:
            raise AssertionError(f"[multi] the {name} target engaged the fused or corrected run")
        t1 = time.perf_counter()
        got, counts = _counted(counters, lambda: c.generate(list(prompt), n_predict,
                                                            ignore_eos=True))
        timed[name] = dict(tok_s=n_predict / (time.perf_counter() - t1),
                           acceptance=c.stats.n_accept / max(c.stats.n_drafted, 1))
        if got != want:
            first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(f"[multi] the controller over {name} differs from plain "
                                 f"greedy at token {first}: {got[first:first + 8]} vs "
                                 f"{want[first:first + 8]}")
        if name == "staged2_tp2":
            launches = counts
            groups = [[str(d) for d in g] for g in tgt.groups]
        del tgt, c
    for k in ("i4g_matmul", "cell_attention"):
        if launches[k] == 0:
            raise AssertionError(f"[multi] the 2 x 2 controller run never launched {k}")
    log(f"[multi] controller over 2 stages x 2-way TP ({tcfg.n_layers}L 7B target, groups "
        f"{groups}) == plain greedy over {n_predict} tokens; launches {launches}; tok/s on "
        f"{card_line()}: " + ", ".join(f"{k} {v['tok_s']:.1f} (acceptance "
                                        f"{v['acceptance']:.2f})" for k, v in timed.items()))
    del tparams, dparams
    gc.collect()
    torch.cuda.empty_cache()
    return dict(target=str(t_path), n_layers=tcfg.n_layers, groups=groups, n_predict=n_predict,
                engines=timed, launches=launches)


def _multi_tokens(n_vocab: int):
    """The fused step's streams [dp * mb, MULTI_PF_T]: one random stream per
    dp shard, repeated over its mb microbatches. The i4g kernel's
    activations share one scale per slab across all rows of a call (the
    head takes a dp shard's rows at once), so repeated rows keep each
    row's rounding that of the stream alone, as the one-device reference
    decodes it; the microbatches still pass the stages at different
    phases."""
    import numpy as np

    rows = np.random.default_rng(SEED + 23).integers(3, n_vocab, (MULTI_PF["dp"], MULTI_PF_T))
    return np.repeat(rows, MULTI_PF["mb"], axis=0).astype(np.int32)


def _multi_pipefused(counters: dict, live: Path) -> dict:
    """pp x tp x dp (MULTI_PF) with M microbatches over default_devices on
    the live llama: the prompt and one decode step of every stream against
    the port's one-device forward under the step's own roundings (its bf16
    token table and bf16 cache) within MULTI_PF_RTOL; the distance to the
    f32-table forward is logged. Returns the record and the step's prompt
    logits (the multihost check's reference)."""
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.models import llama as t_llama
    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.ops.qmatmul import dequant
    from pipeinfer_tpu_torch.parallel import pipefused as pf
    from pipeinfer_tpu_torch.runtime import kv_cache as KV

    params, cfg = load_model(live)
    c = MULTI_PF
    pc = pf.PipeConfig(n_stages=c["pp"], tp=c["tp"], dp=c["dp"], n_microbatches=c["mb"])
    mesh = pf.make_mesh(pc)
    toks = _multi_tokens(cfg.n_vocab)
    t = toks.shape[1]

    def run():
        stacked = pf.stack_params(params, cfg, pc, mesh)
        cache = pf.init_cache(cfg, pc, mesh, batch=toks.shape[0], max_len=64)
        step = pf.build_step(cfg, pc, mesh)
        first, cache = step(stacked, cache, toks, np.arange(t, dtype=np.int32))
        nxt, _ = step(stacked, cache, toks[:, :1], np.asarray([t], np.int32))
        return first.cpu().numpy(), nxt.cpu().numpy()

    (first, nxt), launches = _counted(counters, run)
    rounded = dict(params, tok_embd=dequant(params["tok_embd"], torch.bfloat16).float())

    dev = params["output_norm"].device

    def one_device(p, dtype, stream):
        cache = KV.create(cfg.n_layers, 64, cfg.n_kv_heads, cfg.head_dim, dtype, device=dev)
        out = []
        for tk, p0 in ((toks[stream], 0), (toks[stream, :1], t)):
            n = len(tk)
            ar = torch.arange(p0, p0 + n, dtype=torch.int32, device=dev)
            lg, _ = t_llama.forward(p, cfg, cache, torch.tensor(tk, device=dev), ar,
                                    torch.zeros(n, dtype=torch.int32, device=dev), ar,
                                    torch.ones(n, dtype=torch.bool, device=dev))
            out.append(lg.cpu().numpy())
        return out

    err = err_f32 = 0.0
    for b in range(toks.shape[0]):
        for got, w_r, w_f in zip((first[b], nxt[b]), one_device(rounded, torch.bfloat16, b),
                                 one_device(params, torch.float32, b)):
            err = max(err, float(np.abs(got - w_r).max() / np.abs(w_r).max()))
            err_f32 = max(err_f32, float(np.abs(got - w_f).max() / np.abs(w_f).max()))
    log(f"[multi] pipefused {c} on {mesh}: prompt T={t} and one step of {toks.shape[0]} streams "
        f"against one device {err:.3g} of max|logit| (bar {MULTI_PF_RTOL}), against the "
        f"f32-table f32-cache forward {err_f32:.3g}; launches {launches}")
    if not err <= MULTI_PF_RTOL:
        raise AssertionError(f"[multi] pipefused {err:.4g} from one device, past {MULTI_PF_RTOL}")
    if launches["i4g_matmul"] == 0:
        raise AssertionError("[multi] the fused step never launched i4g")
    del params
    return dict(config=c, prompt_t=t, streams=int(toks.shape[0]), err=err, err_f32_ref=err_f32,
                rtol=MULTI_PF_RTOL, launches=launches), first


def _multi_start_workers(live: Path, out_dir: Path) -> tuple[list, list[Path], list[Path]]:
    """Start the two multihost workers on the card (gloo over localhost)."""
    import socket

    import numpy as np

    from pipeinfer_tpu_torch.gguf.reader import GGUFReader
    from pipeinfer_tpu_torch.models.config import config_from_gguf

    with GGUFReader(live) as r:
        n_vocab = config_from_gguf(r).n_vocab
    script = out_dir / "multihost_worker.py"
    script.write_text(MULTI_WORKER)
    np.save(out_dir / "tokens.npy", _multi_tokens(n_vocab))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [out_dir / f"logits_{pid}.npy" for pid in range(2)]
    logs = [out_dir / f"worker_{pid}.log" for pid in range(2)]
    c = MULTI_PF
    procs = []
    for pid in range(2):
        with open(logs[pid], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(pid), str(port), str(outs[pid]), str(live),
                 str(out_dir / "tokens.npy"), MULTI_WORKER_DEVICE,
                 *(str(c[k]) for k in ("pp", "tp", "dp", "mb"))],
                stdout=f, stderr=subprocess.STDOUT, env=env))
    return procs, outs, logs


def _multi_join_workers(procs, logs, outs, want) -> dict:
    """Wait for the workers (the caller kills one still running past
    MULTI_WORKER_TIMEOUT); both must exit 0 with logits within
    MULTI_MH_RTOL of the one-process step's."""
    import numpy as np

    t0 = time.perf_counter()
    rcs = [p.wait(timeout=max(1.0, MULTI_WORKER_TIMEOUT - (time.perf_counter() - t0)))
           for p in procs]
    if rcs != [0, 0]:
        raise AssertionError(f"[multi] multihost workers exited {rcs}:\n"
                             + "\n".join(p.read_text()[-2000:] for p in logs))
    errs = []
    for out in outs:
        got = np.load(out)
        if got.shape != want.shape:
            raise AssertionError(f"[multi] multihost logits {got.shape}, want {want.shape}")
        errs.append(float(np.abs(got - want).max() / np.abs(want).max()))
    log(f"[multi] two processes on the card over gloo, global_mesh{tuple(MULTI_PF.values())}: "
        f"logits against one process's step {errs} of max|logit| (bar {MULTI_MH_RTOL}); "
        + "; ".join(p.read_text().strip().splitlines()[-1] for p in logs))
    if not all(e <= MULTI_MH_RTOL for e in errs):
        raise AssertionError(f"[multi] multihost logits {errs} past {MULTI_MH_RTOL}")
    return dict(errs=errs, rtol=MULTI_MH_RTOL, wait_s=time.perf_counter() - t0)


def run_multi(counters: dict, records: dict, n_predict: int) -> dict:
    """The multi-device phase on one card, every mesh entry on
    default_devices (cuda:i % device_count): the kernels at shard shapes,
    TP logits against one device, the controller over 2 stages x 2-way TP,
    the fused pp x tp x dp step and the same step over two processes (the
    workers start first and run while this process checks the rest)."""
    from pipeinfer_tpu_torch.parallel.mesh import default_devices
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair, cached_llama_live

    t_full, _ = cached_bench_pair(ROOT / "build" / "bench", "7b", "Q4_K", 0.02, log=log)
    live = cached_llama_live(t_full, log=log)
    out_dir = ROOT / "chiprun_out" / "multi"
    out_dir.mkdir(parents=True, exist_ok=True)
    log(f"[multi] mesh entries: {[str(d) for d in default_devices(4)]} (cuda:i % "
        f"{__import__('torch').cuda.device_count()} cards)")
    procs, outs, logs = _multi_start_workers(live, out_dir)
    try:
        details: list = []
        check_multi_shapes(details)
        tp = _multi_tp_logits(counters, live)
        flagship = _multi_flagship(counters, n_predict)
        pfr, want = _multi_pipefused(counters, live)
        mh = _multi_join_workers(procs, logs, outs, want)
    finally:
        for p in procs:  # a worker left waiting in a collective
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, rec in records.items():
        rec["launches_multi"] = {**{run: n[k] for run, n in tp["launches"].items()},
                                 "staged2_tp2": flagship["launches"][k],
                                 "pipefused": pfr["launches"][k]}
    return dict(label="multi", shapes=details, tp_logits=tp, flagship=flagship, pipefused=pfr,
                multihost=mh, card=card_line())


# ---------------------------------------------------------------------------


def share_pair_loads(*pair_dirs: Path) -> dict:
    """From here on, a load of a bench pair's target or draft in one of
    pair_dirs, or of its target cut to CLI_DEPTH layers, hands out the
    params its first load of the same arguments and weight layout made,
    instead of reading the file again: the run keeps them on the card. The
    7B pair's full-depth files are loaded by the main, serve and tools
    phases (load_model, the server's and the tools' build_context), its
    cut by the cli phase's main and speculative calls of one layout, the
    chat phase and the tools' --prompt-cache; the MPT pair by the arch
    phase's streams and its in-process CLIs. Returns the memo (arguments
    -> (params, config))."""
    from pipeinfer_tpu_torch import device as port_device
    from pipeinfer_tpu_torch import models
    from pipeinfer_tpu_torch.cli import main as cli_main
    from pipeinfer_tpu_torch.cli import pipeline as cli_pipeline
    from pipeinfer_tpu_torch.models import loader

    real, memo = loader.load_model, {}
    shared = {(d / n).resolve() for d in pair_dirs
              for n in ("target.gguf", "draft.gguf", f"target_d{CLI_DEPTH}.gguf")}

    def load_model(path, *, device=None, fuse=None):
        key = (Path(path).resolve(), str(port_device.resolve(device)), fuse,
               os.environ.get("PIPEINFER_WEIGHT_LAYOUT"))
        if key[0] not in shared:
            return real(path, device=device, fuse=fuse)
        if key not in memo:
            memo[key] = real(path, device=device, fuse=fuse)
        return memo[key]

    loader.load_model = models.load_model = cli_main.load_model = load_model
    cli_pipeline.load_model = load_model
    return memo


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="kernels,main,sample,i8g,cli,serve,arch,tools,train,llava,chat,dcn,"
                            "multi",
                    help="comma list of kernels, main, sample, i8g, cli, serve, arch, tools, "
                         "train, llava, chat, dcn, multi "
                         "(default: all); "
                         "qmatmul runs only the i4g and i8g part of kernels, exact only the "
                         "k_major, i8 and k4 part")
    ap.add_argument("--n-predict", type=int, default=128)
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "pipeinfer_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no pipeinfer_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pipeinfer_tpu_torch.ops import cell_attention as CA
    from pipeinfer_tpu_torch.ops import cuda_build
    from pipeinfer_tpu_torch.ops import qmatmul as Q

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = cuda_build.build_all(extra_flags=["-Xptxas", "-v"])
    took = {k: v[0] for k, v in built.items()}
    log(f"built kernels in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()))
    for k, (_, text) in built.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k}: {line.strip()}")

    counters = {"i4g_matmul": Q.i4g_matmul, "i8g_matmul": Q.i8g_matmul,
                "kmajor_matmul": Q.kmajor_matmul, "i8_matmul": Q.i8_matmul,
                "k4_matmul": Q.k4_matmul, "cell_attention": CA.cell_attention}
    records: dict = {}
    details: list = []
    runs: list = []
    phase_s: dict = {}

    def done(phase: str, t0: float) -> float:
        phase_s[phase] = time.perf_counter() - t0
        log(f"[{phase}] phase took {phase_s[phase]:.1f} s")
        return phase_s[phase]

    bench = ROOT / "build" / "bench"
    share_pair_loads(bench / "7b_Q4_K_eps0.02_vocab",
                     bench / f"mpt7b_Q4_K_eps{ARCH_EPS}_vocab_d{ARCH_DEPTH}")
    if phases & {"kernels", "qmatmul", "exact"}:
        t0 = time.perf_counter()
        if phases & {"kernels", "qmatmul"}:
            phase_qmatmul(records, details)
        if phases & {"kernels", "exact"}:
            phase_exact(records, details)
        if "kernels" in phases:
            phase_attention(records, details)
        done("kernels", t0)
    if "main" in phases:
        t0 = time.perf_counter()
        repack = run_native_repack()  # first: it times the library's build at first use
        runs.append(run_pair("7b_q4k", "7b", "Q4_K", 0.02, args.n_predict, counters))
        for k in ("i4g_matmul", "cell_attention"):
            if runs[-1]["launches"][k] == 0:
                raise AssertionError(f"the 7B main path never launched {k}")
            if k in records:
                records[k]["launches"] = runs[-1]["launches"][k]
        runs.append(repack)
        done("main", t0)
    if "sample" in phases:
        t0 = time.perf_counter()
        runs.extend(run_sample(counters, records))
        done("sample", t0)
    if "i8g" in phases:
        t0 = time.perf_counter()
        runs.append(run_pair("toy_q6k", "toy", "Q6_K", 0.02, args.n_predict, counters))
        for k in ("i8g_matmul", "cell_attention"):
            if runs[-1]["launches"][k] == 0:
                raise AssertionError(f"the Q6_K path never launched {k}")
        if "i8g_matmul" in records:
            records["i8g_matmul"]["launches"] = runs[-1]["launches"]["i8g_matmul"]
        done("i8g", t0)
    if "cli" in phases:
        t0 = time.perf_counter()
        from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair, cut_depth

        pair_7b = cached_bench_pair(bench, "7b", "Q4_K", 0.02, log=log)
        # the layouts' CLI runs load the target six times: its depth is cut
        # (the bench pair's stream does not depend on it) to keep the run short
        pair_7b = (cut_depth(pair_7b[0], pair_7b[0].with_name(f"target_d{CLI_DEPTH}.gguf"),
                             CLI_DEPTH, log=log), pair_7b[1])
        for layout, kernel in (("k_major", "kmajor_matmul"), ("i8", "i8_matmul"),
                               ("k4", "k4_matmul")):
            label = f"cli_{layout}_{pair_7b[0].parent.name}_d{CLI_DEPTH}"
            runs.append(run_cli_layout(label, layout, pair_7b, args.n_predict, counters, kernel))
            if kernel in records:
                records[kernel]["launches"] = runs[-1]["launches"][kernel]
        texts = {r["layout"]: r["text_sha256"] for r in runs if "text_sha256" in r}
        if len(set(texts.values())) != 1:
            raise AssertionError(f"the 7B CLI printed different text per layout: {texts}")
        log(f"the 7B CLI printed the same text under {', '.join(texts)}")
        runs.append(run_cli_engines(cached_bench_pair(bench, "toy", "Q6_K", 0.02, log=log),
                                    args.n_predict))
        done("cli", t0)
    if "serve" in phases:
        t0 = time.perf_counter()
        check_serve_shapes(details)
        runs.append(run_serve(counters, args.n_predict))
        for k, rec in records.items():  # launches per serve run, beside the main path's
            rec["launches_serve"] = {run: n[k] for run, n in runs[-1]["launches"].items()}
        done("serve", t0)
    if "arch" in phases:
        t0 = time.perf_counter()
        check_arch_shapes(records, details)
        runs.extend(run_arch(counters, records, args.n_predict))
        done("arch", t0)
    if "tools" in phases:
        t0 = time.perf_counter()
        check_tools_shapes(records, details)
        runs.extend(run_tools(counters, records))
        done("tools", t0)
    if "train" in phases:
        t0 = time.perf_counter()
        runs.extend(run_train(counters, records))
        done("train", t0)
    if "llava" in phases:
        t0 = time.perf_counter()
        runs.extend(run_llava(counters, records))
        done("llava", t0)
    if "chat" in phases:
        t0 = time.perf_counter()
        runs.extend(run_chat(counters, records))
        done("chat", t0)

    if "dcn" in phases:
        t0 = time.perf_counter()
        runs.append(run_dcn(counters, records, args.n_predict))
        done("dcn", t0)
    if "multi" in phases:
        t0 = time.perf_counter()
        runs.append(run_multi(counters, records, args.n_predict))
        runs[-1]["phase_s"] = done("multi", t0)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=took,
             phase_s=phase_s, kernels=details, runs=runs,
             total_s=time.perf_counter() - t_start), indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
