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
   of their type, whichever is larger);
4. the main path at full width: the llama-2-7B-shaped Q4_K bench pair
   (random weights from a seed, built into build/bench/ and reused), plain
   greedy decode and then PipeInferController in device-corrected greedy
   mode on the same prompt; the streams must be identical and every
   kernel's launch count over the controller run above 0;
5. the i8g path: the same on the toy-scale Q6_K pair, where every matmul
   goes through the i8g kernel.

The last lines printed are the card line, one JSON line with a record per
kernel, and {"ok": true, "device": {...}}. Details of every shape go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
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
    torch.cuda._sleep(200_000_000)  # ~0.1 s of GPU clock
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
I8G_SHAPES = {"wo": (4096, 4096), "w_down": (4096, 11008)}
MS = (1, 9, 33)
MATMUL_RTOL = 1e-4  # of max|plain|: exact integer dots, f32 order of the scaled sums
ATTN_ATOL = 1e-4  # f32 online vs one-pass softmax, summation order


def _rand_i4g(n, k, dev, g):
    import torch

    kp = -(-k // 256) * 256
    qs = torch.randint(0, 256, (kp // 2, n), dtype=torch.uint8, device=dev, generator=g)
    step = torch.rand(kp // 128, n, device=dev, generator=g) * 0.01 + 1e-3
    wmin = -torch.rand(kp // 128, n, device=dev, generator=g) * 0.08
    return qs, step, wmin


def phase_qmatmul(records: dict, details: list):
    import torch

    from pipeinfer_tpu_torch.ops import qmatmul as Q

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rep = {}
    for layout, shapes in (("i4g", I4G_SHAPES), ("i8g", I8G_SHAPES)):
        worst = 0.0
        for name, (n, k) in shapes.items():
            if layout == "i4g":
                planes = [_rand_i4g(n, k, dev, g) for _ in range(copies_for(n * k // 2))]
                qs, step, wmin = planes[0]
                qt = Q.QuantTensor(qs, None, step, wmin, qtype=None, shape=(n, k), layout="i4g")
            else:
                kp = -(-k // 512) * 512
                planes = [(torch.randint(-127, 128, (kp, n), dtype=torch.int8, device=dev,
                                         generator=g),
                           torch.rand(kp // 512, n, device=dev, generator=g) * 1e-3 + 1e-4)
                          for _ in range(copies_for(kp * n))]
                qt = Q.QuantTensor(planes[0][0], None, planes[0][1], planes[0][1][:0],
                                   qtype=None, shape=(n, k), layout="i8g")
            w_bf16 = Q.dequant_T(qt, torch.bfloat16)  # [K, N], for the yardstick only
            for m in MS:
                x = torch.randn(m, k, device=dev, generator=g)
                if layout == "i4g":
                    kp = planes[0][0].shape[0] * 2
                    xq, sx = Q.quantize_activations(x, kp, Q.I4G_HALF)
                    xsum = xq.reshape(m, kp // 128, 128).sum(dim=2, dtype=torch.int32).float()
                    ins = [(xq, xsum, sx, *p) for p in planes]
                    kern, plain, name_k = Q.i4g_matmul, Q._i4g_plain, "i4g_matmul"
                    ops, kind = 2 * m * n * kp, "int8"
                else:
                    kp = planes[0][0].shape[0]
                    xq, sx = Q.quantize_activations(x, kp, Q.I8G_SLAB)
                    ins = [(xq, sx, *p) for p in planes]
                    kern, plain, name_k = Q.i8g_matmul, Q._i8g_plain, "i8g_matmul"
                    ops, kind = 2 * m * n * kp, "int8"
                got = kern(*ins[0])
                want = plain(*ins[0])
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                if not err <= MATMUL_RTOL * scale:
                    raise AssertionError(f"{name_k} {name} M={m}: max err {err} > "
                                         f"{MATMUL_RTOL} * {scale}")
                worst = max(worst, err)
                it = iter(range(1 << 30))
                k_ms = gpu_ms(lambda: kern(*ins[next(it) % len(ins)]), iters=20)
                p_ms = gpu_ms(lambda: plain(*ins[0]), iters=3, warmup=1)
                xb = x.to(torch.bfloat16)
                lib_ms = gpu_ms(lambda: xb @ w_bf16, iters=20)
                b_ms, b_by = bound(nbytes(*ins[0]) + m * n * 4, ops, kind)
                row = dict(kernel=name_k, tensor=name, N=n, K=k, M=m, max_abs_err=err,
                           tol=MATMUL_RTOL * scale, ms=k_ms, plain_ms=p_ms, yardstick_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by)
                details.append(row)
                log(f"{name_k:11s} {name:7s} [{n}x{k}] M={m:2d}: err {err:.3g} "
                    f"(tol {MATMUL_RTOL * scale:.3g})  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
                    f"  bf16 GEMM {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
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


def phase_attention(records: dict, details: list):
    import torch
    import torch.nn.functional as F

    from pipeinfer_tpu_torch.ops import cell_attention as CA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_l, kvh, h, d, c, w = 4, 32, 32, 128, 4096, 2
    kc = torch.randn(n_l, kvh, c, d, device=dev, generator=g).to(torch.bfloat16)
    vc = torch.randn(n_l, kvh, c, d, device=dev, generator=g).to(torch.bfloat16)
    rep = None
    worst = 0.0
    for hot in (0, 2048):
        used = hot or c
        pos = torch.full((c,), -1, dtype=torch.int32, device=dev)
        pos[:used] = torch.arange(used, dtype=torch.int32, device=dev)
        seq = torch.zeros(c, w, dtype=torch.int32, device=dev)
        seq[:used, 0] = 1 | (torch.randint(0, 2, (used,), device=dev, generator=g) << 1).int()
        for t in (1, 4, 33):
            q = torch.randn(t, h, d, device=dev, generator=g)
            tok_pos = torch.randint(used // 2, used, (t,), device=dev, generator=g).int()
            tok_seq = torch.randint(0, 2, (t,), device=dev, generator=g).int()
            valid = torch.ones(t, dtype=torch.bool, device=dev)
            if t > 1:
                valid[-1] = False
            args = (q, kc, vc, pos, seq, tok_pos, tok_seq, valid)
            kw = dict(scale=d ** -0.5, hot=hot)
            got = CA.cell_attention(*args, layer=1, **kw)
            cc = hot or c
            want = CA._cell_attention_plain(q, kc, vc, pos, seq, tok_pos, tok_seq, valid, 1,
                                            d ** -0.5, None, cc)
            torch.cuda.synchronize()
            err = (got[valid] - want[valid]).abs().max().item()
            if not err <= ATTN_ATOL:
                raise AssertionError(f"cell_attention T={t} hot={hot}: max err {err}")
            worst = max(worst, err)
            it = iter(range(1 << 30))
            k_ms = gpu_ms(lambda: CA.cell_attention(*args, layer=next(it) % n_l, **kw))
            p_ms = gpu_ms(lambda: CA._cell_attention_plain(
                q, kc, vc, pos, seq, tok_pos, tok_seq, valid, 1, d ** -0.5, None, cc),
                iters=3, warmup=1)
            # library call: SDPA over the same layer with the visibility
            # as an additive mask (built outside the timed call)
            mask = torch.where(
                ((seq[:cc].long()[:, (tok_seq // 32).long()] >> (tok_seq % 32).long()[None])
                 & 1).T.bool() & (pos[None, :cc] <= tok_pos[:, None]) & (pos[None, :cc] >= 0)
                & valid[:, None], 0.0, -1e9).to(torch.bfloat16)
            qb = q.to(torch.bfloat16).transpose(0, 1)[None]  # [1, H, T, D]
            kl, vl = kc[1, :, :cc][None], vc[1, :, :cc][None]
            lib_ms = gpu_ms(lambda: F.scaled_dot_product_attention(qb, kl, vl, attn_mask=mask))
            io = 2 * kvh * cc * d * 2 + nbytes(q, tok_pos, tok_seq, valid) + cc * 4 * (1 + w) \
                + t * h * d * 4
            b_ms, b_by = bound(io, 4 * t * h * cc * d, "f32")
            row = dict(kernel="cell_attention", T=t, C=c, hot=hot, H=h, KVH=kvh, D=d,
                       max_abs_err=err, tol=ATTN_ATOL, ms=k_ms, plain_ms=p_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            details.append(row)
            log(f"cell_attention T={t:2d} C={c} hot={hot:4d}: err {err:.3g} (tol {ATTN_ATOL})"
                f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  SDPA {lib_ms:.4f} ms"
                f"  bound {b_ms:.4f} ms ({b_by})")
            if t == 1 and hot == 0:
                rep = row
    records["cell_attention"] = dict(
        name="cell_attention", route="cuda", source="pipeinfer_tpu_torch/csrc/cell_attention.cu",
        replaces="pipeinfer_tpu/ops/cell_attention.py:27", launches=0, max_abs_err=worst,
        ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
        bound_by=rep["bound_by"], library_ms=rep["library_ms"],
        library="F.scaled_dot_product_attention bf16 with an additive mask",
        shape=f"T=1 H=KVH=32 D=128 C={c} (whole pool)")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def run_pair(label: str, scale: str, qtype_name: str, eps: float, n_predict: int,
             counters: dict) -> dict:
    import numpy as np
    import torch

    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
    from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
    from pipeinfer_tpu_torch.spec.controller import PipeInferController
    from pipeinfer_tpu_torch.spec.params import SpecParams
    from pipeinfer_tpu_torch.tools.benchpair import cached_bench_pair

    t_path, d_path = cached_bench_pair(ROOT / "build" / "bench", scale, qtype_name, eps, log=log)
    t0 = time.perf_counter()
    tparams, tcfg = load_model(t_path)
    dparams, dcfg = load_model(d_path)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    log(f"[{label}] loaded {tcfg.n_layers}L target + {dcfg.n_layers}L draft "
        f"(n_embd {tcfg.n_embd}, n_ff {tcfg.n_ff}, vocab {tcfg.n_vocab}) in {t_load:.1f} s")

    rng = np.random.default_rng(SEED)
    prompt = [1] + rng.integers(3, tcfg.n_vocab, 31).tolist()
    n_cells = 1024  # >= 512 and a multiple of it: draft steps take the flash kernel
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    sp = SpecParams(n_draft=8, n_parallel=1, p_accept=0.1, p_split=0.9, max_inflight=4)

    def plain(n):
        ctx = InferenceContext(tparams, tcfg, n_cells=n_cells)
        b = Batch()
        for i, t in enumerate(prompt):
            b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
        first = int(np.argmax(ctx.decode(b)[-1]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rest, _ = ctx.draft_chain(first, len(prompt), 0, n - 1, n_cand=0)
        return [first] + rest, time.perf_counter() - t1

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
               prompt_len=len(prompt), n_cells=n_cells, load_s=t_load,
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


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,main,i8g",
                    help="comma list of kernels, main, i8g (default: all)")
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
                "cell_attention": CA.cell_attention}
    records: dict = {}
    details: list = []
    runs: list = []
    if "kernels" in phases:
        phase_qmatmul(records, details)
        phase_attention(records, details)
    if "main" in phases:
        runs.append(run_pair("7b_q4k", "7b", "Q4_K", 0.02, args.n_predict, counters))
        for k in ("i4g_matmul", "cell_attention"):
            if runs[-1]["launches"][k] == 0:
                raise AssertionError(f"the 7B main path never launched {k}")
            if k in records:
                records[k]["launches"] = runs[-1]["launches"][k]
    if "i8g" in phases:
        runs.append(run_pair("toy_q6k", "toy", "Q6_K", 0.02, args.n_predict, counters))
        for k in ("i8g_matmul", "cell_attention"):
            if runs[-1]["launches"][k] == 0:
                raise AssertionError(f"the Q6_K path never launched {k}")
        if "i8g_matmul" in records:
            records["i8g_matmul"]["launches"] = runs[-1]["launches"]["i8g_matmul"]

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=took,
             kernels=details, runs=runs, total_s=time.perf_counter() - t_start), indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
