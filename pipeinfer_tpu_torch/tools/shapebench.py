"""Shape-faithful performance probe: synthesizes quantized models of real
production shapes (7B target / 1.1B draft / ...) directly in device memory
(no GGUF build, no host quantization of the whole model) and measures the
decode-path step times against the device-memory roofline.

Torch counterpart of pipeinfer_tpu.tools.shapebench. Single-token decode
of a quantized model is bound by device memory: every step must stream the
full packed weight bytes, so

    bandwidth utilization = packed_bytes / (step_time * PEAK_BW)

is the honest "percent of roofline" figure (MFU is ~0 by construction at
batch 1; it is reported for the batched verify shapes too). The weights
are Q4_K in the k_major layout: one real 256 x 128 tile quantized and
packed by the port's own packer, tiled over each tensor (timing does not
depend on the values, and the planes are valid).

Usage: python -m pipeinfer_tpu_torch.tools.shapebench [--model 7b] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

SHAPES = {
    # llama-7B (the BASELINE.md Orca-2 7B class target)
    "7b": dict(n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=32, n_ff=11008, n_vocab=32000),
    # TinyLlama-1.1B (the BASELINE.md draft)
    "1.1b": dict(n_layers=22, n_embd=2048, n_heads=32, n_kv_heads=4, n_ff=5632, n_vocab=32000),
    # round-1 bench target shape
    "220m": dict(n_layers=12, n_embd=1024, n_heads=16, n_kv_heads=8, n_ff=2816, n_vocab=32000),
    "13b": dict(n_layers=40, n_embd=5120, n_heads=40, n_kv_heads=40, n_ff=13824, n_vocab=32000),
}

# peaks of an NVIDIA H100 SXM (80GB HBM3), data sheet: 3.35 TB/s of device
# memory, 989 TFLOP/s dense bf16 on the tensor cores
PEAK_BW = 3.35e12
PEAK_FLOPS = 989e12

_TILE_N, _TILE_K = 128, 256  # one packed tile: 128 rows of W, one 256-wide pack group


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _tile(layout: str, device) -> tuple:
    """(qs, scales, bias) planes of one random Q4_K tile [128, 256] in
    `layout` on `device`, quantized and packed as the loader does."""
    from ..gguf.constants import GGMLQuantType
    from ..ops.qmatmul import to_device
    from ..quant.pack import pack_array

    w = np.random.default_rng(0).standard_normal((_TILE_N, _TILE_K)).astype(np.float32) * 0.02
    qt = to_device(pack_array(w, GGMLQuantType.Q4_K), layout=layout, device=device)
    return qt.qs, qt.scales, qt.bias


def synth_qtensor(n: int, k: int, layout: str = "k_major", device="cuda"):
    """A Q4_K QuantTensor [n, k] (k % 256 == 0) in `layout` (k_major for
    matmuls, n_major for the embedding) on `device`: one packed tile
    repeated over the tensor."""
    from ..gguf.constants import GGMLQuantType
    from ..ops.qmatmul import QuantTensor

    reps_n, reps_k = -(-n // _TILE_N), k // _TILE_K
    planes = []
    for p in _tile(layout, device):
        if layout == "k_major":  # planes [K rows, N]
            planes.append(p.repeat(reps_k, reps_n)[:, :n].contiguous())
        else:  # n_major: planes [N, K cols]
            planes.append(p.repeat(reps_n, reps_k)[:n].contiguous())
    qs, scales, bias = planes
    return QuantTensor(qs=qs, qh=None, scales=scales, bias=bias, qtype=GGMLQuantType.Q4_K,
                       shape=(n, k), layout=layout)


def synth_params(shape: dict, device="cuda"):
    """Quantized llama-family params of the given shape, on `device`; the
    projections fused as the loader fuses them there."""
    from ..models.loader import default_fuse, fuse_projections

    e, ff, v = shape["n_embd"], shape["n_ff"], shape["n_vocab"]
    kvd = shape["n_kv_heads"] * (e // shape["n_heads"])

    def q(n, k, layout="k_major"):
        return synth_qtensor(n, k, layout, device)

    def ones():
        return torch.ones(e, dtype=torch.float32, device=device)

    params = {"tok_embd": q(v, e, "n_major"), "output_norm": ones(), "output": q(v, e)}
    params["layers"] = [
        {"attn_norm": ones(), "wq": q(e, e), "wk": q(kvd, e), "wv": q(kvd, e), "wo": q(e, e),
         "ffn_norm": ones(), "w_gate": q(ff, e), "w_up": q(ff, e), "w_down": q(e, ff)}
        for _ in range(shape["n_layers"])
    ]
    if default_fuse(device):
        fuse_projections(params)
    return params


def model_bytes(params) -> int:
    """Bytes of every tensor and quantized plane in a parameter tree."""
    from ..ops.qmatmul import QuantTensor

    if isinstance(params, QuantTensor):
        return params.nbytes()
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(model_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(model_bytes(v) for v in params)
    return 0


def make_config(shape: dict):
    from ..models.config import ModelConfig

    hd = shape["n_embd"] // shape["n_heads"]
    return ModelConfig(
        arch="llama",
        n_vocab=shape["n_vocab"],
        n_embd=shape["n_embd"],
        n_layers=shape["n_layers"],
        n_heads=shape["n_heads"],
        n_kv_heads=shape["n_kv_heads"],
        n_ff=shape["n_ff"],
        head_dim=hd,
        rope_dims=hd,
        rope_mode="norm",
    )


def time_fn(fn, iters=8, warmup=2):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def _prefill(ctx, n: int = 128):
    from ..runtime.context import Batch

    b = Batch()
    for i in range(n):
        b.add(int(i % 1000 + 10), i, 0, want_logits=(i == n - 1))
    ctx.decode(b, 128)


def probe(shape: dict, dshape: dict | None = None, *, name: str = "", n_cells: int = 2048,
          iters: int = 8, device="cuda") -> dict:
    """Synthesize `shape` (and the draft `dshape`) on `device`, prefill 128
    tokens and time the decode step at batch 1, the verify steps at 8 and
    32, the on-device greedy chains at depth 8 and 32, the host fetch round
    trip and the draft's chains. Returns the results dict."""
    from ..device import resolve
    from ..runtime.context import Batch, InferenceContext

    device = resolve(device)
    results = {}
    t0 = time.perf_counter()
    params = synth_params(shape, device)
    cfg = make_config(shape)
    nbytes = model_bytes(params)
    log(f"{name}: synthesized {nbytes / 1e9:.2f} GB packed in "
        f"{time.perf_counter() - t0:.1f}s")
    results["model"] = name
    results["packed_gb"] = round(nbytes / 1e9, 3)

    ctx = InferenceContext(params, cfg, n_cells=n_cells, device=device)
    t0 = time.perf_counter()
    _prefill(ctx)
    log(f"prefill(128): {time.perf_counter() - t0:.1f}s")

    # single-token decode step (the memory-bound hot loop)
    n_past = [128]

    def step1():
        bb = Batch()
        bb.add(11, n_past[0], 0)
        ctx.decode(bb, 128)
        n_past[0] += 1

    dt1 = time_fn(step1, iters)
    bw1 = nbytes / dt1
    log(f"decode step (batch 1): {dt1 * 1e3:.2f} ms  -> {bw1 / 1e9:.0f} GB/s "
        f"({100 * bw1 / PEAK_BW:.1f}% of roofline), {1 / dt1:.1f} tok/s host loop")
    results["step1_ms"] = round(dt1 * 1e3, 3)
    results["step1_bw_frac"] = round(bw1 / PEAK_BW, 4)

    # batched verify step (tree of 32 draft tokens in one pass)
    for bs in (8, 32):
        def stepb(bs=bs):
            bb = Batch()
            for j in range(bs):
                bb.add(11 + j, n_past[0] + j, 0)
            h = ctx.decode_async(bb, 128)
            h.fetch()
            ctx.rm_tail(n_past[0])

        dtb = time_fn(stepb, iters)
        flops = 2 * (nbytes / 0.75) * bs  # ~params*2 flops/token (k_major Q4_K: 0.75 B/param)
        log(f"verify step (batch {bs}): {dtb * 1e3:.2f} ms  "
            f"({nbytes / dtb / 1e9:.0f} GB/s eff, mfu {100 * flops / dtb / PEAK_FLOPS:.1f}%)")
        results[f"step{bs}_ms"] = round(dtb * 1e3, 3)

    # on-device greedy chain: the draft loop / multi-step baseline probe
    for depth in (8, 32):
        def chain(depth=depth):
            ctx.draft_chain(11, n_past[0], 1, depth, n_cand=8)
            ctx.seq_rm(1, 0, -1)

        dtc = time_fn(chain, max(2, iters // 2))
        log(f"chain depth {depth}: {dtc * 1e3:.2f} ms "
            f"({dtc / depth * 1e3:.2f} ms/tok, {depth / dtc:.1f} tok/s)")
        results[f"chain{depth}_ms"] = round(dtc * 1e3, 3)

    # host fetch round trip
    x = torch.ones(8, device=device)

    def fetch():
        (x * 2).cpu().numpy()

    dtf = time_fn(fetch, 16)
    log(f"host fetch RTT: {dtf * 1e3:.3f} ms")
    results["fetch_ms"] = round(dtf * 1e3, 4)
    del ctx, params

    if dshape is not None:
        dparams = synth_params(dshape, device)
        dbytes = model_bytes(dparams)
        dctx = InferenceContext(dparams, make_config(dshape), n_cells=n_cells, device=device)
        log(f"draft: {dbytes / 1e9:.2f} GB packed")
        _prefill(dctx)

        for depth in (8, 32):
            def dchain(depth=depth):
                dctx.draft_chain(11, 128, 1, depth, n_cand=8)
                dctx.seq_rm(1, 0, -1)

            dtd = time_fn(dchain, max(2, iters // 2))
            log(f"draft chain depth {depth}: {dtd * 1e3:.2f} ms "
                f"({dtd / depth * 1e3:.2f} ms/tok; weights want "
                f"{dbytes * depth / PEAK_BW * 1e3:.1f} ms)")
            results[f"draft_chain{depth}_ms"] = round(dtd * 1e3, 3)
        results["draft_packed_gb"] = round(dbytes / 1e9, 3)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="7b", choices=sorted(SHAPES))
    ap.add_argument("--draft", default="1.1b", choices=sorted(SHAPES) + ["none"])
    ap.add_argument("--n-cells", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    res = probe(SHAPES[args.model], None if args.draft == "none" else SHAPES[args.draft],
                name=args.model, n_cells=args.n_cells, iters=args.iters, device=args.device)
    if args.json:
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
