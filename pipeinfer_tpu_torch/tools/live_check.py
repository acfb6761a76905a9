"""The live-model check and the faults its bar must catch.

A bench pair's attention never reaches its logits (its attn_output and
ffn_down are zero), so a wrong ALiBi or a wrong cell would not show in any
stream. The live model (``testmodel.build_mpt_bench_pair(live_path=...)``)
has non-zero ones: its logits after a 9-token prefill and 8 single-token
steps, whose attention takes the cell kernel, are compared between the
card and the CPU within ``LIVE_RTOL`` of max|logit|.

The bar sits between two measured spreads:

- the floor: two f32 summation orders apart. ``perturbed_matmuls`` moves
  every quantized matmul's output by a relative ``rel`` (about 3 ulp, as a
  kernel's other order of f32 sums does): a run under it against a plain
  run on the same device shows the spread one other order makes;
- the faults: ``fault(name)`` runs the single-token steps through the cell
  kernel (its plain version on CPU tensors) with its inputs rewritten as a
  faulty kernel would read them (``FAULTS``). Each must move the logits
  by more than the bar.

Shifting every visible cell's ALiBi position by the same amount adds one
constant to each row's scores, which the softmax takes out again: no
output can show it, and none is wrong for it. The positional faults here
move cells against each other.

    python -m pipeinfer_tpu_torch.tools.live_check [--scale mpt_nano]

builds the live model at ``scale`` (``testmodel.MPT_SCALES``) and prints
the floor and each fault's spread on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..models import clip, llama
from ..models import train
from ..runtime import kv_cache as kv
from ..runtime.context import Batch, InferenceContext

# of max|logit|: on an H100 80GB HBM3 at 700 W, at MPT-7B width, the card
# against the CPU and one other f32 order on the card both spread about
# 0.015, and the weakest fault 0.19 (PERF.md): the bar sits between them,
# about 3x from each
LIVE_RTOL = 0.05
# The tools' live check in chip_smoke.py (a 2-layer llama at 7B width,
# testmodel.build_llama_live; perplexity at n_ctx 128 over two windows and
# one 13-token embedding, card against CPU): the perplexity's relative
# difference and the unit embeddings' max |difference|. On an H100 80GB
# HBM3 at 700 W the card against the CPU spread 1.4e-3 and 4.4e-4, one
# other f32 order on the card 1.8e-3 and 4.2e-4, and the weakest of
# MASK_FAULTS moved them by 8.6e-3 and 0.023 (PERF.md): each bar sits
# between, about 2x over the spread and 2x under the perplexity's weakest
# fault, 7x from each side for the embedding
LIVE_PPL_RTOL = 4e-3
LIVE_EMBED_ATOL = 3e-3
PREFILL = 9  # prompt tokens of the live run; 8 single-token steps follow
STEPS = 8
N_CELLS = 1024


def _own_cell_dropped(pos, tok_pos, alibi):
    return torch.where(pos == tok_pos[:1], -1, pos), alibi


def _oldest_cell_dropped(pos, tok_pos, alibi):
    return torch.where(pos == 0, -1, pos), alibi


def _positions_one_cell_on(pos, tok_pos, alibi):
    # each cell's position read from the next cell: the newest cell takes a
    # free cell's -1, and one stale position goes to the oldest cell's left
    return torch.cat([pos[1:], pos.new_full((1,), -1)]), alibi


def _slopes_one_head_off(pos, tok_pos, alibi):
    return pos, torch.roll(alibi, 1)


FAULTS = {  # name -> (cell_pos, tok_pos, alibi) -> (cell_pos, alibi) as the kernel reads them
    "own cell dropped": _own_cell_dropped,
    "oldest cell dropped": _oldest_cell_dropped,
    "positions read one cell on": _positions_one_cell_on,
    "ALiBi slopes one head off": _slopes_one_head_off,
}


@contextlib.contextmanager
def fault(name: str):
    """Within: attend sends every step of at most FLASH_SMALL_T rows to the
    cell kernel (the plain version on the CPU), with FAULTS[name] applied
    to the kernel's cell positions and ALiBi slopes."""
    real_kernel, real_use = kv.cell_attention, kv.use_cell_kernel
    rewrite = FAULTS[name]

    def use(t, h, kvh, d, c, hot, on_cuda):
        return t <= kv.FLASH_SMALL_T and kv.cell_kernel_supports(d, hot or c, h, kvh)

    def faulty(q, k, v, cell_pos, cell_seq, tok_pos, tok_seq, valid, *, alibi=None, **kw):
        cell_pos, alibi = rewrite(cell_pos, tok_pos, alibi)
        return real_kernel(q, k, v, cell_pos, cell_seq, tok_pos, tok_seq, valid, alibi=alibi,
                           **kw)

    kv.cell_attention, kv.use_cell_kernel = faulty, use
    try:
        yield
    finally:
        kv.cell_attention, kv.use_cell_kernel = real_kernel, real_use


@contextlib.contextmanager
def perturbed_matmuls(rel: float = 3e-7, seed: int = 0):
    """Within: every quantized matmul's output, and every product of the
    training forward (models/train._mm), times (1 + rel * N(0, 1)), drawn
    from `seed` on the CPU: another order of the f32 sums."""
    real, real_mm = llama.qmatmul, train._mm
    g = torch.Generator().manual_seed(seed)

    def moved(y):
        return y * (1 + rel * torch.randn(y.shape, generator=g, device="cpu").to(y.device))

    llama.qmatmul = lambda x, w: moved(real(x, w))
    train._mm = lambda x, w: moved(real_mm(x, w))
    try:
        yield
    finally:
        llama.qmatmul, train._mm = real, real_mm


# The tools' live check: perplexity windows and the embedding's one step
# are many rows each, so they take the dense path, whose visibility is the
# mask (kv.attn_mask). A fault there rewrites the mask as a faulty
# visibility rule would make it.


def _next_cell_visible(real, cache, tok_pos, tok_seq):
    return real(cache, tok_pos + 1, tok_seq)  # each row sees the token it predicts


def _own_cell_hidden(real, cache, tok_pos, tok_seq):
    return real(cache, tok_pos - 1, tok_seq)


def _oldest_cell_hidden(real, cache, tok_pos, tok_seq):
    return torch.where((cache.pos == 0)[None, :], kv.MASK_VALUE, real(cache, tok_pos, tok_seq))


MASK_FAULTS = {  # name -> (attn_mask, cache, tok_pos, tok_seq) -> mask [T, C]
    "next cell visible": _next_cell_visible,
    "own cell hidden": _own_cell_hidden,
    "oldest cell hidden": _oldest_cell_hidden,
}


@contextlib.contextmanager
def mask_fault(name: str):
    """Within: every step's attention mask is MASK_FAULTS[name]'s."""
    real, rewrite = kv.attn_mask, MASK_FAULTS[name]
    kv.attn_mask = lambda cache, tok_pos, tok_seq: rewrite(real, cache, tok_pos, tok_seq)
    try:
        yield
    finally:
        kv.attn_mask = real


# The training forward's check in chip_smoke.py (the 2-layer live llama at
# 7B width, finetune's dense_params on the card; lm_loss and its gradient
# at B = 2, T = 64, card against CPU): the loss's relative difference and,
# over the parameter tensors, the largest max|g_card - g_cpu| / max|g_cpu|.
# Each of TRAIN_FAULTS on the card must land past both bars. On an H100
# 80GB HBM3 at 700 W the card against the CPU spread 0 (the f32 loss's
# ulp is 1e-7 of it) and 4.3e-6, one other f32 order on the card 0 and
# 3.6e-6, and the weakest fault moved them by 9.8e-5 and 0.71 (PERF.md):
# the loss bar sits 100 ulp over and 10x under, the gradient bar 23x over
# the spread and 7000x under the weakest fault
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4


def _next_token_visible(real):
    def mask(t, device):
        keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device), diagonal=1)
        return torch.where(keep, 0.0, -1e9)

    return mask


def _first_token_hidden(real):
    def mask(t, device):
        m = real(t, device).clone()
        m[1:, 0] = -1e9
        return m

    return mask


def _rope_turned_back(real):
    def tables(cfg, t, device):
        cos, sin = real(cfg, t, device)
        return cos, -sin

    return tables


TRAIN_FAULTS = {  # name -> (models.train function, (the real one) -> its faulty form)
    "next token visible": ("causal_mask", _next_token_visible),
    "first token hidden": ("causal_mask", _first_token_hidden),
    "RoPE turned back": ("rope_tables", _rope_turned_back),
}


@contextlib.contextmanager
def train_fault(name: str):
    """Within: the training forward's causal mask or RoPE tables are
    TRAIN_FAULTS[name]'s."""
    attr, make = TRAIN_FAULTS[name]
    real = getattr(train, attr)
    setattr(train, attr, make(real))
    try:
        yield
    finally:
        setattr(train, attr, real)


# The image tower's check in chip_smoke.py (llava phase: the CLIP ViT-L/14-336
# tower and LLaVA-1.5 projector of testmodel.build_mmproj, f32, TF32 off):
# max|embedding card - CPU| over max|embedding CPU|. Its floor is one other
# f32 order (clip_other_order: every product summed over K in two halves),
# and each of CLIP_FAULTS must land past it. On an H100 80GB HBM3 at 700 W
# the card against the CPU spread 1.4e-6 (a square and a non-square image),
# the other order on the card 1.3e-6, and the faults 0.25 (last block
# kept), 0.61 (class row kept) and 9.8e-3 (tanh GELU for quick GELU)
# (PERF.md): the bar sits about 80x from the spread and 100x from the
# weakest fault
CLIP_RTOL = 1e-4
# decode_embd against the token path in a padded bucket, where the token
# path's padding rows hold token 0's row and decode_embd's zeros: under i4g
# every row of a product shares the activation scales, so the valid rows'
# logits part, by a share of i4g's own rounding (the i4g token path's
# distance from the exact k_major layout on the same rows). The bar on that
# share: tests/test_torch_llava.py::test_padded_token_path_within_a_share_of_i4g_rounding
# measures it on the CPU (at most 0.093 over three draws of a 256-wide Q4_K
# llama, i4g's rounding 0.30-0.57 of max|logit|) and chip_smoke.py's llava
# phase at 7B width on the card (PERF.md): the bar sits 2.7x over the CPU's
PAD_SHARE = 0.25


def _split_k_mm(real):
    def mm(x, w):
        k = x.shape[-1] // 2
        return x[..., :k] @ w[:, :k].T + x[..., k:] @ w[:, k:].T

    return mm


def _last_block_kept(real):
    return lambda cfg: cfg.n_layers


def _class_row_kept(real):
    return lambda x: x[:-1]  # the class row in place of the last patch


def _tanh_gelu(real):
    return lambda x, cfg: torch.nn.functional.gelu(x, approximate="tanh")


CLIP_FAULTS = {  # name -> (models.clip function, (the real one) -> its faulty form)
    "last block kept": ("_n_blocks", _last_block_kept),
    "class row kept": ("_drop_class", _class_row_kept),
    "tanh GELU for quick GELU": ("_act", _tanh_gelu),
}


@contextlib.contextmanager
def _clip_replaced(attr, make):
    real = getattr(clip, attr)
    setattr(clip, attr, make(real))
    try:
        yield
    finally:
        setattr(clip, attr, real)


def clip_fault(name: str):
    """Within: encode_image runs with CLIP_FAULTS[name]."""
    return _clip_replaced(*CLIP_FAULTS[name])


def clip_other_order():
    """Within: every matmul of encode_image sums its K in two halves, one
    other order of the f32 sums."""
    return _clip_replaced("_mm", _split_k_mm)


def live_tokens(n_vocab: int, seed: int) -> list[int]:
    return np.random.default_rng(seed).integers(3, n_vocab, PREFILL + STEPS).tolist()


def run_live(params, cfg, toks: list[int], device) -> np.ndarray:
    """The logits [PREFILL + STEPS, n_vocab] of a PREFILL-token prefill and
    STEPS single-token steps through an N_CELLS-cell context on `device`."""
    ctx = InferenceContext(params, cfg, n_cells=N_CELLS, device=device)
    b = Batch()
    for i, t in enumerate(toks[:PREFILL]):
        b.add(t, i, 0)
    rows = [ctx.decode(b)]
    for j, t in enumerate(toks[PREFILL:]):
        b = Batch()
        b.add(t, PREFILL + j, 0)
        rows.append(ctx.decode(b))
    return np.concatenate(rows)


def spread(got: np.ndarray, want: np.ndarray) -> float:
    """max|got - want| over max|want|: the measure LIVE_RTOL bounds."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def emulate(params, cfg, toks: list[int], rel: float = 3e-7) -> dict[str, float]:
    """On the CPU: the spread of a run under perturbed_matmuls(rel) and of
    a run under each fault, each against the plain run."""
    cpu = torch.device("cpu")
    want = run_live(params, cfg, toks, cpu)
    with perturbed_matmuls(rel):
        out = {"floor": spread(run_live(params, cfg, toks, cpu), want)}
    for name in FAULTS:
        with fault(name):
            out[name] = spread(run_live(params, cfg, toks, cpu), want)
    return out


def main(argv=None) -> int:
    from ..models import load_model
    from . import testmodel

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="mpt_nano", choices=list(testmodel.MPT_SCALES))
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    torch.manual_seed(args.seed)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        testmodel.build_mpt_bench_pair(d / "t.gguf", d / "d.gguf", scale=args.scale,
                                       seed=args.seed, live_path=d / "live.gguf")
        params, cfg = load_model(d / "live.gguf", device="cpu")
    res = emulate(params, cfg, live_tokens(cfg.n_vocab, args.seed))
    for name, v in res.items():
        print(f"{name:28s} {v:.4g} of max|logit|"
              + ("" if name == "floor" else f"  ({'fails' if v > LIVE_RTOL else 'PASSES'} "
                                            f"the {LIVE_RTOL} bar)"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
