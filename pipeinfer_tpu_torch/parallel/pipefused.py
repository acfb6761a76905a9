"""Fused multi-device pipeline: one pp x tp x dp decode step.

Torch counterpart of pipeinfer_tpu.parallel.pipefused (ref:
ggml-mpi.c:523-587 ggml_mpi_split_range / scatter, :591-681 graph slicing,
:710-721 stage activation relay). The JAX package runs the whole step as
one jitted shard_map over a (data, stage, model) mesh; the port writes the
same program out over a parallel.mesh.Mesh:

- the layers are cut into S stage slabs, one per 'stage' index, whose
  heads and FFN columns are sharded over 'model';
- one step runs the (M + S - 1)-phase microbatch schedule: each dp shard's
  streams are split into M microbatches along the batch axis; at phase t
  stage s computes microbatch t - s, and then every stage's activation
  hops to the next stage (ppermute over 'stage', a ring). After S - 1
  phases every stage is busy on a different microbatch. The JAX package
  computes inactive phases too and masks their writes; the port skips
  them;
- the ring KV cache carries per-slot stored positions, so attention
  masking is wrap-safe (a slot is visible iff it holds a position in
  (q_pos - C, q_pos]) and every stream has its own position column;
- within a stage, packed N-last weights are output-sharded with gathers
  before and after wo / w_down; dense ones are Megatron-style, wo / w_down
  row-parallel with a psum over 'model';
- the finished activations live on the last stage and are broadcast to
  every stage (a psum over 'stage'), each of which computes its
  vocab-shard of the head; the logits are gathered over 'model'.

Attention here is plain tensor code, as in the JAX package (no Pallas
kernel there); the matmuls of packed weights go through the kernels. This
path serves throughput decode and prefill; the asynchronous PipeInfer
controller drives the per-stage sub-mesh contexts of parallel.stages.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..models.config import ModelConfig
from ..ops import layers as L
from ..ops.qmatmul import PLANES, QuantTensor, dequant, qmatmul
from ..runtime.context import _params_to
from .mesh import Mesh, default_devices, groups_of

_N_LAST = ("i4g", "i8g", "i8", "k4", "k_major")
_IN_PROJ = ("wq", "wk", "wv", "w_gate", "w_up")  # output-sharded when dense
_OUT_PROJ = ("wo", "w_down")  # row-parallel (input-sharded) when dense


@dataclasses.dataclass(frozen=True)
class PipeConfig:
    n_stages: int
    tp: int
    dp: int
    n_microbatches: int = 1

    @property
    def n_devices(self) -> int:
        return self.n_stages * self.tp * self.dp


def make_mesh(pc: PipeConfig, devices=None) -> Mesh:
    """The (data, stage, model) mesh over `devices` (default
    mesh.default_devices: this process's cards, repeated as needed)."""
    devices = list(devices) if devices is not None else default_devices(pc.n_devices)
    grid = np.empty(pc.n_devices, dtype=object)
    grid[:] = devices[: pc.n_devices]
    return Mesh(grid.reshape(pc.dp, pc.n_stages, pc.tp), ("data", "stage", "model"))


# ---------------------------------------------------------------------------
# Parameters: per-layer dicts -> each coordinate's stage slab and shard
# ---------------------------------------------------------------------------


def _qt_rows(qt: QuantTensor, lo: int, hi: int) -> QuantTensor:
    """Output-row slice [lo, hi) of an N-last QuantTensor (de-fuses
    wqkv / wgu and cuts a 'model' shard: every plane's last axis is
    indexed by output column), each plane a contiguous copy."""
    cut = {f: getattr(qt, f)[..., lo:hi].contiguous()
           for f in PLANES if getattr(qt, f) is not None}
    return dataclasses.replace(qt, **cut, shape=(hi - lo, qt.shape[1]))


def stack_params(params: dict[str, Any], cfg: ModelConfig, pc: PipeConfig,
                 mesh: Mesh) -> list[dict]:
    """Each local coordinate's weights: its stage's layer slab with the
    head and FFN columns of its 'model' shard, on its device.

    Quantized matmul slots whose per-layer QuantTensors agree on (qtype,
    layout, shape) in an N-last layout stay PACKED: each shard is the
    weight's output columns [m*N/tp, (m+1)*N/tp), so every device streams
    packed bytes through the kernels (ref: ggml-mpi.c:523-587 splits
    quantized slabs). Slots that cannot (mixed per-layer formats, dense
    checkpoints) are dequantized to bf16, as in the JAX package.
    Coordinates that share a device and a (stage, shard) share one tree."""
    s, lps = pc.n_stages, cfg.n_layers // pc.n_stages
    if lps * s != cfg.n_layers:
        raise ValueError(f"n_stages ({s}) must divide n_layers ({cfg.n_layers})")
    if cfg.n_heads % pc.tp or cfg.n_kv_heads % pc.tp or cfg.n_ff % pc.tp:
        raise ValueError(f"heads {cfg.n_heads}/{cfg.n_kv_heads} and n_ff {cfg.n_ff} must "
                         f"divide by tp={pc.tp}")
    # this fused path runs the llama-family layer body only; refuse models
    # whose features it would silently drop (parallel.stages / parallel.dcn
    # run every architecture)
    unsupported = {"bq", "bk", "bv", "bo", "b_gate", "b_up", "b_down",
                   "bqkv", "attn_norm_2", "attn_norm_b", "q_norm"}
    present = unsupported & set(params["layers"][0])
    if present or cfg.max_alibi_bias > 0 or cfg.tok_norm or cfg.pos_embd \
            or cfg.yarn_ext_factor != 0.0:
        raise NotImplementedError(
            f"pipefused supports the llama-family body only (found "
            f"{sorted(present) or 'non-llama config features'}); use "
            "parallel.stages / parallel.dcn for this architecture")

    kv_dim = cfg.n_kv_heads * cfg.head_dim
    n_q = cfg.n_heads * cfg.head_dim
    segs = {  # fused-load slots de-fuse here
        "wq": ("wqkv", 0, n_q), "wk": ("wqkv", n_q, n_q + kv_dim),
        "wv": ("wqkv", n_q + kv_dim, n_q + 2 * kv_dim),
        "w_gate": ("wgu", 0, cfg.n_ff), "w_up": ("wgu", cfg.n_ff, 2 * cfg.n_ff),
    }

    def per_layer(slot):
        out = []
        for lp in params["layers"]:
            if slot in lp:
                out.append(lp[slot])
            else:
                fused, lo, hi = segs[slot]
                w = lp[fused]
                out.append(_qt_rows(w, lo, hi) if isinstance(w, QuantTensor) else w[lo:hi])
        return out

    def packed(ws) -> bool:
        first = ws[0]
        return (all(isinstance(w, QuantTensor) and w.qtype == first.qtype
                    and w.layout == first.layout and w.shape == first.shape for w in ws)
                and first.layout in _N_LAST and first.shape[0] % pc.tp == 0)

    def dense(w):
        return dequant(w, torch.bfloat16) if isinstance(w, QuantTensor) else w.to(torch.bfloat16)

    def shard(slot, w, m):
        """Shard m of one layer's (or the head's) weight."""
        if isinstance(w, QuantTensor) and slot in pack:
            n = w.shape[0] // pc.tp
            return _qt_rows(w, m * n, (m + 1) * n)
        d = dense(w)
        if slot in _OUT_PROJ:  # row-parallel: this shard's input columns
            k = d.shape[1] // pc.tp
            return d[:, m * k: (m + 1) * k].contiguous()
        n = d.shape[0] // pc.tp  # the in-projections and a dense head: output rows
        return d[m * n: (m + 1) * n].contiguous()

    slots = {slot: per_layer(slot) for slot in (*_IN_PROJ, *_OUT_PROJ)}
    pack = {slot for slot, ws in slots.items() if packed(ws)}
    if packed([params["output"]]):
        pack.add("output")
    tok_embd = dense(params["tok_embd"])

    memo: dict = {}
    out = []
    for c, dev in zip(mesh.local, mesh.local_devices):
        st, m = mesh.index(c, "stage"), mesh.index(c, "model")
        key = (str(dev), st, m)
        if key not in memo:
            layers = []
            for li in range(st * lps, (st + 1) * lps):
                lp = {slot: shard(slot, ws[li], m) for slot, ws in slots.items()}
                lp["attn_norm"] = params["layers"][li]["attn_norm"].float()
                lp["ffn_norm"] = params["layers"][li]["ffn_norm"].float()
                layers.append(lp)
            tree = {"layers": layers, "tok_embd": tok_embd,
                    "output_norm": params["output_norm"].float(),
                    "output": shard("output", params["output"], m)}
            memo[key] = _params_to(tree, dev)
        out.append(memo[key])
    return out


def init_cache(cfg: ModelConfig, pc: PipeConfig, mesh: Mesh, batch: int, max_len: int) -> dict:
    """The ring KV cache, per local coordinate: K and V [Lps, B/dp, C,
    KVH/tp, D] bf16 (its stage's layers, data shard and heads) and the
    per-slot stored positions [B/dp, C] int32 (wrap-safe masking; -1 =
    empty), as lists aligned with mesh.local under "k", "v" and "pos"."""
    lps = cfg.n_layers // pc.n_stages
    if batch % pc.dp:
        raise ValueError(f"batch {batch} does not split over dp={pc.dp}")
    b_l = batch // pc.dp
    shape = (lps, b_l, max_len, cfg.n_kv_heads // pc.tp, cfg.head_dim)
    devs = mesh.local_devices
    return {
        "k": [torch.zeros(shape, dtype=torch.bfloat16, device=d) for d in devs],
        "v": [torch.zeros(shape, dtype=torch.bfloat16, device=d) for d in devs],
        "pos": [torch.full((b_l, max_len), -1, dtype=torch.int32, device=d) for d in devs],
    }


# ---------------------------------------------------------------------------
# The fused step
# ---------------------------------------------------------------------------


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """x [M, K] @ W[N, K]^T in f32 for a dense bf16 weight (x rounded to
    bf16, products and sums in f32, as jnp.dot with
    preferred_element_type=f32) or a packed shard (the one-device kernels
    run per shard)."""
    if isinstance(w, QuantTensor):
        return qmatmul(x, w)
    return x.to(torch.bfloat16).float() @ w.float().T


def _stage_layers(cfg: ModelConfig, layers: list[list[dict]], kcs: list, vcs: list, pslabs: list,
                  hs: list, pos: torch.Tensor, mesh: Mesh, group: list[tuple], tp: int) -> list:
    """Run one stage's layer slab on its 'model' group `group`: per shard
    hidden hs[i] [B, T, E] (replicated), layers[i] (its Lps layers),
    ring caches kcs[i] / vcs[i] [Lps, B, C, KVH/tp, D] and stored
    positions pslabs[i] [B, C] (views of the cache, updated in place);
    pos [B, T] the query positions. Returns the new hidden states."""
    b, t, e = hs[0].shape
    heads, kvh, d = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim
    c = kcs[0].shape[2]  # ring length
    rope_kw = dict(mode=cfg.rope_mode, freq_base=cfg.rope_base, freq_scale=cfg.rope_scale)
    ins = []
    for ps, p in zip(pslabs, mesh.replicate(pos, group)):
        slots = (p % c).long()
        bi = torch.arange(b, device=p.device)[:, None]
        ps[bi, slots] = p  # visibility after this step's writes
        stored = ps[:, None, :]
        visible = (stored >= 0) & (stored <= p[:, :, None]) & (stored > p[:, :, None] - c)
        mask = torch.where(visible, 0.0, -1e9)
        ins.append((bi, slots, mask, p.reshape(b * t)))

    def gathered(xs):
        return mesh.all_gather(xs, "model", dim=1, coords=group)

    def out_proj(xs, slot, li):
        ws = [lay[li][slot] for lay in layers]
        if isinstance(ws[0], QuantTensor):  # output-sharded packed planes
            return gathered([_mm(x, w) for x, w in zip(gathered(xs), ws)])
        return mesh.psum([_mm(x, w) for x, w in zip(xs, ws)], "model", coords=group)

    for li in range(len(layers[0])):
        attn = []
        for h, lay, kc, vc, (bi, slots, mask, pflat) in zip(hs, layers, kcs, vcs, ins):
            lp = lay[li]
            af = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps).reshape(b * t, e)
            q = _mm(af, lp["wq"]).reshape(b * t, heads, d)
            k = _mm(af, lp["wk"]).reshape(b * t, kvh, d)
            v = _mm(af, lp["wv"]).reshape(b, t, kvh, d)
            if cfg.rope_mode != "none":
                q = L.apply_rope(q, pflat, cfg.rope_dims, **rope_kw)
                k = L.apply_rope(k, pflat, cfg.rope_dims, **rope_kw)
            kc[li][bi, slots] = k.reshape(b, t, kvh, d).to(kc.dtype)  # per-stream ring write
            vc[li][bi, slots] = v.to(vc.dtype)
            qf = q.float().reshape(b, t, kvh, heads // kvh, d)
            scores = torch.einsum("btkgd,bckd->btkgc", qf, kc[li].float()) * cfg.attn_scale
            pr = torch.softmax(scores + mask[:, :, None, None, :], dim=-1)
            o = torch.einsum("btkgc,bckd->btkgd", pr, vc[li].float())
            attn.append(o.reshape(b * t, heads * d))
        hs = [h + o.reshape(b, t, e) for h, o in zip(hs, out_proj(attn, "wo", li))]
        mids = []
        for h, lay in zip(hs, layers):
            lp = lay[li]
            f = L.rms_norm(h, lp["ffn_norm"], cfg.norm_eps).reshape(b * t, e)
            mids.append(L.silu(_mm(f, lp["w_gate"])) * _mm(f, lp["w_up"]))
        hs = [h + o.reshape(b, t, e) for h, o in zip(hs, out_proj(mids, "w_down", li))]
    return hs


def build_step(cfg: ModelConfig, pc: PipeConfig, mesh: Mesh):
    """The fused pipeline step: step(params, cache, tokens [B, T], pos,
    n_past=0) -> (logits [B, T, V] f32 on the first local device, cache).

    pos may be [T] (shared positions) or [B, T] (per stream); n_past is
    accepted for the JAX package's signature and ignored (the stored
    positions make the mask self-describing). The cache is updated in
    place and returned. Every process of a mesh that spans processes calls
    the step with the same arguments; 'model' stays within a process
    (multihost.global_mesh lays it out so)."""
    if mesh.spans_processes("model"):
        raise NotImplementedError("the fused step keeps each 'model' group within one process")
    m_count = max(1, pc.n_microbatches)
    n_stages = mesh.shape["stage"]
    coords = mesh.local
    at = {c: i for i, c in enumerate(coords)}

    def step(params, cache, tokens, pos, n_past=0):
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int32)
        pos = torch.as_tensor(np.asarray(pos), dtype=torch.int32)
        if pos.dim() == 1:
            pos = pos[None, :].expand(tokens.shape)
        b_all, t = tokens.shape
        b_l = b_all // pc.dp
        if b_l * pc.dp != b_all or b_l % m_count:
            raise ValueError(f"batch {b_all} does not split into dp={pc.dp} shards of "
                             f"{m_count} microbatches")
        bm = b_l // m_count
        toks = {c: tokens[mesh.index(c, "data") * b_l:][:b_l].to(mesh.devices[c]) for c in coords}
        poss = {c: pos[mesh.index(c, "data") * b_l:][:b_l].to(mesh.devices[c]) for c in coords}
        h_cur = {c: torch.zeros(bm, t, cfg.n_embd, device=mesh.devices[c]) for c in coords}
        out_h = {c: torch.zeros(b_l, t, cfg.n_embd, device=mesh.devices[c]) for c in coords}

        for ph in range(m_count + n_stages - 1):
            if ph < m_count:  # stage 0 injects microbatch ph's embedding
                for c in coords:
                    if mesh.index(c, "stage") == 0:
                        tok = toks[c][ph * bm: (ph + 1) * bm].long()
                        h_cur[c] = params[at[c]]["tok_embd"][tok].float()
            active = [c for c in coords if 0 <= ph - mesh.index(c, "stage") < m_count]
            for group in groups_of(active, mesh, "model"):
                st = mesh.index(group[0], "stage")
                sl = slice((ph - st) * bm, (ph - st + 1) * bm)  # this stage's microbatch
                hs = _stage_layers(
                    cfg, [params[at[c]]["layers"] for c in group],
                    [cache["k"][at[c]][:, sl] for c in group],
                    [cache["v"][at[c]][:, sl] for c in group],
                    [cache["pos"][at[c]][sl] for c in group],
                    [h_cur[c] for c in group], poss[group[0]][sl], mesh, group, pc.tp)
                for c, h in zip(group, hs):
                    h_cur[c] = h
                    if st == n_stages - 1:  # the last stage banks its finished microbatch
                        out_h[c][sl] = h
            # relay the activations to the next stage (a ring, as the JAX ppermute)
            relayed = mesh.ppermute([h_cur[c] for c in coords], "stage",
                                    [(i, (i + 1) % n_stages) for i in range(n_stages)])
            h_cur = dict(zip(coords, relayed))

        # the finished activations live on the last stage: broadcast them
        h = mesh.psum([out_h[c] if mesh.index(c, "stage") == n_stages - 1
                       else torch.zeros_like(out_h[c]) for c in coords], "stage")
        local = [_mm(L.rms_norm(hc, params[at[c]]["output_norm"], cfg.norm_eps)
                     .reshape(b_l * t, -1), params[at[c]]["output"]).reshape(b_l, t, -1)
                 for c, hc in zip(coords, h)]
        # the head is vocab-sharded over 'model': gather the vocab axis
        logits = dict(zip(coords, mesh.all_gather(local, "model", dim=2)))
        first = mesh.local_devices[0]
        rows = []
        for di in range(pc.dp):
            have = [c for c in coords if mesh.index(c, "data") == di]
            if not have:
                raise ValueError(f"data shard {di} has no coordinate in process {mesh.rank}")
            rows.append(logits[have[0]].to(first))
        return torch.cat(rows), cache

    return step
