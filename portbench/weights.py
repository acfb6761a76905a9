"""The served pair's weights: drawn on the device from the configuration's
own weight seed, encoded as k-quant bytes (kquant.py), and handed to the
program through its own device-plane functions.

The pair is built as the port's bench pairs are (tools/testmodel.py), with
every layer live:

- the draft is the target's lower ``draft_layers`` layers (the same bytes);
- the target's upper layers share one template layer's bytes, each layer in
  buffers of its own, so a step reads every byte a dense model reads;
- the embedding rows are zero-mean, so LayerNorm keeps their direction;
- the head's row perm[t] is ``head_margin`` times the unit embedding of
  token t, plus ``head_noise`` times a random unit row: the margin decides
  most greedy tokens, and the residual's random part, which the layers
  move, decides the rest;
- the draft's head uses a permutation that differs on a ``draft_eps``
  share of the vocabulary, so it disagrees with the target there;
- the output projections (``attn_output``, ``ffn_down``) are drawn at
  ``out_gain / sqrt(fan_in)``, so every layer of target and draft reaches
  the logits; every other projection at ``1 / sqrt(fan_in)``, the
  embedding at unit variance.

Nothing here reads or writes a file: the bytes live on the device, and a
run makes them anew from the seed in a few large calls.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .kquant import ENCODERS

# per-architecture layer slots: (name, rows, cols) from the widths; the
# output projections are the ones drawn at out_gain
_SLOTS = {
    "mpt": lambda e, kv, ff: [("attn_qkv", 3 * e, e), ("attn_output", e, e),
                              ("ffn_up", ff, e), ("ffn_down", e, ff)],
    "llama": lambda e, kv, ff: [("attn_q", e, e), ("attn_k", kv, e), ("attn_v", kv, e),
                                ("attn_output", e, e), ("ffn_gate", ff, e), ("ffn_up", ff, e),
                                ("ffn_down", e, ff)],
}
_OUT_SLOTS = ("attn_output", "ffn_down")


@dataclasses.dataclass
class ModelBytes:
    """The pair as k-quant payloads on the device. ``tensors`` maps a name
    to (qtype, (N, K), uint8 bytes): ``tok_embd``, ``output`` (the target's
    head), ``output_draft``, and ``lower.<slot>`` / ``upper.<slot>``;
    ``layers`` names the template ("lower" or "upper") of each target layer."""

    arch: str
    n_embd: int
    n_heads: int
    n_kv_heads: int
    n_ff: int
    n_vocab: int
    n_layers: int
    draft_layers: int
    norm_eps: float
    rope_base: float
    max_alibi_bias: float
    n_ctx_train: int
    tensors: dict
    layers: list
    perm: object = None  # the head's permutation (the weight design's checks)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_heads

    def slots(self) -> list[tuple[str, int, int]]:
        kv = self.n_kv_heads * self.head_dim
        return _SLOTS[self.arch](self.n_embd, kv, self.n_ff)


def model_dims(cfg: dict) -> dict:
    """The widths of a configuration file, by the port's names."""
    m = cfg["model"]
    return dict(arch=m["arch"], n_embd=m["n_embd"], n_heads=m["n_heads"],
                n_kv_heads=m["n_kv_heads"], n_ff=m["n_ff"], n_vocab=m["n_vocab"],
                n_layers=m["n_layers"], draft_layers=cfg["weights"]["draft_layers"],
                norm_eps=m["norm_eps"], rope_base=m.get("rope_base", 10000.0),
                max_alibi_bias=m.get("max_alibi_bias", 0.0), n_ctx_train=m["n_ctx_train"])


def make_bytes(cfg: dict, device) -> ModelBytes:
    """Draw the pair of configuration `cfg` on `device` and encode it."""
    dims = model_dims(cfg)
    w = cfg["weights"]
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(w["seed"]))
    e, v = dims["n_embd"], dims["n_vocab"]

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32)

    def enc(qtype, arr):
        return (qtype, tuple(arr.shape), ENCODERS[qtype](arr))

    tensors = {}
    embed = randn(v, e)
    embed -= embed.mean(dim=1, keepdim=True)
    tensors["tok_embd"] = enc("Q4_K", embed)
    unit = embed / embed.norm(dim=1, keepdim=True)
    del embed
    perm = torch.randperm(v, generator=g, device=device)
    noise = randn(v, e) / math.sqrt(e)
    n_bad = max(1, int(round(float(w["draft_eps"]) * v)))
    bad = torch.randperm(v, generator=g, device=device)[:n_bad]
    perm_d = perm.clone()
    perm_d[bad] = perm[torch.roll(bad, 1)]
    for name, p in (("output", perm), ("output_draft", perm_d)):
        head = torch.empty_like(unit)
        head[p] = unit  # row perm[t] holds token t's direction
        head.mul_(float(w["head_margin"])).add_(noise, alpha=float(w["head_noise"]))
        tensors[name] = enc("Q6_K", head)
        del head
    del unit, noise
    mb = ModelBytes(**dims, tensors=tensors, layers=[], perm=perm)
    for tmpl in ("lower", "upper"):
        for slot, n, k in mb.slots():
            gain = float(w["out_gain"]) if slot in _OUT_SLOTS else 1.0
            tensors[f"{tmpl}.{slot}"] = enc("Q4_K", randn(n, k) * (gain / math.sqrt(k)))
    mb.layers = (["lower"] * mb.draft_layers
                 + ["upper"] * (mb.n_layers - mb.draft_layers))
    return mb


# GGUF slot names -> the port's parameter names (models/loader.py's map)
_PORT_SLOT = {"attn_qkv": "wqkv", "attn_q": "wq", "attn_k": "wk", "attn_v": "wv",
              "attn_output": "wo", "ffn_gate": "w_gate", "ffn_up": "w_up", "ffn_down": "w_down"}


def port_config(mb: ModelBytes, draft: bool = False):
    """The program's ModelConfig of the target (or the draft)."""
    from pipeinfer_tpu_torch.models.config import ModelConfig

    mpt = mb.arch == "mpt"
    return ModelConfig(
        arch=mb.arch, n_vocab=mb.n_vocab, n_embd=mb.n_embd,
        n_layers=mb.draft_layers if draft else mb.n_layers, n_heads=mb.n_heads,
        n_kv_heads=mb.n_kv_heads, n_ff=mb.n_ff, head_dim=mb.head_dim, rope_dims=mb.head_dim,
        rope_mode="none" if mpt else "norm", rope_base=mb.rope_base, norm_eps=mb.norm_eps,
        norm_rms=not mpt, n_ctx_train=mb.n_ctx_train, max_alibi_bias=mb.max_alibi_bias)


def port_params(mb: ModelBytes, device, draft: bool = False) -> dict:
    """The program's parameters of the target (or the draft), built with the
    port's own functions: quant.pack.pack on the host, ops.qmatmul.to_device
    on the device (the loader's layouts), each layer's planes in buffers of
    their own, then models.loader.fuse_projections where the loader would."""
    from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
    from pipeinfer_tpu_torch.models.loader import default_fuse, fuse_projections, matmul_layout
    from pipeinfer_tpu_torch.ops.qmatmul import PLANES, to_device
    from pipeinfer_tpu_torch.quant import pack

    device = torch.device(device)
    built = {}

    def planes(name, layout=None):
        if name not in built:
            qtype, shape, raw = mb.tensors[name]
            qt = GGMLQuantType[qtype]
            pw = pack.pack(raw.cpu().numpy().reshape(-1), qt, shape)
            built[name] = to_device(pw, layout=layout or matmul_layout(qt, device), device=device)
        return built[name]

    def own(qt):
        return dataclasses.replace(qt, **{f: getattr(qt, f).clone() for f in PLANES
                                          if getattr(qt, f) is not None})

    e = mb.n_embd
    ones = torch.ones(e, dtype=torch.float32, device=device)
    params = {"tok_embd": planes("tok_embd", "n_major"), "output_norm": ones.clone(),
              "output": planes("output_draft" if draft else "output"), "layers": []}
    for tmpl in mb.layers[: mb.draft_layers if draft else mb.n_layers]:
        lp = {"attn_norm": ones.clone(), "ffn_norm": ones.clone()}
        for slot, _, _ in mb.slots():
            lp[_PORT_SLOT[slot]] = own(planes(f"{tmpl}.{slot}"))
        params["layers"].append(lp)
    built.clear()
    if default_fuse(device):
        fuse_projections(params)
    return params
