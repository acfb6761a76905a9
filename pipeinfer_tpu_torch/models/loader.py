"""GGUF -> device model parameters.

Torch counterpart of pipeinfer_tpu.models.loader (ref: llama.cpp:1805-1938
`llama_model_loader`, :2684-3404 `llm_load_tensors`). Quantized 2-D weights
are repacked on the host (quant.pack, the native runtime of native.py),
uploaded raw, and turned into the kernels' device planes on the device
(ops.qmatmul.to_device); small tensors (norms, biases) load dense in f32.
Tensors load one after another: the native repack already runs on every
host core, so the JAX loader's thread pool is not ported.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..device import resolve
from ..gguf.constants import GGMLQuantType
from ..gguf.reader import GGUFReader
from ..ops.qmatmul import QuantTensor, concat_qt, to_device
from ..quant import pack
from . import generic, llama
from .config import ModelConfig, config_from_gguf

_DENSE_TYPES = (
    GGMLQuantType.F32,
    GGMLQuantType.F16,
    GGMLQuantType.I8,
    GGMLQuantType.I16,
    GGMLQuantType.I32,
)


def matmul_layout(qtype: GGMLQuantType | None = None, device="cuda") -> str:
    """Device layout for quantized matmul weights, as the JAX package picks
    it. PIPEINFER_WEIGHT_LAYOUT (k_major, i8, k4, i8g or i4g) overrides.
    Otherwise: on CUDA, where the JAX package would ask for a TPU, "i4g"
    for 4-bit formats (nibble-packed, ~0.56 B/param, the i4g kernel) and
    "i8g" for wider ones (s8 requantized per (512, column)); elsewhere (the
    CPU) the exact, minimum-memory "k_major" planes. i8 and k4 are exact
    too and stay selectable; fidelity-critical runs can take any of the
    three exact layouts on the card."""
    env = os.environ.get("PIPEINFER_WEIGHT_LAYOUT", "")
    if env in ("i8", "k_major", "k4", "i8g", "i4g"):
        return env
    if torch.device(device).type != "cuda":
        return "k_major"
    if qtype is not None and pack.FORMAT_INFO.get(qtype, (0, 0))[0] == 4:
        return "i4g"
    return "i8g"


def _load_tensor(r: GGUFReader, name: str, device: torch.device, layout=None):
    info = r.tensors[name]
    if info.qtype in _DENSE_TYPES or len(info.shape) != 2:
        arr = np.array(r.tensor(name), dtype=np.float32)  # own the bytes: the
        return torch.from_numpy(arr).to(device)  # reader's views are read-only
    if layout is None:
        layout = matmul_layout(info.qtype, device)
    if info.qtype in pack.FORMAT_INFO:
        pw = pack.pack(r.tensor_bytes(name), info.qtype, info.shape)
        return to_device(pw, layout=layout, device=device)
    # quant format without a matmul layout: dequantize to bf16 dense
    arr = np.array(r.tensor(name), dtype=np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=torch.bfloat16)


# GGUF tensor name -> param slot, shared by every architecture (ref:
# llama.cpp LLM_TENSOR_NAMES)
GLOBAL_TENSOR_MAP = {
    "token_embd.weight": "tok_embd",
    "token_embd_norm.weight": "tok_norm",
    "token_embd_norm.bias": "tok_norm_b",
    "position_embd.weight": "pos_embd",
    "output_norm.weight": "output_norm",
    "output_norm.bias": "output_norm_b",
    "output.weight": "output",
}

LAYER_TENSOR_MAP = {
    "attn_norm.weight": "attn_norm",
    "attn_norm.bias": "attn_norm_b",
    "attn_norm_2.weight": "attn_norm_2",
    "attn_norm_2.bias": "attn_norm_2_b",
    "attn_qkv.weight": "wqkv",
    "attn_qkv.bias": "bqkv",
    "attn_q.weight": "wq",
    "attn_q.bias": "bq",
    "attn_k.weight": "wk",
    "attn_k.bias": "bk",
    "attn_v.weight": "wv",
    "attn_v.bias": "bv",
    "attn_q_norm.weight": "q_norm",
    "attn_q_norm.bias": "q_norm_b",
    "attn_k_norm.weight": "k_norm",
    "attn_k_norm.bias": "k_norm_b",
    "attn_output.weight": "wo",
    "attn_output.bias": "bo",
    "ffn_norm.weight": "ffn_norm",
    "ffn_norm.bias": "ffn_norm_b",
    "ffn_gate.weight": "w_gate",
    "ffn_gate.bias": "b_gate",
    "ffn_down.weight": "w_down",
    "ffn_down.bias": "b_down",
    "ffn_up.weight": "w_up",
    "ffn_up.bias": "b_up",
}

# non-matmul slots loaded for row gathers (embeddings)
_GATHER_SLOTS = {"tok_embd", "pos_embd"}


def forward_for_arch(arch: str):
    """The forward for an architecture: the llama fast path, or the
    generic trait-driven decoder for every other one."""
    if arch == "llama":
        return llama.forward
    return generic.forward


def load_model(path: str | Path, *, device=None,
               fuse: bool | None = None) -> tuple[dict[str, Any], ModelConfig]:
    """Load a GGUF model onto `device` (default ``cuda``; raises
    without CUDA unless ``device="cpu"``). Returns (params, config).

    fuse: merge same-input projections (see fuse_projections); default on
    for CUDA (PIPEINFER_FUSE_PROJ=0 disables), off elsewhere, as the JAX
    package does it on and off the TPU."""
    device = resolve(device)
    with GGUFReader(path) as r:
        cfg = config_from_gguf(r)
        params: dict[str, Any] = {"layers": [{} for _ in range(cfg.n_layers)]}
        for gname, slot in GLOBAL_TENSOR_MAP.items():
            if gname in r.tensors:
                layout = "n_major" if slot in _GATHER_SLOTS else None
                params[slot] = _load_tensor(r, gname, device, layout)
        if "output.weight" not in r.tensors:
            # tied embeddings: the head matmul needs its own matmul-layout copy
            params["output"] = _load_tensor(r, "token_embd.weight", device)
        for li in range(cfg.n_layers):
            for suffix, slot in LAYER_TENSOR_MAP.items():
                gname = f"blk.{li}.{suffix}"
                if gname in r.tensors:
                    params["layers"][li][slot] = _load_tensor(r, gname, device)
    if fuse is None:
        fuse = default_fuse(device)
    if fuse:
        fuse_projections(params)
    return params, cfg


def default_fuse(device) -> bool:
    """Fuse same-input projections by default on CUDA (PIPEINFER_FUSE_PROJ=0
    disables); the JAX package's gate asks for a TPU instead."""
    return (torch.device(device).type == "cuda"
            and os.environ.get("PIPEINFER_FUSE_PROJ", "1") != "0")


def fuse_projections(params: dict[str, Any]) -> None:
    """Fuse same-input projections into single tensors, in place: wq+wk+wv
    -> 'wqkv' ([Q;K;V] row order) and w_gate+w_up -> 'wgu'. One kernel call
    with a wider N replaces three/two. Only QuantTensor groups with matching
    (qtype, layout) fuse — Q4_K_M-style layers, whose w_v is Q6_K, keep
    split projections — or dense groups of one dtype and width. Groups
    with biases (bq/bk/bv, b_gate/b_up) stay split: the fused slots carry
    no bias."""

    def fuse_group(lp, slots, dest, biases):
        if not all(k in lp for k in slots) or any(b in lp for b in biases):
            return
        ws = [lp[k] for k in slots]
        if all(isinstance(w, QuantTensor) for w in ws):
            fused = concat_qt(ws)
        elif (all(isinstance(w, torch.Tensor) and w.dim() == 2 for w in ws)
              and len({w.shape[1] for w in ws}) == 1 and len({w.dtype for w in ws}) == 1):
            fused = torch.cat(ws, dim=0)
        else:
            fused = None
        if fused is not None:
            lp[dest] = fused
            for k in slots:
                del lp[k]

    for lp in params.get("layers", []):
        fuse_group(lp, ("wq", "wk", "wv"), "wqkv", ("bq", "bk", "bv"))
        fuse_group(lp, ("w_gate", "w_up"), "wgu", ("b_gate", "b_up"))
