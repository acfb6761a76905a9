"""GGUF -> device model parameters.

Torch counterpart of pipeinfer_tpu.models.loader (ref: llama.cpp:1805-1938
`llama_model_loader`, :2684-3404 `llm_load_tensors`). Quantized 2-D weights
are repacked on the host (quant.pack, numpy), uploaded raw, and turned into
the kernels' device planes on the device (ops.qmatmul.to_device); small
tensors (norms, biases) load dense in f32.
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
from ..ops.qmatmul import PORTED_LAYOUTS, QuantTensor, concat_qt, to_device
from ..quant import pack
from . import llama
from .config import ModelConfig, config_from_gguf

_DENSE_TYPES = (
    GGMLQuantType.F32,
    GGMLQuantType.F16,
    GGMLQuantType.I8,
    GGMLQuantType.I16,
    GGMLQuantType.I32,
)


def matmul_layout(qtype: GGMLQuantType | None = None, device="cuda") -> str:
    """Device layout for quantized matmul weights: "i4g" for 4-bit formats
    (nibble-packed, ~0.56 B/param, the i4g kernel) and "i8g" for wider ones
    (s8 requantized per (512, column), the i8g kernel).
    PIPEINFER_WEIGHT_LAYOUT overrides, as in the JAX package; of its
    layouts only i4g and i8g are ported so far.

    Where the JAX package asks whether it runs on a TPU (and picks the
    exact "k_major" layout elsewhere), the port asks which device the
    weights go to. k_major waits in ROADMAP.md, so a CPU load takes the
    kernels' layouts too and runs their plain PyTorch versions."""
    env = os.environ.get("PIPEINFER_WEIGHT_LAYOUT", "")
    if env in ("i8", "k_major", "k4"):
        raise ValueError(f"PIPEINFER_WEIGHT_LAYOUT={env} is not ported yet "
                         f"(ported: {', '.join(PORTED_LAYOUTS)})")
    if env in ("i4g", "i8g"):
        return env
    del device  # both device types take the kernels' layouts (see above)
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


# GGUF tensor name -> param slot (ref: llama.cpp LLM_TENSOR_NAMES; the llama
# subset, since models/generic.py is not ported yet)
GLOBAL_TENSOR_MAP = {
    "token_embd.weight": "tok_embd",
    "output_norm.weight": "output_norm",
    "output.weight": "output",
}

LAYER_TENSOR_MAP = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "w_gate",
    "ffn_down.weight": "w_down",
    "ffn_up.weight": "w_up",
}

_GATHER_SLOTS = {"tok_embd"}


def forward_for_arch(arch: str):
    """The forward for an architecture (llama only so far)."""
    if arch == "llama":
        return llama.forward
    raise NotImplementedError(f"architecture {arch!r} is not ported yet (llama is)")


def load_model(path: str | Path, *, device=None,
               fuse: bool | None = None) -> tuple[dict[str, Any], ModelConfig]:
    """Load a GGUF llama model onto `device` (default ``cuda``; raises
    without CUDA unless ``device="cpu"``). Returns (params, config).

    fuse: merge same-input projections (see fuse_projections); default on
    for CUDA (PIPEINFER_FUSE_PROJ=0 disables), off elsewhere, as the JAX
    package does it on and off the TPU."""
    device = resolve(device)
    with GGUFReader(path) as r:
        cfg = config_from_gguf(r)
        forward_for_arch(cfg.arch)  # fail before loading an unported arch
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
    split projections — or dense groups of one dtype and width."""

    def fuse_group(lp, slots, dest):
        if not all(k in lp for k in slots):
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
        fuse_group(lp, ("wq", "wk", "wv"), "wqkv")
        fuse_group(lp, ("w_gate", "w_up"), "wgu")
