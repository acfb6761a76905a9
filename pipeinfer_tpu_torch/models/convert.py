"""Carry parameters loaded elsewhere into the port.

``params_from_numpy`` turns a parameter tree whose arrays are already numpy
(for example the JAX package's loaded params, converted by the caller) into
the port's params on a device, plane for plane. Tests use it to run both
packages on identical weight planes, so a comparison measures the compute
and not the rounding of two plane fits (the i4g least-squares refit sums in a
different order on each side).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve
from ..gguf.constants import GGMLQuantType
from ..ops.qmatmul import PORTED_LAYOUTS, QuantTensor
from .config import ModelConfig

_PLANES = ("qs", "qh", "scales", "bias")


def _is_quant(x) -> bool:
    return all(hasattr(x, a) for a in _PLANES + ("qtype", "shape", "layout"))


def quant_from_numpy(qt, device) -> QuantTensor:
    """One quantized weight: anything with numpy planes qs, qh (or None),
    scales and bias, and qtype, shape and layout (a QuantTensor of either
    package after np.asarray of its planes)."""
    if qt.layout not in PORTED_LAYOUTS:
        raise ValueError(f"layout {qt.layout!r} is not ported (ported: {PORTED_LAYOUTS})")

    def put(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(device)

    return QuantTensor(
        qs=put(qt.qs), qh=put(qt.qh), scales=put(qt.scales), bias=put(qt.bias),
        qtype=GGMLQuantType(int(qt.qtype)), shape=tuple(int(s) for s in qt.shape),
        layout=qt.layout,
    )


def params_from_numpy(np_params: dict[str, Any], cfg: ModelConfig, device=None) -> dict[str, Any]:
    """The port's params from a tree of numpy arrays and numpy-plane
    quantized weights, laid out as the loader lays them out
    ({"layers": [per-layer dicts], "tok_embd": ..., ...}). Dense arrays
    become f32 tensors; quantized weights keep their planes bit for bit."""
    device = resolve(device)
    if len(np_params["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(np_params['layers'])} layers given, config has {cfg.n_layers}")

    def conv(x):
        if _is_quant(x):
            return quant_from_numpy(x, device)
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    out = {k: conv(v) for k, v in np_params.items() if k != "layers"}
    out["layers"] = [{k: conv(v) for k, v in lp.items()} for lp in np_params["layers"]]
    return out
