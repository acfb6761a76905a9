"""Device selection for the port's entry points.

``load_model`` and ``InferenceContext`` run on ``cuda`` unless the caller
names another device (the CPU tests pass ``device="cpu"``). Asking for CUDA
on a machine without it raises: the port never drops silently to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The torch.device an entry point runs on (default ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pipeinfer_tpu_torch needs a CUDA device; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels on the CPU"
        )
    return dev
