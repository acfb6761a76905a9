"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers: a build takes seconds, not minutes). The build runs at first use,
all sources in parallel, into ``build/cuda/`` at the root of the checkout
(``PIPEINFER_CUDA_BUILD_DIR`` overrides it). Library names carry a hash of
their source, so an edited kernel is rebuilt and a stale one never loads.

Nothing here runs at import time: the CPU tests import every module of the
port on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("qmatmul_i4g", "qmatmul_i8g", "cell_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("PIPEINFER_CUDA_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "cuda"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build_all(names=KERNELS, extra_flags=()) -> dict[str, tuple[float, str]]:
    """Compile every missing kernel library, one nvcc per source, all
    started together. Returns (seconds, nvcc output) per kernel; (0.0, "")
    for one already built. extra_flags: more nvcc flags, such as
    ["-Xptxas", "-v"] to print registers and shared memory per kernel."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    took = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            took[name] = (0.0, "")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                       tmp, target, time.perf_counter())
    errors = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        took[name] = (time.perf_counter() - t0, text)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{text}")
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check_tensors(name: str, **tensors) -> None:
    """Raise unless every (tensor, dtype) given is a contiguous tensor of
    that dtype on one CUDA device: what a kernel reads through a raw
    pointer it does not check."""
    devices = set()
    for key, (t, dtype) in tensors.items():
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous CUDA {dtype} tensor, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")


def _ctype(arg):
    if arg is None or hasattr(arg, "data_ptr"):
        return ctypes.c_void_p  # a device pointer (c_void_p: not cut to 32 bits)
    return ctypes.c_float if isinstance(arg, float) else ctypes.c_int


def launch(name: str, symbol: str, *args) -> None:
    """Call C entry point `symbol` of kernel library `name`, which launches
    its kernel on PyTorch's current CUDA stream (passed last) and returns
    cudaGetLastError(). Tensors (or None) go as device pointers, ints as
    int and floats as float. Raises on a non-zero error: a launch the
    CUDA runtime refuses never runs, and no later synchronize reports it."""
    import torch

    key = f"{name}:{symbol}"
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = [_ctype(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    vals = [ctypes.c_void_p(a.data_ptr()) if hasattr(a, "data_ptr") else a for a in args]
    err = fn(*vals, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed to launch: cudaError {err}")
