"""ctypes bindings to the port's host C++ runtime (csrc/repack.cpp).

Torch counterpart of pipeinfer_tpu.native. The model-load hot path (block
decode + planar repack of quant.pack) and the quantizers' rounding
(quant.formats) run natively on a thread pool; every call releases the GIL.

The library is built by ``g++`` (``CXX`` names another compiler) at first
use into ``build/native/`` at the root of the checkout, never at import
time. Its name carries a hash of the source, the flags and the host's CPU
(``-march=native`` compiles for that CPU), and it is written to a temporary
name and renamed into place, so processes that build at once never load a
half-written file and a library built for another host never loads.

Unlike the JAX package, nothing here falls back to numpy: a library that
cannot be built or loaded raises with the compiler's message, since the
numpy path is about 20x slower on a 7B load and rounds Q6_K differently.
``quant.pack.pack(..., backend="numpy")`` stays as the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

from .gguf.constants import GGMLQuantType, QUANT_BLOCK_INFO

SOURCE = Path(__file__).resolve().parent / "csrc" / "repack.cpp"
# -std=c++17, not gnu++17: GCC then contracts no a*b+c into an FMA, so the
# scale and bias planes keep numpy's bits
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]

# formats the native repacker supports (csrc/repack.cpp decoder_for)
NATIVE_QTYPES = {
    GGMLQuantType.Q4_0,
    GGMLQuantType.Q8_0,
    GGMLQuantType.Q4_K,
    GGMLQuantType.Q5_K,
    GGMLQuantType.Q6_K,
}

_lib: ctypes.CDLL | None = None
_error: RuntimeError | None = None  # a failed build, raised again without rebuilding
_lock = threading.Lock()


def build_dir() -> Path:
    return SOURCE.parent.parent.parent / "build" / "native"


def _host_cpu() -> str:
    """The model and instruction-set flags of this host's CPU: what
    -march=native compiles for."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine()
    keep = {line for line in lines if line.startswith(("model name", "flags"))}
    return "\n".join(sorted(keep)) or platform.machine()


def lib_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu().encode())
    return build_dir() / f"libpipeinfer_repack-{h.hexdigest()[:12]}.so"


def _build(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build the native runtime ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native runtime failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)


def get_lib() -> ctypes.CDLL:
    """The loaded runtime library, built first if missing. Raises
    RuntimeError when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        path = lib_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _error = RuntimeError(f"cannot load the native runtime {path}: {e}")
            raise _error from e
        except RuntimeError as e:
            _error = e
            raise
        lib.pi_repack.restype = ctypes.c_int
        lib.pi_repack.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int,
        ]
        for name in ("pi_round_clip_u8", "pi_round_clip_i8"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray | None) -> ctypes.c_void_p | None:
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def repack(raw: np.ndarray, qtype: GGMLQuantType, n: int, k: int, n_threads: int = 0):
    """Native decode+repack of an [n, k] payload to N-major planes: (qs,
    qh, scales, bias) in quant.pack's layouts, bit for bit its numpy
    version's. qtype must be one of NATIVE_QTYPES."""
    from .quant.pack import FORMAT_INFO, PACK_GROUP

    if qtype not in NATIVE_QTYPES:
        raise ValueError(f"the native repacker does not take {qtype.name}")
    be, bb = QUANT_BLOCK_INFO[qtype]
    if k % be or k % min(PACK_GROUP, k):
        raise ValueError(f"K={k} is not whole {qtype.name} blocks and pack groups")
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.size != n * (k // be) * bb:
        raise ValueError(f"{qtype.name} payload of {raw.size} bytes for [{n}, {k}]: "
                         f"need {n * (k // be) * bb}")
    lib = get_lib()
    bits, group = FORMAT_INFO[qtype]
    if bits == 8:
        qs = np.empty((n, k), np.int8)
        qh = None
    else:
        qs = np.empty((n, k // 2), np.uint8)
        qh = {5: np.empty((n, k // 8), np.uint8), 6: np.empty((n, k // 4), np.uint8)}.get(bits)
    scales = np.empty((n, k // group), np.float32)
    bias = np.empty((n, k // group), np.float32)
    rc = lib.pi_repack(int(qtype), _ptr(raw), n, k, _ptr(qs), _ptr(qh), _ptr(scales),
                       _ptr(bias), n_threads)
    if rc != 0:
        raise RuntimeError(f"pi_repack failed for {qtype.name} [{n}, {k}]: {rc}")
    return qs, qh, scales, bias


def round_clip(x: np.ndarray, lo: float, hi: float, dtype=np.uint8,
               half_away: bool = False, n_threads: int = 0) -> np.ndarray:
    """round(x) clipped to [lo, hi] as u8 or i8, x taken as f32.
    half_away=False matches np.round (half to even); half_away=True
    matches ggml's (x + 0.5) truncation rounding."""
    if dtype not in (np.uint8, np.int8):
        raise ValueError(f"round_clip gives uint8 or int8, not {dtype}")
    fn = get_lib().pi_round_clip_u8 if dtype == np.uint8 else get_lib().pi_round_clip_i8
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype)
    fn(_ptr(x), x.size, ctypes.c_float(lo), ctypes.c_float(hi), _ptr(out),
       1 if half_away else 0, n_threads)
    return out

