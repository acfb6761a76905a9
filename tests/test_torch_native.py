"""The port's native runtime (pipeinfer_tpu_torch/native.py over
csrc/repack.cpp) on the CPU, mirroring tests/test_native.py: the native
repack bit for bit against the port's own numpy repack and against the JAX
package's `pack`, the quantizers' native rounding against the JAX
package's bytes, the library built under build/ and never the JAX
package's, a failed build raising instead of falling back to numpy, and
the loader giving with the native repack the parameters the numpy repack
gives."""

import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pipeinfer_tpu.quant import formats as jformats
from pipeinfer_tpu.quant import pack as jpack
from pipeinfer_tpu_torch import native
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.ops.qmatmul import QuantTensor
from pipeinfer_tpu_torch.quant import formats, pack
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine

ROOT = Path(__file__).resolve().parent.parent
QTYPES = sorted(native.NATIVE_QTYPES, key=int)
# (N, K): 37 rows split over the repacker's threads leave a ragged last chunk
SHAPES = [(37, 512), (64, 1024)]
PLANES = ("qs", "qh", "scales", "bias")


def _weights(seed: int, n: int, k: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((n, k)) * 1.5).astype(np.float32)


def _assert_planes_equal(got, want, label: str):
    for f in PLANES:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f"{label} {f}"
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f"{label} {f}"
            assert a.tobytes() == b.tobytes(), f"{label} {f}"


@pytest.mark.parametrize("qtype", QTYPES, ids=lambda q: q.name)
def test_native_repack_bit_exact(qtype):
    n, k = 32, 1024
    raw = formats.quantize(_weights(7, n, k).reshape(-1), qtype)
    ref = pack.pack(raw, qtype, (n, k), backend="numpy")
    nat = pack.pack(raw, qtype, (n, k), backend="auto")
    _assert_planes_equal(nat, ref, qtype.name)


@pytest.mark.parametrize("n_threads", [1, 3, 7])
def test_native_repack_splits_rows_over_any_thread_count(n_threads):
    """37 rows over 3 or 7 threads leave a ragged last chunk: the planes
    are the numpy repack's all the same."""
    n, k = 37, 512
    qtype = GGMLQuantType.Q5_K
    raw = formats.quantize(_weights(4, n, k).reshape(-1), qtype)
    ref = pack.pack(raw, qtype, (n, k), backend="numpy")
    for f, plane in zip(PLANES, native.repack(raw, qtype, n, k, n_threads=n_threads)):
        want = getattr(ref, f)
        assert plane.dtype == want.dtype and plane.tobytes() == want.tobytes(), f


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("qtype", QTYPES, ids=lambda q: q.name)
def test_pack_gives_the_jax_packages_planes(qtype, shape):
    n, k = shape
    raw = jformats.quantize(_weights(11, n, k).reshape(-1), qtype)
    _assert_planes_equal(pack.pack(raw, qtype, shape),
                         jpack.pack(raw, qtype, shape), f"{qtype.name} {shape}")


def _near_ties(seed: int, n: int) -> np.ndarray:
    """n values whose Q6_K quants qv lie within 4e-6 of a half-integer:
    each 16-value group's first value 1.0 sets its step near 1/32. There
    round(qv) + 32 (numpy, the port before its native rounding) and
    round(qv + 32) in f32 (the JAX package) part on about 1 in 6 values."""
    rng = np.random.default_rng(seed)
    m = rng.integers(-31, 31, n) + 0.5 + rng.uniform(-4e-6, 4e-6, n)
    g = (m / 32.0).astype(np.float32).reshape(-1, 16)
    g[:, 0] = 1.0
    return g.reshape(-1)


@pytest.mark.parametrize("qtype", QTYPES, ids=lambda q: q.name)
def test_quantize_gives_the_jax_packages_bytes(qtype):
    """formats.quantize rounds through the native runtime where the JAX
    package does (Q8_0, the k-quant qmax path, Q6_K's qv + 32): the same
    bytes on 65536 normal values and 16384 near-ties."""
    x = np.concatenate([_weights(5, 64, 1024).reshape(-1), _near_ties(6, 64 * 256)])
    got, want = formats.quantize(x, qtype), jformats.quantize(x, qtype)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


_PROBE = r"""
import json, sys
import numpy as np
from pipeinfer_tpu_torch import native
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
from pipeinfer_tpu_torch.quant import formats, pack
x = np.random.default_rng(0).standard_normal(256 * 8).astype(np.float32)
pack.pack(formats.quantize(x, GGMLQuantType.Q6_K), GGMLQuantType.Q6_K, (8, 256))
maps = open("/proc/self/maps").read()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pipeinfer_tpu"))
print(json.dumps({"lib": native.get_lib()._name, "path": str(native.lib_path()),
                  "leaked": leaked, "mapped": [l.split()[-1] for l in maps.splitlines()
                                               if "pipeinfer" in l and ".so" in l]}))
"""


def test_the_port_builds_its_own_library_and_imports_no_jax():
    """In a fresh process (this one has jax loaded by conftest): packing
    and quantizing load the port's library from build/native/, map no
    file under native/ and import neither jax nor pipeinfer_tpu."""
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    lib = Path(res["lib"])
    assert lib == Path(res["path"]) and lib.exists()
    assert lib.is_relative_to(ROOT / "build" / "native")
    assert res["mapped"] and all(Path(p) == lib for p in res["mapped"])
    assert not any(Path(p).is_relative_to(ROOT / "native") for p in res["mapped"])


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """native with no library loaded and an empty build directory."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "build")
    return tmp_path


@pytest.mark.parametrize("fault", ["missing_compiler", "source_error"])
def test_a_failed_build_raises_and_nothing_falls_back(fresh_native, monkeypatch, fault):
    if fault == "missing_compiler":
        monkeypatch.setenv("CXX", str(fresh_native / "no-such-g++"))
        match = "no-such-g\\+\\+"
    else:
        bad = fresh_native / "repack.cpp"
        bad.write_text(native.SOURCE.read_text() + "\nint broken( {\n")
        monkeypatch.setattr(native, "SOURCE", bad)
        match = "error"  # the compiler's own message
    n, k = 4, 256
    x = _weights(2, n, k)
    raw = jformats.quantize(x.reshape(-1), GGMLQuantType.Q4_K)
    with pytest.raises(RuntimeError, match=match):
        native.get_lib()
    with pytest.raises(RuntimeError, match=match):  # the failure is kept, not rebuilt
        pack.pack(raw, GGMLQuantType.Q4_K, (n, k))
    with pytest.raises(RuntimeError, match=match):
        formats.quantize(x.reshape(-1), GGMLQuantType.Q6_K)
    with pytest.raises(RuntimeError, match=match):
        native.round_clip(x, 0.0, 15.0)
    assert not list((fresh_native / "build").glob("*.so"))
    # the plain version stays available on request
    np.testing.assert_array_equal(pack.pack(raw, GGMLQuantType.Q4_K, (n, k), backend="numpy").qs,
                                  jpack.pack(raw, GGMLQuantType.Q4_K, (n, k), "numpy").qs)


def test_concurrent_first_use_builds_one_library(fresh_native):
    """16 threads (more than this machine's cores) ask for the library at
    once: one build, one library for all, no temporary file left."""
    libs, errors = [], []

    def ask():
        try:
            libs.append(native.get_lib())
        except Exception as e:  # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=ask) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(libs) == 16 and len({id(lib) for lib in libs}) == 1
    built = sorted(p.name for p in (fresh_native / "build").iterdir())
    assert built == [native.lib_path().name]


@pytest.fixture(scope="module")
def q4k_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_native") / "q4k.gguf"
    testmodel.build_tiny_llama(path, seed=9, n_layers=3, n_embd=256, n_heads=4, n_kv_heads=2,
                               n_ff=512, n_vocab=300, qtype=GGMLQuantType.Q4_K)
    return path


def _flat(params) -> dict:
    out = {}
    for key, val in params.items():
        if key == "layers":
            for i, lp in enumerate(val):
                out.update({f"{i}.{k}": v for k, v in lp.items()})
        else:
            out[key] = val
    return out


@pytest.mark.parametrize("layout", ["k_major", "i4g"])
def test_load_model_native_gives_the_numpy_repacks_params(q4k_model, monkeypatch, layout):
    """load_model repacks through the native runtime; the same file
    repacked by the plain numpy version gives bitwise the same parameters."""
    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", layout)
    nat, cfg1 = load_model(q4k_model, device="cpu")
    real_pack = pack.pack
    monkeypatch.setattr(pack, "pack", lambda *a, **kw: real_pack(*a, **kw, backend="numpy"))
    ref, cfg2 = load_model(q4k_model, device="cpu")
    assert cfg1 == cfg2
    nat, ref = _flat(nat), _flat(ref)
    assert list(nat) == list(ref)
    n_quant = 0
    for name, a in nat.items():
        b = ref[name]
        if isinstance(a, QuantTensor):
            n_quant += 1
            assert a.layout == b.layout and a.qtype == b.qtype and a.shape == b.shape, name
            for f in ("qs", "qh", "scales", "bias", "scales2", "bias2"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None), (name, f)
                if x is not None:
                    assert x.dtype == y.dtype and torch.equal(x, y), (name, f)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert n_quant >= 3 * 7  # every layer's seven projections
    assert nat["0.wq"].layout == layout
