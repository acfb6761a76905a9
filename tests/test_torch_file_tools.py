"""The port's host-only file tools against the JAX package's on the same
inputs: gguf_dump, tokenize, results and quantize_stats print the same
stdout; preset (mirroring tests/test_batched_tools.py::test_preset_runner)
runs the port's batched_bench from a YAML preset and names the port's
entry points only."""

import contextlib
import io

import pytest
import torch

from pipeinfer_tpu.tools import gguf_dump as j_gguf_dump
from pipeinfer_tpu.tools import quantize_stats as j_quantize_stats
from pipeinfer_tpu.tools import results as j_results
from pipeinfer_tpu.tools import tokenize as j_tokenize
from pipeinfer_tpu_torch.tools import gguf_dump, preset, quantize_stats, results, testmodel
from pipeinfer_tpu_torch.tools import tokenize as t_tokenize

torch.set_num_threads(1)  # several test processes share the machine


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_file_tools")
    testmodel.build_tiny_llama(d / "m.gguf", seed=3, n_layers=2, n_embd=256, n_heads=4,
                               n_kv_heads=2, n_ff=512, n_vocab=300)
    # a synthetic SPM vocabulary for the tokenizer (build_tiny_llama writes none)
    testmodel.build_bench_pair(d / "t.gguf", d / "d.gguf", scale="nano", eps=0.5, vocab=True)
    return d


def _stdout(main, argv, stdin: str | None = None) -> tuple[object, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.ExitStack() as st:
        if stdin is not None:
            st.enter_context(_stdin(stdin))
        rc = main(argv)
    return rc, buf.getvalue()


@contextlib.contextmanager
def _stdin(text: str):
    import sys

    old = sys.stdin
    sys.stdin = io.StringIO(text)
    try:
        yield
    finally:
        sys.stdin = old


def _same(port_main, jax_main, argv, stdin=None) -> str:
    got = _stdout(port_main, argv, stdin)
    want = _stdout(jax_main, argv, stdin)
    assert got == want
    assert got[1]
    return got[1]


@pytest.mark.parametrize("flags", [[], ["--no-tensors"]])
def test_gguf_dump_matches_jax(files, flags):
    out = _same(gguf_dump.main, j_gguf_dump.main, [str(files / "m.gguf"), *flags])
    assert ("tns " in out) == (not flags)


@pytest.mark.parametrize("flags", [[], ["--ids-only"], ["--no-bos", "--ids-only"]])
def test_tokenize_matches_jax(files, flags):
    _same(t_tokenize.main, j_tokenize.main,
          ["-m", str(files / "t.gguf"), "the little robot saw the sea", *flags])


def test_tokenize_reads_stdin(files):
    _same(t_tokenize.main, j_tokenize.main, ["-m", str(files / "t.gguf"), "--ids-only"],
          stdin="once upon a time")


def test_results_matches_jax(tmp_path):
    csv = tmp_path / "results.csv"
    csv.write_text("120.5,33.25,0.0301,0.41,7b:Sequential\n"
                   "118.0,61.5,0.0163,0.44,7b:PipeInfer\n"
                   "240.0,90.0,0.0111,0.2,tiny\n")
    out = _same(results.main, j_results.main, [str(csv)])
    assert "7b:PipeInfer" in out and len(out.splitlines()) == 4
    png = tmp_path / "r.png"
    rc, _ = _stdout(results.main, [str(csv), "--plot", str(png)])
    assert rc == 0 and png.stat().st_size > 0
    bad = tmp_path / "mixed.csv"
    bad.write_text("1,2,3,4,a\n1,2,3,4\n")
    for main in (results.main, j_results.main):
        with pytest.raises(SystemExit, match="mixed row schemas"):
            main([str(bad)])


@pytest.mark.parametrize("ftypes", ["q4_0,q4_k,q5_k,q8_0", "q6_k"])
def test_quantize_stats_matches_jax(files, ftypes):
    out = _same(quantize_stats.main, j_quantize_stats.main,
                ["-m", str(files / "m.gguf"), "--ftypes", ftypes, "--per-tensor"])
    assert "rmse" in out


def test_preset_runner(files, tmp_path, capsys):
    """The port's preset runs the port's batched_bench (``device: cpu`` in
    the preset: its entry points default to CUDA), prints the JAX
    package's table row, and fails on a missing preset."""
    (tmp_path / "p.yml").write_text(f"model: {files / 'm.gguf'}\npp: 8\ntg: 2\npl: [1]\n"
                                    "device: cpu\n")
    rc = preset.main(["batched-bench", str(tmp_path / "p.yml")])
    assert rc == 0
    captured = capsys.readouterr()
    assert "| 8 | 2 | 1 |" in captured.out
    assert "batched-bench --model" in captured.err and "--device cpu" in captured.err
    with pytest.raises(SystemExit):
        preset.main(["batched-bench", str(tmp_path / "missing.yml")])


def test_preset_names_the_port():
    from pipeinfer_tpu.tools import preset as j_preset

    assert sorted(preset.KNOWN) == sorted(j_preset.KNOWN)
    for name, mod in preset.KNOWN.items():
        assert mod == j_preset.KNOWN[name].replace("pipeinfer_tpu.", "pipeinfer_tpu_torch.", 1)
        assert callable(getattr(__import__(mod, fromlist=["main"]), "main"))
    doc = {"model": "m.gguf", "temp": 0.0, "ignore_eos": True, "no_mmap": False,
           "layer_split": [0.5, 0.5]}
    assert preset.preset_to_argv(doc) == j_preset.preset_to_argv(doc)


def test_tools_run_as_modules(files):
    """`python -m pipeinfer_tpu_torch.tools.gguf_dump` prints what its
    main prints."""
    import subprocess
    import sys
    from pathlib import Path

    argv = [str(files / "m.gguf"), "--no-tensors"]
    out = subprocess.run([sys.executable, "-m", "pipeinfer_tpu_torch.tools.gguf_dump", *argv],
                         cwd=Path(__file__).resolve().parent.parent, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout == _stdout(gguf_dump.main, argv)[1]
