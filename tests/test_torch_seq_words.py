"""SEQ_WORDS in the port: tests/test_seq_words.py's test. Widened to 4 words
(PIPEINFER_SEQ_WORDS=4, read at import, so in a subprocess), the
sequence-slot ceiling is 128 and 32 concurrent MultiPipeInfer streams fit;
each stream equals plain greedy decoding, the port's in the subprocess
and the JAX package's here, on the same files."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu_torch.tools import testmodel

pytestmark = pytest.mark.skipif(os.environ.get("CI_NO_SUBPROC"), reason="subprocess test")

PROMPTS = [[3, 17, 42], [5, 9], [11, 30, 7, 2]]
N = 10

SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)

from pipeinfer_tpu_torch.runtime import kv_cache as kv
assert kv.SEQ_WORDS == 4, kv.SEQ_WORDS

from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.multi import MAX_SEQS, MultiPipeInfer
from pipeinfer_tpu_torch.spec.params import SpecParams

assert MAX_SEQS == 128, MAX_SEQS

pt, pd, PROMPTS, N = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), int(sys.argv[4])
tgt, dft = load_model(pt, device="cpu"), load_model(pd, device="cpu")


def ctx(m, n_cells):
    return InferenceContext(*m, n_cells=n_cells, cache_dtype=torch.float32, device="cpu")


goldens = []
for prompt in PROMPTS:
    c = ctx(tgt, 256)
    b = Batch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    logits = c.decode(b)[-1]
    out = []
    for n_past in range(len(prompt), len(prompt) + N):
        out.append(int(np.argmax(logits)))
        b.clear()
        b.add(out[-1], n_past, 0)
        logits = c.decode(b)[0]
    goldens.append(out)

GREEDY = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
N_STREAMS = 32
sp = SpecParams(n_draft=3, n_parallel=1, p_accept=0.0, max_inflight=2)
# stride = 1 + 1*2 = 3 slots/stream: 32 streams need 96 slots > 64 (two
# words) and <= 128 (four)
cells = sum((len(PROMPTS[i % 3]) + N + 2 * 3 + 4) for i in range(N_STREAMS)) + 64
eng = MultiPipeInfer(ctx(tgt, cells), ctx(dft, cells), GREEDY, sp, eos_id=-1)
reqs = [eng.submit(prompt_ids=list(PROMPTS[i % 3]), n_predict=N, ignore_eos=True)
        for i in range(N_STREAMS)]
eng.run_until_idle()
for i, r in enumerate(reqs):
    assert r.error is None, (i, r.error)
    assert r.tokens == goldens[i % 3], (i, r.tokens, goldens[i % 3])
print("GOLDENS", json.dumps(goldens))
print("OK", len(reqs), "streams at SEQ_WORDS=4")
"""


def _jax_golden(path, prompt):
    params, cfg = j_load(path)
    ctx = JContext(params, cfg, n_cells=256, cache_dtype=jnp.float32)
    b = JBatch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    logits = ctx.decode(b)[-1]
    out = []
    for n_past in range(len(prompt), len(prompt) + N):
        out.append(int(np.argmax(logits)))
        b.clear()
        b.add(out[-1], n_past, 0)
        logits = ctx.decode(b)[0]
    return out


def test_32_streams_at_seq_words_4(tmp_path):
    pt, pd = tmp_path / "t.gguf", tmp_path / "d.gguf"
    testmodel.build_tiny_llama(pt, seed=5, n_layers=2, n_embd=128, n_heads=4, n_kv_heads=2,
                               n_ff=256, n_vocab=512)
    testmodel.build_tiny_llama(pd, seed=9, n_layers=1, n_embd=64, n_heads=2, n_kv_heads=2,
                               n_ff=128, n_vocab=512)
    env = dict(os.environ)
    env["PIPEINFER_SEQ_WORDS"] = "4"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent.parent)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(pt), str(pd), json.dumps(PROMPTS),
                          str(N)], env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK 32 streams" in out.stdout, out.stdout
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("GOLDENS "))
    assert json.loads(line[len("GOLDENS "):]) == [_jax_golden(pt, p) for p in PROMPTS]
