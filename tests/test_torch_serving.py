"""The port's serving layer (serving/batching.py, serving/server.py) and
its multi-stream engine (spec/multi.py) against the JAX package's, on the
CPU.

- Continuous batching (BatchScheduler) and speculative continuous
  batching (SpecBatchScheduler, MultiPipeInfer) give every request what a
  dedicated plain decode gives, and what the JAX engines give.
- Both HTTP servers, the JAX package's and the port's, run in process on
  port 0 over the same nano bench pair with its synthetic SPM vocabulary
  (no vocabulary file is needed), with and without a draft model, and
  answer the same bodies with the same `content`.
- Image segments: BatchScheduler prefills a request's token and image
  segments at admission (the image through the context's embedding input)
  as the JAX package does, and SpecBatchScheduler serves such a request's
  prompt_ids as the JAX package's does. A server started without --mmproj
  answers image_data with the JAX package's 400, and --mmproj with
  --draft exits with its message.
"""

import json
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.sampling.samplers import SamplingParams as JSampling
from pipeinfer_tpu.serving import server as j_server
from pipeinfer_tpu.serving.batching import BatchScheduler as JBatchScheduler
from pipeinfer_tpu.serving.batching import Request as JRequest
from pipeinfer_tpu.serving.batching import SpecBatchScheduler as JSpecBatchScheduler
from pipeinfer_tpu.spec.multi import MultiPipeInfer as JMulti
from pipeinfer_tpu.spec.params import SpecParams as JSpec
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import (SamplerState, SamplingParams, SparseLogits,
                                                   sample, top_probs)
from pipeinfer_tpu_torch.serving import server as t_server
from pipeinfer_tpu_torch.serving.batching import BatchScheduler, Request, SpecBatchScheduler
from pipeinfer_tpu_torch.spec.multi import MultiPipeInfer
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine (test_torch_cli.py)

CFG = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128, n_vocab=260)
SPEC_CFG = dict(n_layers=2, n_embd=128, n_heads=4, n_kv_heads=2, n_ff=256, n_vocab=160)
N_PREDICT = 24
PROMPTS = [[3, 17, 42, 7], [3, 14, 15, 9, 2], [31, 4, 1, 5, 9, 26]]
GREEDY = dict(temp=0.0)


def _both(path):
    return j_load(path), load_model(path, device="cpu")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The tiny serving model: (JAX (params, cfg), port (params, cfg))."""
    path = tmp_path_factory.mktemp("torch_srv") / "m.gguf"
    testmodel.build_tiny_llama(path, seed=11, **CFG)
    return _both(path)


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    """The multi-stream target (the JAX multi-spec tests' model)."""
    path = tmp_path_factory.mktemp("torch_mspec") / "tgt.gguf"
    testmodel.build_tiny_llama(path, seed=7, **SPEC_CFG)
    return _both(path)


def tctx(m, n_cells=256):
    return InferenceContext(*m, n_cells=n_cells, cache_dtype=torch.float32, device="cpu")


def jctx(m, n_cells=256):
    return JContext(*m, n_cells=n_cells, cache_dtype=jnp.float32)


def plain_decode(m, prompt, n, sampling: SamplingParams):
    """Plain decoding with the host sampler chain (penalties and RNG state
    included) on a dedicated port context."""
    ctx, st, b = tctx(m), SamplerState(params=sampling), Batch()
    for i, t in enumerate(prompt):
        st.accept(t, apply_grammar=False)
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    logits, out = ctx.decode(b)[-1], []
    for n_past in range(len(prompt), len(prompt) + n):
        out.append(sample(st, logits))
        st.accept(out[-1])
        b.clear()
        b.add(out[-1], n_past, 0)
        logits = ctx.decode(b)[0]
    return out


# -- continuous batching -------------------------------------------------------


def test_continuous_batching_matches_sequential(model):
    """Three interleaved greedy requests each produce exactly what a
    dedicated context produces, in both packages."""
    prompts = [[5, 9, 23], [7, 100, 42, 8], [11]]
    got = []
    for sched_cls, req_cls, samp, ctx, m in ((BatchScheduler, Request, SamplingParams, tctx,
                                              model[1]),
                                             (JBatchScheduler, JRequest, JSampling, jctx,
                                              model[0])):
        sched = sched_cls(ctx(m), max_slots=4, eos_id=-1, topk=None)
        reqs = [sched.submit(req_cls(prompt_ids=p, n_predict=12, sampling=samp(**GREEDY)))
                for p in prompts]
        sched.run_until_idle()
        assert all(r.done for r in reqs)
        got.append([r.generated for r in reqs])
    assert got[0] == got[1] == [plain_decode(model[1], p, 12, SamplingParams(**GREEDY))
                                for p in prompts]


def test_hot_join(model):
    """A request admitted while another is mid-generation decodes exactly."""
    sched = BatchScheduler(tctx(model[1]), max_slots=4, eos_id=-1, topk=None)
    r1 = sched.submit(Request(prompt_ids=[5, 9, 23], n_predict=20,
                              sampling=SamplingParams(**GREEDY)))
    for _ in range(5):
        sched.step()
    r2 = sched.submit(Request(prompt_ids=[42, 17], n_predict=8, sampling=SamplingParams(**GREEDY)))
    sched.run_until_idle()
    assert r1.done and r2.done
    assert r1.generated == plain_decode(model[1], [5, 9, 23], 20, SamplingParams(**GREEDY))
    assert r2.generated == plain_decode(model[1], [42, 17], 8, SamplingParams(**GREEDY))


def test_kv_admission_control(model):
    """A request that can never fit fails with .error (no hang, engine
    alive); oversubscribing requests queue until cells free up."""
    sched = BatchScheduler(tctx(model[1], 64), max_slots=4, eos_id=-1, topk=None)
    too_big = sched.submit(Request(prompt_ids=[1] * 10, n_predict=200,
                                   sampling=SamplingParams(**GREEDY)))
    sched.step()
    assert too_big.done and too_big.error and "KV cells" in too_big.error
    reqs = [sched.submit(Request(prompt_ids=[5, 9, 23], n_predict=35,
                                 sampling=SamplingParams(**GREEDY))) for _ in range(2)]
    sched.run_until_idle()
    for r in reqs:
        assert r.done and r.error is None and len(r.generated) == 35
    assert sched._reserved == 0


def test_logit_bias_ban_and_boost(model):
    """bias = -inf (the JSON-false form) bans a token; +1000 forces it."""
    sched = BatchScheduler(tctx(model[1], 512), max_slots=4, eos_id=-1, topk=None)
    r0 = sched.submit(Request(prompt_ids=[5, 9], n_predict=6, sampling=SamplingParams(temp=0.0)))
    sched.run_until_idle()
    banned = r0.generated[0]
    r1 = sched.submit(Request(prompt_ids=[5, 9], n_predict=6, sampling=SamplingParams(
        temp=0.0, logit_bias={banned: float("-inf")})))
    r2 = sched.submit(Request(prompt_ids=[5, 9], n_predict=4, sampling=SamplingParams(
        temp=0.0, penalty_repeat=1.0, penalty_last_n=0, logit_bias={123: 1000.0})))
    sched.run_until_idle()
    assert banned not in r1.generated
    assert r2.generated == [123] * 4


def test_top_probs_logit_bias_normalized():
    """n_probs under a logit bias: exact full-vocab probabilities of the
    BIASED distribution (the normalizer moves with the bias)."""
    rng = np.random.default_rng(3)
    row = rng.normal(size=32).astype(np.float32)
    order = np.argsort(-row)[:8]
    sl = SparseLogits(order.astype(np.int32), row[order],
                      float(np.log(np.exp(row.astype(np.float64)).sum())))
    tid = int(order[0])
    p = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0, logit_bias={tid: 10.0})
    probs = dict(top_probs(SamplerState(params=p), sl, 8))
    biased = row.astype(np.float64).copy()
    biased[tid] += 10.0
    want = np.exp(biased) / np.exp(biased).sum()
    for t, v in probs.items():
        assert abs(v - want[t]) < 1e-4


# -- speculative continuous batching --------------------------------------------


def test_spec_scheduler_matches_sequential(model):
    """SpecBatchScheduler (the server's --draft engine) over one model as
    target and draft: greedy outputs exact, as in the JAX package."""
    prompts = [[5, 9, 23], [7, 100, 42, 8], [11]]
    sp = dict(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=2)
    sched = SpecBatchScheduler(tctx(model[1], 512), tctx(model[1], 512),
                               spec_params=SpecParams(**sp), max_slots=4, eos_id=-1)
    reqs = [sched.submit(Request(prompt_ids=p, n_predict=12, sampling=SamplingParams(**GREEDY)))
            for p in prompts]
    sched.run_until_idle()
    want = [plain_decode(model[1], p, 12, SamplingParams(**GREEDY)) for p in prompts]
    assert all(r.done and r.error is None for r in reqs)
    assert [r.generated for r in reqs] == want


def test_spec_scheduler_grammar_and_nprobs(model):
    """The speculative scheduler carries grammar and n_probs down the
    host-verified engine (device lanes take neither)."""
    sched = SpecBatchScheduler(
        tctx(model[1], 2048), tctx(model[1], 2048),
        spec_params=SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=2),
        max_slots=2, eos_id=-1, device_lanes=2, device_rounds=2)
    assert sched.devsrv is not None
    req = sched.submit(Request(prompt_ids=[5, 9, 23], n_predict=8, n_probs=2,
                               sampling=SamplingParams(temp=0.0, penalty_repeat=1.0,
                                                       penalty_last_n=0)))
    sched.run_until_idle()
    assert req.done and req.error is None
    assert sched.n_host_served == 1 and sched.n_device_served == 0
    assert len(req.probs) == len(req.generated)
    for tok, row in zip(req.generated, req.probs):
        assert row[0][0] == tok  # greedy commit == top candidate


@pytest.mark.parametrize("segments", ["text_image_text", "image_first", "two_images"])
def test_batch_scheduler_prefills_image_segments_like_jax(model, segments):
    """Token segments through decode and image segments through
    decode_embd, all at admission: the port's BatchScheduler generates the
    JAX package's ids for the same segments, beside a plain request, and
    the image conditions the stream (another embedding, another stream)."""
    rng = np.random.default_rng(4)
    img = rng.standard_normal((5, CFG["n_embd"])).astype(np.float32)
    img2 = rng.standard_normal((3, CFG["n_embd"])).astype(np.float32)
    segs = {"text_image_text": [("tok", [1, 5]), ("img", img), ("tok", [9, 4])],
            "image_first": [("tok", [1]), ("img", img), ("tok", [9])],
            "two_images": [("tok", [1]), ("img", img), ("tok", [7]), ("img", img2),
                           ("tok", [9])]}[segments]

    def serve(sched_cls, req_cls, ctx, sampling_cls, segs):
        sched = sched_cls(ctx, max_slots=2, eos_id=-1, topk=None)
        reqs = [sched.submit(req_cls(prompt_ids=[1, 5, 9], n_predict=6,
                                     sampling=sampling_cls(**GREEDY), segments=segs)),
                sched.submit(req_cls(prompt_ids=PROMPTS[0], n_predict=6,
                                     sampling=sampling_cls(**GREEDY)))]
        sched.run_until_idle()
        assert all(r.done and r.error is None for r in reqs)
        return [r.generated for r in reqs]

    got = serve(BatchScheduler, Request, tctx(model[1]), SamplingParams, segs)
    want = serve(JBatchScheduler, JRequest, jctx(model[0]), JSampling, segs)
    assert got == want
    assert got[1] == plain_decode(model[1], PROMPTS[0], 6, SamplingParams(**GREEDY))
    moved = [(k, p * 0.5 if k == "img" else p) for k, p in segs]
    assert serve(BatchScheduler, Request, tctx(model[1]), SamplingParams, moved)[0] != got[0]
    # a segmented prompt must end with text, as in the JAX package
    sched = BatchScheduler(tctx(model[1]), max_slots=2, eos_id=-1, topk=None)
    sched.submit(Request(prompt_ids=[], n_predict=2, sampling=SamplingParams(**GREEDY),
                         segments=[("tok", [1]), ("img", img)]))
    with pytest.raises(ValueError, match="must end with text"):
        sched.run_until_idle()


def test_spec_scheduler_serves_segmented_requests_like_jax(model):
    """SpecBatchScheduler keeps segmented requests off the device lanes and
    hands the host engine their prompt_ids, as the JAX package's does (its
    server never sends it images: --mmproj with --draft exits): the same
    ids as the JAX scheduler and as plain decoding of prompt_ids."""
    img = np.ones((4, CFG["n_embd"]), np.float32)
    segs = [("tok", [1, 5]), ("img", img), ("tok", [9])]
    sp = dict(n_draft=4, n_parallel=1, max_inflight=2)
    got = []
    for sched, req_cls, samp in (
            (SpecBatchScheduler(tctx(model[1], 512), tctx(model[1], 512), eos_id=-1,
                                spec_params=SpecParams(**sp)), Request, SamplingParams),
            (JSpecBatchScheduler(jctx(model[0], 512), jctx(model[0], 512), eos_id=-1,
                                 spec_params=JSpec(**sp)), JRequest, JSampling)):
        req = sched.submit(req_cls(prompt_ids=[1, 5, 9], n_predict=6, sampling=samp(**GREEDY),
                                   segments=segs))
        sched.run_until_idle()
        assert req.done and req.error is None
        got.append(req.generated)
    assert got[0] == got[1] == plain_decode(model[1], [1, 5, 9], 6, SamplingParams(**GREEDY))


# -- MultiPipeInfer -------------------------------------------------------------


def _multi(target, sp, sampling_kw, **kw):
    t = MultiPipeInfer(tctx(target[1], 512), tctx(target[1], 512), SamplingParams(**sampling_kw),
                       SpecParams(**sp), eos_id=-1, **kw)
    j = JMulti(jctx(target[0], 512), jctx(target[0], 512), JSampling(**sampling_kw), JSpec(**sp),
               eos_id=-1, **kw)
    return t, j


def test_multi_streams_each_exact(target):
    """Concurrent PipeInfer streams over one shared context pair: every
    stream equals the JAX engine's and plain decoding; all slots and
    cells come back."""
    eng, jeng = _multi(target, dict(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=2),
                       GREEDY)
    got = []
    for e in (eng, jeng):
        reqs = [e.submit(p, N_PREDICT) for p in PROMPTS]
        e.run_until_idle()
        assert all(r.done for r in reqs)
        got.append([r.tokens for r in reqs])
    assert got[0] == got[1] == [plain_decode(target[1], p, N_PREDICT, SamplingParams(**GREEDY))
                                for p in PROMPTS]
    assert len(eng.free_bases) == eng.max_streams and not eng.active and not eng.pending
    for ctx in (eng.tgt, eng.dft):
        assert (ctx.h_pos[: ctx.trash_cell] < 0).all(), "leaked cells"


def test_multi_hot_join_and_overcommit(target):
    """More requests than stream slots (trees of 2 branches): later
    requests queue, join as earlier streams finish, and decode exactly."""
    prompts = PROMPTS + [[9, 9, 2, 7], [1, 2, 3, 4, 5]]
    eng, _ = _multi(target, dict(n_draft=4, n_parallel=2, p_accept=0.0, max_inflight=2), GREEDY,
                    max_streams=2)
    assert eng.max_streams == 2
    reqs = [eng.submit(p, N_PREDICT) for p in prompts[:3]]
    for _ in range(4):
        eng.step()
    reqs += [eng.submit(p, N_PREDICT) for p in prompts[3:]]
    eng.run_until_idle()
    for r, p in zip(reqs, prompts):
        assert r.done and r.tokens == plain_decode(target[1], p, N_PREDICT,
                                                   SamplingParams(**GREEDY)), r.id
    assert len(eng.free_bases) == eng.max_streams


def test_multi_stochastic_streams_independent(target):
    """Seeded stochastic sampling per stream (host verification: the
    default penalties keep the device verifier out): concurrency does not
    perturb any stream's tokens, and the port samples what the JAX package
    samples (the same numpy sampler chain)."""
    samp = dict(temp=0.9, top_k=20, seed=77)
    eng, jeng = _multi(target, dict(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=2), samp)
    got = []
    for e in (eng, jeng):
        reqs = [e.submit(p, N_PREDICT) for p in PROMPTS[:2]]
        e.run_until_idle()
        got.append([r.tokens for r in reqs])
    assert got[0] == got[1] == [plain_decode(target[1], p, N_PREDICT, SamplingParams(**samp))
                                for p in PROMPTS[:2]]


# -- the HTTP servers --------------------------------------------------------------


@pytest.fixture(scope="module")
def nano_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_http")
    t, dr = d / "t.gguf", d / "d.gguf"
    testmodel.build_bench_pair(t, dr, scale="nano", eps=0.5, vocab=True)
    return t, dr


@pytest.fixture(scope="module")
def servers(nano_pair):
    """{(package, draft?): port number}: the JAX and the port servers, each
    without and with a draft model, on the nano bench pair."""
    t, dr = nano_pair
    ports, started = {}, []
    for pkg, mod, sp_cls, extra in (("jax", j_server, JSpec, {}),
                                    ("torch", t_server, SpecParams, {"device": "cpu"})):
        for draft in (False, True):
            kw = dict(n_cells=1024, max_slots=4, **extra)
            if draft:
                kw.update(draft_path=str(dr), spec_params=sp_cls(n_draft=4, n_parallel=1,
                                                                 p_accept=0.0, max_inflight=2))
            httpd, engine = mod.serve(str(t), "127.0.0.1", 0, **kw)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            started.append((httpd, engine))
            ports[pkg, draft] = httpd.server_address[1]
    yield ports
    for httpd, engine in started:
        httpd.shutdown()
        engine.shutdown()
        assert not engine.thread.is_alive()


def _post(port, body, path="/completion", raw=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=raw if raw is not None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def _stream(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/completion",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    pieces, final = [], None
    with urllib.request.urlopen(req, timeout=300) as r:
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                obj = json.loads(line[6:])
                if obj.get("stop"):
                    final = obj
                else:
                    pieces.append(obj["content"])
    return "".join(pieces) + (final.get("content") or ""), final


BODIES = {
    "greedy": {"prompt": "Once upon a time", "n_predict": 20, "temperature": 0,
               "repeat_penalty": 1.0, "repeat_last_n": 0},
    "penalty": {"prompt": "The little robot", "n_predict": 16, "temperature": 0},
    "grammar": {"prompt": "Answer:", "n_predict": 8, "temperature": 0,
                "grammar": 'root ::= "yes" | "no"'},
    "n_probs": {"prompt": "Hello", "n_predict": 5, "temperature": 0, "n_probs": 3,
                "repeat_penalty": 1.0, "repeat_last_n": 0},
}


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "draft"])
def test_http_servers_answer_alike(servers, draft):
    """The same bodies, sent to the JAX server and the port's, get the same
    answers: content, token counts and n_probs payloads; and /health,
    /props, /v1/completions and a malformed body behave alike."""
    jp, tp = servers["jax", draft], servers["torch", draft]
    for name, body in BODIES.items():
        want, got = _post(jp, body), _post(tp, body)
        # n_probs: the same candidates, probabilities within f32 rounding
        g, w = got.pop("completion_probabilities", []), want.pop("completion_probabilities", [])
        assert got == want, name
        assert got["tokens_predicted"] >= 1 and "error" not in got
        assert len(g) == len(w) == (got["tokens_predicted"] if body.get("n_probs") else 0)
        for ge, we in zip(g, w):
            assert ge["content"] == we["content"]
            assert [c["tok_str"] for c in ge["probs"]] == [c["tok_str"] for c in we["probs"]]
            np.testing.assert_allclose([c["prob"] for c in ge["probs"]],
                                       [c["prob"] for c in we["probs"]], rtol=0, atol=1e-5)
    assert _post(tp, BODIES["grammar"])["content"] in ("yes", "no")
    for port in (jp, tp):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
    props = [json.load(urllib.request.urlopen(f"http://127.0.0.1:{p}/props", timeout=30))
             for p in (jp, tp)]
    assert props[0] == props[1] and props[1]["arch"] == "llama"
    v1 = {"prompt": "Hi", "max_tokens": 6, "temperature": 0}
    assert _post(tp, v1, "/v1/completions") == _post(jp, v1, "/v1/completions")
    for port in (jp, tp):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, None, raw=b"{not json")
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(tp, {"prompt": "x", "grammar": "root := broken"})
    assert e.value.code == 400


def test_http_concurrent_requests_on_the_draft_server(servers):
    """Concurrent requests on the port's --draft server each get the text
    the JAX server gives them alone (greedy ones ride the device lanes)."""
    bodies = [dict(BODIES["greedy"], prompt=p) for p in ("Hello", "The quick", "Every day")]
    bodies.append(BODIES["penalty"])
    want = [_post(servers["jax", True], b) for b in bodies]
    results = [None] * len(bodies)

    def post(i):
        results[i] = _post(servers["torch", True], bodies[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert results == want


def test_http_stop_sequences(servers):
    """Stop sequences truncate (and cancel) the same way in both servers,
    plain and streamed."""
    tp, jp = servers["torch", True], servers["jax", True]
    base = _post(tp, BODIES["greedy"])["content"]
    assert len(base) > 6
    stop = base[3:6]
    body = dict(BODIES["greedy"], stop=[stop])
    out = _post(tp, body)
    assert out == _post(jp, body)
    assert out["stopped_word"] is True and out["stopping_word"] == stop
    assert out["content"] == base[: base.find(stop)]
    text, final = _stream(servers["torch", False], body)
    assert final["stopped_word"] is True and text == base[: base.find(stop)]


def test_image_data_without_mmproj_is_400(servers):
    """A server started without --mmproj answers a request's image_data
    with the JAX package's 400, with and without a draft model."""
    body = {"prompt": "[img-1] what is this?", "n_predict": 4,
            "image_data": [{"id": 1, "data": "AAAA"}]}
    for draft in (False, True):
        errs = []
        for pkg in ("jax", "torch"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(servers[pkg, draft], body)
            assert e.value.code == 400
            errs.append(json.loads(e.value.read())["error"])
        assert errs[0] == errs[1] == "server started without --mmproj"


def test_mmproj_checks_exit_like_jax(nano_pair, tmp_path):
    """--mmproj with --draft exits with the JAX package's message, and so
    does a projector whose width is not the model's."""
    t, dr = nano_pair
    fits = testmodel.build_mmproj(tmp_path / "mm256.gguf", "nano", seed=1, n_embd=256)
    narrow = testmodel.build_mmproj(tmp_path / "mm64.gguf", "nano", seed=1)
    for mm, draft, want in ((fits, str(dr), "--mmproj and --draft cannot be combined yet"),
                            (narrow, None, "projector width 64 != model embedding 256")):
        msgs = []
        for mod, extra in ((j_server, {}), (t_server, {"device": "cpu"})):
            with pytest.raises(SystemExit) as e:
                mod.serve(str(t), "127.0.0.1", 0, n_cells=256, mmproj_path=str(mm),
                          draft_path=draft, **extra)
            msgs.append(str(e.value.code))
        assert msgs[0] == msgs[1] and want in msgs[1]
    with pytest.raises(SystemExit) as e:
        t_server.main(["-m", str(t), "--mmproj", str(fits), "--draft", str(dr), "--device",
                       "cpu", "-c", "256"])
    assert "cannot be combined" in str(e.value.code)


def test_module_entry_serves(nano_pair, servers):
    """`python -m pipeinfer_tpu_torch.serving.server --draft D --device cpu`
    in a process of its own answers as the in-process server does."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t, dr = nano_pair
    proc = subprocess.Popen(
        [sys.executable, "-m", "pipeinfer_tpu_torch.serving.server", "-m", str(t), "--draft",
         str(dr), "--n-draft", "4", "--max-inflight", "2", "--device", "cpu", "--port",
         str(port)], cwd=Path(__file__).resolve().parent.parent, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 240
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    assert json.load(r)["status"] == "ok"
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.monotonic() < deadline, "server did not start"
                time.sleep(0.5)
        assert _post(port, BODIES["greedy"]) == _post(servers["torch", True], BODIES["greedy"])
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=60)
    assert f"listening on http://127.0.0.1:{port}" in err
