"""The port's image path into the language model against the JAX
package's, on the CPU: InferenceContext.decode_embd, image conditioning,
cli.llava and the server's image_data.

The language model is a tiny random llama (attention and the FFN reach the
logits, so an image can condition it) with the nano bench pair's synthetic
SPM vocabulary, f32 weights and an f32 cache; the tower is a nano mmproj
(tools/testmodel.build_mmproj) projecting to its n_embd of 64. Both
packages run the same files; greedy text is compared byte for byte.
"""

import base64
import contextlib
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.cli import llava as j_llava
from pipeinfer_tpu.models import clip as j_clip
from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.serving import server as j_server
from pipeinfer_tpu_torch.cli import llava as t_llava
from pipeinfer_tpu_torch.models import clip as t_clip
from pipeinfer_tpu_torch.models import load_model as t_load
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.serving import server as t_server
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)

N_EMBD = 64
LOGITS_ATOL = 1e-5  # f32 logits of two packages' matmul orders (max|logit| is about 1)
GREEDY_ARGV = ["--temp", "0", "--repeat-penalty", "1.0", "--repeat-last-n", "0"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_llava")
    testmodel.build_bench_pair(d / "nt.gguf", d / "nd.gguf", scale="nano", eps=0.5, vocab=True)
    lm = testmodel.build_tiny_llama(d / "lm.gguf", seed=2, n_layers=2, n_embd=N_EMBD, n_heads=4,
                                    n_kv_heads=2, n_ff=128, vocab_from=d / "nt.gguf")
    mm = testmodel.build_mmproj(d / "mm.gguf", "nano", seed=1)
    narrow = testmodel.build_mmproj(d / "mm48.gguf", "nano", seed=1, n_embd=48)
    return dict(dir=d, lm=str(lm), mm=str(mm), narrow=str(narrow))


@pytest.fixture(scope="module")
def models(files):
    return dict(j=j_load(files["lm"]), t=t_load(files["lm"], device="cpu"),
                jclip=j_clip.load_mmproj(files["mm"]),
                tclip=t_clip.load_mmproj(files["mm"], device="cpu"))


def tctx(models, n_cells=128):
    return InferenceContext(*models["t"], n_cells=n_cells, cache_dtype=torch.float32, device="cpu")


def jctx(models, n_cells=128):
    return JContext(*models["j"], n_cells=n_cells, cache_dtype=jnp.float32)


def _rows(ctx, toks):
    b = Batch()
    for i, t in enumerate(toks):
        b.add(t, i, 0, want_logits=(i == len(toks) - 1))
    return ctx.decode(b)[-1]


def test_decode_embd_matches_token_path(models):
    """tok_embd rows through decode_embd give the token path's logits bit
    for bit (same rows, same bucket, same cells), and the next token
    decoded over either cache gives the same logits."""
    toks = [5, 9, 23, 7]
    ctx_a, ctx_b = tctx(models), tctx(models)
    want = _rows(ctx_a, toks)
    embd = models["t"][0]["tok_embd"][toks]
    got = ctx_b.decode_embd(embd, 0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ctx_b.h_pos, ctx_a.h_pos)
    np.testing.assert_array_equal(ctx_b.h_seq, ctx_a.h_seq)
    nxt = int(np.argmax(got))
    b = Batch()
    b.add(nxt, len(toks), 0)
    np.testing.assert_array_equal(ctx_b.decode(b)[0], ctx_a.decode(b.copy())[0])


@pytest.mark.parametrize("t,seq", [(5, 0), (20, 0), (33, 1)])
def test_decode_embd_matches_jax(models, t, seq):
    """decode_embd of random rows after a 3-token prefix, at buckets 8, 32
    and 128 and on another sequence: the JAX package's logits within
    LOGITS_ATOL, the same host mirror (cells, positions, membership)."""
    embd = np.random.default_rng(t).standard_normal((t, N_EMBD)).astype(np.float32)
    out = {}
    for side, ctx, batch_cls in (("t", tctx(models), Batch), ("j", jctx(models), JBatch)):
        b = batch_cls()
        for i, tk in enumerate([1, 17, 4]):
            b.add(tk, i, seq)
        ctx.decode(b)
        logits = ctx.decode_embd(embd if side == "j" else torch.from_numpy(embd), 3, seq)
        out[side] = (np.asarray(logits), np.asarray(ctx.h_pos), np.asarray(ctx.h_seq),
                     ctx.n_free_cells)
    assert out["t"][0].shape == (models["t"][1].n_vocab,)
    np.testing.assert_allclose(out["t"][0], out["j"][0], rtol=0, atol=LOGITS_ATOL)
    for i in (1, 2):
        np.testing.assert_array_equal(out["t"][i], out["j"][i])
    assert out["t"][3] == out["j"][3] == 127 - 3 - t


def _image(seed, h=32, w=32):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)


def _conditioned(models, side, img, n=8):
    """Greedy ids after [1, 7, 12] + the image's embeddings (the JAX
    package's test_llava_image_conditions_generation)."""
    if side == "t":
        params, cfg = models["tclip"]
        embd = t_clip.encode_image(params, cfg, t_clip.preprocess_image(img, cfg))
        ctx, batch_cls = tctx(models), Batch
    else:
        params, cfg = models["jclip"]
        embd = j_clip.encode_image(params, cfg, j_clip.preprocess_image(img, cfg))
        ctx, batch_cls = jctx(models), JBatch
    b = batch_cls()
    pre = [1, 7, 12]
    for i, t in enumerate(pre):
        b.add(t, i, 0)
    ctx.decode(b)
    logits = ctx.decode_embd(embd, len(pre))
    out, pos = [], len(pre) + embd.shape[0]
    for _ in range(n):
        out.append(int(np.argmax(logits)))
        b = batch_cls()
        b.add(out[-1], pos, 0)
        logits = ctx.decode(b)[0]
        pos += 1
    return out


def test_image_conditions_generation_like_jax(models):
    """Same image twice gives one stream, another image another stream,
    and each stream is the JAX package's (a non-square image too)."""
    a1, a2 = _conditioned(models, "t", _image(1)), _conditioned(models, "t", _image(1))
    c = _conditioned(models, "t", _image(99))
    assert a1 == a2 and a1 != c
    assert a1 == _conditioned(models, "j", _image(1))
    assert c == _conditioned(models, "j", _image(99))
    wide = _image(5, 20, 44)
    assert _conditioned(models, "t", wide) == _conditioned(models, "j", wide)


def _png(img) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _run(entry, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = entry(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("extra", [[], ["-p", "what is in it?", "--system", "be brief"]])
def test_cli_llava_prints_the_jax_stdout(files, extra, tmp_path):
    """cli.llava on a PNG: the port prints the JAX package's text and says
    how many image tokens it encoded; another image, another text."""
    for seed in (1, 2):
        (tmp_path / f"{seed}.png").write_bytes(_png(_image(seed, 28, 40)))
    texts = []
    for seed in (1, 2):
        argv = ["-m", files["lm"], "--mmproj", files["mm"], "--image",
                str(tmp_path / f"{seed}.png"), "-n", "12", "-c", "256", *GREEDY_ARGV, *extra]
        rc_j, want, _ = _run(j_llava.main, argv)
        rc_t, got, err = _run(t_llava.main, argv + ["--device", "cpu"])
        assert rc_j == rc_t == 0 and got == want
        assert "encoded 16 image tokens" in err and "decode:" in err
        texts.append(got)
    assert texts[0] != texts[1]


def test_cli_llava_refuses_a_projector_of_another_width(files, tmp_path):
    (tmp_path / "x.png").write_bytes(_png(_image(1)))
    argv = ["-m", files["lm"], "--mmproj", files["narrow"], "--image", str(tmp_path / "x.png")]
    msgs = []
    for entry, extra in ((j_llava.main, []), (t_llava.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            entry(argv + extra)
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and "projector width 48 != model embedding 64" in msgs[1]


@pytest.fixture(scope="module")
def servers(files):
    """{package: port} of both packages' servers with --mmproj."""
    ports, started = {}, []
    for pkg, mod, extra in (("jax", j_server, {}), ("torch", t_server, {"device": "cpu"})):
        httpd, engine = mod.serve(files["lm"], "127.0.0.1", 0, n_cells=512, max_slots=2,
                                  mmproj_path=files["mm"], **extra)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        started.append((httpd, engine))
        ports[pkg] = httpd.server_address[1]
    yield ports
    for httpd, engine in started:
        httpd.shutdown()
        engine.shutdown()


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/completion",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def _b64(img) -> str:
    return base64.b64encode(_png(img)).decode()


def test_server_image_requests_match_jax(servers):
    """/completion with base64 image_data and [img-N] placeholders: each
    reply is the JAX server's, deterministic per image, different across
    images; two images in one prompt too."""
    body = {"prompt": "USER:[img-0]\ndescribe\nASSISTANT:", "n_predict": 6, "temperature": 0,
            "image_data": [{"data": _b64(_image(3)), "id": 0}]}
    r1, r2, j1 = _post(servers["torch"], body), _post(servers["torch"], body), \
        _post(servers["jax"], body)
    assert r1["tokens_predicted"] >= 1 and r1["content"] == r2["content"] == j1["content"]
    other = dict(body, image_data=[{"data": _b64(_image(4, 20, 36)), "id": 0}])
    r3 = _post(servers["torch"], other)
    assert r3["content"] != r1["content"]
    assert r3["content"] == _post(servers["jax"], other)["content"]
    two = {"prompt": "[img-2] and [img-5]: same?", "n_predict": 5, "temperature": 0,
           "image_data": [{"data": _b64(_image(3)), "id": 2}, {"data": _b64(_image(4)), "id": 5}]}
    assert _post(servers["torch"], two)["content"] == _post(servers["jax"], two)["content"]


@pytest.mark.parametrize("bad", ["missing_id", "not_an_image", "no_data"])
def test_server_bad_image_data_is_400_like_jax(servers, bad):
    """A prompt naming an image that was not sent, data PIL cannot read,
    an item without data: both servers answer 400 with one message."""
    item = {"missing_id": {"data": _b64(_image(3)), "id": 0},
            "not_an_image": {"data": base64.b64encode(b"zzzz").decode(), "id": 7},
            "no_data": {"id": 7}}[bad]
    body = {"prompt": "[img-7]x", "n_predict": 2, "image_data": [item]}
    errs = []
    for pkg in ("jax", "torch"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(servers[pkg], body)
        assert e.value.code == 400
        errs.append(json.loads(e.value.read())["error"])
    assert errs[0].split(":")[0] == errs[1].split(":")[0] == "bad image_data"
    if bad != "not_an_image":  # PIL's own message names its BytesIO object
        assert errs[0] == errs[1]


@pytest.mark.parametrize("embd_path", [False, True])
def test_padding_rows_leave_valid_rows_alone(tmp_path, monkeypatch, embd_path):
    """Under i4g (one activation scale per slab for every row of a call) a
    step's padding rows must not carry what earlier requests left in the
    cache into the valid rows: the same 5 rows (bucket 8; tokens or, with
    decode_embd, their embeddings) give the same logits bit for bit on a
    fresh context and on one whose cells another sequence filled and
    freed, as the --mmproj server's second identical request showed on
    the card."""
    from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
    from pipeinfer_tpu_torch.models.llama import embed

    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", "i4g")
    lm = testmodel.build_tiny_llama(tmp_path / "q.gguf", seed=4, n_layers=2, n_embd=256,
                                    n_heads=4, n_kv_heads=2, n_ff=512, n_vocab=300,
                                    qtype=GGMLQuantType.Q4_K)
    params, cfg = t_load(lm, device="cpu")
    toks = [7, 19, 3, 250, 42]

    def run(ctx):
        if embd_path:
            return ctx.decode_embd(embed(torch.tensor(toks), params["tok_embd"]), 0)
        b = Batch()
        for i, t in enumerate(toks):
            b.add(t, i, 0)
        return ctx.decode(b)[-1]

    want = run(InferenceContext(params, cfg, n_cells=64, device="cpu"))
    ctx = InferenceContext(params, cfg, n_cells=64, device="cpu")
    b = Batch()
    rng = np.random.default_rng(0)
    for i, t in enumerate(rng.integers(3, 300, 40).tolist()):
        b.add(t, i, 1)
    ctx.decode(b)
    ctx.seq_rm(1, 0, -1)
    np.testing.assert_array_equal(run(ctx), want)


@pytest.fixture(scope="module")
def q4k_models(tmp_path_factory):
    """A 256-wide Q4_K llama loaded under i4g (the card's layout) and under
    the exact k_major layout."""
    from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType

    lm = testmodel.build_tiny_llama(tmp_path_factory.mktemp("q4k") / "q.gguf", seed=2,
                                    n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512,
                                    n_vocab=300, qtype=GGMLQuantType.Q4_K)
    out = {}
    for layout in ("i4g", "k_major"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PIPEINFER_WEIGHT_LAYOUT", layout)
            out[layout] = t_load(lm, device="cpu")
    return out


@pytest.mark.parametrize("t,seed", [(32, 0), (40, 0), (40, 4), (20, 1)])
def test_padded_token_path_within_a_share_of_i4g_rounding(q4k_models, t, seed):
    """decode_embd of t tok_embd rows against the token path under i4g:
    bit for bit in a whole bucket (32); in a padded one (40 rows in bucket
    128, 20 in 32) the token path's padding rows hold token 0's row and
    decode_embd's zeros, and share the valid rows' activation scales, so
    the logits part by at most live_check.PAD_SHARE of i4g's own rounding
    (the i4g token path against k_major's on the same rows)."""
    from pipeinfer_tpu_torch.models.llama import embed
    from pipeinfer_tpu_torch.tools import live_check as LC

    toks = np.random.default_rng(seed).integers(3, 300, t).tolist()
    params, cfg = q4k_models["i4g"]
    want = _rows(InferenceContext(params, cfg, n_cells=1024, device="cpu"), toks)
    got = InferenceContext(params, cfg, n_cells=1024, device="cpu").decode_embd(
        embed(torch.tensor(toks, dtype=torch.int32), params["tok_embd"]), 0)
    if t == 32:
        np.testing.assert_array_equal(got, want)
        return
    exact = _rows(InferenceContext(*q4k_models["k_major"], n_cells=1024, device="cpu"), toks)
    pad, rounding = LC.spread(got, want), LC.spread(want, exact)
    print(f"T {t} seed {seed}: padded spread {pad:.4g}, i4g rounding {rounding:.4g}, "
          f"share {pad / rounding:.3g}")
    assert pad <= LC.PAD_SHARE * rounding
