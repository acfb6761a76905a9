"""The port's training path (models/train.py, tools/finetune.py) against
the JAX package's, on the CPU: the same tiny f32 llama and the same numpy
token batches go through both.

- forward_train's logits within atol 1e-5 (f32 on both sides), and within
  3e-3 of the port's own inference forward (tests/test_train.py's bar);
- lm_loss within 1e-6 relative; each parameter's gradient (torch autograd
  against jax.grad) within 1e-5 of that tensor's max|g|;
- `train` (AdamW, the update of optax.adamw) for 10 steps: each step's
  loss within 1e-4 relative;
- checkpoints cross the packages both ways: the port resumes from the JAX
  package's GGUF + .opt.npz, and the JAX package from the port's;
- `tools.finetune.main` runs end to end with --device cpu.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.models.train import forward_train as j_forward_train
from pipeinfer_tpu.models.train import lm_loss as j_lm_loss
from pipeinfer_tpu.tools import finetune as jft
from pipeinfer_tpu_torch.models import load_model as t_load
from pipeinfer_tpu_torch.models.train import forward_train, lm_loss
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.tools import finetune as tft
from pipeinfer_tpu_torch.tools import testmodel

CFG = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128, n_vocab=120)
LOSS_RTOL = 1e-4
QUIET = dict(log=lambda s: None)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_train") / "m.gguf"
    testmodel.build_tiny_llama(path, seed=2, **CFG)
    return path


def _both(path):
    jp, jc = j_load(path)
    tp, tc = t_load(path, device="cpu")
    return (jft.dense_params(jp), jc), (tft.dense_params(tp), tc)


def _stream(n=600, seed=0):
    return np.random.default_rng(seed).integers(2, CFG["n_vocab"], n).astype(np.int32)


def test_forward_train_matches_jax(model_path):
    (jp, jc), (tp, tc) = _both(model_path)
    toks = np.random.default_rng(1).integers(0, CFG["n_vocab"], (3, 17)).astype(np.int32)
    want = np.asarray(j_forward_train(jp, jc, jnp.asarray(toks)))
    got = forward_train(tp, tc, torch.from_numpy(toks)).detach().numpy()
    assert got.shape == (3, 17, CFG["n_vocab"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_forward_train_matches_the_port_inference_forward(model_path):
    _, (tp, tc) = _both(model_path)
    toks = [3, 17, 42, 7, 99]
    ctx = InferenceContext(tp, tc, n_cells=16, cache_dtype=torch.float32, device="cpu")
    b = Batch()
    for i, t in enumerate(toks):
        b.add(t, i, 0)
    want = np.asarray(ctx.decode(b))
    got = forward_train(tp, tc, torch.tensor([toks]))[0].detach().numpy()
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=3e-3)


def test_loss_and_gradients_match_jax(model_path):
    (jp, jc), (tp, tc) = _both(model_path)
    toks = np.random.default_rng(2).integers(0, CFG["n_vocab"], (2, 33)).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(lambda p: j_lm_loss(p, jc, jnp.asarray(toks)))(jp)
    loss, grads = tft.value_and_grad(lambda: lm_loss(tp, tc, torch.from_numpy(toks)),
                                     tft.tree_leaves(tp))
    assert abs(float(loss) / float(j_loss) - 1) < 1e-6
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(j_leaves) == len(grads) == 3 + 9 * CFG["n_layers"]
    for jg, g in zip(j_leaves, grads):
        jg = np.asarray(jg)
        assert g.shape == jg.shape
        assert np.abs(g.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


def test_tree_leaves_is_the_jax_flatten_order(model_path):
    (jp, _), (tp, _) = _both(model_path)
    j_leaves = jax.tree_util.tree_leaves(jp)
    t_leaves = tft.tree_leaves(tp)
    assert [x.shape for x in j_leaves] == [tuple(x.shape) for x in t_leaves]
    for a, b in zip(j_leaves, t_leaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_adamw_is_optax_adamw():
    """One AdamW update against optax.adamw's on the same tree: the
    weight decay (1e-4), the bias correction and eps are optax's."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((5, 7)).astype(np.float32),
          "b": [rng.standard_normal(11).astype(np.float32)]}
    grads = [{"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": [rng.standard_normal(11).astype(np.float32) * 1e-3]} for _ in range(4)]
    opt = optax.adamw(1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = opt.init(jp)
    leaves = [torch.from_numpy(np.array(x)) for x in tft.tree_leaves(p0)]
    ours = tft.AdamW(1e-2)
    st = ours.init(leaves)
    for g in grads:
        upd, js = opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        st = ours.update(leaves, [torch.from_numpy(x) for x in tft.tree_leaves(g)], st)
    assert st.count == int(js[0].count) == 4
    for want, got in zip(jax.tree_util.tree_leaves(jp), leaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for want, got in zip(jax.tree_util.tree_leaves(js[0].mu) + jax.tree_util.tree_leaves(js[0].nu),
                         st.mu + st.nu):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_train_matches_jax(model_path):
    """10 steps of both packages' `train` on one stream: every loss within
    LOSS_RTOL. The final weights: Adam's first steps move each weight by
    about lr * sign(g), so an element whose gradient is ~0 may step the
    other way in one package (f32 summation order); the bound is 2 * lr
    per step taken, and nearly every element must agree within 1e-6."""
    (jp, jc), (tp, tc) = _both(model_path)
    stream, lr, steps = _stream(), 1e-3, 10
    j_params, j_losses = jft.train(jp, jc, stream, seq_len=32, batch=2, steps=steps, lr=lr, **QUIET)
    t_params, t_losses = tft.train(tp, tc, stream, seq_len=32, batch=2, steps=steps, lr=lr, **QUIET)
    assert len(t_losses) == steps
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL, atol=0)
    assert t_losses[-1] < t_losses[0]
    close = total = 0
    for want, got in zip(jax.tree_util.tree_leaves(j_params), tft.tree_leaves(t_params)):
        d = np.abs(got.numpy() - np.asarray(want))
        assert d.max() <= 2 * lr * steps
        close += int((d <= 1e-6).sum())
        total += d.size
    assert close >= 0.99 * total
    # the input params are left as they were (the JAX package's train is pure)
    np.testing.assert_array_equal(tp["output"].numpy(), np.asarray(jp["output"]))


def test_port_resumes_a_jax_checkpoint(model_path, tmp_path):
    """JAX `train` checkpoints at step 5 (GGUF + .opt.npz); the port loads
    both files and resumes: its steps 5-9 within LOSS_RTOL of the JAX
    package's uninterrupted run."""
    (jp, jc), _ = _both(model_path)
    stream, kw = _stream(), dict(seq_len=32, batch=2, lr=1e-3, **QUIET)
    _, j_full = jft.train(jp, jc, stream, steps=10, **kw)
    ckpt = tmp_path / "ck.gguf"
    _, j_first = jft.train(jp, jc, stream, steps=5, ckpt_every=5, ckpt_path=str(ckpt), **kw)
    rp, rc = t_load(ckpt, device="cpu")
    _, t_rest = tft.train(tft.dense_params(rp), rc, stream, steps=10,
                          resume_opt=str(ckpt) + ".opt.npz", **kw)
    assert len(t_rest) == 5
    np.testing.assert_allclose(j_first + t_rest, j_full, rtol=LOSS_RTOL, atol=0)


def test_jax_resumes_a_port_checkpoint(model_path, tmp_path):
    """The port's .opt.npz loads in the JAX package's load_opt_state
    against an optax.adamw template with the file's leaves, and the JAX
    package resumes from the port's checkpoint within LOSS_RTOL of the
    port's uninterrupted run."""
    (jp, jc), (tp, tc) = _both(model_path)
    stream, kw = _stream(), dict(seq_len=32, batch=2, lr=1e-3, **QUIET)
    _, t_full = tft.train(tp, tc, stream, steps=8, **kw)
    ckpt = tmp_path / "ck.gguf"
    _, t_first = tft.train(tp, tc, stream, steps=4, ckpt_every=4, ckpt_path=str(ckpt), **kw)
    data = np.load(str(ckpt) + ".opt.npz")
    n = 3 + 9 * CFG["n_layers"]
    assert sorted(data.files) == sorted(["step"] + [f"leaf_{i}" for i in range(1 + 2 * n)])
    assert data["step"].dtype == np.int64 and int(data["step"]) == 3
    assert data["leaf_0"].dtype == np.int32 and int(data["leaf_0"]) == 4

    rp, rc = j_load(ckpt)
    rp = jft.dense_params(rp)
    state, step = jft.load_opt_state(str(ckpt) + ".opt.npz", optax.adamw(1e-3).init(rp))
    assert step == 3 and int(state[0].count) == 4
    for i, leaf in enumerate(jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(leaf), data[f"leaf_{i}"])
    # first moment of layer 0's wq: leaf 1 + its place in the sorted flatten
    wq_at = [k for k in sorted(rp["layers"][0])].index("wq")
    np.testing.assert_array_equal(np.asarray(state[0].mu["layers"][0]["wq"]),
                                  data[f"leaf_{1 + wq_at}"])
    _, j_rest = jft.train(rp, rc, stream, steps=8, resume_opt=str(ckpt) + ".opt.npz", **kw)
    np.testing.assert_allclose(t_first + j_rest, t_full, rtol=LOSS_RTOL, atol=0)


def test_port_resume_is_the_uninterrupted_run(model_path, tmp_path):
    _, (tp, tc) = _both(model_path)
    stream, kw = _stream(), dict(seq_len=32, batch=2, lr=1e-3, **QUIET)
    full_params, full = tft.train(tp, tc, stream, steps=6, **kw)
    ckpt = tmp_path / "ck.gguf"
    _, first = tft.train(tp, tc, stream, steps=3, ckpt_every=3, ckpt_path=str(ckpt), **kw)
    rp, rc = t_load(ckpt, device="cpu")
    rest_params, rest = tft.train(tft.dense_params(rp), rc, stream, steps=6,
                                  resume_opt=str(ckpt) + ".opt.npz", **kw)
    assert first + rest == full  # one device, one order: bit for bit on the CPU
    for a, b in zip(tft.tree_leaves(full_params), tft.tree_leaves(rest_params)):
        assert torch.equal(a, b)


def _vocab_model(path, n_vocab=384, seed=4):
    rng = np.random.default_rng(seed)
    shape = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=4, n_ff=128, n_vocab=n_vocab)
    testmodel.write_llama_gguf(path, testmodel.random_llama_weights(rng, **shape), **shape,
                               extra_kv=testmodel.synthetic_spm_vocab(n_vocab, seed))
    return path


def _corpus(path, n_vocab=384):
    words = [w for w in testmodel.synthetic_spm_vocab(n_vocab)["tokenizer.ggml.tokens"][259:]]
    text = " ".join(w.lstrip("▁") for w in words[:60]) + "\n"
    path.write_text(text * 4)
    return path


def _run(entry, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert entry(argv) == 0
    return out.getvalue(), err.getvalue()


def _final_loss(stdout: str) -> float:
    return float(stdout.split("final loss ")[1].split()[0])


def test_finetune_main_runs_and_resumes(tmp_path):
    """`tools.finetune.main --device cpu`: the JAX package's final loss
    (within the 4 printed digits' LOSS_RTOL), a GGUF that carries the
    source's tokenizer, and --resume from its checkpoint (which the JAX
    package's tokenizer-less output cannot do)."""
    from pipeinfer_tpu_torch.gguf.reader import GGUFReader
    from pipeinfer_tpu_torch.tokenizer import tokenizer_from_gguf

    model, corpus = _vocab_model(tmp_path / "m.gguf"), _corpus(tmp_path / "c.txt")
    argv = ["-m", str(model), "-f", str(corpus), "--seq-len", "32", "--batch", "2",
            "--steps", "4", "--lr", "1e-3", "--ckpt-every", "2"]
    j_out, _ = _run(jft.main, argv + ["-o", str(tmp_path / "j.gguf")])
    out, err = _run(tft.main, argv + ["-o", str(tmp_path / "t.gguf"), "--device", "cpu"])
    assert _final_loss(out) == pytest.approx(_final_loss(j_out), rel=LOSS_RTOL, abs=1e-4)
    assert "step 0: loss" in err and "checkpoint ->" in err
    with GGUFReader(tmp_path / "t.gguf") as r:
        assert tokenizer_from_gguf(r).vocab.n_vocab == 384
    assert (tmp_path / "t.gguf.opt.npz").exists()
    out2, err2 = _run(tft.main, ["--resume", str(tmp_path / "t.gguf"), "-f", str(corpus),
                                 "-o", str(tmp_path / "t2.gguf"), "--seq-len", "32", "--batch",
                                 "2", "--steps", "6", "--lr", "1e-3", "--device", "cpu"])
    assert "resumed optimizer state at step 4" in err2 and "step 5: loss" in err2
    assert np.isfinite(_final_loss(out2))


def test_finetune_main_init_random(tmp_path):
    model, corpus = _vocab_model(tmp_path / "v.gguf"), _corpus(tmp_path / "c.txt")
    out, _ = _run(tft.main, ["--init-random", "--vocab-from", str(model), "-f", str(corpus),
                             "-o", str(tmp_path / "s.gguf"), "--n-layers", "1", "--n-embd",
                             "32", "--n-heads", "4", "--n-ff", "64", "--seq-len", "16",
                             "--batch", "2", "--steps", "3", "--device", "cpu"])
    _, cfg = t_load(tmp_path / "s.gguf", device="cpu")
    assert (cfg.n_layers, cfg.n_embd, cfg.n_vocab) == (1, 32, 384)
    assert np.isfinite(_final_loss(out))


def test_training_faults_move_past_the_bars(model_path):
    """tools/live_check's training faults (chip_smoke.py's train phase runs
    each on the card) change the loss and the gradients past
    TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL on the tiny model too, and its
    other f32 order (perturbed_matmuls) stays under them."""
    from pipeinfer_tpu_torch.tools import live_check as LC

    _, (tp, tc) = _both(model_path)
    toks = torch.from_numpy(_stream(2 * 33).reshape(2, 33))

    def run():
        loss, grads = tft.value_and_grad(lambda: lm_loss(tp, tc, toks), tft.tree_leaves(tp))
        return float(loss), grads

    def spread(got, want):
        g = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got[1], want[1]))
        return abs(got[0] / want[0] - 1), g

    ref = run()
    with LC.perturbed_matmuls():
        loss_rel, grad_rel = spread(run(), ref)
    assert 0 < grad_rel < LC.TRAIN_GRAD_RTOL and loss_rel < LC.TRAIN_LOSS_RTOL
    for name in LC.TRAIN_FAULTS:
        with LC.train_fault(name):
            loss_rel, grad_rel = spread(run(), ref)
        assert loss_rel > LC.TRAIN_LOSS_RTOL and grad_rel > LC.TRAIN_GRAD_RTOL, name
    assert spread(run(), ref) == (0.0, 0.0)  # every fault undone
