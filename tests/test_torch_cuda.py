"""The port's CUDA side at small shapes: each kernel wrapper against its
plain version on the card, its launch counter, its input checks, the
non-blocking fetch, and the nano bench pair's controller stream on the card
against the same stream on the CPU.

Every test here needs a CUDA card and skips without one (decided in the
`cuda` fixture, not at import). On a machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py

(--noconftest: the suite's conftest imports jax, which this file does not
need.)"""

import numpy as np
import pytest
import torch

from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.ops import cell_attention as CA
from pipeinfer_tpu_torch.ops import qmatmul as Q
from pipeinfer_tpu_torch.quant import pack
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext, h2d, to_host_async
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("layout,qtype,k", [("i4g", GGMLQuantType.Q4_K, 768),
                                            ("i8g", GGMLQuantType.Q6_K, 1536)])
@pytest.mark.parametrize("m", [1, 5, 33])
def test_qmatmul_kernel_matches_plain(cuda, layout, qtype, k, m):
    g = np.random.default_rng(m)
    w = (g.standard_normal((200, k)) * 0.1).astype(np.float32)  # N = 200: a ragged tile
    qt = Q.to_device(pack.pack_array(w, qtype), layout=layout, device=cuda)
    x = torch.from_numpy(g.standard_normal((m, k)).astype(np.float32)).to(cuda)
    counter = Q.i4g_matmul if layout == "i4g" else Q.i8g_matmul
    before = counter.launches
    got = Q.qmatmul(x, qt)
    assert counter.launches == before + 1
    cpu_qt = Q.QuantTensor(*(None if p is None else p.cpu()
                             for p in (qt.qs, qt.qh, qt.scales, qt.bias)),
                           qtype=qt.qtype, shape=qt.shape, layout=qt.layout)
    want = Q.qmatmul(x.cpu(), cpu_qt)
    assert counter.launches == before + 1  # the CPU call ran the plain version
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("t,hot", [(1, 0), (4, 512), (9, 0)])
def test_cell_attention_kernel_matches_plain(cuda, t, hot):
    g = torch.Generator(device=cuda).manual_seed(t)
    n_l, kvh, h, d, c = 2, 2, 8, 64, 1024
    kc = torch.randn(n_l, kvh, c, d, device=cuda, generator=g).to(torch.bfloat16)
    vc = torch.randn(n_l, kvh, c, d, device=cuda, generator=g).to(torch.bfloat16)
    pos = torch.arange(c, dtype=torch.int32, device=cuda)
    pos[700:] = -1
    seq = torch.zeros(c, 4, dtype=torch.int32, device=cuda)
    seq[:, 0] = 1
    seq[::3, 3] = -(1 << 31)  # seq id 127 on every third cell: bit 31 of word 3
    q = torch.randn(t, h, d, device=cuda, generator=g)
    tok_pos = torch.randint(100, 500, (t,), device=cuda, generator=g).int()
    tok_seq = torch.tensor([0, 127] * t, dtype=torch.int32)[:t].to(cuda)
    valid = torch.ones(t, dtype=torch.bool, device=cuda)
    slopes = torch.linspace(0.01, 0.5, h, device=cuda)
    args = (q, kc, vc, pos, seq, tok_pos, tok_seq, valid)
    before = CA.cell_attention.launches
    got = CA.cell_attention(*args, layer=1, scale=d ** -0.5, alibi=slopes, hot=hot)
    assert CA.cell_attention.launches == before + 1
    want = CA.cell_attention(*(a.cpu() for a in args), layer=1, scale=d ** -0.5,
                             alibi=slopes.cpu(), hot=hot)
    assert CA.cell_attention.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    xq = torch.zeros(2, 512, dtype=torch.int8, device=cuda)
    sx = torch.ones(1, device=cuda)
    qs = torch.zeros(512, 64, dtype=torch.int8, device=cuda)
    sw = torch.ones(1, 64, device=cuda)
    Q.i8g_matmul(xq, sx, qs, sw)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        Q.i8g_matmul(xq.float(), sx, qs, sw)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        Q.i8g_matmul(xq, sx, qs.t().contiguous().t(), sw)
    with pytest.raises(ValueError, match="do not fit"):
        Q.i8g_matmul(xq, sx, qs, torch.ones(2, 64, device=cuda))
    with pytest.raises(ValueError, match="do not fit"):
        Q.i4g_matmul(xq, torch.zeros(2, 3, device=cuda), torch.ones(4, device=cuda),
                     torch.zeros(256, 64, dtype=torch.uint8, device=cuda),
                     torch.ones(4, 64, device=cuda), torch.ones(4, 64, device=cuda))
    q = torch.zeros(1, 4, 64, device=cuda)
    k = torch.zeros(1, 4, 512, 64, dtype=torch.bfloat16, device=cuda)
    meta = (torch.zeros(512, dtype=torch.int32, device=cuda),
            torch.zeros(512, 2, dtype=torch.int32, device=cuda),
            torch.zeros(1, dtype=torch.int32, device=cuda),
            torch.zeros(1, dtype=torch.int32, device=cuda),
            torch.ones(1, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="do not fit"):
        CA.cell_attention(q, k, k, *meta, layer=1, scale=0.1)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        CA.cell_attention(q, k.float(), k, *meta, scale=0.1)


def test_async_fetch_does_not_block(cuda):
    t = torch.arange(1000, dtype=torch.float32, device=cuda)
    torch.cuda._sleep(50_000_000)  # keep the stream busy
    host, ev = to_host_async(t * 2)
    assert host.is_pinned() and not ev.query()  # queued behind the sleep
    ev.synchronize()
    assert host[999].item() == 1998.0
    assert h2d(np.arange(5, dtype=np.int32), cuda).tolist() == [0, 1, 2, 3, 4]


def test_nano_controller_on_card_matches_cpu(cuda, tmp_path):
    testmodel.build_bench_pair(tmp_path / "t.gguf", tmp_path / "d.gguf", scale="nano", eps=0.5)
    prompt, n = list(range(5, 25)), 48
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    sp = SpecParams(n_draft=8, n_parallel=1, p_accept=0.0, max_inflight=4, min_inflight=2)
    streams = {}
    for dev in ("cpu", "cuda"):
        tgt = load_model(tmp_path / "t.gguf", device=dev)
        dft = load_model(tmp_path / "d.gguf", device=dev)
        ctx = InferenceContext(*tgt, n_cells=1024, device=dev)
        b = Batch()
        for i, tok in enumerate(prompt):
            b.add(tok, i, 0, want_logits=(i == len(prompt) - 1))
        first = int(np.argmax(ctx.decode(b)[-1]))
        plain = [first] + ctx.draft_chain(first, len(prompt), 0, n - 1, n_cand=0)[0]
        c = PipeInferController(InferenceContext(*tgt, n_cells=1024, device=dev),
                                InferenceContext(*dft, n_cells=1024, device=dev),
                                greedy, sp, eos_id=-1)
        assert c.use_corrected
        launches = CA.cell_attention.launches
        got = c.generate(list(prompt), n, ignore_eos=True)
        assert got == plain
        if dev == "cuda":
            assert CA.cell_attention.launches > launches  # draft steps took the kernel
        streams[dev] = got
    assert streams["cuda"] == streams["cpu"]
