"""The port's CUDA side at small shapes: each kernel wrapper against its
plain version on the card, its launch counter (which a refused launch
leaves alone), its input checks, the non-blocking fetch, and the nano
bench pair's controller stream on the card against the same stream on the
CPU.

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
from pipeinfer_tpu_torch.ops import cuda_build
from pipeinfer_tpu_torch.ops import qmatmul as Q
from pipeinfer_tpu_torch.quant import pack
from pipeinfer_tpu_torch.quant.pack import FORMAT_INFO
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


@pytest.mark.parametrize("m,n,qname", [(1, 4000, "Q6_K"), (8, 4000, "Q8_0"), (9, 1000, "Q6_K")])
def test_i8g_split_k_matches_plain_and_repeats_bitwise(cuda, m, n, qname):
    """The i8g kernel's split-K on the card: a cut with several splits and
    a short last one (K picked for this card's SM count), a ragged last
    column tile (N % 128 != 0), M = 8 (the verify bucket) and two row tiles
    at M = 9. Two calls on the same inputs are bitwise equal: the last block
    of each tile sums the splits' partials in split order."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    k = next(k for k in range(1024, 16385, 512)
             if (c := Q.i8g_plan(m, n, k, sms)).splits > 1 and (k // Q.I8G_CHUNK) % c.chunks)
    g = np.random.default_rng(m)
    w = (g.standard_normal((n, k)) * 0.1).astype(np.float32)
    qt = Q.to_device(pack.pack_array(w, GGMLQuantType[qname]), layout="i8g", device=cuda)
    x = torch.from_numpy(g.standard_normal((m, k)).astype(np.float32)).to(cuda)
    xq, sx = Q.quantize_activations(x, k, Q.I8G_SLAB)
    before = Q.i8g_matmul.launches
    got = Q.i8g_matmul(xq, sx, qt.qs, qt.scales)
    again = Q.i8g_matmul(xq, sx, qt.qs, qt.scales)
    assert Q.i8g_matmul.launches == before + 2
    assert torch.equal(got, again)
    want = Q._i8g_plain(xq.cpu(), sx.cpu(), qt.qs.cpu(), qt.scales.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_i8g_wrapper_rejects_misaligned_planes(cuda):
    xq = torch.zeros(2, 1024, dtype=torch.int8, device=cuda)
    sx = torch.ones(1, device=cuda)
    qs = torch.zeros(512 * 64 + 4, dtype=torch.int8, device=cuda)
    sw = torch.ones(65, device=cuda)
    Q.i8g_matmul(xq[:, :512].contiguous(), sx, qs[:512 * 64].view(512, 64), sw[:64].view(1, 64))
    with pytest.raises(ValueError, match="aligned"):
        Q.i8g_matmul(xq.view(-1)[4:516].view(1, 512), sx, qs[:512 * 64].view(512, 64),
                     sw[:64].view(1, 64))
    with pytest.raises(ValueError, match="aligned"):
        Q.i8g_matmul(xq[:1, :512].contiguous(), sx, qs[:512 * 64].view(512, 64),
                     sw[1:].view(1, 64))
    with pytest.raises(ValueError, match="aligned"):
        Q.i8g_matmul(xq[:1, :512].contiguous(), sx, qs[2:2 + 512 * 64].view(512, 64),
                     sw[:64].view(1, 64))


@pytest.mark.parametrize("m,n,qname", [(1, 4000, "Q4_K"), (8, 4000, "Q8_0"), (9, 1000, "Q6_K")])
def test_i8_split_k_matches_plain_and_repeats_bitwise(cuda, m, n, qname):
    """The i8 kernel's split-K on the card: a cut with several splits and
    a short last one, and a ragged last chunk (K % 128 != 0, so warps past
    K skip it), K picked for this card's SM count; a ragged last column
    tile (N % 128 != 0), M = 8 (the verify bucket) and two row tiles at
    M = 9. Two calls on the same inputs are bitwise equal: the last block
    of each tile sums the splits' partials in split order."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    k = next(k for k in range(1056, 16385, 32) if k % 128
             and (c := Q.i8_plan(m, n, k, sms)).splits > 1 and -(-k // Q.I8G_CHUNK) % c.chunks)
    g = np.random.default_rng(m)
    group = 16 if qname == "Q6_K" else 32
    lo, hi = {"Q4_K": (0, 16), "Q6_K": (0, 64), "Q8_0": (-127, 128)}[qname]
    qs = torch.from_numpy(g.integers(lo, hi, (k, n)).astype(np.int8)).to(cuda)
    scales = torch.from_numpy((g.random((k // group, n)) * 0.01 + 1e-3).astype(np.float32)).to(cuda)
    x = torch.from_numpy(g.standard_normal((m, k)).astype(np.float32)).to(cuda)
    bias = xg = None
    if qname != "Q8_0":
        bias = torch.from_numpy((g.random((k // group, n)) * 0.08).astype(np.float32)).to(cuda)
        xg = Q._group_sums(x, group)
    xb = x.to(torch.bfloat16)
    before = Q.i8_matmul.launches
    got = Q.i8_matmul(xb, xg, qs, scales, bias, group=group)
    again = Q.i8_matmul(xb, xg, qs, scales, bias, group=group)
    assert Q.i8_matmul.launches == before + 2
    assert torch.equal(got, again)
    want = Q._i8_plain(*(None if t is None else t.cpu() for t in (xb, xg, qs, scales, bias)),
                       group)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("m,n,qname", [(1, 4000, "Q4_K"), (8, 4000, "Q8_0"), (9, 1000, "Q3_K"),
                                         (1, 4000, "Q2_K"), (8, 4000, "Q6_K"), (33, 1000, "Q5_K")])
def test_kmajor_split_k_matches_plain_and_repeats_bitwise(cuda, m, n, qname):
    """The k_major kernel's split-K on the card: a cut with several splits
    and a short last one, K picked for this card's SM count; at 2/3 bits an
    odd number of pack groups, so the last chunk is half full and warps 4-7
    skip it; Q8_0 with no bias; the qh planes of 5 and 6 bits; a ragged
    last column tile (N % 128 != 0), M = 8 (the verify bucket) and several
    row tiles at M = 9 and 33. Two calls on the same inputs are bitwise
    equal: the last block of each tile sums the splits' partials in split
    order."""
    bits, group = FORMAT_INFO[GGMLQuantType[qname]]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count

    def chunks(k):
        return -(-(k // Q._QS_ROWS[bits]) // Q.KMAJOR_CHUNK)

    k = next(k for k in range(1280, 16385, 256)
             if (bits not in (2, 3) or (k // 256) % 2)
             and (c := Q.kmajor_plan(m, n, k, bits, sms)).splits > 1 and chunks(k) % c.chunks)
    g = np.random.default_rng(m)

    def u8(rows):
        return torch.from_numpy(g.integers(0, 256, (rows, n)).astype(np.uint8)).to(cuda)

    qs = torch.from_numpy(g.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda) if bits == 8 \
        else u8(k // Q._QS_ROWS[bits])
    qh = u8(k // Q._QH_DIV[bits]) if bits in Q._QH_DIV else None
    scales = torch.from_numpy((g.random((k // group, n)) * 0.01 + 1e-3).astype(np.float32)).to(cuda)
    bias = None if bits == 8 else \
        torch.from_numpy((g.random((k // group, n)) * 0.08).astype(np.float32)).to(cuda)
    xb = torch.from_numpy(g.standard_normal((m, k)).astype(np.float32)).to(cuda).to(torch.bfloat16)
    before = Q.kmajor_matmul.launches
    got = Q.kmajor_matmul(xb, qs, qh, scales, bias, bits=bits, group=group)
    again = Q.kmajor_matmul(xb, qs, qh, scales, bias, bits=bits, group=group)
    assert Q.kmajor_matmul.launches == before + 2
    assert torch.equal(got, again)
    want = Q._kmajor_plain(*(None if t is None else t.cpu() for t in (xb, qs, qh, scales, bias)),
                           bits, group)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("m,n,qname", [(1, 4000, "Q4_K"), (8, 4000, "Q4_0"), (9, 1000, "Q4_1"),
                                         (8, 200, "Q4_K"), (33, 200, "Q4_0")])
def test_k4_split_k_matches_plain_and_repeats_bitwise(cuda, m, n, qname):
    """The k4 kernel's split-K on the card: several splits, and at N = 4000
    and 1000 a short last one (K picked for this card's SM count); a ragged
    last column tile (N % 128 != 0; N = 200: two tiles, the second of 72
    columns), a byte plane padded past K/2 rows with scale rows past K/64
    (never read: they hold NaN here), M = 8 (the verify bucket) and
    several row tiles at M = 9 and 33. Two calls on the same inputs are
    bitwise equal: the last block of each tile sums the splits' partials
    in split order."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    k = next(k for k in range(1280, 16385, 256)
             if (c := Q.k4_plan(m, n, k, sms)).splits > 1 and (n < 1000 or (k // 256) % c.chunks))
    g = np.random.default_rng(m)
    r2 = -(-k // 2 // 256) * 256 + 256  # one more pack group of padding than to_device makes
    qs = torch.from_numpy(g.integers(0, 256, (r2, n)).astype(np.uint8)).to(cuda)
    planes = [torch.from_numpy((g.random((r2 // 32, n)) * scale).astype(np.float32)).to(cuda)
              for scale in (0.01, 0.01, 0.08, 0.08)]  # s_lo, s_hi, b_lo, b_hi
    for p in planes:
        p[k // 64:] = float("nan")
    x = torch.from_numpy(g.standard_normal((m, k)).astype(np.float32)).to(cuda)
    args = (x.to(torch.bfloat16), Q._group_sums(x, Q.K4_GROUP), qs, *planes)
    before = Q.k4_matmul.launches
    got = Q.k4_matmul(*args)
    again = Q.k4_matmul(*args)
    assert Q.k4_matmul.launches == before + 2
    assert Q.k4_matmul.last_plan == Q.k4_plan(m, n, k, sms) and Q.k4_matmul.last_plan.splits > 1
    assert torch.equal(got, again)
    want = Q._k4_plain(*(t.cpu() for t in args))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("m", [1, 8])
def test_k4_fused_projection_matches_plain(cuda, m):
    """A fused k4 weight (concat_qt of three projections, as wq+wk+wv):
    N = 200 + 128 + 72 = 400, its scale and bias planes concatenated along
    N, through qmatmul on the card against the same fused weight on the
    CPU and against its parts."""
    g = np.random.default_rng(m)
    parts = [Q.to_device(pack.pack_array((g.standard_normal((n, 1280)) * 0.1).astype(np.float32),
                                         GGMLQuantType.Q4_K), layout="k4", device=cuda)
             for n in (200, 128, 72)]
    fused = Q.concat_qt(parts)
    assert fused.layout == "k4" and fused.shape == (400, 1280)
    x = torch.from_numpy(g.standard_normal((m, 1280)).astype(np.float32)).to(cuda)
    before = Q.k4_matmul.launches
    got = Q.qmatmul(x, fused)
    assert Q.k4_matmul.launches == before + 1
    cpu = Q.QuantTensor(fused.qs.cpu(), None, fused.scales.cpu(), fused.bias.cpu(), fused.qtype,
                        fused.shape, "k4", fused.scales2.cpu(), fused.bias2.cpu())
    want = Q.qmatmul(x.cpu(), cpu)
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=tol)
    each = torch.cat([Q.qmatmul(x, p) for p in parts], dim=1)
    torch.testing.assert_close(got, each, rtol=0, atol=tol)


EXACT_CASES = [("k_major", q) for q in ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K",
                                         "Q4_K", "Q5_K", "Q6_K")] \
    + [("i8", q) for q in ("Q4_K", "Q6_K", "Q8_0")] + [("k4", q) for q in ("Q4_0", "Q4_K")]
EXACT_COUNTERS = {"k_major": Q.kmajor_matmul, "i8": Q.i8_matmul, "k4": Q.k4_matmul}


@pytest.mark.parametrize("layout,qname", EXACT_CASES)
@pytest.mark.parametrize("m", [1, 5, 33])
def test_exact_layout_kernels_match_plain(cuda, layout, qname, m):
    """The k_major, i8 and k4 kernels against their plain versions at a
    ragged N (200: not a multiple of a 32- or 128-column tile) and K =
    1280 (five pack groups). Each weight is the same bf16 value on both
    sides, so only the f32 summation order differs: atol 1e-5 of
    max|out|."""
    g = np.random.default_rng(m)
    w = (g.standard_normal((200, 1280)) * 0.1).astype(np.float32)
    qt = Q.to_device(pack.pack_array(w, GGMLQuantType[qname]), layout=layout, device=cuda)
    assert qt.layout == layout
    x = torch.from_numpy(g.standard_normal((m, 1280)).astype(np.float32)).to(cuda)
    counter = EXACT_COUNTERS[layout]
    before = counter.launches
    got = Q.qmatmul(x, qt)
    assert counter.launches == before + 1
    cpu_qt = Q.QuantTensor(*(None if p is None else p.cpu()
                             for p in (qt.qs, qt.qh, qt.scales, qt.bias)),
                           qtype=qt.qtype, shape=qt.shape, layout=qt.layout,
                           scales2=None if qt.scales2 is None else qt.scales2.cpu(),
                           bias2=None if qt.bias2 is None else qt.bias2.cpu())
    want = Q.qmatmul(x.cpu(), cpu_qt)
    assert counter.launches == before + 1  # the CPU call ran the plain version
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_refused_launch_leaves_the_count_alone(cuda, monkeypatch):
    """A launch whose C entry reports an error raises, and its wrapper's
    count stays where it was: counts only record kernels that ran."""
    qt = Q.to_device(pack.pack_array(np.ones((64, 256), np.float32), GGMLQuantType.Q4_K),
                     layout="k_major", device=cuda)
    x = torch.ones(1, 256, device=cuda)
    Q.qmatmul(x, qt)  # loads the library and its entry point
    before = Q.kmajor_matmul.launches
    monkeypatch.setitem(cuda_build._fns, "qmatmul_kmajor:pi_kmajor_matmul",
                        lambda *a: 9)  # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="cudaError 9"):
        Q.qmatmul(x, qt)
    assert Q.kmajor_matmul.launches == before


def test_exact_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 512, dtype=torch.bfloat16, device=cuda)
    qs = torch.zeros(256, 64, dtype=torch.uint8, device=cuda)
    s = torch.ones(16, 64, device=cuda)
    Q.kmajor_matmul(x, qs, None, s, s, bits=4, group=32)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        Q.kmajor_matmul(x.float(), qs, None, s, s, bits=4, group=32)
    with pytest.raises(ValueError, match="do not fit"):
        Q.kmajor_matmul(x, qs, None, s, None, bits=4, group=32)  # a 4-bit format has a bias
    with pytest.raises(ValueError, match="do not fit"):
        Q.kmajor_matmul(x, qs, None, s, s, bits=5, group=32)  # 5 bits need qh
    with pytest.raises(ValueError, match="aligned"):
        Q.kmajor_matmul(x.reshape(-1)[2:514].reshape(1, 512), qs, None, s, s, bits=4, group=32)
    q8k = torch.zeros(512, 64, dtype=torch.int8, device=cuda)
    Q.kmajor_matmul(x, q8k, None, s, None, bits=8, group=32)
    with pytest.raises(ValueError, match="do not fit"):
        Q.kmajor_matmul(x, q8k, None, s, s, bits=8, group=32)  # Q8_0 has no bias
    # the k_major kernel reads scales and bias 16 bytes at a time
    s4k = torch.ones(16 * 64 + 1, device=cuda)[1:].view(16, 64)  # 4-byte aligned, not 16
    with pytest.raises(ValueError, match="scales must be 16-byte"):
        Q.kmajor_matmul(x, qs, None, s4k, s, bits=4, group=32)
    with pytest.raises(ValueError, match="bias must be 16-byte"):
        Q.kmajor_matmul(x, qs, None, s, s4k, bits=4, group=32)
    q8 = torch.zeros(512, 64, dtype=torch.int8, device=cuda)
    xg = torch.zeros(2, 16, device=cuda)
    Q.i8_matmul(x, xg, q8, s, s, group=32)
    with pytest.raises(ValueError, match="do not fit"):
        Q.i8_matmul(x, None, q8, s, s, group=32)
    with pytest.raises(ValueError, match="do not fit"):
        Q.i8_matmul(x, xg, q8, s, s, group=16)
    # the i8 kernel reads x 8 bytes, scales and bias 16 bytes and qs 4 bytes at a time
    Q.i8_matmul(x.reshape(-1)[4:516].reshape(1, 512), xg[:1], q8, s, s, group=32)
    with pytest.raises(ValueError, match="x must be 8-byte"):
        Q.i8_matmul(x.reshape(-1)[2:514].reshape(1, 512), xg[:1], q8, s, s, group=32)
    s4 = torch.ones(16 * 64 + 1, device=cuda)[1:].view(16, 64)  # 4-byte aligned, not 16
    with pytest.raises(ValueError, match="scales must be 16-byte"):
        Q.i8_matmul(x, xg, q8, s4, s, group=32)
    with pytest.raises(ValueError, match="bias must be 16-byte"):
        Q.i8_matmul(x, xg, q8, s, s4, group=32)
    q8o = torch.zeros(512 * 64 + 2, dtype=torch.int8, device=cuda)[2:].view(512, 64)
    with pytest.raises(ValueError, match="qs must be 4-byte"):
        Q.i8_matmul(x, xg, q8o, s, s, group=32)
    s4 = torch.ones(8, 64, device=cuda)
    Q.k4_matmul(x, xg, qs, s4, s4, s4, s4)
    with pytest.raises(ValueError, match="do not fit"):
        Q.k4_matmul(x, xg, qs[:128], s4[:4], s4[:4], s4[:4], s4[:4])
    with pytest.raises(ValueError, match="contiguous CUDA"):
        Q.k4_matmul(x, xg, qs.to(torch.int8), s4, s4, s4, s4)


ATTN_CASES = {  # name -> (t, hot, h, kvh, d, c, one split all masked)
    "t1": (1, 0, 8, 2, 64, 1024, False),
    "t4_hot512": (4, 512, 8, 2, 64, 1024, False),
    "t9": (9, 0, 8, 2, 64, 1024, False),
    "t1_7b_heads": (1, 0, 32, 32, 128, 4096, False),  # the main path's heads and pool
    "t4_toy_gqa": (4, 0, 16, 8, 64, 1024, False),  # the toy pair's heads
    "t4_masked_split": (4, 0, 8, 2, 64, 1024, True),
    "t33": (33, 0, 32, 32, 128, 1024, False),
    "t2_two_rows": (2, 0, 32, 32, 128, 1024, False),  # 2 rows per block
    "t3_d32": (3, 0, 4, 2, 32, 512, False),  # 4 lanes per cell, 2 rows per block
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_cell_attention_kernel_matches_plain(cuda, case):
    t, hot, h, kvh, d, c, masked_split = ATTN_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(t)
    n_l = 2
    kc = torch.randn(n_l, kvh, c, d, device=cuda, generator=g).to(torch.bfloat16)
    vc = torch.randn(n_l, kvh, c, d, device=cuda, generator=g).to(torch.bfloat16)
    pos = torch.arange(c, dtype=torch.int32, device=cuda)
    pos[700:] = -1
    seq = torch.zeros(c, 4, dtype=torch.int32, device=cuda)
    seq[:, 0] = 1
    seq[::3, 3] = -(1 << 31)  # seq id 127 on every third cell: bit 31 of word 3
    cut = CA.plan(t, h, kvh, d, hot or c)
    if masked_split:
        assert cut.n_splits > 2
        seq[cut.split:2 * cut.split] = 0
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


@pytest.mark.parametrize("t", [4, 9])
def test_cell_attention_padding_rows_give_zero(cuda, t):
    """A padding row (valid 0) weighs every cell 0 and comes out 0, in the
    kernel as in its plain version, whatever the cells hold; the valid rows
    match the plain version."""
    g = torch.Generator(device=cuda).manual_seed(t)
    h, kvh, d, c = 8, 2, 64, 1024
    kc = torch.randn(2, kvh, c, d, device=cuda, generator=g).to(torch.bfloat16)
    vc = torch.randn(2, kvh, c, d, device=cuda, generator=g).to(torch.bfloat16)
    pos = torch.arange(c, dtype=torch.int32, device=cuda)
    seq = torch.zeros(c, 4, dtype=torch.int32, device=cuda)
    seq[:, 0] = 1
    q = torch.randn(t, h, d, device=cuda, generator=g)
    tok_pos = torch.full((t,), 900, dtype=torch.int32, device=cuda)
    tok_seq = torch.zeros(t, dtype=torch.int32, device=cuda)
    valid = torch.arange(t, device=cuda) < t // 2
    args = (q, kc, vc, pos, seq, tok_pos, tok_seq, valid)
    got = CA.cell_attention(*args, layer=1, scale=d ** -0.5).cpu()
    want = CA.cell_attention(*(a.cpu() for a in args), layer=1, scale=d ** -0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert not got[~valid.cpu()].any() and got[valid.cpu()].abs().amax() > 0


@pytest.mark.parametrize("t", [1, 4])
def test_cell_attention_alibi_at_mpt_heads(cuda, t):
    """ALiBi fused in the kernel at MPT-7B's heads (H = KVH = 32, D = 128,
    kv_cache.alibi_slopes(32, 8.0)) over a 1024-cell pool with holes (freed
    cells, pos -1, between live ones), against the plain version on the CPU."""
    from pipeinfer_tpu_torch.runtime import kv_cache as KV

    h, d, c = 32, 128, 1024
    g = torch.Generator(device=cuda).manual_seed(40 + t)
    kc = torch.randn(2, h, c, d, device=cuda, generator=g).to(torch.bfloat16)
    vc = torch.randn(2, h, c, d, device=cuda, generator=g).to(torch.bfloat16)
    pos = torch.arange(c, dtype=torch.int32, device=cuda)
    pos[300:340] = -1  # freed by a seq_rm
    pos[600:] = -1
    seq = torch.zeros(c, KV.SEQ_WORDS, dtype=torch.int32, device=cuda)
    seq[pos >= 0, 0] = 1
    q = torch.randn(t, h, d, device=cuda, generator=g)
    tok_pos = torch.arange(600, 600 + t, dtype=torch.int32, device=cuda)
    tok_seq = torch.zeros(t, dtype=torch.int32, device=cuda)
    valid = torch.ones(t, dtype=torch.bool, device=cuda)
    slopes = KV.alibi_slopes(h, 8.0, device=cuda)
    args = (q, kc, vc, pos, seq, tok_pos, tok_seq, valid)
    before = CA.cell_attention.launches
    got = CA.cell_attention(*args, layer=1, scale=d ** -0.5, alibi=slopes)
    assert CA.cell_attention.launches == before + 1
    want = CA.cell_attention(*(a.cpu() for a in args), layer=1, scale=d ** -0.5,
                             alibi=slopes.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("t", [1, 4])
def test_cell_attention_f32_cache_matches_plain(cuda, t):
    """The kernel over an f32 cache (--cache-dtype f32), reached through
    attend at MPT-7B's heads with ALiBi over a 1024-cell pool whose
    positions are shuffled against the cell index, against the plain
    version on the CPU."""
    from pipeinfer_tpu_torch.runtime import kv_cache as KV

    h, d, c = 32, 128, 1024
    g = torch.Generator(device=cuda).manual_seed(50 + t)
    kc = torch.randn(2, h, c, d, device=cuda, generator=g)
    vc = torch.randn(2, h, c, d, device=cuda, generator=g)
    pos = torch.randperm(c, device=cuda, generator=g).to(torch.int32)
    pos[300:340] = -1
    seq = torch.zeros(c, KV.SEQ_WORDS, dtype=torch.int32, device=cuda)
    seq[pos >= 0, 0] = 1
    q = torch.randn(t, h, d, device=cuda, generator=g)
    tok_pos = torch.arange(c, c + t, dtype=torch.int32, device=cuda)
    tok_seq = torch.zeros(t, dtype=torch.int32, device=cuda)
    valid = torch.ones(t, dtype=torch.bool, device=cuda)
    slopes = KV.alibi_slopes(h, 8.0, device=cuda)
    cache = KV.KVCache(kc, vc, pos, seq)
    before = CA.cell_attention.launches
    got = KV.attend(q, cache, 1, KV.attn_mask(cache, tok_pos, tok_seq), tok_pos, tok_seq, valid,
                    scale=d ** -0.5, alibi=slopes)
    assert CA.cell_attention.launches == before + 1
    args = (q, kc, vc, pos, seq, tok_pos, tok_seq, valid)
    want = CA.cell_attention(*(a.cpu() for a in args), layer=1, scale=d ** -0.5,
                             alibi=slopes.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("m", [1, 8, 128])
@pytest.mark.parametrize("n,k", [(12288, 4096), (4096, 4096), (16384, 4096), (4096, 16384)])
def test_i4g_at_mpt_widths(cuda, n, k, m):
    """i4g over each of MPT-7B's 4-bit tensors (wqkv, wo, w_up, w_down) at
    a decode or draft step (M = 1), the verify bucket (M = 8) and the
    bucket of lookahead's 121-row verify batch (M = 128; W 15, N 5, G 15):
    on the same s8 activations, the plain version's result within 1e-5 of
    max|out| and two calls bitwise equal. (The activations are quantized
    once: quantized apart on the two devices, one of 2M elements can round
    the other way.)"""
    g = torch.Generator(device=cuda).manual_seed(n + k + m)
    qs = torch.randint(0, 256, (k // 2, n), dtype=torch.uint8, device=cuda, generator=g)
    step = torch.rand(k // 128, n, device=cuda, generator=g) * 0.01 + 1e-3
    wmin = -torch.rand(k // 128, n, device=cuda, generator=g) * 0.08
    xq, sx = Q.quantize_activations(torch.randn(m, k, device=cuda, generator=g), k, Q.I4G_HALF)
    xsum = xq.reshape(m, k // Q.I4G_HALF, Q.I4G_HALF).sum(dim=2, dtype=torch.int32).float()
    args = (xq, xsum, sx, qs, step, wmin)
    before = Q.i4g_matmul.launches
    got, again = Q.i4g_matmul(*args), Q.i4g_matmul(*args)
    assert Q.i4g_matmul.launches == before + 2 and torch.equal(got, again)
    want = Q.i4g_matmul(*(a.cpu() for a in args))  # the plain version
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("arch", ["mpt", "falcon", "starcoder", "bloom", "persimmon"])
def test_generic_model_on_card_matches_cpu(cuda, tmp_path, arch):
    """A small f32 model of a non-llama architecture through a 512-cell
    context on the card (its T = 1 steps take the cell kernel, ALiBi, MQA
    and partial rope included) against the same weights on the CPU: logits
    within 5e-3 of max|logit| (chip_smoke.TOY_RTOL: the bf16 cache rounds
    the two devices' f32 orders apart; a CPU emulation of that moved them
    by at most 3.5e-4)."""
    path = testmodel.build_tiny_arch(tmp_path / f"{arch}.gguf", arch, seed=5, n_embd=256,
                                     n_heads=4, n_kv_heads=4 if arch in ("mpt", "persimmon") else 1,
                                     n_ff=512, n_vocab=512)
    params, cfg = load_model(path, device=cuda)
    outs = []
    before = CA.cell_attention.launches
    for dev in (cuda, torch.device("cpu")):
        ctx = InferenceContext(params, cfg, n_cells=512, device=dev)
        b = Batch()
        for i, tk in enumerate([1, 17, 200, 33, 5, 9, 71, 8, 99]):
            b.add(tk, i, 0)
        rows = [ctx.decode(b)]
        for j in range(4):
            b = Batch()
            b.add(40 + j, 9 + j, 0)
            rows.append(ctx.decode(b))
        outs.append(np.concatenate(rows))
    assert CA.cell_attention.launches == before + 4 * cfg.n_layers  # the card's T = 1 steps
    scale = np.abs(outs[1]).max()
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=5e-3 * scale)


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


def test_nano_controller_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    # one layout on both devices (the default is i4g on CUDA, k_major on the CPU)
    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", "i4g")
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


def test_nano_device_loops_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    """DeviceLoopEngine and the 4-lane DeviceLoopServer on slots 60-63 give
    on the card the streams they give on the CPU, which are plain greedy;
    the lanes' 4-row draft steps take the cell kernel."""
    from pipeinfer_tpu_torch.spec.device_loop import DeviceLoopEngine
    from pipeinfer_tpu_torch.spec.device_multi import DeviceLoopServer

    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", "i4g")
    testmodel.build_bench_pair(tmp_path / "t.gguf", tmp_path / "d.gguf", scale="nano", eps=0.5)
    prompts, n = [list(range(5, 25)), [1, 9, 33], [7] * 5, list(range(40, 47))], 40
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    streams = {}
    for dev in ("cpu", "cuda"):
        tgt = load_model(tmp_path / "t.gguf", device=dev)
        dft = load_model(tmp_path / "d.gguf", device=dev)

        def ctx(m):
            return InferenceContext(*m, n_cells=1024, device=dev)

        eng = DeviceLoopEngine(ctx(tgt), ctx(dft), greedy, SpecParams(n_draft=6), eos_id=-1,
                               rounds=4)
        one = eng.generate(list(prompts[0]), n, ignore_eos=True)
        srv = DeviceLoopServer(ctx(tgt), ctx(dft), greedy, SpecParams(n_draft=8), n_lanes=4,
                               seq_base=60, rounds=4, eos_id=-1)
        launches = CA.cell_attention.launches
        hs = [srv.submit(p, n) for p in prompts]
        srv.run_until_idle()
        assert all(h.done and h.error is None for h in hs)
        if dev == "cuda":
            assert CA.cell_attention.launches > launches
        streams[dev] = (one, [h.tokens for h in hs])
    assert streams["cuda"] == streams["cpu"]
    assert streams["cpu"][0] == streams["cpu"][1][0]


def test_clip_encode_and_decode_embd_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    """The nano CLIP tower and projector on the card against the CPU within
    live_check.CLIP_RTOL; decode_embd of its embeddings into a Q4_K llama
    (i4g on both devices) at T = 16 (bucket 32), then 4 single-token steps
    over 1024 cells (the cell kernel): the card's logits against the CPU's
    within live_check.LIVE_RTOL; on the card, decode_embd of 8 tok_embd rows
    gives the token path's logits bit for bit, and of 40 (bucket 128, whose
    padding rows the two paths fill apart) within live_check.PAD_SHARE of
    i4g's rounding (the token path against k_major's)."""
    from pipeinfer_tpu_torch.models import clip
    from pipeinfer_tpu_torch.tools import live_check as LC

    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", "i4g")
    mm = testmodel.build_mmproj(tmp_path / "mm.gguf", "nano", seed=1, n_embd=256)
    lm = testmodel.build_tiny_llama(tmp_path / "lm.gguf", seed=2, n_layers=2, n_embd=256,
                                    n_heads=4, n_kv_heads=2, n_ff=512, n_vocab=300,
                                    qtype=GGMLQuantType.Q4_K)
    img = np.random.default_rng(3).integers(0, 256, (40, 28, 3), np.uint8)
    out = {}
    for dev in ("cuda", "cpu"):
        cparams, ccfg = clip.load_mmproj(mm, device=dev)
        embd = clip.encode_image(cparams, ccfg, clip.preprocess_image(img, ccfg))
        assert embd.device.type == dev and embd.shape == (16, 256)
        if dev == "cuda":
            params, cfg = load_model(lm, device=dev)
        else:  # the card's planes, so only the compute differs
            params = out["cuda"][2]
        ctx = InferenceContext(params, cfg, n_cells=1024, cache_dtype=torch.float32, device=dev)
        b = Batch()
        for i, t in enumerate([1, 7, 12]):
            b.add(t, i, 0)
        ctx.decode(b)
        launches = (Q.i4g_matmul.launches, CA.cell_attention.launches)
        rows = [ctx.decode_embd(embd, 3)]
        for j in range(4):
            b = Batch()
            b.add(int(np.argmax(rows[-1])), 19 + j, 0)
            rows.append(ctx.decode(b)[0])
        if dev == "cuda":
            assert Q.i4g_matmul.launches > launches[0] and CA.cell_attention.launches > launches[1]
            from pipeinfer_tpu_torch.runtime.context import _params_to

            out[dev] = (embd.cpu(), np.stack(rows), _params_to(params, torch.device("cpu")))
            # a whole bucket: the token path pads with token 0's row, decode_embd
            # with zeros, and i4g's activation scale is shared by all rows
            toks = [5, 9, 23, 7, 88, 41, 2, 150]
            a, e = (InferenceContext(params, cfg, n_cells=1024, device=dev) for _ in range(2))
            b = Batch()
            for i, t in enumerate(toks):
                b.add(t, i, 0, want_logits=(i == len(toks) - 1))
            want = a.decode(b)[-1]
            from pipeinfer_tpu_torch.models.llama import embed

            tok_rows = embed(torch.tensor(toks, dtype=torch.int32, device=cuda), params["tok_embd"])
            np.testing.assert_array_equal(e.decode_embd(tok_rows, 0), want)

            def token_path(p, toks):
                b = Batch()
                for i, t in enumerate(toks):
                    b.add(t, i, 0, want_logits=(i == len(toks) - 1))
                return InferenceContext(p, cfg, n_cells=1024, device=dev).decode(b)[-1]

            toks = np.random.default_rng(0).integers(3, 300, 40).tolist()
            want = token_path(params, toks)
            got = InferenceContext(params, cfg, n_cells=1024, device=dev).decode_embd(
                embed(torch.tensor(toks, dtype=torch.int32, device=cuda), params["tok_embd"]), 0)
            monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", "k_major")
            exact = token_path(load_model(lm, device=dev)[0], toks)
            monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", "i4g")
            assert LC.spread(got, want) <= LC.PAD_SHARE * LC.spread(want, exact)
        else:
            out[dev] = (embd, np.stack(rows))
    assert LC.spread(out["cuda"][0].numpy(), out["cpu"][0].numpy()) <= LC.CLIP_RTOL
    assert LC.spread(out["cuda"][1], out["cpu"][1]) <= LC.LIVE_RTOL
