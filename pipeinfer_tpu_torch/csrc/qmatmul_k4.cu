// k4 quantized matmul for Hopper (sm_90a): the packed nibble plane of a
// 4-bit format, its lo and hi nibbles taken as two K-halves, dequantized
// exactly inside the kernel.
//
// Replaces the Pallas kernel pipeinfer_tpu/ops/qmatmul.py::_k4_kernel
// (wrapper _qmm_k4_pallas). Byte row p of the plane qs u8 [r2, N] holds
// element kl(p) = (p / 128) * 256 + p % 128 in its low nibble and
// kh(p) = kl(p) + 128 in its high nibble; plane row p takes scale and bias
// row p / 32 of its plane (s_lo, b_lo and s_hi, b_hi, f32 [r2/32, N]).
// Computes
//
//   out[m, n] = sum_p x[m, kl(p)] * bf16(fl(s_lo[p/32, n] * lo(p, n)))
//                   + x[m, kh(p)] * bf16(fl(s_hi[p/32, n] * hi(p, n)))
//               - sum_g (xg[m, gl(g)] * b_lo[g, n] + xg[m, gh(g)] * b_hi[g, n])
//
// over p < K/2 and plane groups g < K/64, with x bf16 [M, K] in natural
// order and xg f32 [M, K/32] its natural group sums (gl(g) = (g / 4) * 8 +
// g % 4, gh(g) = gl(g) + 4). As on the TPU the weight is s * q rounded to
// f32 and then to bf16, the bias term is separate (as in the i8 kernel,
// unlike k_major), each product with bf16 x is exact in f32 and the sums
// are f32. The padding rows of qs (r2 may exceed K/2) and the scale rows
// past K/64 are never read. Reading x at kl(p) and kh(p) directly spares
// the re-ordering of x into plane order that the TPU wrapper does.
//
// What bounds it on the H100: bytes. At decode M (1..33) each weight is
// used M times, far below the ~295 operations per byte where the tensor
// cores would bind, so the floor is qs (0.5 B/weight) plus the four scale
// and bias planes (0.25 B/weight: 16 B per 64 weights) read once at
// 3.35 TB/s, 0.0101 ms at w_down [4096, 11008]. Two things stand between
// the kernel and that floor, and the design takes each in turn:
// - bytes in flight. The frame is the i8 kernel's (split_merge.cuh): a
//   block is 8 warps over a 128-column tile, a lane takes 4 adjacent
//   columns, so a warp's word load is one 128-byte line of one byte-plane
//   row. A chunk is 128 byte rows, exactly one 256-element pack group
//   (K % 256 == 0 for every k4 weight, so no chunk is ragged); warp w takes
//   byte rows [16 w, 16 w + 16), the lo elements ch * 256 + 16 w + [0, 16)
//   and the same + 128 for hi, which lie in one scale row of each plane
//   (ch * 4 + w / 2): one float4 of s_lo and one of s_hi a lane. Split-K:
//   the wrapper's plan (ops/qmatmul.py::k4_plan) cuts the K / 256 chunks
//   into `splits` ranges of whole chunks so that the grid fills the card's
//   waves of resident blocks even at N = 4096. In each chunk the warp
//   issues its 16 word loads together, transposes its 4 x 4 byte blocks
//   (__byte_perm), loads the chunk's x (32 bf16 values a row, 16 at kl and
//   16 at kh: lane l reads 16 bytes of row l / 4, so one load covers 8
//   rows), and only then issues the next chunk's 16 word loads and its
//   scale rows (and, for an even warp, bias rows and xg values), so the
//   stream goes on while this chunk is summed; such a warp subtracts its
//   bias terms (below) before that, from the registers they arrived in
//   (keeping copies for later cost about 40 moves a pass). At 4 and 8
//   rows of x a chunk loads its own scale and bias rows and xg values at
//   its start instead, which other warps cover: 32 accumulators beside the
//   words in flight leave no registers for them (as in the k_major kernel;
//   flying them was measured slower there and here). The lanes widen their
//   x values to f32 into the warp's slice of shared memory, from which
//   every lane reads them (one 16-byte read per row of x, plane and 4 K
//   rows).
// - per-weight work. At the byte bound the card issues about 6.7 thread
//   instructions per weight, and the conversion pipe runs at 16 per clock
//   per SM: the first form's int-to-float and float-to-bf16 conversions of
//   every weight held that pipe well past the byte bound. Here q becomes a
//   float with no int-to-float conversion: the lo nibbles are the word
//   masked with 0x0F0F0F0F, and one __byte_perm per weight builds the
//   float bits 0x4B0000uu = 2^23 + u. The hi nibbles keep their place (the
//   word masked with 0xF0F0F0F0, so u = 16 q) and s_hi is prescaled by
//   2^-4 once per chunk: s 2^-4 * 16 q = s * q while s 2^-4 is exact, which
//   holds for |s| >= 2^-122 and for 0 (every scale a 4-bit GGUF block
//   gives is 0 or at least 2^-24). No add takes 2^23 away: one FMA with
//   c = -s 2^23 (exact, once per chunk and column) computes s (2^23 + u) +
//   c = s * u exactly and rounds it once, to fl(s * q), the TPU's product
//   (but +0 where q = 0 under a negative scale, whose fl(s * 0) is -0: the
//   same value; tests/test_torch_k4_split.py checks every nibble value).
//   One packed conversion rounds it to bf16 (nearest even) into the high
//   half of a word whose low half is zero: those bits are the bf16 value
//   widened to f32, so no shift or mask follows. Each weight then feeds
//   one FMA per row of x: PRMT, FFMA, F2FP and an FFMA per row. (Rounding
//   to bf16 on the FMA pipe by Veltkamp's split, three FMA-pipe operations
//   instead of the conversion, was measured slower.) A full row tile sums
//   with no test per row.
// An even warp holds the first rows of the natural groups gl = ch * 8 +
// w / 2 and gh = gl + 4: before its products it subtracts xg[m, gl] * b_lo
// and then xg[m, gh] * b_hi into its sums (two fmaf, one rounding each), so
// the bias planes are read once, by the kernel (the TPU kernel leaves this
// term to an XLA dot outside). The 8 warps meet in warp order and the
// splits in split order, through the merge the split-K kernels share
// (split_merge.cuh): no atomics touch the output, so calls on the same
// inputs are bitwise equal. Out of scope here: tensor-core MMA, TMA
// staging, and reusing a chunk's dequantized weights across the row tiles
// of x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_merge.cuh"

namespace {

using split_merge::BLOCKS_PER_SM;
using split_merge::KG;
using split_merge::THREADS;
using split_merge::TN;
using split_merge::transpose4x4;

constexpr int CH = 16;          // byte rows a warp takes of each chunk (inside one scale row)
constexpr int CHUNK = KG * CH;  // byte rows per chunk, one pack group (K4_CHUNK in ops/qmatmul.py)
constexpr int XW = 2 * CH;      // x values a warp takes per row of a chunk: 16 lo, then 16 hi

struct Args {
  const uint16_t* x;     // bf16 [M, K]
  const float* xg;       // [M, K/32], natural group sums of f32 x
  const uint8_t* qs;     // [r2, N]
  const float* s_lo;     // [r2/32, N], and s_hi, b_lo, b_hi alike
  const float* s_hi;
  const float* b_lo;
  const float* b_hi;
  float* out;            // [M, N]
  int* tickets;          // [TICKETS], zero between calls; then f32 partials [splits, M, N]
  int M, N, K, chunks, splits;
};

// The 4 weights of nibble word `u` (byte t: one nibble of K row t of one
// column, u_t = q_t or 16 q_t), each bf16(fl(s * u_t)) widened to f32.
__device__ __forceinline__ void dequant4(uint32_t u, float s, float w[4]) {
  const float c = __fmul_rn(s, -8388608.0f);  // -s 2^23, exact
  float p[4];
#pragma unroll
  for (int t = 0; t < 4; ++t)  // s (2^23 + u) - s 2^23 = s u exactly, rounded once by the FMA
    p[t] = __fmaf_rn(s, __uint_as_float(__byte_perm(u, 0x4B00u, 0x5440 + t)), c);
  // bf16 rounding to nearest even into the high half of a word whose low
  // half is zero: those bits are the bf16 value widened to f32
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(0.f, p[t]);
    w[t] = __uint_as_float(*reinterpret_cast<const uint32_t*>(&h));
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) k4_kernel(Args a) {
  __shared__ __align__(16) float xs[KG][MT][XW];  // each warp's x of its chunk, widened
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int rt = blockIdx.x, ct = blockIdx.y, sp = blockIdx.z;
  const int n0 = ct * TN + lane * 4;
  const int m0 = rt * MT;
  const int rows = min(MT, a.M - m0);
  const int c0 = sp * a.chunks, c1 = min(a.K / 256, c0 + a.chunks);
  const int ngroups = a.K / 32;  // natural groups of x (the columns of xg)
  // warps 0, 2, 4, 6 hold the first rows of their plane groups
  const bool bias_warp = w % 2 == 0;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  // A lane past N (in a ragged last tile) reads columns N - 4 .. N - 1 and
  // its sums are dropped: every lane of a warp runs the loop, which moves
  // x through shared memory with warp-wide syncs.
  const int nc = min(n0, a.N - 4);
  const size_t N = a.N;
  uint32_t q[CH];
  float4 sl_next, sh_next, bl_next = make_float4(0.f, 0.f, 0.f, 0.f), bh_next = bl_next;
  float xgl_next[MT], xgh_next[MT];  // a bias warp's xg[m, gl] and xg[m, gh]
  // the next chunk's scale and bias rows fly with its words (see the header)
  constexpr bool SB_AHEAD = MT == 1;
  // the warp's scale rows of chunk ch, and a bias warp's bias rows and xg values
  auto fetch_sb = [&](int ch) {
    const size_t gi = (size_t)(ch * 4 + w / 2) * N + nc;
    sl_next = __ldg(reinterpret_cast<const float4*>(a.s_lo + gi));
    sh_next = __ldg(reinterpret_cast<const float4*>(a.s_hi + gi));
    if (bias_warp) {
      bl_next = __ldg(reinterpret_cast<const float4*>(a.b_lo + gi));
      bh_next = __ldg(reinterpret_cast<const float4*>(a.b_hi + gi));
      const int gl = ch * 8 + w / 2;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* g = a.xg + (size_t)(m0 + m) * ngroups;
        xgl_next[m] = m < rows ? __ldg(g + gl) : 0.f;
        xgh_next[m] = m < rows ? __ldg(g + gl + 4) : 0.f;
      }
    }
  };
  // the warp's 16 word loads of chunk ch
  auto fetch = [&](int ch) {
    const uint8_t* wp = a.qs + (size_t)(ch * CHUNK + w * CH) * N + nc;
#pragma unroll
    for (int r = 0; r < CH; ++r)
      q[r] = __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)r * N));
    if (SB_AHEAD) fetch_sb(ch);
  };
  // a bias warp's two bias terms, before its products
  auto subtract_bias = [&] {
    if (bias_warp) {
      const float bl[4] = {bl_next.x, bl_next.y, bl_next.z, bl_next.w};
      const float bh[4] = {bh_next.x, bh_next.y, bh_next.z, bh_next.w};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[m][c] = fmaf(-xgl_next[m], bl[c], acc[m][c]);
          acc[m][c] = fmaf(-xgh_next[m], bh[c], acc[m][c]);
        }
    }
  };
  if (c0 < c1) fetch(c0);
  for (int ch = c0; ch < c1; ++ch) {
    if (!SB_AHEAD) fetch_sb(ch);
    const int e0 = ch * 256 + w * CH;  // this warp's first lo element; hi: + 128
    uint32_t col[CH / 4][4];  // per column: the bytes of K rows 4 r4 .. 4 r4 + 3
#pragma unroll
    for (int r4 = 0; r4 < CH / 4; ++r4)
      transpose4x4(q[4 * r4], q[4 * r4 + 1], q[4 * r4 + 2], q[4 * r4 + 3], col[r4]);
    // s[0]: s_lo; s[1]: s_hi * 2^-4 (the hi nibble keeps its place, 16 q),
    // exact for |s| >= 2^-122 (see the header)
    const float s[2][4] = {
        {sl_next.x, sl_next.y, sl_next.z, sl_next.w},
        {__fmul_rn(sh_next.x, 0.0625f), __fmul_rn(sh_next.y, 0.0625f),
         __fmul_rn(sh_next.z, 0.0625f), __fmul_rn(sh_next.w, 0.0625f)}};
    // this chunk's x: lane l reads 8 values (16 bytes) of row l / 4, part
    // l % 4: lo [0, 8), lo [8, 16), hi [0, 8), hi [8, 16)
    const bool x_lane = lane < 4 * rows;
    const int part = lane % 4;
    uint4 xr = make_uint4(0u, 0u, 0u, 0u);
    if (x_lane)
      xr = __ldg(reinterpret_cast<const uint4*>(a.x + (size_t)(m0 + lane / 4) * a.K + e0 +
                                                (part / 2) * 128 + (part % 2) * 8));
    // the bias terms are subtracted from the registers they arrived in:
    // at one row of x before the next chunk's loads overwrite them, else
    // after those loads are issued (this chunk's own loads may still fly)
    if (SB_AHEAD) subtract_bias();
    if (ch + 1 < c1) fetch(ch + 1);  // flies while this one is summed
    if (!SB_AHEAD) subtract_bias();
    __syncwarp();  // every lane has read the previous chunk's x
    if (x_lane) {
      float4* dst = reinterpret_cast<float4*>(&xs[w][lane / 4][8 * part]);
      dst[0] = make_float4(__uint_as_float(xr.x << 16), __uint_as_float(xr.x & 0xFFFF0000u),
                           __uint_as_float(xr.y << 16), __uint_as_float(xr.y & 0xFFFF0000u));
      dst[1] = make_float4(__uint_as_float(xr.z << 16), __uint_as_float(xr.z & 0xFFFF0000u),
                           __uint_as_float(xr.w << 16), __uint_as_float(xr.w & 0xFFFF0000u));
    }
    __syncwarp();
    // a full row tile runs with no test per row
    auto sum_chunk = [&](int live) {
#pragma unroll
      for (int r4 = 0; r4 < CH / 4; ++r4) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // plane: lo nibbles, then hi
          const uint32_t mask = i == 0 ? 0x0F0F0F0Fu : 0xF0F0F0F0u;
          float wv[4][4];  // [column c][row t]
#pragma unroll
          for (int c = 0; c < 4; ++c) dequant4(col[r4][c] & mask, s[i][c], wv[c]);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < live) {
              const float4 x4 = *reinterpret_cast<const float4*>(&xs[w][m][i * CH + 4 * r4]);
              const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
              for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int t = 0; t < 4; ++t) acc[m][c] = fmaf(wv[c][t], xv[t], acc[m][c]);
            }
          }
        }
      }
    };
    if (rows == MT)
      sum_chunk(MT);
    else
      sum_chunk(rows);
  }

  split_merge::finish<MT>(acc, a.out, a.tickets, a.M, a.N, m0, rows, a.splits);
}

}  // namespace

// x bf16 [M, K]; xg f32 [M, K/32]; qs u8 [r2, N]; s_lo, s_hi, b_lo, b_hi
// f32 [r2/32, N]; out f32 [M, N]; scratch: TICKETS int32 counters (zero on
// entry, left zero) followed by f32 partials [splits, M, N], or null for
// one split. K % 256 == 0, r2 >= K/2, N % 4 == 0; x and the four scale
// and bias planes 16-byte aligned, qs 4-byte. The cut (rows of x per block
// in {1, 4, 8}, 128-row chunks per split, splits over K / 256 chunks) comes
// from the wrapper's plan; returns the launch error (cudaErrorInvalidValue
// for a cut or shape the kernel does not take).
extern "C" int pi_k4_matmul(const void* x, const void* xg, const void* qs, const void* s_lo,
                            const void* s_hi, const void* b_lo, const void* b_hi, void* out,
                            void* scratch, int M, int N, int K, int rows, int chunks, int splits,
                            void* stream) {
  if (K <= 0 || K % 256) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const uint16_t*>(x), static_cast<const float*>(xg),
         static_cast<const uint8_t*>(qs),  static_cast<const float*>(s_lo),
         static_cast<const float*>(s_hi),  static_cast<const float*>(b_lo),
         static_cast<const float*>(b_hi),  static_cast<float*>(out),
         static_cast<int*>(scratch),       M, N, K, chunks, splits};
  return split_merge::launch<Args>(k4_kernel<1>, k4_kernel<4>, k4_kernel<8>, a, M, N, rows,
                                   K / 256, chunks, splits, scratch, stream);
}
