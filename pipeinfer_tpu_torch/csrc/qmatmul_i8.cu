// i8 quantized matmul for Hopper (sm_90a): the integer quants widened to
// s8, exact dequantization inside the kernel.
//
// Replaces the Pallas kernel pipeinfer_tpu/ops/qmatmul.py::_i8_kernel
// (wrapper _qmm_i8_pallas). Computes
//
//   out[m, n] = sum_k x[m, k] * bf16(s[k / G, n] * q[k, n])
//               - sum_g xg[m, g] * b[g, n]
//
// with x bf16 [M, K], q s8 [K, N], s and b f32 [K/G, N] and xg f32
// [M, K/G] the group sums of the f32 activations. As on the TPU the weight
// is s * q rounded to f32 and then to bf16 (the bias is not folded into
// it), the product with x is exact in f32, sums are f32. The TPU kernel
// leaves the bias term to an XLA dot outside; here the warp that holds a
// group's first row subtracts its term into its partial sums, so the bias
// plane is read once, by the kernel. Q8_0 has no bias (b and xg null).
//
// What bounds it on the H100: bytes. At decode M (1..33) each s8 weight is
// used M times, far below the ~295 operations per byte where the tensor
// cores would bind, so the floor is qs (1 B/weight) plus the scale and
// bias planes (8 B per group of G weights) read once at 3.35 TB/s. Two
// things stand between the kernel and that floor, and the design takes
// each in turn:
// - bytes in flight. The frame is the i8g kernel's (qmatmul_i8g.cu): a
//   block is 8 warps over a 128-column tile, a lane takes 4 adjacent
//   columns, so a warp's word load is one 128-byte line of one s8 row; K
//   is walked in 128-row chunks, warp w taking rows [16 w, 16 w + 16) of
//   each and issuing their 16 word loads together. Split-K: the wrapper's
//   plan (ops/qmatmul.py::i8_plan) cuts the ceil(K / 128) chunks into
//   `splits` ranges of whole chunks so that the grid fills the card's
//   waves of resident blocks even at N = 4096. K need only be a multiple
//   of G, so the last chunk may be ragged; K is a multiple of 16, so a
//   warp's 16 rows lie all inside K or all past it, and a warp past K
//   skips the chunk. In each chunk the warp transposes its 4 x 4 byte
//   blocks (__byte_perm), loads the chunk's x rows (32 bytes of bf16 a
//   row, 8 bytes a lane), and only then issues the next chunk's 16 word
//   loads and its scale (and bias) row, so the stream goes on while this
//   chunk is summed (x issued after the prefetch was measured to wait
//   behind it in the i8g kernel). The lanes widen their x values to f32
//   into the warp's slice of shared memory, from which every lane reads
//   them (one 16-byte read per row of x and 4 K rows): 8 rows of bf16 x
//   held in each lane's registers (64 of them) beside 32 weight words and
//   32 accumulators would pass the 128 registers a thread has under
//   __launch_bounds__(256, 2).
// - per-weight work. At the byte bound the card issues about 11 thread
//   instructions per weight, and the conversion pipe runs at 16 per clock
//   per SM: an int-to-float and a float-to-bf16 conversion per weight
//   would take that pipe 1.45 times the byte bound. A warp's 16 rows lie
//   in one scale group (G is 16 or 32), so each lane reads one float4 of
//   scales per chunk, and the dequantization is bit-exact with
//   __float2bfloat16_rn(__fmul_rn(s, (float)q)) but needs no int-to-float
//   conversion: the word is XORed with 0x80808080 once (byte t becomes
//   u = q + 128), one __byte_perm per weight builds the float bits
//   0x4B0000uu = 2^23 + u, and subtracting 2^23 + 128 gives q exactly;
//   fl(s * q) is rounded to bf16 (round to nearest even, as
//   __float2bfloat16_rn) by one packed conversion into the high half of a
//   word whose low half is zero, which is the bf16 value widened to f32,
//   so no shift or mask follows. Each weight then feeds one FMA per row of
//   x. (Packing two weights per conversion and widening each with a shift
//   or a mask was measured slower at 4 and 8 rows of x: under the register
//   cap the compiler widened each weight again for every row.) A full row
//   tile sums with no test per row.
// The 8 warps meet in warp order and the splits in split order, through
// the merge the i4g, i8g and i8 kernels share (split_merge.cuh): no
// atomics touch the output, so calls on the same inputs are bitwise equal.
// Out of scope here: tensor-core MMA and TMA staging.

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

constexpr int CH = 16;           // rows a warp takes of each chunk (inside one scale group)
constexpr int CHUNK = KG * CH;   // K rows per chunk (I8G_CHUNK in ops/qmatmul.py)

struct Args {
  const uint16_t* x;     // bf16 [M, K]
  const float* xg;       // [M, K/G] or null
  const int8_t* qs;      // [K, N]
  const float* scales;   // [K/G, N]
  const float* bias;     // [K/G, N] or null
  float* out;            // [M, N]
  int* tickets;          // [TICKETS], zero between calls; then f32 partials [splits, M, N]
  int M, N, K, G, chunks, splits;
};

// The 4 s8 weights of `word` (K rows t = 0..3 of one column, byte t), each
// bf16(fl(s * q)) widened to f32.
__device__ __forceinline__ void dequant4(uint32_t word, float s, float w[4]) {
  const uint32_t u = word ^ 0x80808080u;  // byte t: q_t + 128
  float p[4];
#pragma unroll
  for (int t = 0; t < 4; ++t)  // 2^23 + u - (2^23 + 128): q exactly; then s * q rounded once
    p[t] = __fmul_rn(s, __fadd_rn(__uint_as_float(__byte_perm(u, 0x4B00u, 0x5440 + t)),
                                  -8388736.0f));
  // bf16 rounding to nearest even into the high half of a word whose low
  // half is zero: those bits are the bf16 value widened to f32
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(0.f, p[t]);
    w[t] = __uint_as_float(*reinterpret_cast<const uint32_t*>(&h));
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) i8_kernel(Args a) {
  __shared__ __align__(16) float xs[KG][MT][CH];  // each warp's x rows of its chunk, widened
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int rt = blockIdx.x, ct = blockIdx.y, sp = blockIdx.z;
  const int n0 = ct * TN + lane * 4;
  const int m0 = rt * MT;
  const int rows = min(MT, a.M - m0);
  const int nchunk = (a.K + CHUNK - 1) / CHUNK;
  const int c0 = sp * a.chunks, c1 = min(nchunk, c0 + a.chunks);
  const int ngroups = a.K / a.G;
  const int gshift = a.G == 16 ? 4 : 5;  // log2(G)

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
  const int kw = w * CH;  // this warp's first K row of each chunk
  // chunks [c0, c_end) hold rows of this warp: past K lies only the ragged last chunk's tail
  const int c_end = min(c1, (a.K - kw + CHUNK - 1) / CHUNK);
  uint32_t q[CH];
  float4 s_next, b_next = make_float4(0.f, 0.f, 0.f, 0.f);
  // the 16 word loads of this warp's rows [k, k + 16), then their scale
  // row (and the bias row where a group starts)
  auto fetch = [&](int k) {
    const int8_t* wp = a.qs + (size_t)k * N + nc;
#pragma unroll
    for (int r = 0; r < CH; ++r)
      q[r] = __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)r * N));
    const size_t gi = (size_t)(k >> gshift) * N + nc;
    s_next = __ldg(reinterpret_cast<const float4*>(a.scales + gi));
    if (a.bias && (k & (a.G - 1)) == 0)
      b_next = __ldg(reinterpret_cast<const float4*>(a.bias + gi));
  };
  if (c0 < c_end) fetch(c0 * CHUNK + kw);
  for (int ch = c0; ch < c_end; ++ch) {
    const int k0 = ch * CHUNK + kw;
    uint32_t col[CH / 4][4];  // per column: 4 K values of rows 4 r4 .. 4 r4 + 3
#pragma unroll
    for (int r4 = 0; r4 < CH / 4; ++r4)
      transpose4x4(q[4 * r4], q[4 * r4 + 1], q[4 * r4 + 2], q[4 * r4 + 3], col[r4]);
    const float s[4] = {s_next.x, s_next.y, s_next.z, s_next.w};
    const float b[4] = {b_next.x, b_next.y, b_next.z, b_next.w};
    // this chunk's x rows: lane l reads 4 values (8 bytes) of row l / 4
    const bool x_lane = lane < 4 * rows;
    uint2 xr = make_uint2(0u, 0u);
    if (x_lane)
      xr = __ldg(reinterpret_cast<const uint2*>(a.x + (size_t)(m0 + lane / 4) * a.K + k0 +
                                                4 * (lane % 4)));
    const bool group_start = a.bias && (k0 & (a.G - 1)) == 0;
    float xgv[MT];
    if (group_start) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        xgv[m] = m < rows ? __ldg(a.xg + (size_t)(m0 + m) * ngroups + (k0 >> gshift)) : 0.f;
    }
    if (ch + 1 < c_end) fetch(k0 + CHUNK);  // flies while this one is summed
    if (group_start) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(-xgv[m], b[c], acc[m][c]);
    }
    __syncwarp();  // every lane has read the previous chunk's x
    if (x_lane)
      *reinterpret_cast<float4*>(&xs[w][lane / 4][4 * (lane % 4)]) =
          make_float4(__uint_as_float(xr.x << 16), __uint_as_float(xr.x & 0xFFFF0000u),
                      __uint_as_float(xr.y << 16), __uint_as_float(xr.y & 0xFFFF0000u));
    __syncwarp();
    // a full row tile runs with no test per row
    auto sum_chunk = [&](int live) {
#pragma unroll
      for (int r4 = 0; r4 < CH / 4; ++r4) {
        float wv[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) dequant4(col[r4][c], s[c], wv[c]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < live) {
            const float4 x4 = *reinterpret_cast<const float4*>(&xs[w][m][4 * r4]);
            const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int t = 0; t < 4; ++t) acc[m][c] = fmaf(wv[c][t], xv[t], acc[m][c]);
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

// x bf16 [M, K]; xg f32 [M, K/G] or null; qs s8 [K, N]; scales f32 [K/G, N];
// bias f32 [K/G, N] or null (null with xg); out f32 [M, N]; scratch:
// TICKETS int32 counters (zero on entry, left zero) followed by f32
// partials [splits, M, N], or null for one split. K % G == 0, G in {16,
// 32}, N % 4 == 0; x 8-byte aligned, scales and bias 16-byte, qs 4-byte.
// The cut (rows of x per block in {1, 4, 8}, 128-row chunks per split,
// splits over ceil(K / 128) chunks) comes from the wrapper's plan; returns
// the launch error (cudaErrorInvalidValue for a cut the kernel does not
// take).
extern "C" int pi_i8_matmul(const void* x, const void* xg, const void* qs, const void* scales,
                            const void* bias, void* out, void* scratch, int M, int N, int K,
                            int G, int rows, int chunks, int splits, void* stream) {
  if (K <= 0 || (G != 16 && G != 32) || K % G || (xg == nullptr) != (bias == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const uint16_t*>(x), static_cast<const float*>(xg),
         static_cast<const int8_t*>(qs),  static_cast<const float*>(scales),
         static_cast<const float*>(bias), static_cast<float*>(out),
         static_cast<int*>(scratch),      M, N, K, G, chunks, splits};
  return split_merge::launch<Args>(i8_kernel<1>, i8_kernel<4>, i8_kernel<8>, a, M, N, rows,
                                   (K + CHUNK - 1) / CHUNK, chunks, splits, scratch, stream);
}
