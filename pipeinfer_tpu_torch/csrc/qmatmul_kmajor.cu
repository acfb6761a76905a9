// k_major quantized matmul for Hopper (sm_90a): exact dequantization of
// the GGUF block formats' own bit-packed planes inside the kernel.
//
// Replaces the Pallas kernel pipeinfer_tpu/ops/qmatmul.py::_make_kernel
// (wrapper _qmm_pallas). Computes
//
//   out[m, n] = sum_k x[m, k] * bf16(fl(fl(s[k / G, n] * q[k, n]) - b[k / G, n]))
//
// with x bf16 [M, K], q the integer quants unpacked from the planes, s and
// b f32 [K/G, N] (no b for Q8_0), the product exact in f32 and f32
// accumulation -- the TPU kernel's arithmetic (w = s * q - b in f32, cast
// to bf16, bf16 dot with f32 accumulation). s * q and the subtraction are
// rounded one at a time (__fmul_rn, __fsub_rn): a fused multiply-add would
// round once and could land on another bf16 value. Unlike the i8 kernel,
// the bias stays inside the bf16 rounding, as the TPU kernel folds it.
//
// Planes, per 256-row pack group of K (quant/pack.py's split packing):
//   8 bits (Q8_0): qs s8 [K, N], row k is element k.
//   4/5/6 bits:    qs u8 [K/2, N]; row j of a group holds elements j (lo
//                  nibble) and j + 128 (hi nibble).
//   2/3 bits:      qs u8 [K/4, N]; row j holds elements j + 64 i in bits 2i.
//   5 bits:        qh u8 [K/8, N]; qh row r (32 per group) gives bit i to
//                  element r + 32 i, shifted << 4.
//   6 bits:        qh u8 [K/4, N]; qh row r (64 per group) gives the 2-bit
//                  field i to element r + 64 i, shifted << 4.
//   3 bits:        as 5 bits, shifted << 2.
//
// What bounds it on the H100: bytes. At decode M (1..33) each weight is used
// M times, far below the ~295 operations per byte where the tensor cores
// would bind, so the floor is the planes (0.75 B/weight for Q4_K with its
// f32 scale and bias, 1.25 for Q6_K, 1.125 for Q8_0) read once at
// 3.35 TB/s. Two things stand between the kernel and that floor:
// - bytes in flight. The frame is the i8 kernel's (split_merge.cuh): a
//   block is 8 warps over a 128-column tile, a lane takes 4 adjacent
//   columns, so a warp's word load is one 128-byte line of one plane row.
//   The qs plane is walked in 128-row chunks, warp w taking qs rows
//   [16 w, 16 w + 16) of each; those rows hold 16 consecutive elements of
//   each of the format's planes (lo/hi nibbles, or the four 2-bit fields),
//   aligned to 16, so each plane of a warp has one scale row and one bias
//   row (G is 16 or 32): one float4 each a lane. A chunk is one pack group
//   at 4/5/6 bits, two at 2/3 bits and half of one at 8 bits; at 2/3 bits
//   an odd number of groups leaves the last chunk ragged, and a warp whose
//   rows lie past the plane skips it. Split-K: the wrapper's plan
//   (ops/qmatmul.py::kmajor_plan) cuts the chunks into `splits` ranges of
//   whole chunks so that the grid fills the card's waves of resident
//   blocks even at N = 4096. In each chunk the warp loads the chunk's x
//   values and only then issues the next chunk's 16 qs (and 16 qh) word
//   loads, so the stream goes on while this chunk is summed. At one row of
//   x the next chunk's scale and bias rows fly with them; at 4 and 8 rows
//   (and for Q8_0) a chunk loads its own at its start, which other warps
//   cover: 32 accumulators beside the words in flight leave no registers
//   for them (measured faster, with fewer spills). The words are not
//   transposed: each byte op works on 4 columns of one row at once, and
//   the byte permute takes column c's byte. The lanes widen their x values
//   to f32 into the warp's slice of shared memory, from which every lane
//   reads them (one 16-byte read per row of x, plane and 4 K rows).
// - per-weight work. At the Q4_K byte bound the card issues about 6.7
//   thread instructions per weight, and one conversion per weight on the
//   16-per-clock conversion pipe already takes most of that time. So q
//   becomes a float with no int-to-float conversion: a few word-wide
//   masks and shifts per 4 weights gather each weight's quant bits (the qs
//   field and its qh bits) into one byte of a word, one __byte_perm per
//   weight builds the float bits 0x4B0000uu = 2^23 + u, and subtracting
//   2^23 gives u exactly (Q8_0: the word is XORed with 0x80808080 first and
//   2^23 + 128 subtracted, as in the i8 kernel). A field that has no qh
//   bits and sits higher in its byte (the 4-bit hi nibble, the 2-bit fields
//   1..3) keeps its place: u = q * 2^j, and the scale is prescaled by 2^-j
//   once per chunk, so fl(s 2^-j * q 2^j) = fl(s * q) while s 2^-j is
//   exact, which holds for |s| >= 2^-120 and for 0 (every scale a GGUF
//   block gives is 0 or at least 2^-24; tests/test_torch_kmajor_split.py
//   checks every quant value of every width and plane). Then __fmul_rn,
//   __fsub_rn with b, and one packed conversion rounds to bf16 (nearest
//   even) into the high half of a word whose low half is zero: those bits
//   are the bf16 value widened to f32, so no shift or mask follows (two
//   weights per conversion, widened by a shift and a mask, was measured
//   slower at one row of x too). Each weight then feeds one FMA per row
//   of x. A full row tile sums with no
//   test per row.
// The 8 warps meet in warp order and the splits in split order, through
// the merge the split-K kernels share (split_merge.cuh): no atomics touch
// the output, so calls on the same inputs are bitwise equal.
// Out of scope here: tensor-core MMA, TMA staging, and reusing a chunk's
// dequantized weights across the row tiles of x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "split_merge.cuh"

namespace {

using split_merge::BLOCKS_PER_SM;
using split_merge::KG;
using split_merge::THREADS;
using split_merge::TN;

constexpr int CH = 16;           // qs rows a warp takes of each chunk
constexpr int CHUNK = KG * CH;   // qs rows per chunk (KMAJOR_CHUNK in ops/qmatmul.py)

// Per bit width: elements per qs row (ELEMS), qs rows per pack group
// (ROWS), element distance between planes (STRIDE), qh rows per group (QH,
// 0: none); PLANES = ELEMS.
template <int BITS> struct Fmt;
template <> struct Fmt<8> { static constexpr int ELEMS = 1, ROWS = 256, STRIDE = 0, QH = 0; };
template <> struct Fmt<4> { static constexpr int ELEMS = 2, ROWS = 128, STRIDE = 128, QH = 0; };
template <> struct Fmt<5> { static constexpr int ELEMS = 2, ROWS = 128, STRIDE = 128, QH = 32; };
template <> struct Fmt<6> { static constexpr int ELEMS = 2, ROWS = 128, STRIDE = 128, QH = 64; };
template <> struct Fmt<2> { static constexpr int ELEMS = 4, ROWS = 64, STRIDE = 64, QH = 0; };
template <> struct Fmt<3> { static constexpr int ELEMS = 4, ROWS = 64, STRIDE = 64, QH = 32; };

// log2 of the factor 2^j by which plane i's quant byte holds q: a field
// with no qh bits keeps its place in the byte, and its scale is prescaled
// by 2^-j.
__device__ __forceinline__ constexpr int place(int bits, int i) {
  return bits == 4 ? 4 * i : bits == 2 ? 2 * i : 0;
}

// Plane i's quants of 4 columns of one K row, one byte each (q * 2^place),
// from the qs word W and qh word H of that row; i is a constant once the
// plane loop is unrolled. hs: the bit of the warp's first qh field in a qh
// byte, the same in every chunk. Q8_0: the s8 bytes offset by 128.
template <int BITS>
__device__ __forceinline__ uint32_t quant_word(uint32_t W, uint32_t H, int hs, int i) {
  if constexpr (BITS == 8) {
    return W ^ 0x80808080u;
  } else if constexpr (BITS == 4) {
    return W & (0x0F0F0F0Fu << (4 * i));
  } else if constexpr (BITS == 2) {
    return W & (0x03030303u << (2 * i));
  } else if constexpr (BITS == 5 || BITS == 6) {
    // the element's qh bits at bit 4 i (5 bits: 1 bit, 6 bits: 2) of H >> hs
    const uint32_t mask = BITS == 5 ? 0x10101010u : 0x30303030u;
    const uint32_t h = H >> hs;
    return i == 0 ? (W & 0x0F0F0F0Fu) | ((h << 4) & mask)
                  : ((W >> 4) & 0x0F0F0F0Fu) | (h & mask);
  } else {  // 3 bits: the qh bit at bit 2 i of H >> hs
    const uint32_t h = H >> hs;
    const uint32_t hb = i == 0 ? h << 2 : h >> (2 * i - 2);
    return ((W >> (2 * i)) & 0x03030303u) | (hb & 0x04040404u);
  }
}

// The 4 weights of quant word `u` (byte c: column c of one K row),
// bf16(fl(fl(s[c] * q) - b[c])) widened to f32: s is prescaled so that
// s * u is s * q, and 2^23 + u - sub is u exactly.
template <bool BIAS>
__device__ __forceinline__ void dequant4(uint32_t u, float sub, const float s[4],
                                         const float b[4], float w[4]) {
  float p[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float q = __fadd_rn(__uint_as_float(__byte_perm(u, 0x4B00u, 0x5440 + c)), -sub);
    p[c] = __fmul_rn(s[c], q);
    if (BIAS) p[c] = __fsub_rn(p[c], b[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(0.f, p[c]);
    w[c] = __uint_as_float(*reinterpret_cast<const uint32_t*>(&h));
  }
}

struct Args {
  const uint16_t* x;     // bf16 [M, K]
  const uint8_t* qs;     // [K / ELEMS, N]
  const uint8_t* qh;     // [K / 8 or K / 4, N] or null
  const float* scales;   // [K/G, N]
  const float* bias;     // [K/G, N]; null for Q8_0
  float* out;            // [M, N]
  int* tickets;          // [TICKETS], zero between calls; then f32 partials [splits, M, N]
  int M, N, K, G, chunks, splits;
};

template <int BITS, int MT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) kmajor_kernel(Args a) {
  using F = Fmt<BITS>;
  constexpr int PLANES = F::ELEMS;
  constexpr bool BIAS = BITS != 8;
  constexpr bool HAS_QH = F::QH != 0;
  constexpr int XW = PLANES * CH;                 // x values a warp takes per row of a chunk
  constexpr int XLOADS = (MT * XW + 127) / 128;   // 8-byte x loads a lane makes per chunk
  constexpr float SUB = BITS == 8 ? 8388736.0f : 8388608.0f;  // 2^23 (+ 128 for s8)
  // each warp's x of its chunk, widened: KG * MT * XW floats of dynamic
  // shared memory (16 KB at 2/3 bits and 8 rows, beside finish's 32 KB)
  extern __shared__ __align__(16) float xs_dyn[];
  float (*xs)[MT][XW] = reinterpret_cast<float (*)[MT][XW]>(xs_dyn);

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int rt = blockIdx.x, ct = blockIdx.y, sp = blockIdx.z;
  const int n0 = ct * TN + lane * 4;
  const int m0 = rt * MT;
  const int rows = min(MT, a.M - m0);
  const int R = a.K / F::ELEMS;  // qs rows
  const int nchunk = (R + CHUNK - 1) / CHUNK;
  const int c0 = sp * a.chunks, c1 = min(nchunk, c0 + a.chunks);
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
  const int kw = w * CH;  // this warp's first qs row of each chunk
  // chunks [c0, c_end) hold rows of this warp: past R lies only the ragged last chunk's tail
  const int c_end = min(c1, (R - kw + CHUNK - 1) / CHUNK);
  // The warp's place in its pack group is the same in every chunk where a
  // group holds at most one chunk (ROWS <= CHUNK, every format with qh):
  // its qh rows start at jq, and its elements' first qh field sits at bit
  // hs of a qh byte.
  const int jw = kw % F::ROWS;
  const int jq = jw % (HAS_QH ? F::QH : 1);
  const int hs = BITS == 6 ? 2 * (jw / 64) : jw / 32;

  // qs row r0's pack group and the element of its plane 0
  auto element = [&](int r0) { return r0 / F::ROWS * 256 + r0 % F::ROWS; };
  uint32_t q[CH], h[CH] = {};
  float4 s_next[PLANES], b_next[PLANES];
  // the next chunk's scale and bias rows fly with its words (see the header)
  constexpr bool SB_AHEAD = MT == 1 || BITS == 8;
  // each plane's scale (and bias) row of the elements from e0
  auto fetch_sb = [&](int e0) {
#pragma unroll
    for (int i = 0; i < PLANES; ++i) {
      const size_t gi = (size_t)((e0 + i * F::STRIDE) >> gshift) * N + nc;
      s_next[i] = __ldg(reinterpret_cast<const float4*>(a.scales + gi));
      if (BIAS) b_next[i] = __ldg(reinterpret_cast<const float4*>(a.bias + gi));
    }
  };
  // the warp's 16 qs (and qh) word loads of qs rows [r0, r0 + 16)
  auto fetch = [&](int r0) {
    const uint8_t* wp = a.qs + (size_t)r0 * N + nc;
#pragma unroll
    for (int r = 0; r < CH; ++r)
      q[r] = __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)r * N));
    if constexpr (HAS_QH) {
      const uint8_t* hp = a.qh + (size_t)(r0 / F::ROWS * F::QH + jq) * N + nc;
#pragma unroll
      for (int r = 0; r < CH; ++r)
        h[r] = __ldg(reinterpret_cast<const uint32_t*>(hp + (size_t)r * N));
    }
    if (SB_AHEAD) fetch_sb(element(r0));
  };
  if (c0 < c_end) fetch(c0 * CHUNK + kw);
  for (int ch = c0; ch < c_end; ++ch) {
    const int r0 = ch * CHUNK + kw;
    const int e0 = element(r0);
    if (!SB_AHEAD) fetch_sb(e0);
    uint32_t row[CH], hrow[CH];  // this chunk's words: 4 columns of one qs (qh) row
#pragma unroll
    for (int r = 0; r < CH; ++r) {
      row[r] = q[r];
      hrow[r] = h[r];
    }
    float s[PLANES][4], b[PLANES][4];
#pragma unroll
    for (int i = 0; i < PLANES; ++i) {
      // 2^-place: the prescale is exact for |s| >= 2^-120 (see the header)
      const float f = __int_as_float((127 - place(BITS, i)) << 23);
      s[i][0] = __fmul_rn(s_next[i].x, f);
      s[i][1] = __fmul_rn(s_next[i].y, f);
      s[i][2] = __fmul_rn(s_next[i].z, f);
      s[i][3] = __fmul_rn(s_next[i].w, f);
      if (BIAS) {
        b[i][0] = b_next[i].x;
        b[i][1] = b_next[i].y;
        b[i][2] = b_next[i].z;
        b[i][3] = b_next[i].w;
      } else {
        b[i][0] = b[i][1] = b[i][2] = b[i][3] = 0.f;
      }
    }
    // this chunk's x: value v = 4 (32 u + lane) of the warp's MT x XW,
    // row v / XW, plane (v % XW) / 16, element offset v % 16
    uint2 xr[XLOADS];
#pragma unroll
    for (int u = 0; u < XLOADS; ++u) {
      const int v = 4 * (32 * u + lane), m = v / XW, i = v % XW / CH;
      xr[u] = m < rows ? __ldg(reinterpret_cast<const uint2*>(
                             a.x + (size_t)(m0 + m) * a.K + e0 + i * F::STRIDE + v % CH))
                       : make_uint2(0u, 0u);
    }
    if (ch + 1 < c_end) fetch(r0 + CHUNK);  // flies while this one is summed
    __syncwarp();  // every lane has read the previous chunk's x
#pragma unroll
    for (int u = 0; u < XLOADS; ++u) {
      const int v = 4 * (32 * u + lane), m = v / XW;
      if (m < rows)
        *reinterpret_cast<float4*>(&xs[w][m][v % XW]) =
            make_float4(__uint_as_float(xr[u].x << 16), __uint_as_float(xr[u].x & 0xFFFF0000u),
                        __uint_as_float(xr[u].y << 16), __uint_as_float(xr[u].y & 0xFFFF0000u));
    }
    __syncwarp();
    // a full row tile runs with no test per row
    auto sum_chunk = [&](int live) {
#pragma unroll
      for (int r4 = 0; r4 < CH / 4; ++r4) {
#pragma unroll
        for (int i = 0; i < PLANES; ++i) {
          float wv[4][4];  // [row t][column c]
#pragma unroll
          for (int t = 0; t < 4; ++t)
            dequant4<BIAS>(quant_word<BITS>(row[4 * r4 + t], hrow[4 * r4 + t], hs, i), SUB,
                           s[i], b[i], wv[t]);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < live) {
              const float4 x4 = *reinterpret_cast<const float4*>(&xs[w][m][i * CH + 4 * r4]);
              const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
              for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int t = 0; t < 4; ++t) acc[m][c] = fmaf(wv[t][c], xv[t], acc[m][c]);
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

// Lets the 8-row instance ask for its x in dynamic shared memory, which
// may pass the 48 KB a block gets unasked (2/3 bits: 16 KB beside
// finish's 32). The attribute never changes, so it is set once per card
// and instance, not at every launch: the CUDA call costs host time on a
// path the host already bounds.
template <int BITS>
cudaError_t allow_smem8(int smem) {
  constexpr int MAX_CARDS = 64;
  static std::atomic<bool> done[MAX_CARDS];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < MAX_CARDS && done[dev].load(std::memory_order_acquire)))
    return e;
  e = cudaFuncSetAttribute(kmajor_kernel<BITS, 8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < MAX_CARDS) done[dev].store(true, std::memory_order_release);
  return e;
}

template <int BITS>
int launch(const Args& a, int rows, int chunks, int splits, const void* scratch, void* stream) {
  constexpr int XW = Fmt<BITS>::ELEMS * CH;
  const int smem = (int)(KG * rows * XW * sizeof(float));
  if (rows == 8) {
    const cudaError_t e = allow_smem8<BITS>(smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int units = (a.K / Fmt<BITS>::ELEMS + CHUNK - 1) / CHUNK;
  return split_merge::launch<Args>(kmajor_kernel<BITS, 1>, kmajor_kernel<BITS, 4>,
                                   kmajor_kernel<BITS, 8>, a, a.M, a.N, rows, units, chunks,
                                   splits, scratch, stream, smem);
}

}  // namespace

// x bf16 [M, K]; qs, qh (or null) as above; scales f32 [K/G, N]; bias f32
// [K/G, N], null exactly for 8 bits (Q8_0); out f32 [M, N]; scratch:
// TICKETS int32 counters (zero on entry, left zero) followed by f32
// partials [splits, M, N], or null for one split. K % 256 == 0, G in {16,
// 32}, N % 4 == 0; x 8-byte aligned, scales and bias 16-byte, qs and qh
// 4-byte. The cut (rows of x per block in {1, 4, 8}, 128-row qs chunks per
// split, splits over ceil(qs rows / 128) chunks) comes from the wrapper's
// plan; returns the launch error (cudaErrorInvalidValue for a cut or shape
// the kernel does not take).
extern "C" int pi_kmajor_matmul(const void* x, const void* qs, const void* qh,
                                const void* scales, const void* bias, void* out, void* scratch,
                                int M, int N, int K, int bits, int G, int rows, int chunks,
                                int splits, void* stream) {
  if (K <= 0 || K % 256 || (G != 16 && G != 32) || (bias == nullptr) != (bits == 8) ||
      (qh != nullptr) != (bits == 3 || bits == 5 || bits == 6))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(qs),
         static_cast<const uint8_t*>(qh), static_cast<const float*>(scales),
         static_cast<const float*>(bias),     static_cast<float*>(out),
         static_cast<int*>(scratch),          M, N, K, G, chunks, splits};
  switch (bits) {
    case 8: return launch<8>(a, rows, chunks, splits, scratch, stream);
    case 6: return launch<6>(a, rows, chunks, splits, scratch, stream);
    case 5: return launch<5>(a, rows, chunks, splits, scratch, stream);
    case 4: return launch<4>(a, rows, chunks, splits, scratch, stream);
    case 3: return launch<3>(a, rows, chunks, splits, scratch, stream);
    case 2: return launch<2>(a, rows, chunks, splits, scratch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
