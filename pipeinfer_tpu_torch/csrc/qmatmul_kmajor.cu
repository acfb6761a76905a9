// k_major quantized matmul for Hopper (sm_90a): exact dequantization of
// the GGUF block formats' own bit-packed planes inside the kernel.
//
// Replaces the Pallas kernel pipeinfer_tpu/ops/qmatmul.py::_make_kernel
// (wrapper _qmm_pallas). Computes
//
//   out[m, n] = sum_k x[m, k] * bf16(s[k / G, n] * q[k, n] - b[k / G, n])
//
// with x bf16 [M, K], q the integer quants unpacked from the planes, s and
// b f32 [K/G, N] (no b for Q8_0), the product exact in f32 and f32
// accumulation -- the TPU kernel's arithmetic (w = s * q - b in f32, cast
// to bf16, bf16 dot with f32 accumulation). s * q and the subtraction are
// rounded one at a time (__fmul_rn, __fsub_rn): a fused multiply-add would
// round once and could land on another bf16 value.
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
// M times, far below the ~295 operations per byte where compute would bind,
// so the floor is the planes (0.75 B/weight for Q4_K with its scale and
// bias) read once at 3.35 TB/s. The design follows qmatmul_i4g.cu:
// - one block per 32-column tile (and up to MT rows of x), so N = 4096
//   gives 128 blocks with no cross-block reduction;
// - 256 threads = 8 column groups (4 columns, one 32-bit load each) x 32 K
//   groups; K is cut into chunks of 16 qs rows inside one pack group, dealt
//   round-robin to the K groups. The 16 rows hold 16 consecutive elements of
//   each of the format's planes, aligned to 16, so every plane of a chunk
//   has one scale and one bias row (groups are 16 or 32 rows);
// - four 32-bit loads (4 rows x 4 columns) are transposed in registers with
//   __byte_perm into one word of 4 rows per column, for qs and for qh;
// - the 32 K groups' sums meet in shared memory in a fixed order.
// A later version would stage tiles with TMA and feed bf16 tensor cores;
// this one is the simple, exact first kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 32;        // columns per block
constexpr int KG = 32;        // K groups per block
constexpr int CH = 16;        // qs rows per chunk
constexpr int THREADS = 256;  // (TN / 4) * KG

__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2,
                                             uint32_t r3, uint32_t out[4]) {
  // r_i: bytes (col0..col3) of row i -> out[c]: bytes (row0..row3) of col c
  uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  uint32_t t2 = __byte_perm(r0, r1, 0x7362);
  uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// 4 rows x 4 columns of a byte plane [rows, N] starting at row `row`,
// transposed: out[c] holds rows row..row+3 of column n0 + c.
__device__ __forceinline__ void load4x4(const uint8_t* plane, int row, int N, int n0,
                                        uint32_t out[4]) {
  const uint8_t* p = plane + (size_t)row * N + n0;
  uint32_t w0 = __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t w1 = __ldg(reinterpret_cast<const uint32_t*>(p + N));
  uint32_t w2 = __ldg(reinterpret_cast<const uint32_t*>(p + 2 * (size_t)N));
  uint32_t w3 = __ldg(reinterpret_cast<const uint32_t*>(p + 3 * (size_t)N));
  transpose4x4(w0, w1, w2, w3, out);
}

// 4 consecutive bf16 of x (8-byte aligned) as floats
__device__ __forceinline__ void load_x4(const uint16_t* x, float out[4]) {
  uint2 u = __ldg(reinterpret_cast<const uint2*>(x));
  out[0] = __uint_as_float(u.x << 16);
  out[1] = __uint_as_float(u.x & 0xFFFF0000u);
  out[2] = __uint_as_float(u.y << 16);
  out[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Per bit width: qs rows per pack group (ROWS), planes per qs row (PLANES),
// element distance between planes (STRIDE), qh rows per group (QH, 0: none).
template <int BITS> struct Fmt;
template <> struct Fmt<8> { static constexpr int ROWS = 256, PLANES = 1, STRIDE = 0, QH = 0; };
template <> struct Fmt<4> { static constexpr int ROWS = 128, PLANES = 2, STRIDE = 128, QH = 0; };
template <> struct Fmt<5> { static constexpr int ROWS = 128, PLANES = 2, STRIDE = 128, QH = 32; };
template <> struct Fmt<6> { static constexpr int ROWS = 128, PLANES = 2, STRIDE = 128, QH = 64; };
template <> struct Fmt<2> { static constexpr int ROWS = 64, PLANES = 4, STRIDE = 64, QH = 0; };
template <> struct Fmt<3> { static constexpr int ROWS = 64, PLANES = 4, STRIDE = 64, QH = 32; };

// The quant of plane i from qs byte b and qh byte h of one element row;
// j0 is the chunk's first qs row inside its pack group (a multiple of 16).
template <int BITS>
__device__ __forceinline__ int quant(uint32_t b, uint32_t h, int i, int j0) {
  if constexpr (BITS == 8) {
    return (int)(int8_t)(uint8_t)b;
  } else if constexpr (BITS == 4) {
    return (b >> (4 * i)) & 15;
  } else if constexpr (BITS == 5) {
    return ((b >> (4 * i)) & 15) | (((h >> (j0 / 32 + 4 * i)) & 1) << 4);
  } else if constexpr (BITS == 6) {
    return ((b >> (4 * i)) & 15) | (((h >> (2 * (j0 / 64 + 2 * i))) & 3) << 4);
  } else if constexpr (BITS == 2) {
    return (b >> (2 * i)) & 3;
  } else {
    return ((b >> (2 * i)) & 3) | (((h >> (j0 / 32 + 2 * i)) & 1) << 2);
  }
}

template <int BITS, int MT>
__global__ void __launch_bounds__(THREADS)
kmajor_kernel(const uint16_t* __restrict__ x, const uint8_t* __restrict__ qs,
              const uint8_t* __restrict__ qh, const float* __restrict__ scales,
              const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K,
              int G) {
  using F = Fmt<BITS>;
  __shared__ float red[KG][MT][TN];
  const int tx = threadIdx.x % (TN / 4);
  const int kg = threadIdx.x / (TN / 4);
  const int n0 = blockIdx.x * TN + tx * 4;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int nchunk = K / 256 * F::ROWS / CH;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int ch = kg; ch < nchunk; ch += KG) {
      const int row0 = ch * CH;           // first qs row of the chunk
      const int grp = row0 / F::ROWS;     // pack group
      const int j0 = row0 - grp * F::ROWS;
      const int e0 = grp * 256 + j0;      // element of plane 0, row 0
      const int hrow0 = F::QH ? grp * F::QH + j0 % (F::QH ? F::QH : 1) : 0;
      float s[F::PLANES][4], b[F::PLANES][4];
#pragma unroll
      for (int i = 0; i < F::PLANES; ++i) {
        const size_t g = (size_t)((e0 + i * F::STRIDE) / G) * N + n0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = scales[g + c];
          b[i][c] = bias ? bias[g + c] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < CH; r += 4) {
        uint32_t qcol[4], hcol[4] = {0u, 0u, 0u, 0u};
        load4x4(qs, row0 + r, N, n0, qcol);
        if constexpr (F::QH != 0) load4x4(qh, hrow0 + r, N, n0, hcol);
#pragma unroll
        for (int i = 0; i < F::PLANES; ++i) {
          const int e = e0 + i * F::STRIDE + r;
          float xv[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < rows) load_x4(x + (size_t)(m0 + m) * K + e, xv[m]);
            else xv[m][0] = xv[m][1] = xv[m][2] = xv[m][3] = 0.f;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int q = quant<BITS>((qcol[c] >> (8 * t)) & 0xFFu,
                                        (hcol[c] >> (8 * t)) & 0xFFu, i, j0);
              float w = __fmul_rn(s[i][c], (float)q);
              if (bias) w = __fsub_rn(w, b[i][c]);
              w = bf16_round(w);
#pragma unroll
              for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(w, xv[m][t], acc[m][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[kg][m][tx * 4 + c] = acc[m][c];
  __syncthreads();

  for (int i = threadIdx.x; i < MT * TN; i += THREADS) {
    const int m = i / TN, j = i % TN;
    const int n = blockIdx.x * TN + j;
    if (m >= rows || n >= N) continue;
    float sum = 0.f;
    for (int g = 0; g < KG; ++g) sum += red[g][m][j];
    out[(size_t)(m0 + m) * N + n] = sum;
  }
}

template <int BITS>
int launch(const uint16_t* x, const uint8_t* qs, const uint8_t* qh, const float* scales,
           const float* bias, float* out, int M, int N, int K, int G, cudaStream_t stream) {
  dim3 grid((N + TN - 1) / TN);
  if (M <= 1) {
    kmajor_kernel<BITS, 1><<<grid, THREADS, 0, stream>>>(x, qs, qh, scales, bias, out, M, N, K, G);
  } else if (M <= 4) {
    grid.y = (M + 3) / 4;
    kmajor_kernel<BITS, 4><<<grid, THREADS, 0, stream>>>(x, qs, qh, scales, bias, out, M, N, K, G);
  } else {
    grid.y = (M + 7) / 8;
    kmajor_kernel<BITS, 8><<<grid, THREADS, 0, stream>>>(x, qs, qh, scales, bias, out, M, N, K, G);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [M, K]; qs, qh (or null), scales, bias (null for Q8_0) as above;
// out f32 [M, N]. K % 256 == 0, N % 4 == 0, G in {16, 32}.
extern "C" int pi_kmajor_matmul(const void* x, const void* qs, const void* qh,
                                const void* scales, const void* bias, void* out, int M, int N,
                                int K, int bits, int G, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xx = static_cast<const uint16_t*>(x);
  auto q = static_cast<const uint8_t*>(qs);
  auto h = static_cast<const uint8_t*>(qh);
  auto sc = static_cast<const float*>(scales);
  auto bi = static_cast<const float*>(bias);
  auto o = static_cast<float*>(out);
  switch (bits) {
    case 8: return launch<8>(xx, q, h, sc, bi, o, M, N, K, G, s);
    case 6: return launch<6>(xx, q, h, sc, bi, o, M, N, K, G, s);
    case 5: return launch<5>(xx, q, h, sc, bi, o, M, N, K, G, s);
    case 4: return launch<4>(xx, q, h, sc, bi, o, M, N, K, G, s);
    case 3: return launch<3>(xx, q, h, sc, bi, o, M, N, K, G, s);
    case 2: return launch<2>(xx, q, h, sc, bi, o, M, N, K, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
