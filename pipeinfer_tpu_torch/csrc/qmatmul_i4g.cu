// i4g quantized matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel pipeinfer_tpu/ops/qmatmul.py::_i4g_kernel
// (wrapper _qmm_i4g_pallas). Computes, for x quantized to s8 per 128-row
// half-slab g with one scale sx[g] shared by all rows:
//
//   out[m, n] = sum_g sx[g] * (step[g, n] * sum_{k in g} xq[m, k] * u[k, n]
//                              + wmin[g, n] * xsum[m, g])
//
// where u in [0, 15] is nibble-packed per 256-row slab: byte p of slab s
// (qs row s*128 + p) holds K row s*256 + p in its low nibble and
// s*256 + 128 + p in its high nibble.
//
// What bounds it on the H100: bytes. At decode M (1..33) each weight is used
// M times, far below the ~295 operations per byte where compute would bind,
// so the floor is qs (0.5 B/weight) plus step and wmin (8 B per 128
// weights) read once at 3.35 TB/s. The design streams every byte once:
// - one block per 32-column tile (and up to MT rows of x); N = 32000 gives
//   1000 blocks, N = 4096 gives 128, so every SM has work without any
//   cross-block reduction;
// - 256 threads = 8 column groups (4 columns each, one 32-bit load covers
//   them) x 32 K groups; K is cut into 32-packed-row chunks dealt round-robin
//   to the K groups, each chunk lying inside one slab;
// - four 32-bit loads (4 packed rows x 4 columns) are transposed in
//   registers with __byte_perm into one word of 4 K values per column, the
//   nibble planes are split with two masks, and __dp4a multiplies them with
//   the s8 activations (read through the read-only cache: every K group of
//   a block reads the same x);
// - a chunk's integer sums are exact; they are scaled by step * sx on the
//   output side into f32 accumulators, the 32 K groups are summed through
//   shared memory, and the affine min term is added in the epilogue.
// A later version would stage tiles with TMA and use the s8 tensor cores;
// this one is the simple, exact first kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 32;       // columns per block
constexpr int KG = 32;       // K groups per block
constexpr int CH = 32;       // packed rows per chunk
constexpr int THREADS = 256; // (TN / 4) * KG

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

template <int MT>
__global__ void __launch_bounds__(THREADS)
i4g_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xsum,
           const float* __restrict__ sx, const uint8_t* __restrict__ qs,
           const float* __restrict__ step, const float* __restrict__ wmin,
           float* __restrict__ out, int M, int N, int Kp) {
  __shared__ float red[KG][MT][TN];
  const int tx = threadIdx.x % (TN / 4);
  const int kg = threadIdx.x / (TN / 4);
  const int n0 = blockIdx.x * TN + tx * 4;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int nchunk = Kp / 2 / CH;
  const int nhalf = Kp / 128;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int ch = kg; ch < nchunk; ch += KG) {
      const int p0 = ch * CH;          // first packed row of the chunk
      const int slab = p0 / 128;
      const int klo = slab * 256 + (p0 - slab * 128);
      const int khi = klo + 128;
      int ilo[MT][4], ihi[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) { ilo[m][c] = 0; ihi[m][c] = 0; }
#pragma unroll 4
      for (int r = 0; r < CH; r += 4) {
        const uint8_t* w = qs + (size_t)(p0 + r) * N + n0;
        uint32_t w0 = __ldg(reinterpret_cast<const uint32_t*>(w));
        uint32_t w1 = __ldg(reinterpret_cast<const uint32_t*>(w + N));
        uint32_t w2 = __ldg(reinterpret_cast<const uint32_t*>(w + 2 * (size_t)N));
        uint32_t w3 = __ldg(reinterpret_cast<const uint32_t*>(w + 3 * (size_t)N));
        uint32_t col[4];
        transpose4x4(w0, w1, w2, w3, col);
        int lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = (int)(col[c] & 0x0F0F0F0Fu);
          hi[c] = (int)((col[c] >> 4) & 0x0F0F0F0Fu);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < rows) {
            const int8_t* xr = xq + (size_t)(m0 + m) * Kp;
            int xl = __ldg(reinterpret_cast<const int*>(xr + klo + r));
            int xh = __ldg(reinterpret_cast<const int*>(xr + khi + r));
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              ilo[m][c] = __dp4a(lo[c], xl, ilo[m][c]);
              ihi[m][c] = __dp4a(hi[c], xh, ihi[m][c]);
            }
          }
        }
      }
      const float sxl = sx[2 * slab], sxh = sx[2 * slab + 1];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float sel = step[(size_t)(2 * slab) * N + n0 + c] * sxl;
        const float seh = step[(size_t)(2 * slab + 1) * N + n0 + c] * sxh;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          acc[m][c] += (float)ilo[m][c] * sel;
          acc[m][c] += (float)ihi[m][c] * seh;
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
    float s = 0.f;
    for (int g = 0; g < KG; ++g) s += red[g][m][j];
    float mn = 0.f;
    const float* xs = xsum + (size_t)(m0 + m) * nhalf;
    for (int g = 0; g < nhalf; ++g) mn += xs[g] * (wmin[(size_t)g * N + n] * sx[g]);
    out[(size_t)(m0 + m) * N + n] = s + mn;
  }
}

template <int MT>
void launch(const int8_t* xq, const float* xsum, const float* sx, const uint8_t* qs,
            const float* step, const float* wmin, float* out, int M, int N, int Kp,
            cudaStream_t stream) {
  dim3 grid((N + TN - 1) / TN, (M + MT - 1) / MT);
  i4g_kernel<MT><<<grid, THREADS, 0, stream>>>(xq, xsum, sx, qs, step, wmin, out, M, N, Kp);
}

}  // namespace

// xq s8 [M, Kp]; xsum f32 [M, Kp/128]; sx f32 [Kp/128]; qs u8 [Kp/2, N];
// step, wmin f32 [Kp/128, N]; out f32 [M, N]. Kp % 256 == 0, N % 4 == 0.
extern "C" int pi_i4g_matmul(const void* xq, const void* xsum, const void* sx,
                             const void* qs, const void* step, const void* wmin,
                             void* out, int M, int N, int Kp, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int8_t*>(xq);
  auto b = static_cast<const float*>(xsum);
  auto c = static_cast<const float*>(sx);
  auto w = static_cast<const uint8_t*>(qs);
  auto st = static_cast<const float*>(step);
  auto mn = static_cast<const float*>(wmin);
  auto o = static_cast<float*>(out);
  if (M <= 1) launch<1>(a, b, c, w, st, mn, o, M, N, Kp, s);
  else if (M <= 4) launch<4>(a, b, c, w, st, mn, o, M, N, Kp, s);
  else launch<8>(a, b, c, w, st, mn, o, M, N, Kp, s);
  return (int)cudaGetLastError();
}
