// i8g quantized matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel pipeinfer_tpu/ops/qmatmul.py::_i8g_kernel
// (wrapper _qmm_i8g_pallas). Computes, for x quantized to s8 per 512-row
// slab s with one scale sx[s] shared by all rows:
//
//   out[m, n] = sum_s sx[s] * sw[s, n] * sum_{k in s} xq[m, k] * qs[k, n]
//
// What bounds it on the H100: bytes. At decode M each s8 weight (1 B, plus
// 4 B of sw per 512 weights) is used M times, far below the operations per
// byte where compute would bind; the floor is one pass over the planes at
// 3.35 TB/s. The design is the i4g kernel's without the nibble split:
// one block per 32-column tile and up to MT rows of x, 256 threads = 8
// column groups x 32 K groups, K cut into 32-row chunks (16 per slab) dealt
// round-robin to the K groups, 4x4 byte transposes (__byte_perm) feeding
// __dp4a, and each chunk's exact integer sums scaled by sw * sx on the
// output side before the K groups are summed through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 32;
constexpr int KG = 32;
constexpr int CH = 32;
constexpr int SLAB = 512;
constexpr int THREADS = 256;

__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2,
                                             uint32_t r3, uint32_t out[4]) {
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
i8g_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
           const int8_t* __restrict__ qs, const float* __restrict__ sw,
           float* __restrict__ out, int M, int N, int Kp) {
  __shared__ float red[KG][MT][TN];
  const int tx = threadIdx.x % (TN / 4);
  const int kg = threadIdx.x / (TN / 4);
  const int n0 = blockIdx.x * TN + tx * 4;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int nchunk = Kp / CH;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int ch = kg; ch < nchunk; ch += KG) {
      const int k0 = ch * CH;
      const int slab = k0 / SLAB;
      int isum[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) isum[m][c] = 0;
#pragma unroll 4
      for (int r = 0; r < CH; r += 4) {
        const int8_t* w = qs + (size_t)(k0 + r) * N + n0;
        uint32_t w0 = __ldg(reinterpret_cast<const uint32_t*>(w));
        uint32_t w1 = __ldg(reinterpret_cast<const uint32_t*>(w + N));
        uint32_t w2 = __ldg(reinterpret_cast<const uint32_t*>(w + 2 * (size_t)N));
        uint32_t w3 = __ldg(reinterpret_cast<const uint32_t*>(w + 3 * (size_t)N));
        uint32_t col[4];
        transpose4x4(w0, w1, w2, w3, col);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < rows) {
            int xv = __ldg(reinterpret_cast<const int*>(xq + (size_t)(m0 + m) * Kp + k0 + r));
#pragma unroll
            for (int c = 0; c < 4; ++c) isum[m][c] = __dp4a((int)col[c], xv, isum[m][c]);
          }
        }
      }
      const float sxs = sx[slab];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float se = sw[(size_t)slab * N + n0 + c] * sxs;
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][c] += (float)isum[m][c] * se;
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
    out[(size_t)(m0 + m) * N + n] = s;
  }
}

template <int MT>
void launch(const int8_t* xq, const float* sx, const int8_t* qs, const float* sw, float* out,
            int M, int N, int Kp, cudaStream_t stream) {
  dim3 grid((N + TN - 1) / TN, (M + MT - 1) / MT);
  i8g_kernel<MT><<<grid, THREADS, 0, stream>>>(xq, sx, qs, sw, out, M, N, Kp);
}

}  // namespace

// xq s8 [M, Kp]; sx f32 [Kp/512]; qs s8 [Kp, N]; sw f32 [Kp/512, N];
// out f32 [M, N]. Kp % 512 == 0, N % 4 == 0.
extern "C" int pi_i8g_matmul(const void* xq, const void* sx, const void* qs, const void* sw,
                             void* out, int M, int N, int Kp, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int8_t*>(xq);
  auto b = static_cast<const float*>(sx);
  auto w = static_cast<const int8_t*>(qs);
  auto c = static_cast<const float*>(sw);
  auto o = static_cast<float*>(out);
  if (M <= 1) launch<1>(a, b, w, c, o, M, N, Kp, s);
  else if (M <= 4) launch<4>(a, b, w, c, o, M, N, Kp, s);
  else launch<8>(a, b, w, c, o, M, N, Kp, s);
  return (int)cudaGetLastError();
}
