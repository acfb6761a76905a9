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
// is s * q rounded to bf16 (the bias is not folded into it), the product
// with x is exact in f32, sums are f32. The TPU kernel leaves the bias
// term to an XLA dot outside; here the chunk that starts each group
// subtracts its term into the partial sums, so the bias plane is read once
// by the kernel and no second launch is needed. Q8_0 has no bias (b and xg
// null).
//
// What bounds it on the H100: bytes -- 1 B/weight plus the scale and bias
// planes (8 B per group of G weights), read once at 3.35 TB/s. The design
// is qmatmul_kmajor.cu's with one plane of one element per row: one block
// per 32-column tile and up to MT rows of x; 256 threads = 8 column groups
// (4 columns, one 32-bit load each) x 32 K groups taking 16-row chunks
// round-robin; 4x4 byte transposes in registers; the 32 groups' sums meet
// in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 32;        // columns per block
constexpr int KG = 32;        // K groups per block
constexpr int CH = 16;        // rows per chunk (one scale group: G is 16 or 32)
constexpr int THREADS = 256;  // (TN / 4) * KG

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

__device__ __forceinline__ void load_x4(const uint16_t* x, float out[4]) {
  uint2 u = __ldg(reinterpret_cast<const uint2*>(x));
  out[0] = __uint_as_float(u.x << 16);
  out[1] = __uint_as_float(u.x & 0xFFFF0000u);
  out[2] = __uint_as_float(u.y << 16);
  out[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
i8_kernel(const uint16_t* __restrict__ x, const float* __restrict__ xg,
          const int8_t* __restrict__ qs, const float* __restrict__ scales,
          const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K, int G) {
  __shared__ float red[KG][MT][TN];
  const int tx = threadIdx.x % (TN / 4);
  const int kg = threadIdx.x / (TN / 4);
  const int n0 = blockIdx.x * TN + tx * 4;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int nchunk = K / CH;
  const int ngroups = K / G;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int ch = kg; ch < nchunk; ch += KG) {
      const int k0 = ch * CH;
      const int g = k0 / G;
      float s[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = scales[(size_t)g * N + n0 + c];
      if (bias && k0 % G == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float bb = bias[(size_t)g * N + n0 + c];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if (m < rows) acc[m][c] = fmaf(-xg[(size_t)(m0 + m) * ngroups + g], bb, acc[m][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < CH; r += 4) {
        const int8_t* w = qs + (size_t)(k0 + r) * N + n0;
        uint32_t w0 = __ldg(reinterpret_cast<const uint32_t*>(w));
        uint32_t w1 = __ldg(reinterpret_cast<const uint32_t*>(w + N));
        uint32_t w2 = __ldg(reinterpret_cast<const uint32_t*>(w + 2 * (size_t)N));
        uint32_t w3 = __ldg(reinterpret_cast<const uint32_t*>(w + 3 * (size_t)N));
        uint32_t col[4];
        transpose4x4(w0, w1, w2, w3, col);
        float xv[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < rows) load_x4(x + (size_t)(m0 + m) * K + k0 + r, xv[m]);
          else xv[m][0] = xv[m][1] = xv[m][2] = xv[m][3] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int q = (int)(int8_t)((col[c] >> (8 * t)) & 0xFFu);
            const float wv = __bfloat162float(__float2bfloat16_rn(__fmul_rn(s[c], (float)q)));
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(wv, xv[m][t], acc[m][c]);
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

}  // namespace

// x bf16 [M, K]; xg f32 [M, K/G] or null; qs s8 [K, N]; scales f32 [K/G, N];
// bias f32 [K/G, N] or null (null with xg); out f32 [M, N]. K % G == 0,
// G in {16, 32}, N % 4 == 0.
extern "C" int pi_i8_matmul(const void* x, const void* xg, const void* qs, const void* scales,
                            const void* bias, void* out, int M, int N, int K, int G,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xx = static_cast<const uint16_t*>(x);
  auto g = static_cast<const float*>(xg);
  auto q = static_cast<const int8_t*>(qs);
  auto sc = static_cast<const float*>(scales);
  auto bi = static_cast<const float*>(bias);
  auto o = static_cast<float*>(out);
  dim3 grid((N + TN - 1) / TN);
  if (M <= 1) {
    i8_kernel<1><<<grid, THREADS, 0, s>>>(xx, g, q, sc, bi, o, M, N, K, G);
  } else if (M <= 4) {
    grid.y = (M + 3) / 4;
    i8_kernel<4><<<grid, THREADS, 0, s>>>(xx, g, q, sc, bi, o, M, N, K, G);
  } else {
    grid.y = (M + 7) / 8;
    i8_kernel<8><<<grid, THREADS, 0, s>>>(xx, g, q, sc, bi, o, M, N, K, G);
  }
  return (int)cudaGetLastError();
}
