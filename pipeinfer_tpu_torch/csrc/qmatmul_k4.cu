// k4 quantized matmul for Hopper (sm_90a): the packed nibble plane of a
// 4-bit format, its lo and hi nibbles taken as two K-halves.
//
// Replaces the Pallas kernel pipeinfer_tpu/ops/qmatmul.py::_k4_kernel
// (wrapper _qmm_k4_pallas). Byte row p of the plane qs u8 [r2, N] holds
// element kl(p) = (p / 128) * 256 + p % 128 in its low nibble and
// kh(p) = kl(p) + 128 in its high nibble; plane row p takes scale and bias
// row p / 32 of its plane (s_lo, b_lo and s_hi, b_hi, f32 [r2/32, N]).
// Computes
//
//   out[m, n] = sum_p x[m, kl(p)] * bf16(s_lo[p/32, n] * lo(p, n))
//                   + x[m, kh(p)] * bf16(s_hi[p/32, n] * hi(p, n))
//               - sum_g (xg[m, gl(g)] * b_lo[g, n] + xg[m, gh(g)] * b_hi[g, n])
//
// over p < K/2 and plane groups g < K/64, with x bf16 [M, K] in natural
// order and xg f32 [M, K/32] its natural group sums (gl(g) = (g / 4) * 8 +
// g % 4, gh(g) = gl(g) + 4). As on the TPU the weight is s * q rounded to
// bf16 and the bias term is separate, in f32; here the chunk that starts
// each plane group subtracts its term, so the bias planes are read once by
// the kernel. Reading x at kl(p) and kh(p) directly spares the re-ordering
// of x into plane order that the TPU wrapper does.
//
// What bounds it on the H100: bytes -- 0.5 B/weight plus 8 B per 32
// weights of scale and bias, read once at 3.35 TB/s. The design is
// qmatmul_kmajor.cu's for two planes: one block per 32-column tile and up
// to MT rows of x; 256 threads = 8 column groups (4 columns, one 32-bit
// load each) x 32 K groups taking 16-row chunks of the byte plane
// round-robin; 4x4 byte transposes in registers; the 32 groups' sums meet
// in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 32;        // columns per block
constexpr int KG = 32;        // K groups per block
constexpr int CH = 16;        // byte-plane rows per chunk
constexpr int PG = 32;        // byte-plane rows per scale row
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

__device__ __forceinline__ float bf16_scaled(float s, uint32_t q) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(s, (float)q)));
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
k4_kernel(const uint16_t* __restrict__ x, const float* __restrict__ xg,
          const uint8_t* __restrict__ qs, const float* __restrict__ s_lo,
          const float* __restrict__ s_hi, const float* __restrict__ b_lo,
          const float* __restrict__ b_hi, float* __restrict__ out, int M, int N, int K) {
  __shared__ float red[KG][MT][TN];
  const int tx = threadIdx.x % (TN / 4);
  const int kg = threadIdx.x / (TN / 4);
  const int n0 = blockIdx.x * TN + tx * 4;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int nchunk = K / 2 / CH;
  const int ngroups = K / 32;  // natural groups of x (the columns of xg)

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int ch = kg; ch < nchunk; ch += KG) {
      const int p0 = ch * CH;
      const int sr = p0 / PG;                       // scale row of both planes
      const int klo = (p0 / 128) * 256 + p0 % 128;  // element of byte row p0, lo
      const int khi = klo + 128;
      float sl[4], sh[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sl[c] = s_lo[(size_t)sr * N + n0 + c];
        sh[c] = s_hi[(size_t)sr * N + n0 + c];
      }
      if (p0 % PG == 0) {
        const int gl = klo / 32, gh = khi / 32;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float bl = b_lo[(size_t)sr * N + n0 + c];
          const float bh = b_hi[(size_t)sr * N + n0 + c];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < rows) {
              const float* g = xg + (size_t)(m0 + m) * ngroups;
              acc[m][c] = fmaf(-g[gl], bl, acc[m][c]);
              acc[m][c] = fmaf(-g[gh], bh, acc[m][c]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < CH; r += 4) {
        const uint8_t* w = qs + (size_t)(p0 + r) * N + n0;
        uint32_t w0 = __ldg(reinterpret_cast<const uint32_t*>(w));
        uint32_t w1 = __ldg(reinterpret_cast<const uint32_t*>(w + N));
        uint32_t w2 = __ldg(reinterpret_cast<const uint32_t*>(w + 2 * (size_t)N));
        uint32_t w3 = __ldg(reinterpret_cast<const uint32_t*>(w + 3 * (size_t)N));
        uint32_t col[4];
        transpose4x4(w0, w1, w2, w3, col);
        float xl[MT][4], xh[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < rows) {
            load_x4(x + (size_t)(m0 + m) * K + klo + r, xl[m]);
            load_x4(x + (size_t)(m0 + m) * K + khi + r, xh[m]);
          } else {
#pragma unroll
            for (int t = 0; t < 4; ++t) xl[m][t] = xh[m][t] = 0.f;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const uint32_t byte = (col[c] >> (8 * t)) & 0xFFu;
            const float wl = bf16_scaled(sl[c], byte & 15u);
            const float wh = bf16_scaled(sh[c], byte >> 4);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              acc[m][c] = fmaf(wl, xl[m][t], acc[m][c]);
              acc[m][c] = fmaf(wh, xh[m][t], acc[m][c]);
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

}  // namespace

// x bf16 [M, K]; xg f32 [M, K/32]; qs u8 [r2, N]; s_lo, s_hi, b_lo, b_hi
// f32 [r2/32, N]; out f32 [M, N]. K % 256 == 0, r2 >= K/2, N % 4 == 0.
extern "C" int pi_k4_matmul(const void* x, const void* xg, const void* qs, const void* s_lo,
                            const void* s_hi, const void* b_lo, const void* b_hi, void* out,
                            int M, int N, int K, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xx = static_cast<const uint16_t*>(x);
  auto g = static_cast<const float*>(xg);
  auto q = static_cast<const uint8_t*>(qs);
  auto sl = static_cast<const float*>(s_lo);
  auto sh = static_cast<const float*>(s_hi);
  auto bl = static_cast<const float*>(b_lo);
  auto bh = static_cast<const float*>(b_hi);
  auto o = static_cast<float*>(out);
  dim3 grid((N + TN - 1) / TN);
  if (M <= 1) {
    k4_kernel<1><<<grid, THREADS, 0, s>>>(xx, g, q, sl, sh, bl, bh, o, M, N, K);
  } else if (M <= 4) {
    grid.y = (M + 3) / 4;
    k4_kernel<4><<<grid, THREADS, 0, s>>>(xx, g, q, sl, sh, bl, bh, o, M, N, K);
  } else {
    grid.y = (M + 7) / 8;
    k4_kernel<8><<<grid, THREADS, 0, s>>>(xx, g, q, sl, sh, bl, bh, o, M, N, K);
  }
  return (int)cudaGetLastError();
}
