// The frame and split-K merge shared by the i4g, i8g, i8, k_major and k4
// kernels (qmatmul_i4g.cu, qmatmul_i8g.cu, qmatmul_i8.cu,
// qmatmul_kmajor.cu, qmatmul_k4.cu).
//
// A block is KG warps over a TN-column tile; a lane takes 4 adjacent
// columns, so a warp's word load is one 128-byte line of one weight row.
// The wrapper's plan (ops/qmatmul.py::_split_cut) cuts K into `splits`
// ranges of whole units (slabs or chunks); the grid is (row tiles, column
// tiles, splits). Each warp ends with MT x 4 f32 sums, and `finish` sums
// the KG warps through shared memory in warp order. With one split the
// block writes the output. Otherwise it writes an f32 partial [M, N] tile
// for its split, takes a ticket (an atomic add on one counter per row and
// column tile), and the block that takes the last ticket sums the splits'
// partials in split order and sets the counter back to zero. No atomics
// touch the output: calls on the same inputs are bitwise equal. The five
// kernels share one scratch buffer per stream (TICKETS counters, which
// each leaves at zero, then the partials), and tests/test_torch_split_
// merge.py holds the constants below to their Python mirrors.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace split_merge {

constexpr int TN = 128;          // columns per block (I4G_TN in ops/qmatmul.py)
constexpr int KG = 8;            // warps per block, each a K group
constexpr int THREADS = KG * 32;
constexpr int BLOCKS_PER_SM = 2; // I4G_BLOCKS_PER_SM: resident blocks the plans count
constexpr int TICKETS = 4096;    // I4G_TICKETS: counters at the head of the scratch buffer

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

// Every thread of the block calls this once, after its K range: acc holds
// this lane's sums of rows m0 .. m0 + MT - 1 (rows of them live) at
// columns ct * TN + 4 * lane + c. tickets: the scratch buffer, or null
// with one split.
template <int MT>
__device__ __forceinline__ void finish(const float (&acc)[MT][4], float* out, int* tickets,
                                       int M, int N, int m0, int rows, int splits) {
  __shared__ float red[KG][MT][TN];
  __shared__ bool last_s;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int rt = blockIdx.x, ct = blockIdx.y, sp = blockIdx.z;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[w][m][lane * 4 + c] = acc[m][c];
  __syncthreads();

  float* part = reinterpret_cast<float*>(tickets + TICKETS);
  for (int i = threadIdx.x; i < MT * TN; i += THREADS) {
    const int m = i / TN, j = i % TN;
    const int n = ct * TN + j;
    if (m >= rows || n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < KG; ++g) sum += red[g][m][j];
    if (splits == 1)
      out[(size_t)(m0 + m) * N + n] = sum;
    else
      part[((size_t)sp * M + m0 + m) * N + n] = sum;
  }
  if (splits == 1) return;

  // The last block of this (row tile, column tile) to finish sums the splits.
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  int* ticket = tickets + rt * gridDim.y + ct;
  if (threadIdx.x == 0) last_s = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;  // zero again for the next call
  for (int i = threadIdx.x; i < MT * TN; i += THREADS) {
    const int m = i / TN, j = i % TN;
    const int n = ct * TN + j;
    if (m >= rows || n >= N) continue;
    const float* p = part + (size_t)(m0 + m) * N + n;
    const size_t stride = (size_t)M * N;
    float sum = 0.f;
    for (int k = 0; k < splits; ++k) sum += __ldcg(p + k * stride);  // in split order
    out[(size_t)(m0 + m) * N + n] = sum;
  }
}

// Launch kernel k1, k4 or k8 (rows of x per block 1, 4 or 8) over the
// grid of this cut of `units` K units into `splits` ranges of `per`, with
// `smem` bytes of dynamic shared memory a block; returns the launch error,
// or cudaErrorInvalidValue for a cut the kernels do not take.
template <class Args>
int launch(void (*k1)(Args), void (*k4)(Args), void (*k8)(Args), const Args& a, int M, int N,
           int rows, int units, int per, int splits, const void* scratch, void* stream,
           int smem = 0) {
  void (*kernel)(Args) = rows == 1 ? k1 : rows == 4 ? k4 : rows == 8 ? k8 : nullptr;
  if (kernel == nullptr || M <= 0 || N % 4 || per <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int row_tiles = (M + rows - 1) / rows, col_tiles = (N + TN - 1) / TN;
  if ((splits - 1) * per >= units || splits * per < units ||
      (splits > 1 && (scratch == nullptr || row_tiles * col_tiles > TICKETS)))
    return (int)cudaErrorInvalidValue;
  dim3 grid(row_tiles, col_tiles, splits);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace split_merge
