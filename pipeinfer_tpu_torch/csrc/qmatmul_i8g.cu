// i8g quantized matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel pipeinfer_tpu/ops/qmatmul.py::_i8g_kernel
// (wrapper _qmm_i8g_pallas). Computes, for x quantized to s8 per 512-row
// slab s with one scale sx[s] shared by all rows:
//
//   out[m, n] = sum_s sx[s] * sw[s, n] * sum_{k in s} xq[m, k] * qs[k, n]
//
// What bounds it on the H100: bytes. At decode M (1..33) each s8 weight is
// used M times, far below the ~295 operations per byte where compute would
// bind, so the floor is qs (1 B/weight) plus sw (4 B per 512 weights) read
// once at 3.35 TB/s. The design is the i4g kernel's (qmatmul_i4g.cu)
// without the nibble split or the min term, and keeps enough of those
// bytes in flight on every SM, on the CUDA cores only:
// - a block is 8 warps over a 128-column tile: a warp's 32 threads take 4
//   adjacent columns each, so each of its loads reads one 128-byte line of
//   one s8 row;
// - K is walked in 128-row chunks, four to a slab. Split-K: the wrapper's
//   plan (ops/qmatmul.py::i8g_plan) cuts the chunks into `splits` ranges of
//   whole chunks, so that the grid (row tiles x column tiles x splits)
//   fills the card's waves of resident blocks even at N = 4096; in each
//   chunk of its range, warp w takes rows [16 w, 16 w + 16) and issues all
//   16 of its word loads together;
// - the loads of the next chunk fly while the warp sums this one: the warp
//   transposes this chunk's words, loads its x rows (one 16-byte load per
//   row), and only then issues the next chunk's 16 loads into the same
//   registers (x loaded after them was measured to wait behind them), so
//   the stream does not stop while 8 rows of x are summed;
// - the 4 x 4 byte blocks are transposed in registers with __byte_perm
//   into one word of 4 K values per column, and __dp4a multiplies them with
//   the s8 activations;
// - a chunk's integer sums are exact in s32; they are scaled by sw * sx of
//   the chunk's slab (sw read as one 16-byte load per slab) into f32
//   accumulators;
// - the 8 warps meet in warp order and the splits in split order, through
//   the merge the i4g, i8g and i8 kernels share (split_merge.cuh): no
//   atomics touch the output, so calls on the same inputs are bitwise equal.
// Out of scope here: tensor-core MMA, TMA staging, and activation
// quantization inside the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_merge.cuh"

namespace {

using split_merge::BLOCKS_PER_SM;
using split_merge::KG;
using split_merge::THREADS;
using split_merge::TN;
using split_merge::transpose4x4;

constexpr int CH = 16;           // rows a warp takes of each chunk
constexpr int CHUNK = KG * CH;   // K rows per chunk (I8G_CHUNK in ops/qmatmul.py)
constexpr int SLAB = 512;        // K rows sharing one scale

struct Args {
  const int8_t* xq;      // [M, Kp]
  const float* sx;       // [Kp/512]
  const int8_t* qs;      // [Kp, N]
  const float* sw;       // [Kp/512, N]
  float* out;            // [M, N]
  int* tickets;          // [TICKETS], zero between calls; then f32 partials [splits, M, N]
  int M, N, Kp, chunks, splits;
};

template <int MT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) i8g_kernel(Args a) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int rt = blockIdx.x, ct = blockIdx.y, sp = blockIdx.z;
  const int n0 = ct * TN + lane * 4;
  const int m0 = rt * MT;
  const int rows = min(MT, a.M - m0);
  const int c0 = sp * a.chunks, c1 = min(a.Kp / CHUNK, c0 + a.chunks);

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  if (n0 < a.N) {
    const int8_t* wp = a.qs + (size_t)(w * CH) * a.N + n0;  // this warp's rows of chunk 0
    const size_t chunk_step = (size_t)CHUNK * a.N;
    uint32_t q[CH];
#pragma unroll
    for (int r = 0; r < CH; ++r)
      q[r] = __ldg(reinterpret_cast<const uint32_t*>(wp + c0 * chunk_step + (size_t)r * a.N));
    float se[4];
    for (int ch = c0; ch < c1; ++ch) {
      uint32_t col[CH / 4][4];  // per column: 4 K values of rows 4 r4 .. 4 r4 + 3
#pragma unroll
      for (int r4 = 0; r4 < CH / 4; ++r4)
        transpose4x4(q[4 * r4], q[4 * r4 + 1], q[4 * r4 + 2], q[4 * r4 + 3], col[r4]);
      if (ch == c0 || ch % (SLAB / CHUNK) == 0) {  // a new slab: its scale per column
        const int s = ch / (SLAB / CHUNK);
        const float4 sw4 = __ldg(reinterpret_cast<const float4*>(a.sw + (size_t)s * a.N + n0));
        const float sxs = a.sx[s];
        se[0] = sw4.x * sxs;
        se[1] = sw4.y * sxs;
        se[2] = sw4.z * sxs;
        se[3] = sw4.w * sxs;
      }
      const int k0 = ch * CHUNK + w * CH;  // this warp's first K row of the chunk
      int4 x4[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < rows)
          x4[m] = __ldg(reinterpret_cast<const int4*>(a.xq + (size_t)(m0 + m) * a.Kp + k0));
      if (ch + 1 < c1) {  // the next chunk's 16 loads fly while this one is summed
#pragma unroll
        for (int r = 0; r < CH; ++r)
          q[r] = __ldg(reinterpret_cast<const uint32_t*>(wp + (ch + 1) * chunk_step +
                                                         (size_t)r * a.N));
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < rows) {
          const int xv[4] = {x4[m].x, x4[m].y, x4[m].z, x4[m].w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            int is = 0;
#pragma unroll
            for (int r4 = 0; r4 < CH / 4; ++r4) is = __dp4a((int)col[r4][c], xv[r4], is);
            acc[m][c] += (float)is * se[c];
          }
        }
      }
    }
  }

  split_merge::finish<MT>(acc, a.out, a.tickets, a.M, a.N, m0, rows, a.splits);
}

}  // namespace

// xq s8 [M, Kp]; sx f32 [Kp/512]; qs s8 [Kp, N]; sw f32 [Kp/512, N];
// out f32 [M, N]; scratch: TICKETS int32 counters (zero on entry, left
// zero) followed by f32 partials [splits, M, N], or null for one split.
// Kp % 512 == 0, N % 4 == 0; xq and sw 16-byte aligned, qs 4-byte aligned.
// The cut (rows of x per block in {1, 4, 8}, 128-row chunks per split,
// splits) comes from the wrapper's plan; returns the launch error
// (cudaErrorInvalidValue for a cut the kernel does not take).
extern "C" int pi_i8g_matmul(const void* xq, const void* sx, const void* qs, const void* sw,
                             void* out, void* scratch, int M, int N, int Kp, int rows,
                             int chunks, int splits, void* stream) {
  if (Kp % SLAB) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
         static_cast<const int8_t*>(qs), static_cast<const float*>(sw),
         static_cast<float*>(out),       static_cast<int*>(scratch),
         M, N, Kp, chunks, splits};
  return split_merge::launch<Args>(i8g_kernel<1>, i8g_kernel<4>, i8g_kernel<8>, a, M, N, rows,
                                   Kp / CHUNK, chunks, splits, scratch, stream);
}
