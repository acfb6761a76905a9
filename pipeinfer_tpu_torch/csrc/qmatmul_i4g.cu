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
// weights) read once at 3.35 TB/s. The design keeps enough of those bytes
// in flight on every SM, on the CUDA cores only:
// - a block is 8 warps over a 128-column tile: a warp's 32 threads take 4
//   adjacent columns each, so each of its loads reads 128 contiguous bytes
//   of one packed row;
// - split-K: the wrapper's plan (ops/qmatmul.py::i4g_plan) cuts the slabs
//   into `splits` ranges of whole slabs, so that the grid (row tiles x
//   column tiles x splits) fills the card's waves of resident blocks even
//   at N = 4096; in each slab of its range, warp w takes packed rows
//   [16 w, 16 w + 16) and starts all 16 of its word loads before it uses any;
// - the 4 x 4 byte blocks are transposed in registers with __byte_perm
//   into one word of 4 K values per column, the nibble planes split with
//   two masks, and __dp4a multiplies them with the s8 activations (two
//   16-byte loads per row, through the read-only cache);
// - a slab's integer sums are exact in s32; they are scaled by step * sx
//   (step read as one 16-byte load per half-slab) into f32 accumulators,
//   and the affine min term xsum * sx * wmin of the slab's two half-slabs
//   is added into the same accumulators by one warp of the block (warp
//   s % 8), inside the weight pass;
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

constexpr int CH = 16;           // packed rows a warp takes of each slab (KG * CH = 128)

struct Args {
  const int8_t* xq;      // [M, Kp]
  const float* xsum;     // [M, Kp/128]
  const float* sx;       // [Kp/128]
  const uint8_t* qs;     // [Kp/2, N]
  const float* step;     // [Kp/128, N]
  const float* wmin;     // [Kp/128, N]
  float* out;            // [M, N]
  int* tickets;          // [TICKETS], zero between calls; then f32 partials [splits, M, N]
  int M, N, Kp, slabs, splits;
};

template <int MT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) i4g_kernel(Args a) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int rt = blockIdx.x, ct = blockIdx.y, sp = blockIdx.z;
  const int n0 = ct * TN + lane * 4;
  const int m0 = rt * MT;
  const int rows = min(MT, a.M - m0);
  const int nhalf = a.Kp / 128;
  const int s0 = sp * a.slabs, s1 = min(a.Kp / 256, s0 + a.slabs);

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  if (n0 < a.N) {
    for (int s = s0; s < s1; ++s) {
      const uint8_t* wp = a.qs + (size_t)(s * 128 + w * CH) * a.N + n0;
      uint32_t q[CH];
#pragma unroll
      for (int r = 0; r < CH; ++r)
        q[r] = __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)r * a.N));
      const float4 stl = __ldg(reinterpret_cast<const float4*>(a.step + (size_t)(2 * s) * a.N + n0));
      const float4 sth =
          __ldg(reinterpret_cast<const float4*>(a.step + (size_t)(2 * s + 1) * a.N + n0));
      const float sxl = a.sx[2 * s], sxh = a.sx[2 * s + 1];
      const float sel[4] = {stl.x * sxl, stl.y * sxl, stl.z * sxl, stl.w * sxl};
      const float seh[4] = {sth.x * sxh, sth.y * sxh, sth.z * sxh, sth.w * sxh};

      uint32_t lo[CH / 4][4], hi[CH / 4][4];  // per column: 4 K values of each nibble plane
#pragma unroll
      for (int r4 = 0; r4 < CH / 4; ++r4) {
        uint32_t col[4];
        transpose4x4(q[4 * r4], q[4 * r4 + 1], q[4 * r4 + 2], q[4 * r4 + 3], col);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[r4][c] = col[c] & 0x0F0F0F0Fu;
          hi[r4][c] = (col[c] >> 4) & 0x0F0F0F0Fu;
        }
      }

      const int klo = s * 256 + w * CH;  // K row of this warp's first lo nibble; hi: + 128
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < rows) {
          const int8_t* xr = a.xq + (size_t)(m0 + m) * a.Kp;
          const int4 xl4 = __ldg(reinterpret_cast<const int4*>(xr + klo));
          const int4 xh4 = __ldg(reinterpret_cast<const int4*>(xr + klo + 128));
          const int xl[4] = {xl4.x, xl4.y, xl4.z, xl4.w}, xh[4] = {xh4.x, xh4.y, xh4.z, xh4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            int il = 0, ih = 0;
#pragma unroll
            for (int r4 = 0; r4 < CH / 4; ++r4) {
              il = __dp4a((int)lo[r4][c], xl[r4], il);
              ih = __dp4a((int)hi[r4][c], xh[r4], ih);
            }
            acc[m][c] += (float)il * sel[c];
            acc[m][c] += (float)ih * seh[c];
          }
        }
      }

      if (s % KG == w) {  // the min terms of the slab's two half-slabs, once per block
        const float4 ml = __ldg(reinterpret_cast<const float4*>(a.wmin + (size_t)(2 * s) * a.N + n0));
        const float4 mh =
            __ldg(reinterpret_cast<const float4*>(a.wmin + (size_t)(2 * s + 1) * a.N + n0));
        const float wl[4] = {ml.x * sxl, ml.y * sxl, ml.z * sxl, ml.w * sxl};
        const float wh[4] = {mh.x * sxh, mh.y * sxh, mh.z * sxh, mh.w * sxh};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < rows) {
            const float gl = a.xsum[(size_t)(m0 + m) * nhalf + 2 * s];
            const float gh = a.xsum[(size_t)(m0 + m) * nhalf + 2 * s + 1];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[m][c] += gl * wl[c];
              acc[m][c] += gh * wh[c];
            }
          }
        }
      }
    }
  }

  split_merge::finish<MT>(acc, a.out, a.tickets, a.M, a.N, m0, rows, a.splits);
}

}  // namespace

// xq s8 [M, Kp]; xsum f32 [M, Kp/128]; sx f32 [Kp/128]; qs u8 [Kp/2, N];
// step, wmin f32 [Kp/128, N]; out f32 [M, N]; scratch: TICKETS int32
// counters (zero on entry, left zero) followed by f32 partials
// [splits, M, N], or null for one split. Kp % 256 == 0, N % 4 == 0; xq,
// step and wmin 16-byte aligned. The cut (rows of x per block in {1, 4, 8},
// slabs per split, splits) comes from the wrapper's plan; returns the launch
// error (cudaErrorInvalidValue for a cut the kernel does not take).
extern "C" int pi_i4g_matmul(const void* xq, const void* xsum, const void* sx,
                             const void* qs, const void* step, const void* wmin,
                             void* out, void* scratch, int M, int N, int Kp, int rows,
                             int slabs, int splits, void* stream) {
  if (Kp % 256) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int8_t*>(xq), static_cast<const float*>(xsum),
         static_cast<const float*>(sx),  static_cast<const uint8_t*>(qs),
         static_cast<const float*>(step), static_cast<const float*>(wmin),
         static_cast<float*>(out),       static_cast<int*>(scratch),
         M, N, Kp, slabs, splits};
  return split_merge::launch<Args>(i4g_kernel<1>, i4g_kernel<4>, i4g_kernel<8>, a, M, N, rows,
                                   Kp / 256, slabs, splits, scratch, stream);
}
