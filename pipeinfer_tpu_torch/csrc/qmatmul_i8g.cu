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
// - the 8 warps are summed through shared memory in warp order. With one
//   split the block writes the output. Otherwise it writes an f32 partial
//   [M, N] tile for its split, takes a ticket (an atomic add on one counter
//   per row and column tile), and the block that takes the last ticket sums
//   the splits' partials in split order and sets the counter back to zero.
//   No atomics touch the output: calls on the same inputs are bitwise equal.
// Out of scope here: tensor-core MMA, TMA staging, and activation
// quantization inside the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;          // columns per block
constexpr int KG = 8;            // warps per block, each a K group
constexpr int CH = 16;           // rows a warp takes of each chunk
constexpr int CHUNK = KG * CH;   // K rows per chunk (I8G_CHUNK in ops/qmatmul.py)
constexpr int SLAB = 512;        // K rows sharing one scale
constexpr int THREADS = KG * 32;
constexpr int BLOCKS_PER_SM = 2; // I4G_BLOCKS_PER_SM in ops/qmatmul.py
constexpr int TICKETS = 4096;    // I4G_TICKETS: counters at the head of the scratch buffer

struct Args {
  const int8_t* xq;      // [M, Kp]
  const float* sx;       // [Kp/512]
  const int8_t* qs;      // [Kp, N]
  const float* sw;       // [Kp/512, N]
  float* out;            // [M, N]
  int* tickets;          // [TICKETS], zero between calls; then f32 partials [splits, M, N]
  int M, N, Kp, chunks, splits;
};

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
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) i8g_kernel(Args a) {
  __shared__ float red[KG][MT][TN];
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

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[w][m][lane * 4 + c] = acc[m][c];
  __syncthreads();

  float* part = reinterpret_cast<float*>(a.tickets + TICKETS);
  for (int i = threadIdx.x; i < MT * TN; i += THREADS) {
    const int m = i / TN, j = i % TN;
    const int n = ct * TN + j;
    if (m >= rows || n >= a.N) continue;
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < KG; ++g) sum += red[g][m][j];
    if (a.splits == 1)
      a.out[(size_t)(m0 + m) * a.N + n] = sum;
    else
      part[((size_t)sp * a.M + m0 + m) * a.N + n] = sum;
  }
  if (a.splits == 1) return;

  // The last block of this (row tile, column tile) to finish sums the splits.
  __shared__ bool last_s;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  int* ticket = a.tickets + rt * gridDim.y + ct;
  if (threadIdx.x == 0) last_s = atomicAdd(ticket, 1) == a.splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;  // zero again for the next call
  for (int i = threadIdx.x; i < MT * TN; i += THREADS) {
    const int m = i / TN, j = i % TN;
    const int n = ct * TN + j;
    if (m >= rows || n >= a.N) continue;
    const float* p = part + (size_t)(m0 + m) * a.N + n;
    const size_t stride = (size_t)a.M * a.N;
    float sum = 0.f;
    for (int k = 0; k < a.splits; ++k) sum += __ldcg(p + k * stride);  // in split order
    a.out[(size_t)(m0 + m) * a.N + n] = sum;
  }
}

template <int MT>
void launch(const Args& a, cudaStream_t stream) {
  dim3 grid((a.M + MT - 1) / MT, (a.N + TN - 1) / TN, a.splits);
  i8g_kernel<MT><<<grid, THREADS, 0, stream>>>(a);
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
  const int nchunk = Kp / CHUNK;
  const int row_tiles = (M + rows - 1) / rows, col_tiles = (N + TN - 1) / TN;
  if (M <= 0 || Kp % SLAB || N % 4 || chunks <= 0 || splits <= 0 ||
      (splits - 1) * chunks >= nchunk || splits * chunks < nchunk ||
      (splits > 1 && (scratch == nullptr || row_tiles * col_tiles > TICKETS)))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
         static_cast<const int8_t*>(qs), static_cast<const float*>(sw),
         static_cast<float*>(out),       static_cast<int*>(scratch),
         M, N, Kp, chunks, splits};
  auto s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: launch<1>(a, s); break;
    case 4: launch<4>(a, s); break;
    case 8: launch<8>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
