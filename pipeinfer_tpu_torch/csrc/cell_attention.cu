// Split-cell flash attention over the sequence-aware KV cell cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel pipeinfer_tpu/ops/cell_attention.py::_kernel
// (wrapper cell_attention). Query rows of one step attend the cells [0, hot)
// of one static layer of the [L, KVH, C, D] cache, bf16 (the default) or f32
// (--cache-dtype f32), as the TPU kernel reads either. A cell is visible to
// a row when the row's seq bit is set in the cell's bitmask word, the cell's
// position is >= 0 and <= the token's position, and the row is valid. The
// score is q.k * scale, plus 0 (visible) or -1e9 (masked) — an additive
// finite mask, not -inf, so a valid row that sees no cell gives finite
// values exactly as the reference does — plus slope * max(pos, 0) under
// ALiBi, each step rounded on its own (__fmul_rn / __fadd_rn) as the
// reference rounds it. A padding row (valid 0) scores every cell -inf, so
// its sum stays 0 and the l == 0 -> 1 guard writes 0: unlike the reference,
// whose padding rows average the stale V of every cell, a step's valid rows
// then never see through the activation scale that all rows of an i4g or
// i8g product share what earlier requests left in the cache. The softmax
// runs online (max, sum and accumulator in f32, every max starting at
// -1e9), and the output divides by the sum with the l == 0 -> 1 guard.
//
// What bounds it on the H100: bytes. At decode T each K and V element
// (2 B each in a bf16 cache) feeds T * G rows, at most 16 f32 operations per byte at the
// main path's rows, below the ~20 where the f32 cores would bind; the floor
// is one pass over K and V of [0, hot) for the layer (20 us at C = 4096,
// 32 heads of 128). So the design keeps many bytes in flight on every SM:
//
// 1. Split the cell range (flash decoding). The TPU kernel carries its
//    running max, sum and accumulator along the sequential cell axis of its
//    grid; Hopper's blocks run in no order, so the cells [0, c) are cut into
//    n_splits splits of `split` cells (a multiple of 32, the last one may be
//    shorter), and the grid is (split, row tile, KV head). The wrapper picks
//    the count from the shape: the fewest splits whose blocks fill the waves
//    of resident blocks (blocks_per_sm below, times 132 SMs) to 90%, since a
//    wave the grid fills in part costs as much as a full one. At T = 1 with
//    32 KV heads that is 19 splits (608 blocks) at C = 4096 and 16 (512
//    blocks) at C = 1024.
// 2. No staging of K/V. A block is 128 threads; a group of GS lanes
//    (8 * GS >= D) takes U = 2 cells per step, each lane loading 8 elements
//    (16 B of bf16, two 16 B loads of f32: Vec8 below) of each cell's K row
//    and V row straight into registers, and loads the
//    next step's K, V and metadata before it computes the current one. The
//    block's RT query rows (GQA groups folded in, row = t * G + g) sit in
//    registers, 8 columns per lane. The U * RT partial dots of a lane are
//    reduce-scattered over the group with __shfl_xor_sync, so each lane ends
//    with one (cell, row) pair and computes that pair's mask, score and
//    exponential alone; the probabilities and the rescale factors are then
//    broadcast in the group, and each lane accumulates P.V for its own 8
//    columns of every row. Each group keeps its own (m, l, acc), so the loop
//    has no barrier and no exchange between groups.
// 3. Merge. The block merges its groups through shared memory, writes one
//    partial (m, l, acc[D]) per row for its split into f32 scratch, and
//    takes a ticket (an atomic add on one counter per row tile and KV head).
//    The block that takes the last ticket merges the splits of its rows:
//    M = max m_i, l = sum l_i e^(m_i - M), acc = sum acc_i e^(m_i - M),
//    out = acc / (l == 0 ? 1 : l), and sets the counter back to zero. One
//    kernel, not a second one for the merge: on the H100 a second launch
//    cost more than the last block's merge, which also overlaps the blocks
//    of the other heads (PERF.md). The merge sums in
//    split order, so a result does not depend on which block merges. Every
//    partial max starts at -1e9, so the merged max is the reference's
//    floored max; cells past a split's end score -inf and weigh exactly 0.
//    The per-cell exponentials use __expf: exp(0) is exactly 1, exp(-inf)
//    exactly 0, and its error (a few ulp) is far inside the 1e-4 tolerance.
//
// Rows beyond 4 (T * G > 4) take more row tiles of the same block; each tile
// re-reads K/V (mostly from L2). Tensor cores would round q or p to
// bf16/TF32 and break the f32 parity with the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;        // threads of a split block
constexpr int U = 2;                // cells a lane group takes per step
constexpr int MAX_SPLITS = 256;

// Split blocks resident on one SM, by rows per block: __launch_bounds__ holds
// the registers to it, and the wrapper (BLOCKS_PER_SM in
// ops/cell_attention.py) sizes the grid to one wave of such blocks.
constexpr int blocks_per_sm(int rt) { return rt == 1 ? 5 : rt == 2 ? 4 : 3; }
constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* q;               // [T, H, D]
  const void* k;                // [L, KVH, C, D] of E (bf16 or f32)
  const void* v;
  const int* cell_pos;          // [C]
  const uint32_t* cell_seq;     // [C, W]
  const int* tok_pos;           // [T]
  const int* tok_seq;           // [T]
  const uint8_t* valid;         // [T]
  const float* slopes;          // [H] or null
  float* part;                  // acc [KVH * TG, n_splits, D], then (m, l) [.., n_splits, 2]
  int* tickets;                 // [row tiles * KVH], zero between calls
  float* out;                   // [T, H, D]
  int T, H, KVH, C, D, W, layer, c_hot, split, n_splits;
  float scale;
};

__device__ __forceinline__ void bf16x8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Eight consecutive cache elements of type E, loaded in 16 B pieces and
// widened to f32.
template <typename E>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void zero() { raw = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void widen(float (&f)[8]) const { bf16x8(raw, f); }
};

template <>
struct Vec8<float> {
  float4 lo, hi;
  __device__ __forceinline__ void zero() { lo = hi = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void load(const float* p) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void widen(float (&f)[8]) const {
    f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
    f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
  }
};

// What one lane holds of its group's U cells for one step: their K and V
// columns, and the position and seq word of the cell of its own pair.
template <typename E>
struct Step {
  Vec8<E> k[U], v[U];
  int pos;
  uint32_t word;
};

// Reduce-scatter of N partial sums over the lanes of a group: each step
// trades half of the values with the lane O away, keeping the half that bit O
// of the lane selects, so after log2(N) steps dp[0] holds value j / (GS / N)
// summed over the lanes that differ in those bits: N - 1 shuffles, where a
// butterfly for each value would take N * log2(N).
template <int N, int O, int M>
__device__ __forceinline__ void reduce_scatter(float (&dp)[M], int j) {
  if constexpr (N > 1) {
    const bool hi = j & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float keep = hi ? dp[i + N / 2] : dp[i];
      const float send = hi ? dp[i] : dp[i + N / 2];
      dp[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
    reduce_scatter<N / 2, O / 2>(dp, j);
  }
}

template <int GS, int RT, typename E>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(RT)) split_kernel(const Args a) {
  constexpr int NG = THREADS / GS;  // lane groups per block
  constexpr int STEP = NG * U;      // cells per block step
  constexpr int P = U * RT;         // (cell, row) pairs of a group step
  constexpr int LPP = GS / P;       // lanes that hold one pair after the reduction
  static_assert(U == 2 && P <= GS, "each lane of a group ends up holding one pair");
  static_assert(RT <= THREADS / 32, "the merge takes one warp per row");
  __shared__ float m_s[NG][RT], l_s[NG][RT];
  __shared__ float acc_s[NG][RT][8 * GS];

  const int si = blockIdx.x, tile = blockIdx.y, kvh = blockIdx.z;  // split, row tile, KV head
  const int G = a.H / a.KVH, TG = a.T * G;
  const int tid = threadIdx.x;
  const int j = tid % GS;    // this lane's columns: [8j, 8j + 8)
  const int grp = tid / GS;  // groups are GS-aligned inside a warp
  const bool cols = 8 * j < a.D;
  const int c0 = si * a.split, c1 = min(c0 + a.split, a.c_hot);
  // the pair p = u * RT + r whose score this lane computes
  const int my_u = j / LPP / RT, my_r = j / LPP % RT;

  float qr[RT][8];
  int my_pos = 0, my_word = 0, my_bit = 0;
  bool my_ok = false;
  float my_slope = 0.f;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int gr = tile * RT + r;
    const bool row = gr < TG;
    const int t = row ? gr / G : 0, h = kvh * G + (row ? gr % G : 0);
    const float* qp = a.q + ((size_t)t * a.H + h) * a.D + 8 * j;
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[r][e] = (row && cols) ? qp[e] : 0.f;
    if (r == my_r && row) {
      my_pos = a.tok_pos[t];
      my_word = a.tok_seq[t] >> 5;
      my_bit = a.tok_seq[t] & 31;
      my_ok = a.valid[t] != 0;
      my_slope = a.slopes ? a.slopes[h] : 0.f;
    }
  }

  // online softmax state of row my_r over this group's cells; acc of every
  // row for this lane's columns
  float m = NEG, l = 0.f, acc[RT][8];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;

  const size_t head = ((size_t)a.layer * a.KVH + kvh) * (size_t)a.C * a.D + 8 * j;
  const E* kh = static_cast<const E*>(a.k) + head;
  const E* vh = static_cast<const E*>(a.v) + head;

  // this group's cells of the block step at cb: cb + grp * U + u
  auto fetch = [&](Step<E>& st, int cb) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = cb + grp * U + u;
      st.k[u].zero();
      st.v[u].zero();
      if (c < c1 && cols) {
        st.k[u].load(kh + (size_t)c * a.D);
        st.v[u].load(vh + (size_t)c * a.D);
      }
    }
    const int c = cb + grp * U + my_u;
    st.pos = c < c1 ? __ldg(a.cell_pos + c) : 0;
    st.word = c < c1 ? __ldg(a.cell_seq + (size_t)c * a.W + my_word) : 0u;
  };

  Step<E> cur, nxt;
  fetch(cur, c0);
  for (int cb = c0; cb < c1; cb += STEP) {  // uniform over the block
    fetch(nxt, cb + STEP);

    // partial dots of the P pairs over this lane's 8 columns
    float dp[P];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      cur.k[u].widen(kf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qr[r][e], kf[e], d);
        dp[u * RT + r] = d;
      }
    }
    // lane j ends with pair j / LPP summed over all GS lanes
    reduce_scatter<P, GS / 2>(dp, j);
    float d = dp[0];
#pragma unroll
    for (int o = LPP / 2; o > 0; o /= 2) d += __shfl_xor_sync(FULL, d, o);

    const int c = cb + grp * U + my_u;
    float s = -INFINITY;  // past the split's end, or a padding row: weighs exactly 0
    if (c < c1 && my_ok) {
      const int cp = cur.pos;
      const bool vis = ((cur.word >> (uint32_t)my_bit) & 1u) && cp <= my_pos && cp >= 0;
      s = __fadd_rn(__fmul_rn(d, a.scale), vis ? 0.f : NEG);
      s = __fadd_rn(s, __fmul_rn(my_slope, (float)max(cp, 0)));
    }
    // row my_r's other cell of the step is GS / 2 lanes away (U == 2)
    const float m_next = fmaxf(m, fmaxf(s, __shfl_xor_sync(FULL, s, GS / 2)));
    const float alpha = __expf(m - m_next);
    const float p = __expf(s - m_next);
    l = alpha * l + (p + __shfl_xor_sync(FULL, p, GS / 2));
    m = m_next;

#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float al = __shfl_sync(FULL, alpha, r * LPP, GS);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= al;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      cur.v[u].widen(vf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float pr = __shfl_sync(FULL, p, (u * RT + r) * LPP, GS);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
      }
    }
    cur = nxt;
  }

  // merge the block's groups; one partial per row for this split
  if (j < RT * LPP && j % LPP == 0) {  // the lane of pair (0, my_r)
    m_s[grp][my_r] = m;
    l_s[grp][my_r] = l;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float mb = m_s[0][r];
    for (int g = 1; g < NG; ++g) mb = fmaxf(mb, m_s[g][r]);
    const float w = expf(m_s[grp][r] - mb);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_s[grp][r][8 * j + e] = acc[r][e] * w;
  }
  __syncthreads();

  const int rows = min(RT, TG - tile * RT);
  const size_t row0 = (size_t)kvh * TG + tile * RT;  // part's row of this tile's row 0
  const int n = a.n_splits;
  float* ml = a.part + (size_t)a.KVH * TG * n * a.D;  // (m, l) of (row, split)
  for (int i = tid; i < rows * a.D; i += THREADS) {
    const int r = i / a.D, d = i % a.D;
    float sum = 0.f;
    for (int g = 0; g < NG; ++g) sum += acc_s[g][r][d];
    a.part[((row0 + r) * n + si) * a.D + d] = sum;
  }
  if (tid < rows) {
    float mb = m_s[0][tid];
    for (int g = 1; g < NG; ++g) mb = fmaxf(mb, m_s[g][tid]);
    float lb = 0.f;
    for (int g = 0; g < NG; ++g) lb += l_s[g][tid] * expf(m_s[g][tid] - mb);
    ml[((row0 + tid) * n + si) * 2] = mb;
    ml[((row0 + tid) * n + si) * 2 + 1] = lb;
  }

  // The last block of this (row tile, KV head) to finish merges the splits.
  __shared__ bool last_s;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  int* ticket = a.tickets + tile * a.KVH + kvh;
  if (tid == 0) last_s = atomicAdd(ticket, 1) == n - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (tid == 0) *ticket = 0;  // zero again for the next call

  // m, then the weight e^(m_i - M), of each split, in acc_s (read out above)
  static_assert(sizeof(acc_s) >= sizeof(float) * RT * MAX_SPLITS, "w_s fits in acc_s");
  float(*w_s)[MAX_SPLITS] = reinterpret_cast<float(*)[MAX_SPLITS]>(&acc_s[0][0][0]);
  __shared__ float l_sum[RT];
  for (int i = tid; i < rows * n; i += THREADS)
    w_s[i / n][i % n] = __ldcg(ml + ((row0 + i / n) * n + i % n) * 2);
  __syncthreads();
  const int lane = tid % 32, warp = tid / 32;
  if (warp < rows) {  // one warp per row
    float mx = -INFINITY;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, w_s[warp][i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    float lt = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float w = expf(w_s[warp][i] - mx);
      w_s[warp][i] = w;
      lt += __ldcg(ml + ((row0 + warp) * n + i) * 2 + 1) * w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lt += __shfl_xor_sync(FULL, lt, o);
    if (lane == 0) l_sum[warp] = lt == 0.f ? 1.f : lt;
  }
  __syncthreads();
  for (int i = tid; i < rows * a.D; i += THREADS) {
    const int r = i / a.D, d = i % a.D;
    const float* pa = a.part + (row0 + r) * n * a.D + d;
    float o = 0.f;
    for (int k0 = 0; k0 < n; k0 += 32) {  // 32 loads in flight, summed in split order
      float x[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) x[k] = k0 + k < n ? __ldcg(pa + (size_t)(k0 + k) * a.D) : 0.f;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (k0 + k < n) o += x[k] * w_s[r][k0 + k];
    }
    const int gr = tile * RT + r, t = gr / G, h = kvh * G + gr % G;
    a.out[((size_t)t * a.H + h) * a.D + d] = o / l_sum[r];
  }
}

template <int GS, int RT, typename E>
int run(const Args& a, cudaStream_t stream) {
  const int TG = a.T * (a.H / a.KVH);
  split_kernel<GS, RT, E>
      <<<dim3(a.n_splits, (TG + RT - 1) / RT, a.KVH), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int GS, typename E>
int by_rows(const Args& a, int rows, cudaStream_t stream) {
  if (rows == 1) return run<GS, 1, E>(a, stream);
  if (rows == 2) return run<GS, 2, E>(a, stream);
  if constexpr (U * 4 <= GS) {
    if (rows == 4) return run<GS, 4, E>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename E>
int by_lanes(const Args& a, int rows, int group_lanes, cudaStream_t stream) {
  switch (group_lanes) {
    case 4: return by_rows<4, E>(a, rows, stream);
    case 8: return by_rows<8, E>(a, rows, stream);
    case 16: return by_rows<16, E>(a, rows, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q f32 [T, H, D]; k, v [L, KVH, C, D] of bf16 (cache_bytes 2) or f32
// (cache_bytes 4), 16-byte aligned; pos i32 [C]; seq u32 [C, W];
// tok_pos, tok_seq i32 [T]; valid u8 [T]; slopes f32 [H] or null; part f32
// scratch of KVH * T * (H / KVH) * n_splits * (D + 2); tickets i32
// [row tiles * KVH], zero on entry and left zero; out f32 [T, H, D]. The cut
// (rows per block, lanes per cell, split, n_splits) comes from the wrapper:
// rows in {1, 2, 4}, group_lanes in {4, 8, 16} with 2 * rows <= group_lanes,
// D % 8 == 0 and D <= 8 * group_lanes, split % 32 == 0, and the n_splits (<= MAX_SPLITS)
// splits cover [0, c_hot) exactly. Launches the kernel on `stream` and
// returns the launch error (cudaErrorInvalidValue for a cut it does not take).
extern "C" int pi_cell_attention(const void* q, const void* k, const void* v, const void* pos,
                                 const void* seq, const void* tok_pos, const void* tok_seq,
                                 const void* valid, const void* slopes, void* part,
                                 void* tickets, void* out, int T, int H, int KVH, int C, int D,
                                 int W, int layer, int c_hot, int rows, int group_lanes,
                                 int split, int n_splits, float scale, int cache_bytes,
                                 void* stream) {
  if (D % 8 || D > 8 * group_lanes || split <= 0 || split % 32 || n_splits <= 0 ||
      n_splits > MAX_SPLITS || (long long)(n_splits - 1) * split >= c_hot ||
      (long long)n_splits * split < c_hot || c_hot > C || H % KVH)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q),    k,
         v,                               static_cast<const int*>(pos),
         static_cast<const uint32_t*>(seq), static_cast<const int*>(tok_pos),
         static_cast<const int*>(tok_seq), static_cast<const uint8_t*>(valid),
         static_cast<const float*>(slopes), static_cast<float*>(part),
         static_cast<int*>(tickets),      static_cast<float*>(out),
         T, H, KVH, C, D, W, layer, c_hot, split, n_splits, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (cache_bytes == 2) return by_lanes<__nv_bfloat16>(a, rows, group_lanes, s);
  if (cache_bytes == 4) return by_lanes<float>(a, rows, group_lanes, s);
  return (int)cudaErrorInvalidValue;
}
