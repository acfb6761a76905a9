// Flash attention over the sequence-aware KV cell cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pipeinfer_tpu/ops/cell_attention.py::_kernel
// (wrapper cell_attention). Query rows of one step attend the cells [0, hot)
// of one static layer of the [L, KVH, C, D] bf16 cache. A cell is visible to
// a row when the row's seq bit is set in the cell's bitmask word, the cell's
// position is >= 0 and <= the token's position, and the row is valid. The
// score is q.k * scale, plus 0 (visible) or -1e9 (masked) — an additive
// finite mask, not -inf, so fully masked and padded rows give finite values
// exactly as the reference does — plus slope * max(pos, 0) under ALiBi.
// The softmax runs online over blocks of cells (running max, sum and
// accumulator in f32, the max starting at -1e9), and the output divides by
// the sum with the l == 0 -> 1 guard.
//
// What bounds it on the H100: bytes. At decode T each K and V element
// (2 B each) is used by T * G rows, far below the operations per byte where
// compute would bind; the floor is one pass over K and V of [0, hot) for
// the layer. Design: one block per (KV head, tile of RT query rows), GQA
// groups folded into rows (row = t * G + g), looping over 32-cell blocks
// below hot. Each block loads its K and V tiles with 16-byte loads straight
// from the 4-D cache at the layer offset (no per-layer copy), converts them
// to f32 in shared memory (K rows padded to D + 1 floats so the 32 lanes of
// a warp read 32 different cells without bank conflicts), computes the
// visibility of every (row, cell) pair from the cell's position and seq
// words (a logical shift on the uint32 word), and updates the per-row
// running max and sum with warp reductions. Thread d owns output column d
// of every row of the tile. This simple kernel leaves bandwidth on the
// table at T = 1 (KVH blocks only); splitting the cell range across blocks
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BC = 32;       // cells per block step (one per lane)
constexpr int DMAX = 128;    // largest head dim
constexpr int WMAX = 8;      // largest number of seq words
constexpr int THREADS = 128;
constexpr float NEG = -1e9f;

template <int RT>
__global__ void __launch_bounds__(THREADS)
cell_attn_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                 const __nv_bfloat16* __restrict__ vc, const int* __restrict__ cell_pos,
                 const uint32_t* __restrict__ cell_seq, const int* __restrict__ tok_pos,
                 const int* __restrict__ tok_seq, const uint8_t* __restrict__ valid,
                 const float* __restrict__ slopes, float* __restrict__ out, int T, int H,
                 int KVH, int C, int D, int W, int layer, int c_hot, float scale) {
  __shared__ float q_s[RT][DMAX];
  __shared__ float k_s[BC][DMAX + 1];
  __shared__ float v_s[BC][DMAX];
  __shared__ float p_s[RT][BC];
  __shared__ int pos_s[BC];
  __shared__ uint32_t words_s[WMAX][BC];
  __shared__ int r_pos[RT], r_word[RT], r_bit[RT], r_ok[RT];
  __shared__ float r_slope[RT], m_s[RT], l_s[RT], alpha_s[RT];

  const int kvh = blockIdx.x;
  const int G = H / KVH;
  const int TG = T * G;
  const int row0 = blockIdx.y * RT;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  for (int i = tid; i < RT * D; i += THREADS) {
    const int r = i / D, d = i % D, gr = row0 + r;
    float val = 0.f;
    if (gr < TG) {
      const int t = gr / G, h = kvh * G + gr % G;
      val = q[((size_t)t * H + h) * D + d];
    }
    q_s[r][d] = val;
  }
  if (tid < RT) {
    const int gr = row0 + tid;
    if (gr < TG) {
      const int t = gr / G, h = kvh * G + gr % G;
      r_pos[tid] = tok_pos[t];
      r_word[tid] = tok_seq[t] >> 5;
      r_bit[tid] = tok_seq[t] & 31;
      r_ok[tid] = valid[t] != 0;
      r_slope[tid] = slopes ? slopes[h] : 0.f;
    } else {
      r_pos[tid] = 0; r_word[tid] = 0; r_bit[tid] = 0; r_ok[tid] = 0; r_slope[tid] = 0.f;
    }
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;

  const size_t head_off = ((size_t)layer * KVH + kvh) * (size_t)C * D;
  const __nv_bfloat16* kh = kc + head_off;
  const __nv_bfloat16* vh = vc + head_off;
  const int vec_per_row = D / 8;

  for (int cb = 0; cb < c_hot; cb += BC) {
    __syncthreads();  // previous block's p_s / v_s reads are done
    for (int i = tid; i < BC * vec_per_row; i += THREADS) {
      const int c = i / vec_per_row, d0 = (i % vec_per_row) * 8;
      const size_t off = (size_t)(cb + c) * D + d0;
      uint4 kv4 = __ldg(reinterpret_cast<const uint4*>(kh + off));
      uint4 vv4 = __ldg(reinterpret_cast<const uint4*>(vh + off));
      const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(&kv4);
      const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        k_s[c][d0 + e] = __bfloat162float(kb[e]);
        v_s[c][d0 + e] = __bfloat162float(vb[e]);
      }
    }
    if (tid < BC) pos_s[tid] = cell_pos[cb + tid];
    for (int i = tid; i < W * BC; i += THREADS) {
      const int w = i / BC, c = i % BC;
      words_s[w][c] = cell_seq[(size_t)(cb + c) * W + w];
    }
    __syncthreads();

    // scores with the visibility mask and ALiBi
    for (int i = tid; i < RT * BC; i += THREADS) {
      const int r = i / BC, c = i % BC;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += q_s[r][d] * k_s[c][d];
      s *= scale;
      const int cp = pos_s[c];
      const uint32_t bit = (words_s[r_word[r]][c] >> (uint32_t)r_bit[r]) & 1u;
      const bool vis = bit != 0u && cp <= r_pos[r] && cp >= 0 && r_ok[r];
      s += vis ? 0.f : NEG;
      s += r_slope[r] * (float)max(cp, 0);
      p_s[r][c] = s;
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per cell
    for (int r = warp; r < RT; r += THREADS / 32) {
      const float s = p_s[r][lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_next);
      const float p = expf(s - m_next);
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      p_s[r][lane] = p;
      if (lane == 0) {
        l_s[r] = alpha * l_s[r] + ps;
        m_s[r] = m_next;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    for (int d = tid; d < D; d += THREADS) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float pv = 0.f;
#pragma unroll 8
        for (int c = 0; c < BC; ++c) pv += p_s[r][c] * v_s[c][d];
        acc[r] = acc[r] * alpha_s[r] + pv;
      }
    }
  }
  __syncthreads();

  for (int d = tid; d < D; d += THREADS) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int gr = row0 + r;
      if (gr >= TG) continue;
      const int t = gr / G, h = kvh * G + gr % G;
      const float l = l_s[r];
      out[((size_t)t * H + h) * D + d] = acc[r] / (l == 0.f ? 1.f : l);
    }
  }
}

template <int RT>
void launch(const float* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const int* pos,
            const uint32_t* seq, const int* tpos, const int* tseq, const uint8_t* valid,
            const float* slopes, float* out, int T, int H, int KVH, int C, int D, int W,
            int layer, int c_hot, float scale, cudaStream_t stream) {
  const int TG = T * (H / KVH);
  dim3 grid(KVH, (TG + RT - 1) / RT);
  cell_attn_kernel<RT><<<grid, THREADS, 0, stream>>>(q, k, v, pos, seq, tpos, tseq, valid,
                                                     slopes, out, T, H, KVH, C, D, W, layer,
                                                     c_hot, scale);
}

}  // namespace

// q f32 [T, H, D]; k, v bf16 [L, KVH, C, D]; pos i32 [C]; seq u32 [C, W];
// tok_pos, tok_seq i32 [T]; valid u8 [T]; slopes f32 [H] or null;
// out f32 [T, H, D]. D % 8 == 0, D <= 128, W <= 8, c_hot % 32 == 0.
extern "C" int pi_cell_attention(const void* q, const void* k, const void* v, const void* pos,
                                 const void* seq, const void* tok_pos, const void* tok_seq,
                                 const void* valid, const void* slopes, void* out, int T,
                                 int H, int KVH, int C, int D, int W, int layer, int c_hot,
                                 float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto qq = static_cast<const float*>(q);
  auto kk = static_cast<const __nv_bfloat16*>(k);
  auto vv = static_cast<const __nv_bfloat16*>(v);
  auto pp = static_cast<const int*>(pos);
  auto sq = static_cast<const uint32_t*>(seq);
  auto tp = static_cast<const int*>(tok_pos);
  auto ts = static_cast<const int*>(tok_seq);
  auto va = static_cast<const uint8_t*>(valid);
  auto sl = static_cast<const float*>(slopes);
  auto o = static_cast<float*>(out);
  const int TG = T * (H / KVH);
  if (TG <= 4)
    launch<4>(qq, kk, vv, pp, sq, tp, ts, va, sl, o, T, H, KVH, C, D, W, layer, c_hot, scale, s);
  else
    launch<16>(qq, kk, vv, pp, sq, tp, ts, va, sl, o, T, H, KVH, C, D, W, layer, c_hot, scale, s);
  return (int)cudaGetLastError();
}
