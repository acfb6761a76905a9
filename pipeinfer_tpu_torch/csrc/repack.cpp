// Host runtime of the model-load hot path: block-quant decode, planar
// repacking and rounding, on a thread pool. Compiled by g++ (not nvcc) at
// first use by pipeinfer_tpu_torch/native.py into build/native/ and called
// through its C ABI with ctypes; every call releases the GIL.
//
// It decodes ggml block payloads (ref: ggml-quants.c dequantize_row_*) into
// the planar layout of pipeinfer_tpu_torch.quant.pack (integer quant planes
// + f32 scale/bias planes) over row ranges. Built with -std=c++17, not a
// gnu++ dialect: GCC then contracts no multiply-add into an FMA, so every
// float is the one numpy computes.
//
// Layout contract (must match quant/pack.py exactly; verified bit-for-bit
// by tests/test_torch_native.py):
//   val = scale[g] * q - bias[g], packgroup = 256 columns,
//   nibble plane byte j <-> elems j and j+128 of the packgroup,
//   2-bit plane byte j <-> elems j + 64*i at bits 2i,
//   1-bit plane byte j <-> elems j + 32*i at bit i.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t em = h & 0x7fff;
    uint32_t bits;
    if (em == 0) {
        bits = sign;
    } else if ((em >> 10) == 0) {  // subnormal
        int e = -1;
        uint32_t m = em;
        do { e++; m <<= 1; } while ((m & 0x400) == 0);
        bits = sign | ((uint32_t)(127 - 15 - e) << 23) | ((m & 0x3ff) << 13);
    } else if ((em >> 10) == 0x1f) {
        bits = sign | 0x7f800000 | ((em & 0x3ff) << 13);
    } else {
        bits = sign | (((em >> 10) + 127 - 15) << 23) | ((em & 0x3ff) << 13);
    }
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

inline uint16_t rd16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }

// decoded row chunk: integer quants + per-group scale/bias
struct RowDecoder {
    // write q (uint8) for one superblock/block run of a row
    virtual void decode_row(const uint8_t* src, int64_t k, uint8_t* q, float* s, float* b) const = 0;
    virtual ~RowDecoder() = default;
};

// --- k-quant scale helpers (ref semantics: ggml-quants.c) -----------------

void unpack_scale_min_k4(const uint8_t* sc, int j, uint8_t* d, uint8_t* m) {
    if (j < 4) {
        *d = sc[j] & 63;
        *m = sc[j + 4] & 63;
    } else {
        *d = (sc[j + 4] & 0xF) | ((sc[j - 4] >> 6) << 4);
        *m = (sc[j + 4] >> 4) | ((sc[j] >> 6) << 4);
    }
}

struct Q4K : RowDecoder {  // 144B/256, group 32
    void decode_row(const uint8_t* src, int64_t k, uint8_t* q, float* s, float* b) const override {
        for (int64_t sb = 0; sb < k / 256; sb++) {
            const uint8_t* blk = src + sb * 144;
            float d = f16_to_f32(rd16(blk));
            float dmin = f16_to_f32(rd16(blk + 2));
            const uint8_t* scales = blk + 4;
            const uint8_t* qs = blk + 16;
            for (int j = 0; j < 4; j++) {
                uint8_t sc, m;
                unpack_scale_min_k4(scales, 2 * j, &sc, &m);
                s[sb * 8 + 2 * j] = d * sc;
                b[sb * 8 + 2 * j] = dmin * m;
                unpack_scale_min_k4(scales, 2 * j + 1, &sc, &m);
                s[sb * 8 + 2 * j + 1] = d * sc;
                b[sb * 8 + 2 * j + 1] = dmin * m;
                for (int l = 0; l < 32; l++) {
                    q[sb * 256 + 64 * j + l] = qs[32 * j + l] & 0xF;
                    q[sb * 256 + 64 * j + 32 + l] = qs[32 * j + l] >> 4;
                }
            }
        }
    }
};

struct Q5K : RowDecoder {  // 176B/256, group 32
    void decode_row(const uint8_t* src, int64_t k, uint8_t* q, float* s, float* b) const override {
        for (int64_t sb = 0; sb < k / 256; sb++) {
            const uint8_t* blk = src + sb * 176;
            float d = f16_to_f32(rd16(blk));
            float dmin = f16_to_f32(rd16(blk + 2));
            const uint8_t* scales = blk + 4;
            const uint8_t* qh = blk + 16;
            const uint8_t* qs = blk + 48;
            for (int j = 0; j < 4; j++) {
                uint8_t sc, m;
                unpack_scale_min_k4(scales, 2 * j, &sc, &m);
                s[sb * 8 + 2 * j] = d * sc;
                b[sb * 8 + 2 * j] = dmin * m;
                unpack_scale_min_k4(scales, 2 * j + 1, &sc, &m);
                s[sb * 8 + 2 * j + 1] = d * sc;
                b[sb * 8 + 2 * j + 1] = dmin * m;
                for (int l = 0; l < 32; l++) {
                    uint8_t h1 = (qh[l] >> (2 * j)) & 1;
                    uint8_t h2 = (qh[l] >> (2 * j + 1)) & 1;
                    q[sb * 256 + 64 * j + l] = (qs[32 * j + l] & 0xF) | (h1 << 4);
                    q[sb * 256 + 64 * j + 32 + l] = (qs[32 * j + l] >> 4) | (h2 << 4);
                }
            }
        }
    }
};

struct Q6K : RowDecoder {  // 210B/256, group 16, val = s*(q-32) -> b = 32*s
    void decode_row(const uint8_t* src, int64_t k, uint8_t* q, float* s, float* b) const override {
        for (int64_t sb = 0; sb < k / 256; sb++) {
            const uint8_t* blk = src + sb * 210;
            const uint8_t* ql = blk;
            const uint8_t* qh = blk + 128;
            const int8_t* sc = (const int8_t*)(blk + 192);
            float d = f16_to_f32(rd16(blk + 208));
            for (int g = 0; g < 16; g++) {
                s[sb * 16 + g] = d * sc[g];
                b[sb * 16 + g] = 32.0f * d * sc[g];
            }
            for (int half = 0; half < 2; half++) {
                const uint8_t* l_ = ql + 64 * half;
                const uint8_t* h_ = qh + 32 * half;
                uint8_t* dst = q + sb * 256 + 128 * half;
                for (int l = 0; l < 32; l++) {
                    dst[l] = (l_[l] & 0xF) | ((h_[l] & 3) << 4);
                    dst[32 + l] = (l_[32 + l] & 0xF) | (((h_[l] >> 2) & 3) << 4);
                    dst[64 + l] = (l_[l] >> 4) | (((h_[l] >> 4) & 3) << 4);
                    dst[96 + l] = (l_[32 + l] >> 4) | (((h_[l] >> 6) & 3) << 4);
                }
            }
        }
    }
};

struct Q80 : RowDecoder {  // 34B/32, group 32, signed int8, b = 0
    void decode_row(const uint8_t* src, int64_t k, uint8_t* q, float* s, float* b) const override {
        for (int64_t blk = 0; blk < k / 32; blk++) {
            const uint8_t* p = src + blk * 34;
            s[blk] = f16_to_f32(rd16(p));
            b[blk] = 0.0f;
            std::memcpy(q + blk * 32, p + 2, 32);  // int8 kept as raw bytes
        }
    }
};

struct Q40 : RowDecoder {  // 18B/32, group 32, val = d*(q-8)
    void decode_row(const uint8_t* src, int64_t k, uint8_t* q, float* s, float* b) const override {
        for (int64_t blk = 0; blk < k / 32; blk++) {
            const uint8_t* p = src + blk * 18;
            float d = f16_to_f32(rd16(p));
            s[blk] = d;
            b[blk] = 8.0f * d;
            for (int l = 0; l < 16; l++) {
                q[blk * 32 + l] = p[2 + l] & 0xF;
                q[blk * 32 + 16 + l] = p[2 + l] >> 4;
            }
        }
    }
};

// qtype ids match gguf/constants.py GGMLQuantType
const RowDecoder* decoder_for(int qtype) {
    static Q40 q40;
    static Q80 q80;
    static Q4K q4k;
    static Q5K q5k;
    static Q6K q6k;
    switch (qtype) {
        case 2: return &q40;
        case 8: return &q80;
        case 12: return &q4k;
        case 13: return &q5k;
        case 14: return &q6k;
        default: return nullptr;
    }
}

int bits_for(int qtype) {
    switch (qtype) {
        case 2: case 12: return 4;
        case 13: return 5;
        case 8: return 8;
        case 14: return 6;
        default: return 0;
    }
}

// split-pack one row of integer quants into planes (pack.py layout)
void pack_row(const uint8_t* q, int64_t k, int bits, uint8_t* qs_row, uint8_t* qh_row) {
    int64_t pg = std::min<int64_t>(256, k);
    for (int64_t g = 0; g < k / pg; g++) {
        const uint8_t* src = q + g * pg;
        if (bits == 8) {
            std::memcpy(qs_row + g * pg, src, pg);
        } else if (bits == 4 || bits == 5 || bits == 6) {
            uint8_t* lo = qs_row + g * (pg / 2);
            for (int64_t j = 0; j < pg / 2; j++)
                lo[j] = (src[j] & 0xF) | ((src[pg / 2 + j] & 0xF) << 4);
            if (bits == 5) {
                uint8_t* hb = qh_row + g * (pg / 8);
                for (int64_t j = 0; j < pg / 8; j++) {
                    uint8_t v = 0;
                    for (int i = 0; i < 8; i++) v |= ((src[j + (pg / 8) * i] >> 4) & 1) << i;
                    hb[j] = v;
                }
            } else if (bits == 6) {
                uint8_t* hb = qh_row + g * (pg / 4);
                for (int64_t j = 0; j < pg / 4; j++) {
                    uint8_t v = 0;
                    for (int i = 0; i < 4; i++) v |= ((src[j + (pg / 4) * i] >> 4) & 3) << (2 * i);
                    hb[j] = v;
                }
            }
        }
    }
}

}  // namespace

// round(x) clipped to [lo, hi] -> u8/i8. numpy's float->int conversion
// can fall back to a scalar loop; these loops vectorize.
// mode 0: half-to-even (np.round); mode 1: half-away-from-zero (ggml).
template <typename T>
static void round_clip_impl(const float* x, int64_t n, float lo, float hi,
                            T* out, int mode, int n_threads) {
    if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
    n_threads = (int)std::max<int64_t>(1, std::min<int64_t>(n_threads, std::max<int64_t>(1, n / (1 << 20))));
    auto work = [&](int64_t a, int64_t b) {
        if (mode == 0) {
            for (int64_t i = a; i < b; i++) {
                float v = x[i];
                v = v < lo ? lo : (v > hi ? hi : v);
                out[i] = (T)(int)std::nearbyintf(v);
            }
        } else {
            for (int64_t i = a; i < b; i++) {
                float v = x[i];
                v = v < lo ? lo : (v > hi ? hi : v);
                out[i] = (T)(int)(v + (v >= 0.0f ? 0.5f : -0.5f));
            }
        }
    };
    if (n_threads == 1) { work(0, n); return; }
    std::vector<std::thread> ts;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        int64_t a = t * chunk, b = std::min<int64_t>(n, a + chunk);
        if (a >= b) break;
        ts.emplace_back(work, a, b);
    }
    for (auto& t : ts) t.join();
}


extern "C" {

// Decode + repack an [n, k] tensor payload into N-major planes.
// qs_out: [n, k*bits-plane bytes]; qh_out may be null for 4/8-bit.
// Returns 0 on success.
int pi_repack(
    int qtype,
    const uint8_t* raw,
    int64_t n,
    int64_t k,
    uint8_t* qs_out,
    uint8_t* qh_out,
    float* scales_out,
    float* bias_out,
    int n_threads
) {
    const RowDecoder* dec = decoder_for(qtype);
    if (!dec) return 1;
    int bits = bits_for(qtype);
    int group = (qtype == 12 || qtype == 13 || qtype == 2 || qtype == 8) ? 32 : 16;
    int64_t row_bytes_src;
    switch (qtype) {
        case 2: row_bytes_src = k / 32 * 18; break;
        case 8: row_bytes_src = k / 32 * 34; break;
        case 12: row_bytes_src = k / 256 * 144; break;
        case 13: row_bytes_src = k / 256 * 176; break;
        case 14: row_bytes_src = k / 256 * 210; break;
        default: return 1;
    }
    int64_t qs_row_bytes = (bits == 8) ? k : k / 2;
    int64_t qh_row_bytes = (bits == 5) ? k / 8 : (bits == 6 ? k / 4 : 0);
    int64_t groups = k / group;

    if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
    n_threads = std::max(1, std::min<int>(n_threads, (int)std::min<int64_t>(n, 64)));

    auto work = [&](int64_t lo, int64_t hi) {
        std::vector<uint8_t> qtmp(k);
        for (int64_t r = lo; r < hi; r++) {
            dec->decode_row(raw + r * row_bytes_src, k, qtmp.data(),
                            scales_out + r * groups, bias_out + r * groups);
            pack_row(qtmp.data(), k, bits, qs_out + r * qs_row_bytes,
                     qh_out ? qh_out + r * qh_row_bytes : nullptr);
        }
    };
    if (n_threads == 1) {
        work(0, n);
    } else {
        std::vector<std::thread> ts;
        int64_t chunk = (n + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; t++) {
            int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
            if (lo >= hi) break;
            ts.emplace_back(work, lo, hi);
        }
        for (auto& t : ts) t.join();
    }
    return 0;
}

void pi_round_clip_u8(const float* x, int64_t n, float lo, float hi,
                      uint8_t* out, int mode, int n_threads) {
    round_clip_impl(x, n, lo, hi, out, mode, n_threads);
}

void pi_round_clip_i8(const float* x, int64_t n, float lo, float hi,
                      int8_t* out, int mode, int n_threads) {
    round_clip_impl(x, n, lo, hi, out, mode, n_threads);
}

}  // extern "C"
