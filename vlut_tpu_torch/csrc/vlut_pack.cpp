// Ternary pack/unpack and ternarization on the host, for the PyTorch port.
//
// The port's copy of the JAX package's host packer (the same extern "C"
// functions, the same arithmetic bit for bit): the byte slab layout of
// vlut_tpu_torch/ops/packing.py, with the hot loops in C++ (OpenMP over
// blocks and slab rows) so that packing a multi-GB checkpoint on the host
// does not crawl through numpy temporaries.  Built by g++ at first use and
// bound with ctypes (vlut_tpu_torch/convert/native.py).  No kernel of a TPU
// is replaced: the JAX package runs the same code on its host.  Bound by
// bytes: each trit is read once and each byte written once.
//
// Layout contract (ops/packing.py, tested against it):
//   i2: block kb rows, r=4 slabs of kb/4; byte[b, j, n] bits (2q..2q+1)
//       hold trit(k = b*kb + q*(kb/4) + j, n) + 1.
//   i1: r=5, base-3 digit q (little-endian) holds slab q's trit + 1.

#include <cstdint>
#include <cstring>
#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// trits: (kp, n) int8 in {-1,0,1}, kp % kb == 0; out: (kp/4, n) uint8
void vlut_pack_i2(const int8_t* trits, uint8_t* out,
                  int64_t kp, int64_t n, int64_t kb) {
    const int64_t slab = kb / 4;
    const int64_t nblocks = kp / kb;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        for (int64_t j = 0; j < slab; ++j) {
            const int64_t orow = b * slab + j;
            uint8_t* dst = out + orow * n;
            const int8_t* s0 = trits + (b * kb + 0 * slab + j) * n;
            const int8_t* s1 = trits + (b * kb + 1 * slab + j) * n;
            const int8_t* s2 = trits + (b * kb + 2 * slab + j) * n;
            const int8_t* s3 = trits + (b * kb + 3 * slab + j) * n;
            for (int64_t c = 0; c < n; ++c) {
                dst[c] = (uint8_t)((s0[c] + 1) | ((s1[c] + 1) << 2) |
                                   ((s2[c] + 1) << 4) | ((s3[c] + 1) << 6));
            }
        }
    }
}

// trits: (kp, n) int8, kp % kb == 0 (kb % 5 == 0); out: (kp/5, n) uint8
void vlut_pack_i1(const int8_t* trits, uint8_t* out,
                  int64_t kp, int64_t n, int64_t kb) {
    const int64_t slab = kb / 5;
    const int64_t nblocks = kp / kb;
    static const int16_t POW3[5] = {1, 3, 9, 27, 81};
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        for (int64_t j = 0; j < slab; ++j) {
            const int64_t orow = b * slab + j;
            uint8_t* dst = out + orow * n;
            const int8_t* src[5];
            for (int q = 0; q < 5; ++q)
                src[q] = trits + (b * kb + q * slab + j) * n;
            for (int64_t c = 0; c < n; ++c) {
                int16_t acc = 0;
                for (int q = 0; q < 5; ++q)
                    acc += (int16_t)(src[q][c] + 1) * POW3[q];
                dst[c] = (uint8_t)acc;
            }
        }
    }
}

void vlut_unpack_i2(const uint8_t* packed, int8_t* trits,
                    int64_t kp, int64_t n, int64_t kb) {
    const int64_t slab = kb / 4;
    const int64_t nblocks = kp / kb;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        for (int64_t j = 0; j < slab; ++j) {
            const uint8_t* src = packed + (b * slab + j) * n;
            for (int q = 0; q < 4; ++q) {
                int8_t* dst = trits + (b * kb + q * slab + j) * n;
                for (int64_t c = 0; c < n; ++c)
                    dst[c] = (int8_t)(((src[c] >> (2 * q)) & 3) - 1);
            }
        }
    }
}

void vlut_unpack_i1(const uint8_t* packed, int8_t* trits,
                    int64_t kp, int64_t n, int64_t kb) {
    const int64_t slab = kb / 5;
    const int64_t nblocks = kp / kb;
    static const uint8_t POW3[5] = {1, 3, 9, 27, 81};
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        for (int64_t j = 0; j < slab; ++j) {
            const uint8_t* src = packed + (b * slab + j) * n;
            for (int q = 0; q < 5; ++q) {
                int8_t* dst = trits + (b * kb + q * slab + j) * n;
                for (int64_t c = 0; c < n; ++c)
                    dst[c] = (int8_t)((src[c] / POW3[q]) % 3 - 1);
            }
        }
    }
}

// BitNet-style absmean ternarization (reference converter weight_quant):
// scale = mean|w| over nonzero entries; trits = clip(round(w/scale), -1, 1).
// Returns the scale.  w: (size,) fp32.
float vlut_ternarize_absmean(const float* w, int8_t* trits, int64_t size) {
    double sum = 0.0;
    int64_t cnt = 0;
#pragma omp parallel for reduction(+:sum, cnt) schedule(static)
    for (int64_t i = 0; i < size; ++i) {
        if (w[i] != 0.0f) { sum += std::fabs((double)w[i]); ++cnt; }
    }
    float scale = cnt ? (float)(sum / (double)cnt) : 1e-8f;
    if (scale < 1e-8f) scale = 1e-8f;
    const float inv = 1.0f / scale;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < size; ++i) {
        float v = std::nearbyint(w[i] * inv);
        trits[i] = (int8_t)(v > 1.0f ? 1 : (v < -1.0f ? -1 : (int)v));
    }
    return scale;
}

// Exact-ternary detector: checks the value set is {-s, 0, +s}; returns s
// (>0) if exact, -1.0 if not, 0.0 if all-zero.
float vlut_detect_ternary(const float* w, int64_t size) {
    float s = 0.0f;
    for (int64_t i = 0; i < size; ++i) {
        const float a = std::fabs(w[i]);
        if (a == 0.0f) continue;
        if (s == 0.0f) { s = a; continue; }
        const float rel = std::fabs(a - s) / s;
        if (rel > 1e-4f) return -1.0f;
    }
    return s;
}

}  // extern "C"
