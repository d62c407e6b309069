// Fused decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces vlut_tpu/ops/decode_attention.py:decode_attention_pallas
// (_fused_decode_attn_kernel, bf16 cache) and decode_attention_int8_pallas
// (_fused_decode_attn_int8_kernel, int8 codes + per-(row, head) float32
// scales).  One call per layer and decode step does both halves of the
// step's attention:
//
//   * writes the new K/V row of every slot b into cache[b, start[b]] (the
//     int8 form quantizes it first: scale = max|x| * (1/127), codes =
//     rint(x / scale) clipped to +-127, as the JAX package's jitted
//     quantize_kv);
//   * computes GQA attention of the slot's query heads over the cache rows
//     with row < start[b] (and row > start[b] - window when a window is
//     set), plus the new token itself as a separate term that uses the
//     cache-dtype value (bf16-cast, or quantized then dequantized).
//
// Rows at or past start are never read, so the order of the write and the
// reads does not matter.
//
// Bound: bytes.  A call must read the visible K and V rows once
// (rows x Hkv x hd x 2 bytes x 2 in bf16, half that plus 8 bytes of scales
// per row and head in int8), against 4 flops per element and query head;
// at the flagship (B 32, Hkv 8, H 32, hd 128, ~1000 rows) that is 134 MB
// (0.040 ms at 3.35 TB/s) against 0.5 GFLOP of float32 (0.008 ms at
// 67 TFLOP/s).
//
// Design: two launches.  Pass 1 takes one block of 8 warps per (slot, KV
// head, split of 256 rows): 2,048 blocks at the flagship's S of 2048, of
// which those past a slot's rows exit at once, so a long slot does not set
// the time alone.  A block serves the G query heads of its KV head over
// its rows, staging 16 KB tiles of K and of V in shared memory with
// 16-byte loads.  Per tile, each thread takes whole (query head, row)
// scores, warp j takes head j's online-softmax update (running max and
// denominator in float32), and each thread accumulates four numerator
// elements over a group of the tile's rows; int8 codes become floats by a
// byte permute and an add.  The block writes its state to a float32
// scratch.  Pass 2, one warp per (slot, KV head), merges the splits in
// order, adds the new token's term, divides, and writes the output and the
// new cache row.  No atomics: a result does not change between runs.
// cp.async/TMA and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileBytes = 16384;  // per K tile and per V tile
constexpr int kSplitRows = 256;    // cache rows per pass-1 block
constexpr float kNeg = -1e30f;
constexpr float kRecip127 = 1.0f / 127.0f;  // the float32 reciprocal

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Four consecutive cache elements as float32 (e0 a multiple of 4).
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);  // a bf16 is a float32's high half
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}

// Four int8 codes packed in a word as float32, exactly: each code plus 128
// becomes the low byte of 2^23's mantissa (a byte permute), and 2^23 + 128
// is subtracted; one permute and one add per code, where an int-to-float
// conversion runs at a quarter of the add's rate.
__device__ __forceinline__ void int8x4_to_float(uint32_t x, float* v) {
  const uint32_t u = x ^ 0x80808080u;
  constexpr uint32_t kMagic = 0x4B000000u;  // 2^23
  constexpr float kBias = 8388608.0f + 128.0f;
  v[0] = __uint_as_float(__byte_perm(u, kMagic, 0x7650)) - kBias;
  v[1] = __uint_as_float(__byte_perm(u, kMagic, 0x7651)) - kBias;
  v[2] = __uint_as_float(__byte_perm(u, kMagic, 0x7652)) - kBias;
  v[3] = __uint_as_float(__byte_perm(u, kMagic, 0x7653)) - kBias;
}

__device__ __forceinline__ void load4(const int8_t* p, float* v) {
  int8x4_to_float(*reinterpret_cast<const uint32_t*>(p), v);
}

// The new row's contribution for one warp-held head slice: quantizes it
// (Q8) and writes it into the cache when ``write``; returns the values the
// attention uses for it (cache-dtype values as float).
template <typename T, int EPL, bool Q8>
__device__ __forceinline__ void new_row(const void* src, T* dst_row,
                                        float* dst_scale, bool write,
                                        int lane, float* vals) {
  if constexpr (Q8) {
    const float* x = static_cast<const float*>(src) + lane * EPL;
    float amax = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(x[e]));
    amax = warp_max(amax);
    const float sc = amax * kRecip127;
    const float inv = sc > 0.0f ? 1.0f / fmaxf(sc, 1e-30f) : 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const float c = fminf(fmaxf(rintf(x[e] * inv), -127.0f), 127.0f);
      vals[e] = c * sc;
      if (write) dst_row[lane * EPL + e] = static_cast<int8_t>(c);
    }
    if (write && lane == 0) *dst_scale = sc;
  } else {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(src) + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      vals[e] = __bfloat162float(x[e]);
      if (write) dst_row[lane * EPL + e] = x[e];
    }
  }
}

template <int HD, int G, bool Q8>
struct Dims {
  using T = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  static constexpr int EPL = HD / 32;                  // elements per lane
  static constexpr int ROW_BYTES = HD * sizeof(T);
  static constexpr int TR = kTileBytes / ROW_BYTES;    // rows per tile
  static constexpr int VPR = ROW_BYTES / 16;           // uint4 per row
  static_assert(HD % 32 == 0 && ROW_BYTES % 16 == 0, "head dim");
  static_assert(kSplitRows % TR == 0, "split of whole tiles");
};

// The visible rows [lo, hi) of a slot.
__device__ __forceinline__ void visible_rows(int st, int s, int window,
                                             int* lo, int* hi) {
  *hi = min(st, s);
  *lo = window > 0 ? max(0, st - window + 1) : 0;
}

// Pass 1: block (slot b, KV head, split sp) attends over rows
// [lo + sp * kSplitRows, ...) of its slot and writes its running max,
// denominator and numerator to ``part`` (per (b, kvh, sp, j): m, l, then
// HD numerator values).  A split past the slot's rows exits at once.
//
// Per tile of TR rows staged in shared memory: a thread takes one (row,
// query head) score (the K tile's rows are padded by one 32-bit word, so
// the 32 rows a warp reads sit in 32 banks); warp j then updates head j's
// running max and denominator and turns the scores into probabilities;
// last, a thread accumulates four consecutive numerator elements of one
// head over every PAR-th row of the tile (PAR row groups when the block
// has more threads than output quads; they are summed at the end).
template <int HD, int G, bool Q8>
__global__ void __launch_bounds__(kThreads)
    decode_attn_partial(const float* __restrict__ q,   // (B, H, HD)
                        const void* __restrict__ kc_,  // (B, S, Hkv, HD)
                        const void* __restrict__ vc_,
                        const float* __restrict__ ksc,  // (B, S, Hkv), Q8
                        const float* __restrict__ vsc,
                        const int32_t* __restrict__ start, int window, int s,
                        int hkv, int nsplit, float scale,
                        float* __restrict__ part) {
  using D = Dims<HD, G, Q8>;
  using T = typename D::T;
  constexpr int TR = D::TR, VPR = D::VPR;
  constexpr int KW = D::ROW_BYTES / 4 + 1;            // padded K row, words
  constexpr int NQ = G * HD / 4;                      // output quads
  constexpr int QPT = NQ > kThreads ? NQ / kThreads : 1;  // quads/thread
  constexpr int PAR = NQ < kThreads ? kThreads / NQ : 1;  // row groups
  static_assert(G <= kWarps, "one warp per query head");
  static_assert(NQ % kThreads == 0 || kThreads % NQ == 0, "quads");

  __shared__ uint32_t k_s[TR * KW];
  __shared__ __align__(16) T v_s[TR * HD];
  __shared__ __align__(16) float q_s[G][HD];
  __shared__ float p_s[G][TR];
  __shared__ float ks_s[Q8 ? TR : 1], vs_s[Q8 ? TR : 1];
  __shared__ float alpha_s[G];
  __shared__ __align__(16) float red_s[PAR > 1 ? kThreads * 4 : 4];

  const T* kc = static_cast<const T*>(kc_);
  const T* vc = static_cast<const T*>(vc_);
  const int b = blockIdx.x / hkv;
  const int kvh = blockIdx.x % hkv;
  const int sp = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  int lo, hi;
  visible_rows(start[b], s, window, &lo, &hi);
  const int r0 = lo + sp * kSplitRows;
  const int r1 = min(hi, r0 + kSplitRows);
  if (r0 >= r1) return;

  const float* qb = q + (static_cast<long>(b) * hkv + kvh) * G * HD;
  for (int i = tid; i < G * HD; i += kThreads)
    q_s[i / HD][i % HD] = qb[i] * scale;
  float m = kNeg, l = 0.0f;  // head ``warp``'s state, held by that warp
  const int grp = PAR > 1 ? tid / NQ : 0;  // this thread's row group
  float acc[QPT][4];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  const long row_stride = static_cast<long>(hkv) * HD;  // elements
  for (int t0 = r0; t0 < r1; t0 += TR) {
    const int n = min(TR, r1 - t0);
    const long base = (static_cast<long>(b) * s + t0) * row_stride +
                      static_cast<long>(kvh) * HD;
    for (int i = tid; i < n * VPR; i += kThreads) {
      const int r = i / VPR, c = i % VPR;
      const long g = base + r * row_stride;
      const uint4 kv = reinterpret_cast<const uint4*>(kc + g)[c];
      uint32_t* kd = k_s + r * KW + c * 4;
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      reinterpret_cast<uint4*>(v_s)[i] =
          reinterpret_cast<const uint4*>(vc + g)[c];
    }
    if constexpr (Q8) {
      for (int r = tid; r < n; r += kThreads) {
        const long sidx = (static_cast<long>(b) * s + t0 + r) * hkv + kvh;
        ks_s[r] = ksc[sidx];
        vs_s[r] = vsc[sidx];
      }
    }
    __syncthreads();

    // scores: one (head, row) per thread
    for (int i = tid; i < G * n; i += kThreads) {
      const int j = i / n, r = i % n;
      const uint32_t* kr = k_s + r * KW;
      const float* qj = q_s[j];
      float d0 = 0.0f, d1 = 0.0f;
#pragma unroll 8
      for (int w = 0; w < D::ROW_BYTES / 4; ++w) {
        const uint32_t x = kr[w];
        if constexpr (Q8) {
          const float4 qv = reinterpret_cast<const float4*>(qj)[w];
          float c[4];
          int8x4_to_float(x, c);
          d0 = fmaf(qv.x, c[0], d0);
          d1 = fmaf(qv.y, c[1], d1);
          d0 = fmaf(qv.z, c[2], d0);
          d1 = fmaf(qv.w, c[3], d1);
        } else {
          // a bf16 is the high half of a float32
          const float2 qv = reinterpret_cast<const float2*>(qj)[w];
          d0 = fmaf(qv.x, __uint_as_float(x << 16), d0);
          d1 = fmaf(qv.y, __uint_as_float(x & 0xffff0000u), d1);
        }
      }
      float sc = d0 + d1;
      if constexpr (Q8) sc *= ks_s[r];
      p_s[j][r] = sc;
    }
    __syncthreads();

    // softmax update: warp j owns head j
    if (warp < G) {
      float* pj = p_s[warp];
      float mx = kNeg;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, pj[r]);
      const float m_new = fmaxf(m, warp_max(mx));
      const float alpha = expf(m - m_new);
      float sum = 0.0f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(pj[r] - m_new);
        sum += p;
        pj[r] = Q8 ? p * vs_s[r] : p;
      }
      l = l * alpha + warp_sum(sum);
      m = m_new;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

    // numerator: four elements of one head per thread, over its rows
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int qd = tid % NQ + i * kThreads;
      const int j = qd / (HD / 4), e0 = (qd % (HD / 4)) * 4;
      const float* pj = p_s[j];
      const float alpha = alpha_s[j];
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = acc[i][e] * alpha;
      for (int r = grp; r < n; r += PAR) {
        float v[4];
        load4(v_s + r * HD + e0, v);
        const float p = pj[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = fmaf(p, v[e], a[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = a[e];
    }
    __syncthreads();
  }

  float* out = part + ((static_cast<long>(b) * hkv + kvh) * nsplit + sp) *
                          (G * (HD + 2));
  if constexpr (PAR > 1) {
    // sum the row groups in order
    reinterpret_cast<float4*>(red_s)[tid] =
        make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    __syncthreads();
    if (grp == 0) {
      for (int g = 1; g < PAR; ++g) {
        const float4 x = reinterpret_cast<const float4*>(red_s)[g * NQ + tid];
        acc[0][0] += x.x;
        acc[0][1] += x.y;
        acc[0][2] += x.z;
        acc[0][3] += x.w;
      }
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int qd = tid % NQ + i * kThreads;
      float* o = out + (qd / (HD / 4)) * (HD + 2) + 2 + (qd % (HD / 4)) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = acc[i][e];
    }
  }
  if (warp < G && lane == 0) {
    out[warp * (HD + 2)] = m;
    out[warp * (HD + 2) + 1] = l;
  }
}

// Pass 2: one warp per (slot b, KV head) merges the slot's splits in
// order, adds the new token's own term, writes the output and the new
// cache row (quantized first in the int8 form).
template <int HD, int G, bool Q8>
__global__ void __launch_bounds__(32)
    decode_attn_finish(const float* __restrict__ q, const void* k_new,
                       const void* v_new, void* kc_, void* vc_, float* ksc,
                       float* vsc, const int32_t* __restrict__ start,
                       int window, int s, int hkv, int nsplit, float scale,
                       const float* __restrict__ part,
                       float* __restrict__ out) {
  using D = Dims<HD, G, Q8>;
  using T = typename D::T;
  constexpr int EPL = D::EPL;
  T* kc = static_cast<T*>(kc_);
  T* vc = static_cast<T*>(vc_);
  const int b = blockIdx.x / hkv;
  const int kvh = blockIdx.x % hkv;
  const int h = hkv * G;
  const int lane = threadIdx.x;
  const int st = start[b];
  int lo, hi;
  visible_rows(st, s, window, &lo, &hi);
  const int n_act = hi > lo ? (hi - lo + kSplitRows - 1) / kSplitRows : 0;

  const bool write = st >= 0 && st < s;
  const long nrow = static_cast<long>(b) * hkv + kvh;  // (B, Hkv) index
  const long crow = ((static_cast<long>(b) * s + (write ? st : 0)) * hkv + kvh)
                    * HD;
  const long srow = (static_cast<long>(b) * s + (write ? st : 0)) * hkv + kvh;
  const size_t in_elt = Q8 ? sizeof(float) : sizeof(__nv_bfloat16);
  float kn[EPL], vn[EPL];
  new_row<T, EPL, Q8>(static_cast<const char*>(k_new) + nrow * HD * in_elt,
                      kc + crow, ksc + (Q8 ? srow : 0), write, lane, kn);
  new_row<T, EPL, Q8>(static_cast<const char*>(v_new) + nrow * HD * in_elt,
                      vc + crow, vsc + (Q8 ? srow : 0), write, lane, vn);

  const float* pb = part + nrow * nsplit * (G * (HD + 2));
  for (int j = 0; j < G; ++j) {
    float mm = kNeg;
    for (int sp = 0; sp < n_act; ++sp)
      mm = fmaxf(mm, pb[(sp * G + j) * (HD + 2)]);
    float ll = 0.0f, acc[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = 0.0f;
    for (int sp = 0; sp < n_act; ++sp) {
      const float* ps = pb + (sp * G + j) * (HD + 2);
      const float f = expf(ps[0] - mm);
      ll += ps[1] * f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] += ps[2 + lane * EPL + e] * f;
    }
    const float* qj = q + (static_cast<long>(b) * h + kvh * G + j) * HD;
    float d = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      d = fmaf(qj[lane * EPL + e] * scale, kn[e], d);
    const float sn = warp_sum(d);
    const float m_new = fmaxf(mm, sn);
    const float alpha = expf(mm - m_new);
    const float pn = expf(sn - m_new);
    const float l_new = ll * alpha + pn;
    float* oj = out + (static_cast<long>(b) * h + kvh * G + j) * HD;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      oj[lane * EPL + e] = (acc[e] * alpha + pn * vn[e]) / l_new;
  }
}

struct Args {
  const float* q;
  const void* k_new;
  const void* v_new;
  void* kc;
  void* vc;
  float* ksc;
  float* vsc;
  const int32_t* start;
  int b, s, hkv, window, nsplit;
  float scale;
  float* part;
  float* out;
};

template <int HD, int G, bool Q8>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  decode_attn_partial<HD, G, Q8>
      <<<dim3(a.b * a.hkv, a.nsplit), kThreads, 0, stream>>>(
          a.q, a.kc, a.vc, a.ksc, a.vsc, a.start, a.window, a.s, a.hkv,
          a.nsplit, a.scale, a.part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_finish<HD, G, Q8><<<a.b * a.hkv, 32, 0, stream>>>(
      a.q, a.k_new, a.v_new, a.kc, a.vc, a.ksc, a.vsc, a.start, a.window,
      a.s, a.hkv, a.nsplit, a.scale, a.part, a.out);
  return cudaGetLastError();
}

template <int HD, bool Q8>
cudaError_t launch_g(int g, const Args& a, cudaStream_t stream) {
  switch (g) {
    case 1: return launch<HD, 1, Q8>(a, stream);
    case 2: return launch<HD, 2, Q8>(a, stream);
    case 4: return launch<HD, 4, Q8>(a, stream);
    case 8: return launch<HD, 8, Q8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

long scratch_floats(int b, int s, int h, int hd) {
  const long nsplit = (s + kSplitRows - 1) / kSplitRows;
  return static_cast<long>(b) * h * nsplit * (hd + 2);
}

}  // namespace

extern "C" {

// Float32 scratch the caller allocates for one call (the splits' partial
// states): b * h * ceil(s / 256) * (hd + 2) values.
long vlut_decode_attention_scratch(int b, int s, int h, int hd) {
  return scratch_floats(b, s, h, hd);
}

// q: (b, h, hd) float32; k_new/v_new: (b, hkv, hd) bf16 (quantized == 0) or
// float32 (quantized == 1); kc/vc: (b, s, hkv, hd) bf16 or int8 caches,
// updated in place; ksc/vsc: (b, s, hkv) float32 scales (int8 form only,
// else null); start: (b,) int32; scratch: vlut_decode_attention_scratch
// floats; out: (b, h, hd) float32.  hd must be 128 or 256 and h / hkv one
// of 1, 2, 4, 8.
int vlut_decode_attention(const void* q, const void* k_new, const void* v_new,
                          void* kc, void* vc, void* ksc, void* vsc,
                          const void* start, int b, int s, int h, int hkv,
                          int hd, int window, float scale, int quantized,
                          void* scratch, void* out, void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || h % hkv != 0)
    return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), k_new, v_new, kc, vc,
         static_cast<float*>(ksc), static_cast<float*>(vsc),
         static_cast<const int32_t*>(start), b, s, hkv, window,
         (s + kSplitRows - 1) / kSplitRows, scale,
         static_cast<float*>(scratch), static_cast<float*>(out)};
  auto st = static_cast<cudaStream_t>(stream);
  const int g = h / hkv;
  cudaError_t err;
  if (hd == 128) {
    err = quantized ? launch_g<128, true>(g, a, st)
                    : launch_g<128, false>(g, a, st);
  } else if (hd == 256) {
    err = quantized ? launch_g<256, true>(g, a, st)
                    : launch_g<256, false>(g, a, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
