// Fused decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces vlut_tpu/ops/decode_attention.py:decode_attention_pallas
// (_fused_decode_attn_kernel, bf16 cache) and decode_attention_int8_pallas
// (_fused_decode_attn_int8_kernel, int8 codes + per-(row, head) float32
// scales).  One launch per layer and decode step does both halves of the
// step's attention:
//
//   * writes the new K/V row of every slot b into cache[b, start[b]] (the
//     int8 form quantizes it first: scale = max|x| * (1/127), codes =
//     rint(x / scale) clipped to +-127, as the JAX package's jitted
//     quantize_kv), unless start[b] lies outside [0, S);
//   * computes GQA attention of the slot's query heads over the cache rows
//     with row < start[b] (and row > start[b] - window when a window is
//     set), plus the new token itself as a separate term that uses the
//     cache-dtype value (bf16-rounded, or quantized then dequantized), in
//     float32 as the JAX kernel does at Precision.HIGHEST.
//
// Rows at or past start are never visible, so the order of the write and
// the reads does not matter.
//
// Bound: bytes.  A call must read the visible K and V rows once (rows x
// Hkv x hd x 2 bytes x 2 in bf16, half that plus 8 bytes of scales per row
// and head in int8), against 4 flops per element and query head; at the
// flagship (B 32, Hkv 8, H 32, hd 128, 31,424 rows) that is 129 MB (0.039
// ms at 3.35 TB/s) against 0.5 GFLOP of float32 (0.008 ms at 67 TFLOP/s).
// So the design has to keep copies in flight and spend few instructions
// and little shared-memory traffic per cache byte.
//
// Design: one launch, one block of four warps per (slot, KV head, split of
// `rows` cache rows; ops/decode_attention.py:attn_plan picks `rows`: the
// most that leave at least half a wave of blocks).  A split past the
// slot's visible rows exits at once.
//   * Copies: the block's first thread copies the slot's q rows of its KV
//     head and the new K and V rows into shared memory by three 1-D bulk
//     copies on one mbarrier (they are read for the q fragments and for the
//     new token's term).  The cache comes in stages of 16 rows.  The warps
//     form teams (one warp, or two or four where one warp's accumulators
//     would not fit); team i takes the block's stages i, i + teams, ...
//     Lane 0 of a team keeps its 2-4 stages in flight: K and V as 2-D TMA
//     boxes of 16 rows x 128 bytes in the 128-byte swizzle over the cache
//     seen as (B*S rows, Hkv*hd), on one mbarrier per stage; in int8 the
//     team's first warp also copies the stage's 16 K and 16 V scales
//     (cp.async, counted on the same mbarrier).  Rows of a stage past the
//     split's end (the next split's or slot's, a stale row, the scratch
//     row) are loaded but get p = 0.
//   * Products on the tensor cores, mma.sync m16n8k16 bf16 -> float32.  q
//     (times the softmax scale) and p are float32; each enters as three
//     bf16 terms hi + mid + lo, which equal it exactly, so the products
//     are those of float32 operands.  The terms sit in the rows of the A
//     operand: row 4t + j holds term t of query head j (four heads per
//     m-tile, two m-tiles at G 8), so lane l < 16 holds the hi and lo
//     terms of head (l / 4) % 4 and lane l + 16 its mid term; a score is
//     the sum of its lane's two rows and the partner lane's one (one
//     shuffle).  K is read by ldmatrix and V by ldmatrix.trans; the score
//     product's C fragment becomes the value product's A fragment in
//     registers (as in FlashAttention-2), where p is split.  bf16 cache
//     values are exact as B; int8 codes are too: each lane converts the
//     codes its ldmatrix returned, once per block, and the K scale is
//     applied to the score after the product, the V scale folded into p
//     before its split.  In int8 a lane's ldmatrix word holds four codes of
//     one K row (k = 4t..4t+3 of a 16-wide step, taken as k = 2t, 2t+1,
//     2t+8, 2t+9 with q laid out to match) and two codes of two V rows (an
//     even and an odd output column: the value product's columns are d and
//     d + 1 of each 16-wide step in two n-tiles).
//   * Online softmax in float32 per stage and head; a lane keeps its own
//     partial denominator.  At the end the teams' states meet in shared
//     memory in team order.  A (slot, KV head) with one split finishes in
//     its block; with more, every block stores its state, and the last to
//     arrive (elected by an acquire-release add on a counter per (slot, KV
//     head), which it resets) merges them in split order, adds the new
//     token, writes the output and the new cache row.  No float atomics: a
//     result does not depend on which block arrives last.
//
// On the H100 the bf16 call streams within a few percent of its copies
// alone; the int8 call is bound by its arithmetic and per-block latency
// (PERF.md, section 6).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;         // cache rows per stage
constexpr int kBox = kChunk * 128;  // one TMA box: 16 rows x 128 bytes
constexpr int kRingBytes = 65536;  // a block's stages: three blocks per SM
constexpr float kNeg = -1e30f;
constexpr float kRecip127 = 1.0f / 127.0f;  // the float32 reciprocal

template <int HD, int G, bool Q8>
struct Cfg {
  using T = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  static constexpr int MT = (G + 3) / 4;        // m-tiles of query heads
  static constexpr int CG = MT * HD / 128;      // warps per team
  static constexpr int NT = kWarps / CG;        // teams
  static constexpr int NCOL = HD / CG;          // value columns per warp
  static constexpr int NTW = NCOL / 8;          // value n-tiles per warp
  static constexpr int KS = HD / 16;            // k-steps of a score
  static constexpr int EPL = HD / 32;           // elements per lane
  static constexpr int ROW = HD * static_cast<int>(sizeof(T));
  static constexpr int NBOX = ROW / 128;        // boxes per K (V) stage
  static constexpr int SB = 2 * NBOX * kBox;    // bytes of one stage
  static constexpr int D0 = kRingBytes / (NT * SB);
  static constexpr int D = D0 < 2 ? 2 : (D0 > 4 ? 4 : D0);  // stages/team
  static constexpr int SLOTS = NT * D;
  static constexpr bool QREG = MT * HD <= 128;  // q's fragments in registers
  static constexpr int STATE = HD + 2;          // m, l, numerator
  static constexpr int RING = SLOTS * SB;
  static constexpr int SCALES = RING;           // Q8: [SLOTS][32] floats
  static constexpr int QFRAG = SCALES + (Q8 ? SLOTS * 128 : 0);
  static constexpr int BARS = QFRAG + (QREG ? 0 : MT * KS * 32 * 16);
  static constexpr int FLAG = BARS + (SLOTS + 2) * 8;  // after the bars
  static constexpr int FIN = FLAG + 16;  // q rows, new K and V rows (as given)
  static constexpr int SMEM = FIN + (G + 2) * HD * 4 + 1024;  // + slack
  static_assert(NT * G * STATE * 4 <= RING, "team states fit the ring");
  static_assert(NTW * MT * 4 == 64, "64 accumulators per lane");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A stage that never lands (a fault of the copies) stops the kernel with
// an error after some seconds instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// box at coordinates (c0 inner bytes, c1 row) of `map` into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16, from a 16-byte aligned address) into shared
// memory, counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// orders the team's earlier shared-memory reads before the TMA's writes to
// the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 4 bytes from global memory (none, and zeros written, when n is 0), whose
// completion is counted on `bar` as one of its expected arrivals
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int n,
                                          uint64_t* bar) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One more arrival at `cnt`, releasing the block's earlier writes (the
// block met at a barrier first) and acquiring the earlier arrivals';
// returns the count before it.
__device__ __forceinline__ int arrive(int* cnt) {
  int prev;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
               : "=r"(prev)
               : "l"(cnt)
               : "memory");
  return prev;
}

__device__ __forceinline__ void team_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Four 8 x 16-byte matrices: lanes 8i..8i+7 give the row addresses of
// matrix i; register i of lane 4g + t gets bytes 4t..4t+3 of its row g
// (with .trans: the 16-bit words t2 = 2t and 2t + 1 of column g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// mma.sync m16n8k16 bf16 x bf16 -> float32, D = A B + D.  Per lane (g =
// lane / 4, t = lane % 4): A reg 0 holds row g at k = 2t, 2t+1, reg 1 row
// g+8, regs 2 and 3 the same rows at k = 2t+8, 2t+9; B reg 0 column g at k
// = 2t, 2t+1, reg 1 at k = 2t+8, 2t+9; D rows g, g+8 at columns 2t, 2t+1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// x0, x1 (float32) as three bf16 pairs whose sums equal them exactly: hi =
// x rounded to bf16, mid = the rest rounded, lo = what is left (at most 8
// significant bits, so exact).  Low halves hold x0's terms.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(h);
  x1 -= __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(m);
  x1 -= __high2float(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(x0, x1));
}

// The A fragment of two k pairs (k = 2t, 2t+1 from x0, x1; k = 2t+8, 2t+9
// from y0, y1): rows g (term 0) and g + 8 (term 2) in lanes below 16, row
// g (term 1) above, where row g + 8 is unused (zero).
__device__ __forceinline__ void a_frag(float x0, float x1, float y0, float y1,
                                       bool upper, uint32_t (&a)[4]) {
  uint32_t xh, xm, xl, yh, ym, yl;
  split3(x0, x1, xh, xm, xl);
  split3(y0, y1, yh, ym, yl);
  a[0] = upper ? xm : xh;
  a[1] = upper ? 0u : xl;
  a[2] = upper ? ym : yh;
  a[3] = upper ? 0u : yl;
}

// Four int8 codes packed in a word as float32, exactly: each code plus 128
// becomes the low byte of 2^23's mantissa (a byte permute), and 2^23 + 128
// is subtracted.
__device__ __forceinline__ void int8x4_to_float(uint32_t x, float* v) {
  const uint32_t u = x ^ 0x80808080u;
  constexpr uint32_t kMagic = 0x4B000000u;  // 2^23
  constexpr float kBias = 8388608.0f + 128.0f;
  v[0] = __uint_as_float(__byte_perm(u, kMagic, 0x7650)) - kBias;
  v[1] = __uint_as_float(__byte_perm(u, kMagic, 0x7651)) - kBias;
  v[2] = __uint_as_float(__byte_perm(u, kMagic, 0x7652)) - kBias;
  v[3] = __uint_as_float(__byte_perm(u, kMagic, 0x7653)) - kBias;
}

// two small integers held as float32 as a bf16 pair (a's in the low half):
// a bf16 is a float32's high half, exact at 8 significant bits
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

__device__ __forceinline__ float load_f(const void* p, long i, bool is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// A byte of a K or V stage: box (byte / 128), row, the 16-byte unit XORed
// with row % 8 (the TMA's 128-byte swizzle).
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int byte) {
  return base + (byte >> 7) * kBox + row * 128 +
         ((((byte >> 4) & 7) ^ (row & 7)) << 4) + (byte & 15);
}

struct Params {
  const void* q;       // (B, H, hd) rows q_ld elements apart, bf16 or f32
  const void* k_new;   // (B, Hkv, hd) rows k_ld (v_ld) elements apart
  const void* v_new;
  void* kc;            // (B, S, Hkv, hd) caches
  void* vc;
  float* ksc;          // (B, S, Hkv) scales, int8 form
  float* vsc;
  const void* start;   // (B,) int32 or int64
  float* part;         // the splits' states
  int* counters;       // (B * Hkv,) zero between calls
  float* out;          // (B, H, hd) float32
  long q_ld, k_ld, v_ld;
  int q_bf16, new_bf16, start_i64;
  int s, hkv, window, rows, nsplit;
  float scale;
};

// The merge of n states (m, l, numerator) of head j, `stride` floats
// apart, in order: the lane's EPL numerator columns.
template <int EPL, bool GLOBAL>
__device__ __forceinline__ void merge_states(const float* src, int n,
                                             int stride, int lane, float& M,
                                             float& L, float (&acc)[EPL]) {
  auto ld = [](const float* p) { return GLOBAL ? __ldcg(p) : *p; };
  M = kNeg;
#pragma unroll 4
  for (int i = 0; i < n; ++i) M = fmaxf(M, ld(src + i * stride));
  L = 0.0f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float* st = src + i * stride;
    const float f = expf(ld(st) - M);
    L += ld(st + 1) * f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] += ld(st + 2 + lane * EPL + e) * f;
  }
}

// The new row of (b, kvh) as the cache stores it: its values as float32
// (the lane's EPL elements), written into cache row `row` when `write`.
template <int HD, bool Q8>
__device__ __forceinline__ void new_row(const void* src, bool src_bf16,
                                        void* dst_row, float* dst_scale,
                                        bool write, int lane, float* vals) {
  constexpr int EPL = HD / 32;
  float x[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) x[e] = load_f(src, lane * EPL + e, src_bf16);
  if constexpr (Q8) {
    float amax = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(x[e]));
    amax = warp_max(amax);
    const float sc = amax * kRecip127;
    const float inv = sc > 0.0f ? 1.0f / fmaxf(sc, 1e-30f) : 0.0f;
    int8_t* d = static_cast<int8_t*>(dst_row);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const float c = fminf(fmaxf(rintf(x[e] * inv), -127.0f), 127.0f);
      vals[e] = c * sc;
      if (write) d[lane * EPL + e] = static_cast<int8_t>(c);
    }
    if (write && lane == 0) *dst_scale = sc;
  } else {
    __nv_bfloat16* d = static_cast<__nv_bfloat16*>(dst_row);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const __nv_bfloat16 r = __float2bfloat16_rn(x[e]);
      vals[e] = __bfloat162float(r);
      if (write) d[lane * EPL + e] = r;
    }
  }
}

// Head j of (b, kvh) from its merged state: the new token's term, the
// output, and (warp 0 of the finishing block, when start is in range) the
// new cache rows.  `fin` holds the G q rows, then the new K and V rows, as
// the caller gave them (bf16 or float32).
template <int HD, int G, bool Q8>
__device__ __forceinline__ void finish(const Params& p, const uint8_t* fin,
                                       int b, int kvh, int j, int st,
                                       bool writer, int lane, float M, float L,
                                       const float (&acc)[HD / 32]) {
  constexpr int EPL = HD / 32;
  const int h = p.hkv * G;
  const bool write = writer && st >= 0 && st < p.s;
  const long row =
      (static_cast<long>(b) * p.s + (write ? st : 0)) * p.hkv + kvh;
  const uint8_t* kn_src = fin + G * HD * (p.q_bf16 ? 2 : 4);
  const uint8_t* vn_src = kn_src + HD * (p.new_bf16 ? 2 : 4);
  const size_t esz = Q8 ? 1 : 2;
  float kn[EPL], vn[EPL];
  new_row<HD, Q8>(kn_src, p.new_bf16, static_cast<char*>(p.kc) + row * HD * esz,
                  p.ksc + (Q8 ? row : 0), write, lane, kn);
  new_row<HD, Q8>(vn_src, p.new_bf16, static_cast<char*>(p.vc) + row * HD * esz,
                  p.vsc + (Q8 ? row : 0), write, lane, vn);
  float d = 0.0f;
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    d = fmaf(load_f(fin, j * HD + lane * EPL + e, p.q_bf16) * p.scale, kn[e],
             d);
  const float sn = warp_sum(d);
  const float m_new = fmaxf(M, sn);
  const float alpha = expf(M - m_new);
  const float pn = expf(sn - m_new);
  const float l_new = L * alpha + pn;
  float* o = p.out + (static_cast<long>(b) * h + kvh * G + j) * HD + lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; ++e) o[e] = (acc[e] * alpha + pn * vn[e]) / l_new;
}

template <int HD, int G, bool Q8>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv,
                       const Params p) {
  using C = Cfg<HD, G, Q8>;
  constexpr int MT = C::MT, CG = C::CG, NT = C::NT, D = C::D, KS = C::KS;
  constexpr int NTW = C::NTW, EPL = C::EPL;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes of the shared window
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* fbar = bars + C::SLOTS;  // the q and new rows' copies
  int* flag = reinterpret_cast<int*>(smem + C::FLAG);
  const uint8_t* fin = smem + C::FIN;

  const int pair = blockIdx.x, sp = blockIdx.y;
  const int b = pair / p.hkv, kvh = pair % p.hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int st = p.start_i64
                     ? static_cast<int>(static_cast<const int64_t*>(p.start)[b])
                     : static_cast<const int32_t*>(p.start)[b];
  const int hi = min(st, p.s);
  const int lo = p.window > 0 ? max(0, st - p.window + 1) : 0;
  const int n_act = hi > lo ? (hi - lo + p.rows - 1) / p.rows : 0;
  if (sp >= max(n_act, 1)) return;
  const int r0 = lo + sp * p.rows;
  const int r1 = min(hi, r0 + p.rows);
  const int nch = r1 > r0 ? (r1 - r0 + kChunk - 1) / kChunk : 0;

  const int team = warp / CG, member = warp % CG;
  const int nloc = nch > team ? (nch - team + NT - 1) / NT : 0;
  const int g = lane >> 2, t = lane & 3;
  const bool upper = lane >= 16;
  const long grow = static_cast<long>(b) * p.s;  // the slot's first row
  const int col = kvh * C::ROW;                  // the head's first byte

  if (tid == 0) {
    for (int i = 0; i < C::SLOTS; ++i) mbar_init(&bars[i], Q8 ? 33 : 1);
    mbar_init(fbar, 1);
    prefetch_tensormap(&tmk);
    prefetch_tensormap(&tmv);
  }
  __syncthreads();
  // the slot's q rows of this KV head and its new K and V rows, by the TMA
  // unit, for the score product's A fragments and the new token's term
  if (tid == 0) {
    const int qb = p.q_bf16 ? 2 : 4, nb = p.new_bf16 ? 2 : 4;
    mbar_arrive_expect(fbar, (G * qb + 2 * nb) * HD);
    const uint32_t dst = smem_addr(fin);
    bulk_load(dst, static_cast<const char*>(p.q) +
                       (static_cast<long>(b) * p.q_ld + kvh * G * HD) * qb,
              G * HD * qb, fbar);
    bulk_load(dst + G * HD * qb,
              static_cast<const char*>(p.k_new) +
                  (static_cast<long>(b) * p.k_ld + kvh * HD) * nb,
              HD * nb, fbar);
    bulk_load(dst + G * HD * qb + HD * nb,
              static_cast<const char*>(p.v_new) +
                  (static_cast<long>(b) * p.v_ld + kvh * HD) * nb,
              HD * nb, fbar);
  }

  // chunk i of this team into its slot (lane 0: the boxes; in int8 every
  // lane of the team's first warp: one scale)
  auto issue = [&](int i) {
    const int slot = team * D + i % D;
    uint64_t* bar = &bars[slot];
    const int rb = r0 + (team + i * NT) * kChunk;
    if (lane == 0) {
      mbar_arrive_expect(bar, C::SB);
      const uint32_t dst = smem_addr(smem + slot * C::SB);
#pragma unroll
      for (int x = 0; x < C::NBOX; ++x) {
        tma_load_2d(dst + x * kBox, &tmk, col + 128 * x,
                    static_cast<int>(grow + rb), bar);
        tma_load_2d(dst + (C::NBOX + x) * kBox, &tmv, col + 128 * x,
                    static_cast<int>(grow + rb), bar);
      }
    }
    if constexpr (Q8) {
      const int r = rb + (lane & 15);
      const bool ok = r < r1;
      const float* src = (lane < 16 ? p.ksc : p.vsc) +
                         ((grow + (ok ? r : r0)) * p.hkv + kvh);
      cp_async4(smem_addr(smem + C::SCALES + slot * 128 + lane * 4), src,
                ok ? 4 : 0, bar);
    }
  };
  if (member == 0) {
    for (int i = 0; i < min(D, nloc); ++i) issue(i);
  }

  // q * scale as the score product's A fragments: k-step ks, m-tile mt
  // (bf16 K: k pairs d0 + 2t and d0 + 2t + 8; int8: d0 + 4t and d0 + 4t +
  // 2, the order of the codes a lane's ldmatrix word holds)
  uint32_t qreg[C::QREG ? MT : 1][C::QREG ? KS : 1][4];
  uint4* qsm = reinterpret_cast<uint4*>(smem + C::QFRAG);
  mbar_wait(fbar, 0);
  {
    auto qfrag = [&](int mt, int ks, uint32_t (&a)[4]) {
      const int j = 4 * mt + (g & 3);
      if (j >= G) {
        a[0] = a[1] = a[2] = a[3] = 0u;
        return;
      }
      const int qr = j * HD;
      const int da = 16 * ks + (Q8 ? 4 * t : 2 * t);
      const int db = da + (Q8 ? 2 : 8);
      a_frag(load_f(fin, qr + da, p.q_bf16) * p.scale,
             load_f(fin, qr + da + 1, p.q_bf16) * p.scale,
             load_f(fin, qr + db, p.q_bf16) * p.scale,
             load_f(fin, qr + db + 1, p.q_bf16) * p.scale, upper, a);
    };
    if constexpr (C::QREG) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) qfrag(mt, ks, qreg[mt][ks]);
    } else {
      for (int i = warp; i < MT * KS; i += kWarps) {
        uint32_t a[4];
        qfrag(i / KS, i % KS, a);
        qsm[i * 32 + lane] = make_uint4(a[0], a[1], a[2], a[3]);
      }
      __syncthreads();
    }
  }
  auto qa = [&](int mt, int ks, uint32_t (&a)[4]) {
    if constexpr (C::QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qreg[mt][ks][e];
    } else {
      const uint4 v = qsm[(mt * KS + ks) * 32 + lane];
      a[0] = v.x;
      a[1] = v.y;
      a[2] = v.z;
      a[3] = v.w;
    }
  };

  float m[MT], l[MT], acc[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt] = kNeg;
    l[mt] = 0.0f;
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.0f;
  }

  // ldmatrix row addresses: lane's matrix mi = lane / 8, row lane % 8
  const int mi = lane >> 3;
  const int krow = (mi >> 1) * 8 + (lane & 7);  // K: n-tile mi / 2
  const int kbyte = (mi & 1) * 16;
  const int vrow = (mi & 1) * 8 + (lane & 7);   // V: k half mi % 2
  const int vbyte = (mi >> 1) * 16;

  for (int i = 0; i < nloc; ++i) {
    const int slot = team * D + i % D;
    const int rb = r0 + (team + i * NT) * kChunk;
    mbar_wait(&bars[slot], (i / D) & 1);
    const uint32_t kb = smem_addr(smem + slot * C::SB);
    const uint32_t vb = kb + C::NBOX * kBox;
    const float* scl =
        reinterpret_cast<const float*>(smem + C::SCALES + slot * 128);

    // scores S = (q * scale) K^T, three terms per head
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.0f;
    if constexpr (Q8) {
#pragma unroll
      for (int kk = 0; kk < KS / 2; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, swz(kb, krow, 32 * kk + kbyte));
#pragma unroll
        for (int x = 0; x < 4; ++x) {  // n-tile x / 2, k-step 2kk + x % 2
          float f[4];
          int8x4_to_float(r[x], f);
          const uint32_t b0 = bf16_pair(f[0], f[1]), b1 = bf16_pair(f[2], f[3]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            qa(mt, 2 * kk + (x & 1), a);
            mma_bf16(s[mt][x >> 1], a, b0, b1);
          }
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t r[4];
        ldmatrix_x4(r, swz(kb, krow, 32 * ks + kbyte));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          qa(mt, ks, a);
          mma_bf16(s[mt][0], a, r[0], r[1]);
          mma_bf16(s[mt][1], a, r[2], r[3]);
        }
      }
    }

    // online softmax per head; p (times the V scale) as the value
    // product's A fragment
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float sc[2][2], pv[2][2];
      bool ok[2][2];
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = n * 8 + 2 * t + e;  // the stage's row
          const float part = s[mt][n][e] + s[mt][n][e + 2];
          float v = part + __shfl_xor_sync(0xffffffffu, part, 16);
          if constexpr (Q8) v *= scl[r];
          ok[n][e] = rb + r < r1;
          sc[n][e] = ok[n][e] ? v : kNeg;
          mx = fmaxf(mx, sc[n][e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[mt], mx);
      const float alpha = expf(m[mt] - m_new);
      m[mt] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = ok[n][e] ? expf(sc[n][e] - m_new) : 0.0f;
          sum += pe;
          if constexpr (Q8) {
            pv[n][e] = ok[n][e] ? pe * scl[16 + n * 8 + 2 * t + e] : 0.0f;
          } else {
            pv[n][e] = pe;
          }
        }
      }
      l[mt] = l[mt] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] *= alpha;
      a_frag(pv[0][0], pv[0][1], pv[1][0], pv[1][1], upper, pa[mt]);
    }

    // numerator O += P V over the warp's columns
    if constexpr (Q8) {
#pragma unroll
      for (int cb = 0; cb < NTW / 4; ++cb) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, swz(vb, vrow, member * C::NCOL + 32 * cb + vbyte));
        float f[4][4];
#pragma unroll
        for (int x = 0; x < 4; ++x) int8x4_to_float(r[x], f[x]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // columns 16 (q / 2) + 2c + q % 2
          const int h = q >> 1, par = q & 1;
          const uint32_t b0 = bf16_pair(f[2 * h][par], f[2 * h][2 + par]);
          const uint32_t b1 =
              bf16_pair(f[2 * h + 1][par], f[2 * h + 1][2 + par]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_bf16(acc[mt][4 * cb + q], pa[mt], b0, b1);
        }
      }
    } else {
#pragma unroll
      for (int cb = 0; cb < NTW / 2; ++cb) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, swz(vb, vrow, 2 * (member * C::NCOL + 16 * cb) + vbyte));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * cb], pa[mt], r[0], r[1]);
          mma_bf16(acc[mt][2 * cb + 1], pa[mt], r[2], r[3]);
        }
      }
    }

    // the team is done with the slot: its next stage goes in
    if constexpr (CG == 1) {
      __syncwarp();
    } else {
      team_sync(1 + team, CG * 32);
    }
    if (member == 0 && i + D < nloc) {
      if (lane == 0) fence_proxy_async();
      issue(i + D);
    }
  }

  // the teams' states meet in shared memory (the ring is free now)
  __syncthreads();
  float* tst = reinterpret_cast<float*>(smem);  // [NT][G][STATE]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int j = 4 * mt + (g & 3);
    float lt = l[mt] + __shfl_xor_sync(0xffffffffu, l[mt], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    float* dst = tst + (team * G + j) * C::STATE;
    const bool mine = !upper && j < G;
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float part = acc[mt][n][e] + acc[mt][n][e + 2];
        const float v = part + __shfl_xor_sync(0xffffffffu, part, 16);
        int d;
        if constexpr (Q8) {  // n-tile 4cb + q: columns 16 (q / 2) + 2c + q % 2
          d = member * C::NCOL + 32 * (n >> 2) + 16 * ((n >> 1) & 1) +
              2 * (2 * t + e) + (n & 1);
        } else {
          d = member * C::NCOL + 8 * n + 2 * t + e;
        }
        if (mine) dst[2 + d] = v;
      }
    }
    if (mine && member == 0 && t == 0) {
      dst[0] = m[mt];
      dst[1] = lt;
    }
  }
  __syncthreads();

  const bool alone = n_act <= 1;
  float M, L, o[EPL];
  for (int j = warp; j < G; j += kWarps) {
    merge_states<EPL, false>(tst + j * C::STATE, NT, G * C::STATE, lane, M,
                             L, o);
    if (alone) {
      finish<HD, G, Q8>(p, fin, b, kvh, j, st, warp == 0, lane, M, L, o);
    } else {
      float* dst =
          p.part +
          ((static_cast<long>(pair) * p.nsplit + sp) * G + j) * C::STATE;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dst[2 + lane * EPL + e] = o[e];
      if (lane == 0) {
        dst[0] = M;
        dst[1] = L;
      }
    }
  }
  if (alone) return;

  // the last block of the (slot, KV head) to arrive merges the splits
  __syncthreads();
  if (tid == 0) *flag = arrive(&p.counters[pair]) == n_act - 1;
  __syncthreads();
  if (!*flag) return;
  const float* src = p.part + static_cast<long>(pair) * p.nsplit * G * C::STATE;
  for (int j = warp; j < G; j += kWarps) {
    merge_states<EPL, true>(src + j * C::STATE, n_act, G * C::STATE, lane, M,
                            L, o);
    finish<HD, G, Q8>(p, fin, b, kvh, j, st, warp == 0, lane, M, L, o);
  }
  if (tid == 0) p.counters[pair] = 0;
}

// cuTensorMapEncodeTiled, looked up once through the runtime (the library
// links only the CUDA runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                            : nullptr;
  }();
  return fn;
}

// The cache as a 2-D byte tensor (B*S rows of `inner` bytes) in boxes of
// 128 bytes x 16 rows, 128-byte swizzle.  Encoded per call: keeping the
// maps by pointer and shape left the host's dispatch of a call unchanged
// (bench/attention_study.py; PERF.md, section 6).
bool encode_map(CUtensorMap* map, const void* base, long inner, long rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner)};
  const cuuint32_t box[2] = {128, kChunk};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int G, bool Q8>
int launch(const Params& p, int b, cudaStream_t stream) {
  using C = Cfg<HD, G, Q8>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attn_kernel<HD, G, Q8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long inner = static_cast<long>(p.hkv) * C::ROW;
  const long rows = static_cast<long>(b) * p.s;
  CUtensorMap tmk, tmv;
  if (!encode_map(&tmk, p.kc, inner, rows) ||
      !encode_map(&tmv, p.vc, inner, rows))
    return static_cast<int>(cudaErrorNotSupported);
  decode_attn_kernel<HD, G, Q8>
      <<<dim3(b * p.hkv, p.nsplit), kThreads, C::SMEM, stream>>>(tmk, tmv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool Q8>
int launch_g(int g, const Params& p, int b, cudaStream_t stream) {
  switch (g) {
    case 1: return launch<HD, 1, Q8>(p, b, stream);
    case 2: return launch<HD, 2, Q8>(p, b, stream);
    case 4: return launch<HD, 4, Q8>(p, b, stream);
    case 8: return launch<HD, 8, Q8>(p, b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One call of #7 (quantized == 0) or #8.  q: (b, h, hd) rows q_ld elements
// apart, bf16 (q_bf16) or float32; k_new/v_new: (b, hkv, hd) rows k_ld /
// v_ld elements apart, bf16 (new_bf16) or float32 (each slot's rows
// 16-byte aligned: they are copied whole); kc/vc: (b, s, hkv, hd) bf16
// or int8 caches, updated in place, 16-byte aligned; ksc/vsc: (b, s, hkv)
// float32 scales (int8 form only, else null); start: (b,) int32 or int64
// (start_i64); rows: cache rows per block, a multiple of 16, and nsplit >=
// ceil(visible rows / rows) for every slot; part: b * hkv * nsplit * h /
// hkv * (hd + 2) floats; counters: b * hkv ints, zero (and zero again
// after the call); out: (b, h, hd) float32.  hd must be 128 or 256 and h /
// hkv one of 1, 2, 4, 8.
int vlut_decode_attn(const void* q, long q_ld, int q_bf16, const void* k_new,
                     long k_ld, const void* v_new, long v_ld, int new_bf16,
                     void* kc,
                     void* vc, void* ksc, void* vsc, const void* start,
                     int start_i64, int b, int s, int h, int hkv, int hd,
                     int window, float scale, int quantized, int rows,
                     int nsplit, void* part, void* counters, void* out,
                     void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || h % hkv != 0 || rows <= 0 ||
      rows % kChunk != 0 || nsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k_new, v_new, kc, vc, static_cast<float*>(ksc),
           static_cast<float*>(vsc), start, static_cast<float*>(part),
           static_cast<int*>(counters), static_cast<float*>(out), q_ld, k_ld,
           v_ld, q_bf16, new_bf16, start_i64, s, hkv, window, rows, nsplit,
           scale};
  auto st = static_cast<cudaStream_t>(stream);
  const int g = h / hkv;
  if (hd == 128) {
    return quantized ? launch_g<128, true>(g, p, b, st)
                     : launch_g<128, false>(g, p, b, st);
  }
  if (hd == 256) {
    return quantized ? launch_g<256, true>(g, p, b, st)
                     : launch_g<256, false>(g, p, b, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
