// The small-M ternary projections for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces two TPU kernels of vlut_tpu/ops/pallas_gemm.py:
//   * ternary_gemm_decode (_decode_kernel, :361; its pipelined form
//     _decode_kernel_pipe, :454, computes the same): prologue (RMSNorm /
//     silu*up [+ sub-norm] / nothing) -> bf16 round (not in plain mode) ->
//     per-row int8 quantization, ternary GEMM, epilogue (acc*xs)*ws
//     [+ residual in the output dtype].  Here: vlut_decode_prologue, then
//     vlut_decode_gemm.
//   * ternary_gemm_fused_quant (_fused_gemm_kernel, :245): the same two
//     launches with the prologue in plain mode.
//
// What bounds them on an H100: at M <= 64 each packed weight byte is used
// by at most 64 rows, so moving the weights from memory is the bound (qkv of
// llama3_8b at M 32: 6.3 MB, 1.9 us at 3.35 TB/s).  At that rate one SM
// receives about 14.5 packed bytes per clock, and everything done per byte
// has to fit beside it: the decode, the reads of x and the mma issue.
//
// The design:
//   * The prologue reads x (and the up half) once into shared memory, a
//     cluster of blocks per row (one per 4,096 of K), reduces the sum of
//     squares, the absolute maximum and the codes' row sum through
//     distributed shared memory, and writes the int8 codes in x's natural
//     (M, Kp) order.  It lets the GEMM start early (programmatic dependent
//     launch): the GEMM's weight copies run while the prologue does.
//   * The GEMM block owns BN (128 or 256) output columns and a range of
//     whole pack blocks of K (ops/ternary_gemm.py:decode_plan splits K where
//     the column tiles leave SMs idle).  One thread keeps a ring of 2-6
//     stages filled by the TMA unit: one stage is one pack block per
//     consumer K group, as 2-D boxes of 128 columns x the slab rows (whole
//     128-byte lines in the 128-byte swizzle) and the codes of the same K as
//     boxes of 128 bytes x the rows.  Every x code thus comes from L2 once
//     per block, not once per 32 columns.
//   * Eight consumer warps sit as WN column groups x WK K groups; a warp
//     owns 64 or 128 columns (as many as 128 registers of accumulators
//     allow), reads its packed words from the ring, transposes four rows x
//     four columns per word quad and takes B for each mma chunk with one
//     shift and one mask: the mma's 32-deep chunk q of a pack block is field
//     q's 32 consecutive K (as in the tiled kernel), the fields {0, 1, 2}
//     enter the mma as unsigned bytes, and the epilogue subtracts the row
//     sum of the codes (the trits are the fields less one).  i1's five
//     base-3 digits come from one multiply-shift division per digit on two
//     bytes at once.  A is the codes as they lie, read by ldmatrix.
//   * The K groups meet in shared memory (each warp stores its sums in its
//     group's tile; the epilogue adds them).  The splits of K add their
//     sums into a float workspace by vector atomic adds in L2 (exact: the
//     integers stay below 2^24); the last to arrive at its tile's counter
//     applies the epilogue, every load asked for before any value is used.
//     The prologue zeroes the workspace, so a call stays two launches.
//     Integer sums are exact, so no plan changes a bit.  (Clusters of a
//     tile's splits summing through distributed shared memory did not fit
//     one wave of 200 KB blocks, and an epilogue whose loads waited on each
//     other took longer than the K loop: PERF.md §6.)

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trit_decode.cuh"

namespace {

using vlut::kSlab;

enum Mode { kPlain = 0, kNorm = 1, kSiluMul = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_f(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f(void* p, long i, float v,
                                        int is_bf16) {
  if (is_bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// (acc * xs) * ws [+ the residual res in the output dtype]:
// vlut_tpu/ops/pallas_gemm.py:448-451.  In bf16 the product is rounded
// before the add; in float32 the reference contracts the residual add into
// one fused multiply-add, so fmaf here.
__device__ __forceinline__ float epilogue(int acc, float xs, float ws,
                                          bool has_res, float res,
                                          int out_bf16) {
  const float p = static_cast<float>(acc) * xs;
  if (!has_res) return out_bf16 ? bf16_round(p * ws) : p * ws;
  if (!out_bf16) return fmaf(p, ws, res);
  return bf16_round(res + bf16_round(p * ws));
}

// Programmatic dependent launch: the prologue lets the GEMM start at once;
// the GEMM waits for the prologue's results (and memory) before it reads
// them.  Without the launch attribute both are no-ops.
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// --- the prologue -------------------------------------------------------------

constexpr int kProThreads = 512;
// the row's float inputs live in dynamic shared memory: K <= 57,856
constexpr int kProSmemMax = 227 * 1024 - 1024;

template <bool kMax, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (kMax) {
    return fmaxf(a, b);
  } else {
    return a + b;
  }
}

template <typename T, bool kMax>
__device__ T block_reduce(T v, T* sh) {
  for (int o = 16; o > 0; o >>= 1) {
    v = combine<kMax>(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous reduction's reads of sh are done
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = lane < kProThreads / 32 ? sh[lane] : T(0);
  for (int o = 16; o > 0; o >>= 1) {
    v = combine<kMax>(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;  // every thread holds the result
}

// The sum (or maximum) of v over the cluster: each block reduces its
// threads' values and posts the result in its shared memory; every block
// then combines the posts of all in rank order, so all hold the same value.
template <typename T, bool kMax, bool kCluster>
__device__ T cluster_reduce(T v, T* sh, T* post) {
  namespace cg = cooperative_groups;
  v = block_reduce<T, kMax>(v, sh);
  if constexpr (!kCluster) return v;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *post = v;
  cluster.sync();
  T r = *cluster.map_shared_rank(post, 0);
  for (unsigned b = 1; b < cluster.num_blocks(); ++b) {
    r = combine<kMax>(r, *cluster.map_shared_rank(post, b));
  }
  return r;
}

// A cluster of blocks per row (grid (cs, m), clusters of (cs, 1)): block b
// takes K in [b * chunk, (b + 1) * chunk), chunk a multiple of 16.  x (and
// x2) are read once into shared memory as the prologue's float h before the
// norm; the norm, the bf16 round and the absolute maximum take one pass over
// shared memory; then the codes (zero at K >= k), written four per word in
// natural order, and their row sum.  The sums of squares, the maxima and
// the row sums meet through distributed shared memory.  Block (0, 0) also
// zeroes the split's workspace: block (0, row) row `row` of its sums (np
// floats), block (0, 0) also the n_counters counters behind the m rows.
template <bool kCluster>
__global__ void __launch_bounds__(kProThreads) decode_prologue_kernel(
    const void* x1, const void* x2, long ld, int in_bf16, int k, int kp,
    int chunk, const float* g, int mode, int sub_norm, float norm_n, float eps,
    int8_t* codes, float* xs, int* rowsum, float* work, int np,
    int n_counters, int m) {
  extern __shared__ float h[];
  __shared__ float shf[32], post_ss, post_amax;
  __shared__ int shi[32], post_rs;
  grid_dep_launch();
  const int row = blockIdx.y, tid = threadIdx.x;
  const int k0 = blockIdx.x * chunk, k1 = min(kp, k0 + chunk);
  if (work != nullptr && blockIdx.x == 0) {
    float4* wr = reinterpret_cast<float4*>(work + static_cast<long>(row) * np);
    for (int i = tid; i < np / 4; i += kProThreads) wr[i] = make_float4(0, 0, 0, 0);
    if (row == 0) {
      int* counters = reinterpret_cast<int*>(work + static_cast<long>(m) * np);
      for (int i = tid; i < n_counters; i += kProThreads) counters[i] = 0;
    }
  }
  const long base = static_cast<long>(row) * ld;
  const bool normed = mode == kNorm || sub_norm;

  float ss = 0.0f;
  for (int i = k0 + tid; i < min(k, k1); i += kProThreads) {
    float v = load_f(x1, base + i, in_bf16);
    if (mode == kSiluMul) {
      v = v * (1.0f / (1.0f + expf(-v))) * load_f(x2, base + i, in_bf16);
      if (sub_norm) v = bf16_round(v);  // silu*up is materialized in bf16
    }
    h[i - k0] = v;
    ss += v * v;
  }
  float inv_rms = 1.0f;
  if (normed) {
    ss = cluster_reduce<float, false, kCluster>(ss, shf, &post_ss);
    inv_rms = 1.0f / sqrtf(ss / norm_n + eps);
  }
  float amax = 0.0f;
  for (int i = k0 + tid; i < min(k, k1); i += kProThreads) {  // own h[i]
    float v = h[i - k0];
    if (normed) v = v * inv_rms * g[i];
    if (mode != kPlain) v = bf16_round(v);
    h[i - k0] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  // its barriers publish h
  amax = cluster_reduce<float, true, kCluster>(amax, shf, &post_amax);
  const float inv = amax > 0.0f ? 127.0f / fmaxf(amax, 1e-30f) : 0.0f;
  // amax * (1/127), as the Pallas kernels compute their amax / 127.0
  if (blockIdx.x == 0 && tid == 0) xs[row] = amax * (1.0f / 127.0f);

  int rs = 0;
  uint32_t* cw = reinterpret_cast<uint32_t*>(codes + static_cast<long>(row) * kp);
  for (int i = k0 / 4 + tid; i < k1 / 4; i += kProThreads) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = 4 * i + j;
      // rintf rounds half to even, as jnp.round does
      const int c = kk < k ? static_cast<int>(fminf(
                                 fmaxf(rintf(h[kk - k0] * inv), -127.0f), 127.0f))
                           : 0;
      rs += c;
      word |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(c)))
              << (8 * j);
    }
    cw[i] = word;
  }
  rs = cluster_reduce<int, false, kCluster>(rs, shi, &post_rs);
  if (blockIdx.x == 0 && tid == 0) rowsum[row] = rs;
  if constexpr (kCluster) {
    cooperative_groups::this_cluster().sync();  // the posts outlive their reads
  }
}

// --- the GEMM -------------------------------------------------------------------

// Eight mma warps, two per scheduler, so that each may hold 255 registers
// (a ninth warp would cap them at 168); thread 0 also feeds the ring.
constexpr int kConsumers = 8;
constexpr int kGemmThreads = kConsumers * 32;
// the dynamic shared memory a block may take, less 1 KB for the static part
// and the 1024-byte alignment of the dynamic one
constexpr int kSmemMax = 227 * 1024 - 1024;

template <int MTL, int BN, bool I1>
struct Cfg {
  static constexpr int kKb = I1 ? 160 : 128;
  static constexpr int kNq = I1 ? 5 : 4;  // 32-deep mma chunks per pack block
  // 32-column groups per warp: 128 registers of accumulators at most (i1
  // keeps two words of digit state per word, so it takes two groups)
  static constexpr int kL = (!I1 && MTL <= 2) ? 4 : 2;
  static constexpr int kNw = 32 * kL;           // columns per warp
  static constexpr int kWn = BN / kNw;          // warp columns
  static constexpr int kWk = kConsumers / kWn;  // K groups = pack blocks per stage
  static constexpr int kRows = 16 * MTL;
  // x: boxes of 128 bytes of K x kRows rows covering the stage's K
  static constexpr int kXBoxes = (kWk * kKb + 127) / 128;
  static constexpr int kXBytes = kXBoxes * kRows * 128;
  // weights: BN / 128 boxes of 128 columns x kWk * 32 slab rows
  static constexpr int kWBytes = kWk * kSlab * BN;
  static constexpr int kStage = kXBytes + kWBytes;
  static constexpr int kRing = kSmemMax / kStage < 6 ? kSmemMax / kStage : 6;
  static constexpr int kSmem = kRing * kStage;
  static constexpr int kRedPitch = BN + 1;  // conflict-free stores and loads
  static_assert(kWn * kWk == kConsumers, "warp layout");
  static_assert(kRing >= 2, "ring depth");
  static_assert(kWk * kSlab <= 256, "TMA box rows");
  static_assert(kWk * kRows * kRedPitch * 4 <= kSmem, "reduction tiles");
  static_assert(kXBytes % 1024 == 0 && kWBytes % 1024 == 0, "box alignment");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The stage copies are the TMA unit's: one thread asks for a whole box of
// a tensor (described by a CUtensorMap the host encodes per call), the
// unit zero-fills what lies outside the tensor and counts the bytes it
// writes on an mbarrier, whose phase completes when the one arrival and
// every expected byte are in.
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// box at coordinates (c0 inner, c1 outer) of `map` into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// brings a tensor map's descriptor to the TMA unit ahead of its first copy
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// orders the block's earlier shared-memory reads (published by the empty
// barrier) before the TMA's writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8 x 16-byte matrices: lanes 8i..8i+7 give the row addresses of
// matrix i, register i of lane 4g + t gets bytes 4t..4t+3 of its row g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// mma.sync m16n8k32, int8 codes x uint8 fields -> int32, D = A B + D (A
// row-major 16 x 32, B column-major 32 x 8).  Per lane (g = lane / 4, t =
// lane % 4): A reg 0 holds row g at k = 4t..4t+3, reg 1 row g+8, regs 2
// and 3 the same rows at k = 16+4t..; B reg 0 holds column g at k =
// 4t..4t+3, reg 1 at k = 16+4t..; D holds rows g, g+8 at columns 2t, 2t+1.
__device__ __forceinline__ void mma_s8u8(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// work[0..3] += (a, b, c, d), one vector atomic add in L2 (16-byte aligned)
__device__ __forceinline__ void red_add_v4(float* work, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(work),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// 4 x 4 byte transpose: byte j of v[i] becomes byte i of v[j]
__device__ __forceinline__ void transpose4(uint32_t (&v)[4]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  v[0] = __byte_perm(t0, t2, 0x5410);
  v[1] = __byte_perm(t0, t2, 0x7632);
  v[2] = __byte_perm(t1, t3, 0x5410);
  v[3] = __byte_perm(t1, t3, 0x7632);
}

// i1 digits of four bytes, two bytes per step: the even bytes in the low
// halves of lo's 16-bit lanes, the odd ones in hi's.  One step takes the
// quotient by 3 of each lane (exact below 243) and returns the remainders,
// the next digit, as four bytes.
__device__ __forceinline__ uint32_t i1_step(uint32_t& lo, uint32_t& hi) {
  const uint32_t ql = ((lo * 171u) >> 9) & 0x007f007fu;
  const uint32_t qh = ((hi * 171u) >> 9) & 0x007f007fu;
  const uint32_t d = (lo - 3u * ql) | ((hi - 3u * qh) << 8);
  lo = ql;
  hi = qh;
  return d;
}

// The epilogue of one column of the tile at rows row0 + step * j < m:
// (sum - row sum) * xs * ws [+ the residual], in bf16 or float32 out.
template <bool kBf16, int kPer>
__device__ __forceinline__ void finish(const int (&sum)[kPer],
                                       const int* srs, const float* sxs,
                                       float wsv, const void* res, int res_ld,
                                       int n_res, void* out, int m, int np,
                                       int row0, int col, int step) {
  float rv[kPer];
  const bool has_res = res != nullptr && col < n_res;
  if (res != nullptr) {
    const int rc = min(col, n_res - 1);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      rv[j] = load_f(res, min(row0 + j * step, m - 1) * res_ld + rc, kBf16);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int row = row0 + j * step;
    if (row < m) {
      // the fields are the trits plus one: less the codes' row sum
      store_f(out, row * np + col,
              epilogue(sum[j] - srs[row], sxs[row], wsv, has_res,
                       res != nullptr ? rv[j] : 0.0f, kBf16),
              kBf16);
    }
  }
}

// The GEMM; see the note at the top.  Grid (np / BN, splits); block z takes
// pack blocks [z nb / splits, (z + 1) nb / splits).  Warp w takes columns
// (w % WN) * Nw.. of the tile and pack block w / WN of every stage.  Thread
// 0 asks for the first stages (their weights before the prologue is done),
// then, at the top of stage s, for stage s - 1 + R into the slot that
// stage s - 1 leaves once every thread has arrived on its empty barrier;
// the ring's other R - 1 stages cover the wait.
//
// A consumer lane 4g + t reads, for its 32-column group l, the 32-bit words
// of columns 4g..4g+3 of the group at slab rows 4t+i and 16+4t+i (i < 4)
// of its pack block and transposes them, so that word e holds column 4g+e
// at those four rows: B registers 0 and 1 of n-tile 4l+e, whose mma column
// g is the group's column 4g + e (the epilogue puts it back in place).
// Field (digit) q of those bytes is B for chunk q, whose A is the codes of
// K = 32q..32q+31 of the pack block.
template <int MTL, int BN, bool I1>
__global__ void __launch_bounds__(kGemmThreads, 1) decode_gemm_kernel(
    const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmw, const float* __restrict__ xs,
    const int* __restrict__ rowsum, const float* __restrict__ ws, int m,
    int nb, int np, int splits, float* work, const void* res,
    int res_ld,
    int n_res, void* out, int out_bf16) {
  using C = Cfg<MTL, BN, I1>;
  constexpr int R = C::kRing, S = C::kWk, L = C::kL;
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[R], empty[R];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int p0 = static_cast<int>(static_cast<long>(blockIdx.y) * nb / splits);
  const int nbs =
      static_cast<int>(static_cast<long>(blockIdx.y + 1) * nb / splits) - p0;
  const int ns = (nbs + S - 1) / S;
  auto stage = [&](int s) { return smem + (s % R) * C::kStage; };

  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mbar_init(&full[r], 1);
      mbar_init(&empty[r], kConsumers * 32);
    }
  }
  __syncthreads();

  auto weights = [&](int s) {
    uint64_t* bar = &full[s % R];
    mbar_arrive_expect(bar, C::kStage);
    const uint32_t dw = smem_addr(stage(s) + C::kXBytes);
#pragma unroll
    for (int b = 0; b < BN / 128; ++b) {
      tma_load_2d(dw + b * S * kSlab * 128, &tmw, n0 + 128 * b,
                  (p0 + s * S) * kSlab, bar);
    }
  };
  auto codes = [&](int s) {
    const uint32_t dx = smem_addr(stage(s));
#pragma unroll
    for (int b = 0; b < C::kXBoxes; ++b) {
      tma_load_2d(dx + b * C::kRows * 128, &tmx,
                  (p0 + s * S) * C::kKb + 128 * b, 0, &full[s % R]);
    }
  };
  if (tid == 0) {
    prefetch_tensormap(&tmw);
    prefetch_tensormap(&tmx);
    const int first = ns < R ? ns : R;
    for (int s = 0; s < first; ++s) weights(s);
    grid_dep_wait();  // x's codes are the prologue's
    for (int s = 0; s < first; ++s) codes(s);
  }

  const int wn = warp % C::kWn, wk = warp / C::kWn;
  const int g = lane >> 2, t = lane & 3;
  int acc[MTL][4 * L][4];
#pragma unroll
  for (int i = 0; i < MTL; ++i) {
#pragma unroll
    for (int j = 0; j < 4 * L; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }
  {
    // ldmatrix: lane's row (lane & 15) of each 16-row tile, the 16-byte
    // half lane >> 4 of a chunk; the 128-byte swizzle XORs a row's 16-byte
    // units with row % 8 = lane % 8, so the eight rows of a matrix fall in
    // eight bank groups
    const uint32_t xrow = (lane & 15) * 128;
    const int xhi = lane >> 4, xsw = lane & 7;
    for (int s = 0; s < ns; ++s) {
      if (tid == 0 && s > 0 && s - 1 + R < ns) {
        mbar_wait(&empty[(s - 1) % R], ((s - 1) / R) & 1);
        fence_proxy_async();
        weights(s - 1 + R);
        codes(s - 1 + R);
      }
      __syncwarp();  // warp 0 meets again before its ldmatrix and mma
      mbar_wait(&full[s % R], (s / R) & 1);
      if (s * S + wk < nbs) {
        const uint8_t* wst = stage(s) + C::kXBytes + wk * kSlab * 128;
        uint32_t w[L][2][4];
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const int cb = wn * C::kNw + 32 * l + 4 * g;
          const uint8_t* bp = wst + (cb >> 7) * S * kSlab * 128;
          const int u = (cb & 127) >> 4, in = cb & 15;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 16 * hh + 4 * t + i;
              w[l][hh][i] = *reinterpret_cast<const uint32_t*>(
                  bp + j * 128 + ((u ^ (j & 7)) << 4) + in);
            }
            transpose4(w[l][hh]);
          }
        }
        uint32_t lo[L][2][4], hi[L][2][4];  // i1: the digits still to come
        if constexpr (I1) {
#pragma unroll
          for (int l = 0; l < L; ++l) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                lo[l][hh][e] = w[l][hh][e] & 0x00ff00ffu;
                hi[l][hh][e] = (w[l][hh][e] >> 8) & 0x00ff00ffu;
              }
            }
          }
        }
        const uint32_t xa = smem_addr(stage(s)) + xrow;
#pragma unroll
        for (int q = 0; q < C::kNq; ++q) {
          const int off = wk * C::kKb + 32 * q + 16 * xhi;  // K in the stage
          uint32_t a[MTL][4];
#pragma unroll
          for (int mt = 0; mt < MTL; ++mt) {
            ldmatrix_x4(a[mt], xa + (off >> 7) * C::kRows * 128 + mt * 16 * 128 +
                                   ((((off >> 4) & 7) ^ xsw) << 4));
          }
#pragma unroll
          for (int l = 0; l < L; ++l) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              uint32_t b0, b1;
              if constexpr (I1) {
                if (q < 4) {
                  b0 = i1_step(lo[l][0][e], hi[l][0][e]);
                  b1 = i1_step(lo[l][1][e], hi[l][1][e]);
                } else {  // the last quotient is the fifth digit
                  b0 = lo[l][0][e] | (hi[l][0][e] << 8);
                  b1 = lo[l][1][e] | (hi[l][1][e] << 8);
                }
              } else {
                b0 = (w[l][0][e] >> (2 * q)) & 0x03030303u;
                b1 = (w[l][1][e] >> (2 * q)) & 0x03030303u;
              }
#pragma unroll
              for (int mt = 0; mt < MTL; ++mt) mma_s8u8(acc[mt][4 * l + e], a[mt], b0, b1);
            }
          }
        }
      }
      mbar_arrive(&empty[s % R]);  // this lane is done with the slot
    }
  }

  // the K groups meet in shared memory (the ring is free: every stage
  // asked for was consumed): each warp stores its sums in its K group's
  // tile, and the epilogue adds the WK tiles
  __syncthreads();
  int* red = reinterpret_cast<int*>(smem);  // [WK][rows][BN + 1]
  {
    int* mine = red + wk * C::kRows * C::kRedPitch;
    // D register e of n-tile 4l + e': row g + 8(e >> 1), mma column
    // c = 2t + (e & 1), which is column 4c + e' of group l
#pragma unroll
    for (int mt = 0; mt < MTL; ++mt) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int e2 = 0; e2 < 4; ++e2) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = mt * 16 + g + 8 * (e >> 1);
            const int col = wn * C::kNw + 32 * l + 4 * (2 * t + (e & 1)) + e2;
            mine[row * C::kRedPitch + col] = acc[mt][4 * l + e2][e];
          }
        }
      }
    }
  }
  grid_dep_wait();  // xs, the row sums and the workspace are the prologue's
  __shared__ float sxs[64];
  __shared__ int srs[64];
  if (tid < m) {
    sxs[tid] = xs[tid];
    srs[tid] = rowsum[tid];
  }
  __syncthreads();
  // thread tid takes column tid % BN of the tile at rows tid / BN + kStep
  // * j: a warp's 32 consecutive columns, coalesced in memory and
  // conflict-free in the tiles.  Offsets are 32-bit (splits * m * np is
  // below 2^31).
  constexpr int kStep = kGemmThreads / BN, kPer = C::kRows / kStep;
  const int c = tid % BN, col = n0 + c, z = blockIdx.y, row0 = tid / BN;
  int sum[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int at = (row0 + j * kStep) * C::kRedPitch + c;
    sum[j] = 0;
#pragma unroll
    for (int w = 0; w < S; ++w) sum[j] += red[w * C::kRows * C::kRedPitch + at];
  }
  if (splits > 1) {
    // the splits' sums meet in the zeroed float workspace, four columns per
    // add (the integers are below 2^24, so the float sums are exact and
    // their order cannot show); thread 0's acquire-release add then
    // publishes them (the barrier before it orders every thread's adds)
    // and, in the last block, takes the others' (the barrier after it orders
    // every thread's loads): the pattern of CUTLASS's semaphores
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int row = row0 + j * kStep;
      const int s1 = __shfl_down_sync(0xffffffffu, sum[j], 1);
      const int s2 = __shfl_down_sync(0xffffffffu, sum[j], 2);
      const int s3 = __shfl_down_sync(0xffffffffu, sum[j], 3);
      if (row < m && (lane & 3) == 0) {
        red_add_v4(work + row * np + col, static_cast<float>(sum[j]),
                   static_cast<float>(s1), static_cast<float>(s2),
                   static_cast<float>(s3));
      }
    }
    __shared__ int last;
    __syncthreads();
    if (tid == 0) {
      int prev;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(prev)
                   : "l"(reinterpret_cast<int*>(work + m * np) + blockIdx.x)
                   : "memory");
      last = prev == splits - 1;
    }
    __syncthreads();
    if (!last) return;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      sum[j] = static_cast<int>(work[min(row0 + j * kStep, m - 1) * np + col]);
    }
  }
  // the epilogue: every load asked for before any value is used (rows past
  // m clamped to m - 1 and not stored, so that no load is predicated)
  const float wsv = ws[col];
  if (out_bf16) {
    finish<true>(sum, srs, sxs, wsv, res, res_ld, n_res, out, m, np, row0,
                 col, kStep);
  } else {
    finish<false>(sum, srs, sxs, wsv, res, res_ld, n_res, out, m, np, row0,
                  col, kStep);
  }
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
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// A 2-D uint8 tensor (inner x outer, rows `stride` bytes apart) cut into
// boxes of 128 bytes x box_outer rows in the 128-byte swizzle.
bool encode_2d(CUtensorMap* map, const void* base, long inner, long outer,
               long stride, int box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MTL, int BN, bool I1>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(decode_gemm_kernel<MTL, BN, I1>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<MTL, BN, I1>::kSmem);
}

template <int MTL, int BN, bool I1>
int launch(cudaStream_t st, const void* codes, int kp,
           const void* packed, const float* xs, const int* rowsum,
           const float* ws, int m, int np, int splits, float* work,
           const void* res, int res_ld, int n_res, void* out, int out_bf16) {
  using C = Cfg<MTL, BN, I1>;
  const int nb = kp / C::kKb;
  CUtensorMap tmx, tmw;
  if (!encode_2d(&tmx, codes, kp, m, kp, C::kRows) ||
      !encode_2d(&tmw, packed, np, static_cast<long>(nb) * kSlab, np,
                 C::kWk * kSlab)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(np / BN, splits);
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, decode_gemm_kernel<MTL, BN, I1>, tmx, tmw, xs, rowsum, ws, m, nb,
      np, splits, work, res, res_ld, n_res, out, out_bf16));
}

}  // namespace

extern "C" {

// Once, when the library is loaded (never inside a graph capture): lets
// the prologue and every instantiation of the GEMM take their shared memory.
int vlut_decode_init() {
  const cudaError_t errs[] = {
      cudaFuncSetAttribute(decode_prologue_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kProSmemMax),
      cudaFuncSetAttribute(decode_prologue_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kProSmemMax),
      opt_in<1, 128, false>(), opt_in<2, 128, false>(),
      opt_in<3, 128, false>(), opt_in<4, 128, false>(),
      opt_in<1, 256, false>(), opt_in<2, 256, false>(),
      opt_in<3, 256, false>(), opt_in<4, 256, false>(),
      opt_in<1, 128, true>(),  opt_in<2, 128, true>(),
      opt_in<3, 128, true>(),  opt_in<4, 128, true>(),
      opt_in<1, 256, true>(),  opt_in<2, 256, true>(),
      opt_in<3, 256, true>(),  opt_in<4, 256, true>()};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// x1/x2: (m, k) rows with stride ld, bf16 or f32.  Writes codes (m, kp)
// int8 (zero at K >= k, 16-byte aligned, kp % 16 == 0), xs (m,) f32 and
// rowsum (m,) int32, and zeroes a split's workspace (work: m * np floats,
// then n_counters ints; np % 4 == 0) where work is given.  A cluster
// of blocks per row, one per 4,096 of K (at most 8).
int vlut_decode_prologue(const void* x1, const void* x2, long ld, int in_bf16,
                         int k, int kp, const float* g, int mode, int sub_norm,
                         float norm_n, float eps, int m, void* codes, void* xs,
                         void* rowsum, void* work, int np, int n_counters,
                         void* stream) {
  const int cs = min(8, (k + 4095) / 4096);  // the padding past k is zeros
  const int chunk = ((kp + cs - 1) / cs + 15) / 16 * 16;
  if (m <= 0 || k <= 0 || k > kp || kp % 16 || chunk * 4 > kProSmemMax ||
      reinterpret_cast<uintptr_t>(codes) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, m);
  cfg.blockDim = dim3(kProThreads);
  cfg.dynamicSmemBytes = chunk * 4;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;  // one block per row needs no cluster
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, cs > 1 ? decode_prologue_kernel<true> : decode_prologue_kernel<false>,
      x1, x2, ld, in_bf16, k, kp, chunk, g, mode, sub_norm, norm_n, eps,
      static_cast<int8_t*>(codes), static_cast<float*>(xs),
      static_cast<int*>(rowsum), static_cast<float*>(work), np, n_counters,
      m));
}

// out (m, np) = epilogue(codes @ trits(packed) ) [+ residual (m, n_res) of
// row stride res_ld]; 1 <= m <= 64, kp % kb == 0, np % bn == 0, bn 128 or
// 256, 1 <= splits <= kp / kb (with splits > 1, 254 * kp < 2^24, so that
// the float sums are exact); with splits > 1 work holds m * np floats and
// np / bn ints, zero (the prologue zeroes them).
// codes and packed 16-byte aligned.  The launch may start before the
// previous kernel in the stream ends (programmatic dependent launch):
// until that kernel has ended it reads only the weights and writes nothing.
int vlut_decode_gemm(const void* codes, const void* xs, const void* rowsum,
                     const void* packed, const void* ws, int m, int kp, int np,
                     int i1, int bn, int splits, void* work,
                     const void* res,
                     int res_ld, int n_res, void* out, int out_bf16,
                     void* stream) {
  const int kb = i1 ? 160 : 128;
  if (m <= 0 || m > 64 || kp <= 0 || kp % kb || (bn != 128 && bn != 256) ||
      np % bn || splits < 1 || splits > kp / kb ||
      (splits > 1 && (!work || 254L * kp >= (1L << 24))) ||
      reinterpret_cast<uintptr_t>(codes) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* xsp = static_cast<const float*>(xs);
  auto* rsp = static_cast<const int*>(rowsum);
  auto* wsp = static_cast<const float*>(ws);
  auto* wk = static_cast<float*>(work);
#define VLUT_DECODE(MTL, BN)                                                 \
  (i1 ? launch<MTL, BN, true>(st, codes, kp, packed, xsp, rsp, wsp, m,  \
                              np, splits, wk, res, res_ld, n_res, out,       \
                              out_bf16)                                      \
      : launch<MTL, BN, false>(st, codes, kp, packed, xsp, rsp, wsp, m, \
                               np, splits, wk, res, res_ld, n_res, out,      \
                               out_bf16))
  switch (((m + 15) / 16) * 1000 + bn) {
    case 1128: return VLUT_DECODE(1, 128);
    case 2128: return VLUT_DECODE(2, 128);
    case 3128: return VLUT_DECODE(3, 128);
    case 4128: return VLUT_DECODE(4, 128);
    case 1256: return VLUT_DECODE(1, 256);
    case 2256: return VLUT_DECODE(2, 256);
    case 3256: return VLUT_DECODE(3, 256);
    case 4256: return VLUT_DECODE(4, 256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VLUT_DECODE
}

// The call: the prologue, then the GEMM launched to start early.  codes,
// xs, rowsum and (with splits > 1) work are laid out by the caller
// (ops/ternary_gemm.py:_scratch_layout); the rest as for
// vlut_decode_prologue and vlut_decode_gemm.
int vlut_decode(const void* x1, const void* x2, long ld, int in_bf16, int k,
                int kp, const float* g, int mode, int sub_norm, float norm_n,
                float eps, int m, const void* packed, const void* ws, int np,
                int i1, int bn, int splits, void* codes, void* xs,
                void* rowsum, void* work, const void* res, int res_ld,
                int n_res, void* out, int out_bf16, void* stream) {
  const int err = vlut_decode_prologue(x1, x2, ld, in_bf16, k, kp, g, mode,
                                       sub_norm, norm_n, eps, m, codes, xs,
                                       rowsum, work, np, np / bn, stream);
  if (err != 0) return err;
  return vlut_decode_gemm(codes, xs, rowsum, packed, ws, m, kp, np, i1, bn,
                          splits, work, res, res_ld, n_res, out, out_bf16,
                          stream);
}

}  // extern "C"
