// Ternary GEMM kernel for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces ternary_gemm_pallas (_gemm_kernel) of vlut_tpu/ops/pallas_gemm.py:
// the tiled GEMM on pre-quantized int8 activations.  Here: vlut_tiled_gemm.
// (The small-M projections, ternary_gemm_decode and
// ternary_gemm_fused_quant, are csrc/decode_gemm.cu.)
//
// What bounds it on an H100: it runs the dot on the int8 tensor cores
// (mma.sync m16n8k32); it is bound by bytes at M 32 (llama3_8b ffxd: 14.7
// MB of packed weights, 4.7 us) and by int8 operations from M 256 on (ffxd
// 30 GOP, 15 us; the M 4096 prefill 0.9 ms).  What held its first design
// back: x was scattered into shared memory byte by byte, every load's
// latency was exposed between two barriers, and one 128 x 128 tile at every
// M left three quarters of the mma rows empty at M 32 and put 32 blocks on
// 132 SMs.  The design here: x is copied whole (the mma's K order chosen so
// that A is x in its natural order, read by ldmatrix); a ring of 4 stages
// of 1-2 pack blocks, filled by the TMA unit, keeps the copies in flight
// while the previous stage is decoded and multiplied; each packed byte is
// decoded once per block into a shared B tile in the mma's fragment order
// (16-byte stores and loads, conflict-free); the block's tile (32 x 128,
// 64 x 128, 128 x 128 or 128 x 256) and an integer split of K follow M
// (ops/ternary_gemm.py:tiled_plan), the splits meeting exactly in an int32
// workspace.  16-byte cp.async copies cost half of each stage to issue
// (clock64 timelines, PERF.md §6 PR 5); the TMA's 2-D boxes cost one
// instruction each.  What bounds it now: the shared-memory traffic of the
// mma.sync fragments (copies and fragment loads alone take 72% of an M
// 4096 projection); wgmma, which reads both operands from shared memory
// itself, is next.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trit_decode.cuh"

namespace {

using vlut::kSlab;

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

// (acc * xs) * ws [+ residual in the output dtype]:
// vlut_tpu/ops/pallas_gemm.py:448-451.  In bf16 the product is rounded
// before the add; in float32 the reference contracts the residual add into
// one fused multiply-add, so fmaf here.
__device__ __forceinline__ float epilogue(int acc, float xs, float ws,
                                          const void* res, long res_i,
                                          int out_bf16) {
  const float p = static_cast<float>(acc) * xs;
  if (res == nullptr) return out_bf16 ? bf16_round(p * ws) : p * ws;
  if (!out_bf16) return fmaf(p, ws, load_f(res, res_i, 0));
  return bf16_round(load_f(res, res_i, 1) + bf16_round(p * ws));
}

// mma.sync m16n8k32, int8 x int8 -> int32, D = A B + D (A row-major 16 x 32,
// B column-major 32 x 8).  Per lane (g = lane / 4, t = lane % 4): A reg 0
// holds row g at k = 4t..4t+3, reg 1 row g+8 at the same k, regs 2 and 3
// the same rows at k = 16+4t..; B reg 0 holds column g at k = 4t..4t+3,
// reg 1 at k = 16+4t..; D holds rows g, g+8 at columns 2t, 2t+1.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's int32 sums of an (MT x 16) x (NT x 8) warp tile at rows r0,
// columns c0: with no split they go straight through the epilogue; with
// `splits` > 1 they are added into `work` (m x np int32, zeroed by the
// caller, then one counter per output tile), and the last split of the
// tile to arrive applies the epilogue to the complete sums.  Integer sums
// are exact, so the order of arrival cannot change the result.
template <int MT, int NT>
__device__ __forceinline__ void tile_epilogue(
    const int (&acc)[MT][NT][4], int r0, int c0, int m, int np,
    const float* __restrict__ xs, const float* __restrict__ ws, int splits,
    int* work, int tile, void* out, int out_bf16) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (splits > 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = r0 + mt * 16 + g + 8 * (e >> 1);
        if (gm >= m) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          atomicAdd(work + static_cast<long>(gm) * np + c0 + nt * 8 + 2 * t + (e & 1),
                    acc[mt][nt][e]);
        }
      }
    }
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      int* counter = work + static_cast<long>(m) * np + tile;
      last = atomicAdd(counter, 1) == splits - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = r0 + mt * 16 + g + 8 * h;
      if (gm >= m) continue;
      const float xsv = xs[gm];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = c0 + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long i = static_cast<long>(gm) * np + col + e;
          const int a = splits > 1 ? __ldcg(work + i) : acc[mt][nt][2 * h + e];
          store_f(out, i, epilogue(a, xsv, ws[col + e], nullptr, 0, out_bf16),
                  out_bf16);
        }
      }
    }
  }
}

// Tiled GEMM on natural-layout int8 x (M, K) on the int8 tensor cores; see
// the note at the top of this file.  Block tile BM x BN (chosen with the
// split count by ops/ternary_gemm.py:tiled_plan); the 8 warps sit as 2 (M)
// x 4 (N), each with an (BM/2) x (BN/4) tile of MT x NT mma_s8
// accumulators.  Block z takes pack blocks z*nbs .. z*nbs+nbs-1.
//
// K order.  The mma's 32-deep chunk q of a pack block is field q's 32
// consecutive K (K = b*kb + 32q + j, slab row j), so A is x in its natural
// order, read by ldmatrix from a row-major tile, and i1's fifth digits are
// a fifth chunk like the others.  B register 0 of lane 4g + t for chunk q
// holds field q of slab rows 4t..4t+3 of the n-tile's column g (register 1
// rows 16+4t..): the decode transposes four packed words (four rows x four
// columns) and takes one shift, one mask and fields_to_trits per register.
//
// Shared memory, per stage of KS pack blocks: the x tile as boxes of BM
// rows x 32 bytes (one mma chunk each, in the TMA's 32-byte swizzle) and
// the packed bytes (KS x 32 rows x BN columns), both copied by the TMA
// unit (x's rows past m and K past k come back zero) in a ring of kRing
// stages; and the decoded B tile of the stage, double-buffered, in the
// mma's fragment order: one 16-byte slot per (chunk pair, n-tile, lane)
// holds registers 0 and 1 of both chunks of the pair, so an mma warp loads
// its B for two chunks with one conflict-free 16-byte load, and the decode
// writes it with one.
constexpr int kTiledThreads = 256;
constexpr int kWarpsM = 2, kWarpsN = 4;

template <int BM, int BN, bool I1>
struct TiledCfg {
  static constexpr int kKb = I1 ? 160 : 128;
  static constexpr int kNq = I1 ? 5 : 4;  // 32-deep chunks per pack block
  static constexpr int kQp = (kNq + 1) / 2;  // chunk pairs (16-byte B slots)
  static constexpr int kNTiles = BN / 8;
  // pack blocks per stage and ring depth, within 227 KB of shared memory;
  // the 32-row i2 tile takes a shallower ring so that two blocks fit on an
  // SM (one's decode then runs beside the other's mma)
  static constexpr int kKs = (BN == 256 || (BM == 128 && I1)) ? 1 : 2;
  static constexpr int kBlocksPerSm = BM == 32 && !I1 ? 2 : 1;
  static constexpr int kRing = kBlocksPerSm == 2 ? 3 : 4;
  static constexpr int kMt = BM / (16 * kWarpsM), kNt = BN / (8 * kWarpsN);
  // the 128-row tiles decode a stage at once before its mma; the smaller
  // ones interleave the decode with the mma rounds (measured the faster
  // way for each, PERF.md)
  static constexpr bool kInterleave = BM < 128;
  // x: kKs * kKb / 32 boxes of BM rows x 32 bytes (one mma chunk each)
  static constexpr int kXBytes = BM * kKs * kKb;
  static constexpr int kRawBytes = kKs * kSlab * BN;
  static constexpr int kBSlots = kKs * kQp * kNTiles * 32;  // uint4 per stage
  static constexpr int kSmem = kRing * (kXBytes + kRawBytes) + 2 * kBSlots * 16;
  // per SM: 228 KB, less 1 KB reserved and 1 KB of static shared memory
  // (the 1024-byte alignment of the dynamic part) per block
  static_assert(kBlocksPerSm * (kSmem + 2048) <= 228 * 1024, "shared memory");
  static_assert(kXBytes % 1024 == 0 && kRawBytes % 1024 == 0, "box alignment");
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

// orders the block's earlier shared-memory reads (made visible to this
// thread by a barrier) before its later TMA writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8 x 16-byte matrices: lanes 8i..8i+7 give the row addresses of
// matrix i, register i of lane 4g + t gets bytes 4t..4t+3 of its row g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
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

// The 16-byte B slot of (chunk pair qp, n-tile nt of the block, lane) in
// one pack block's tile.  The XOR permutes slots inside an n-tile so that
// the decode's stores (eight threads: four n-tiles x two column halves)
// and the mma's loads (eight consecutive lanes) each hit eight bank groups.
template <int BN>
__device__ __forceinline__ int b_slot(int qp, int nt, int lane) {
  return (qp * (BN / 8) + nt) * 32 + (lane ^ ((nt & 3) | ((lane >> 2) & 4)));
}

// The decode of one stage's packed bytes into its B tile is one unit per
// thread: pack block pb, columns 4cq..4cq+3, slab rows 4r4..4r4+3 (register
// 0) and 16+4r4.. (register 1), u = (pb * 4 + r4) * BN / 4 + cq.  decode_load
// reads the unit's eight packed words (conflict-free: a warp reads 32
// consecutive words of one row) and transposes them, so that byte i of
// w[h][e] is row i of column 4cq + e; decode_column then writes that
// column's 16-byte B slots, one per chunk pair.
template <int BN>
__device__ __forceinline__ void decode_load(const uint8_t* raw, int u,
                                            uint32_t (&w)[2][4]) {
  const int cq = u % (BN / 4), r4 = u / (BN / 4) % 4, pb = u / BN;
  const uint8_t* rp = raw + pb * kSlab * BN + 4 * cq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[h][i] = *reinterpret_cast<const uint32_t*>(
          rp + (16 * h + 4 * r4 + i) * BN);
    }
  }
  transpose4(w[0]);
  transpose4(w[1]);
}

template <int BN, bool I1>
__device__ __forceinline__ void decode_column(const uint32_t (&w)[2][4], int u,
                                              int e, uint4* bt) {
  constexpr int kQp = I1 ? 3 : 2;
  const int cq = u % (BN / 4), r4 = u / (BN / 4) % 4, pb = u / BN;
  // reg[h][q]: field q of the four rows of register h
  uint32_t reg[2][6];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (I1) {
      uint32_t d[4], t5 = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int v5;
        d[i] = static_cast<uint32_t>(
            vlut::decode_i1((w[h][e] >> (8 * i)) & 0xffu, &v5));
        t5 |= (static_cast<uint32_t>(v5) & 0xffu) << (8 * i);
      }
      transpose4(d);
#pragma unroll
      for (int q = 0; q < 4; ++q) reg[h][q] = d[q];
      reg[h][4] = t5;
      reg[h][5] = 0;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        reg[h][q] = static_cast<uint32_t>(
            vlut::fields_to_trits((w[h][e] >> (2 * q)) & 0x03030303u));
      }
      reg[h][4] = reg[h][5] = 0;
    }
  }
  const int col = 4 * cq + e;
  const int nt = col >> 3, lane = (col & 7) * 4 + r4;
  uint4* bp = bt + pb * kQp * (BN / 8) * 32;
#pragma unroll
  for (int qp = 0; qp < kQp; ++qp) {
    bp[b_slot<BN>(qp, nt, lane)] = make_uint4(reg[0][2 * qp], reg[1][2 * qp],
                                          reg[0][2 * qp + 1],
                                          reg[1][2 * qp + 1]);
  }
}

template <int BM, int BN, bool I1>
__global__ void __launch_bounds__(kTiledThreads,
                                  TiledCfg<BM, BN, I1>::kBlocksPerSm)
    tiled_gemm_kernel(
    const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmw, const float* __restrict__ xs,
    const float* __restrict__ ws, int m, int np, int nbs, int splits,
    int* work, void* out, int out_bf16) {
  using C = TiledCfg<BM, BN, I1>;
  constexpr int KS = C::kKs, R = C::kRing, MT = C::kMt, NT = C::kNt;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* sx = smem;                                  // [R][boxes][BM][32]
  uint8_t* sraw = smem + R * C::kXBytes;               // [R][KS][32][BN]
  uint4* sb = reinterpret_cast<uint4*>(sraw + R * C::kRawBytes);  // [2][..]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / kWarpsN) * MT * 16, wn = (warp % kWarpsN) * NT * 8;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int b0 = blockIdx.z * nbs, ns = (nbs + KS - 1) / KS;
  auto valid = [&](int s) { return min(KS, nbs - s * KS); };

  // Stage s into ring slot s % R: the TMA unit copies the x boxes of its
  // valid pack blocks (rows past m and K past k come back zero) and the
  // packed rows, all counted on full[s % R].  A TMA request takes a thread
  // about a hundred cycles to issue, and the stage's barrier waits for the
  // slowest warp, so the interleaved tiles spread the requests: lane 0 of
  // warp j % 8 asks for box j.  The 128-row tiles, whose decode comes
  // first, measured slower that way and leave every request to thread 0
  // (PERF.md).  Thread 0 also arrives with the stage's byte count.
  __shared__ __align__(8) uint64_t full[R];
  constexpr int kIssuers = C::kInterleave ? kTiledThreads / 32 : 1;
  auto load = [&](int s) {
    if (lane != 0 || warp >= kIssuers || s >= ns) return;
    const int nv = valid(s), kk0 = (b0 + s * KS) * C::kKb;
    const int nx = nv * C::kKb / 32;  // x boxes; box nx is the packed rows
    uint64_t* bar = &full[s % R];
    if (warp == 0) mbar_arrive_expect(bar, BM * nv * C::kKb + C::kRawBytes);
    fence_proxy_async();
    const uint32_t dx = smem_addr(sx + (s % R) * C::kXBytes);
    for (int j = warp; j < nx; j += kIssuers) {
      tma_load_2d(dx + j * BM * 32, &tmx, kk0 + 32 * j, m0, bar);
    }
    if (nx % kIssuers == warp) {
      tma_load_2d(smem_addr(sraw + (s % R) * C::kRawBytes), &tmw, n0,
                  (b0 + s * KS) * kSlab, bar);
    }
  };
  auto landed = [&](int s) { mbar_wait(&full[s % R], (s / R) & 1); };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }

  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) mbar_init(&full[r], 1);
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < R - 1; ++s) load(s);
  landed(0);
  // this thread's decode unit, if the stage has its pack block
  auto has_unit = [&](int s) { return tid < KS * BN && tid / BN < valid(s); };
  if (has_unit(0)) {
    uint32_t w[2][4];
    decode_load<BN>(sraw, tid, w);
#pragma unroll
    for (int e = 0; e < 4; ++e) decode_column<BN, I1>(w, tid, e, sb);
  }

  // lane's ldmatrix row: rows 0-7 / 8-15 for lanes 0-7 / 8-15, the same
  // rows 16 bytes on for lanes 16-31 (registers 0-3 = a0..a3 of m16n8k32).
  // A box row is 32 bytes whose two 16-byte halves the TMA's 32-byte
  // swizzle exchanges in rows 4-7 of every 8: ldmatrix's eight rows then
  // fall in eight bank groups.
  const uint32_t xrow =
      (wm + (lane & 15)) * 32 + (((lane >> 4) ^ (lane >> 2)) & 1) * 16;
  // A stage runs in rounds of one chunk pair of one pack block.  With
  // kInterleave a round's fragments are loaded, then one column of this
  // thread's decode of the next stage is computed (its arithmetic covers
  // the loads' latency), then the round's mma are issued; otherwise the
  // whole decode comes first and each chunk's A is loaded just before its
  // mma (fewer live registers for the 128-row tiles).
  constexpr int kRounds = KS * C::kQp;
  constexpr int kSteps = C::kInterleave && kRounds < 4 ? 4 : kRounds;
  for (int i = 0; i < ns; ++i) {
    if (i + 1 < ns) landed(i + 1);
    __syncthreads();  // stage i - 1 is consumed, B tile i is written
    const bool dec = i + 1 < ns && has_unit(i + 1);
    uint4* bnext = sb + ((i + 1) & 1) * C::kBSlots;
    uint32_t w[2][4];
    if (dec) decode_load<BN>(sraw + ((i + 1) % R) * C::kRawBytes, tid, w);
    if (!C::kInterleave && dec) {
#pragma unroll
      for (int e = 0; e < 4; ++e) decode_column<BN, I1>(w, tid, e, bnext);
    }
    load(i + R - 1);
    const uint32_t xa = smem_addr(sx + (i % R) * C::kXBytes) + xrow;
    const uint4* bt = sb + (i & 1) * C::kBSlots;
    const int nv = valid(i);
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      const int pb = r / C::kQp, qp = r % C::kQp;
      const bool live = r < kRounds && pb < nv;
      uint4 bv[NT];
      if (live) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          bv[nt] = bt[pb * C::kQp * C::kNTiles * 32 + b_slot<BN>(qp, wn / 8 + nt, lane)];
        }
      }
      if constexpr (C::kInterleave) {
        uint32_t a[2][MT][4];
        if (live) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (2 * qp + h >= C::kNq) break;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              ldmatrix_x4(a[h][mt], xa + mt * 16 * 32 +
                                        (pb * C::kNq + 2 * qp + h) * BM * 32);
            }
          }
        }
        if (r < 4 && dec) decode_column<BN, I1>(w, tid, r, bnext);
        if (live) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (2 * qp + h >= C::kNq) break;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                mma_s8(acc[mt][nt], a[h][mt], h ? bv[nt].z : bv[nt].x,
                       h ? bv[nt].w : bv[nt].y);
              }
            }
          }
        }
      } else if (live) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (2 * qp + h >= C::kNq) break;
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            ldmatrix_x4(a[mt], xa + mt * 16 * 32 +
                                   (pb * C::kNq + 2 * qp + h) * BM * 32);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              mma_s8(acc[mt][nt], a[mt], h ? bv[nt].z : bv[nt].x,
                     h ? bv[nt].w : bv[nt].y);
            }
          }
        }
      }
    }
  }

  tile_epilogue<MT, NT>(acc, m0 + wm, n0 + wn, m, np, xs, ws, splits, work,
                        blockIdx.y * gridDim.x + blockIdx.x, out, out_bf16);
}

// Above 48 KB a kernel takes dynamic shared memory only after opting in.
template <int BM, int BN, bool I1>
cudaError_t tiled_opt_in() {
  return cudaFuncSetAttribute(tiled_gemm_kernel<BM, BN, I1>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              TiledCfg<BM, BN, I1>::kSmem);
}

template <int BM, int BN, bool I1>
int launch_tiled(cudaStream_t st, const CUtensorMap& tmx, const CUtensorMap& tmw,
                 const float* xs, const float* ws, int m, int np, int nbs,
                 int splits, int* work, void* out, int out_bf16) {
  const dim3 grid(np / BN, (m + BM - 1) / BM, splits);
  tiled_gemm_kernel<BM, BN, I1>
      <<<grid, kTiledThreads, TiledCfg<BM, BN, I1>::kSmem, st>>>(
          tmx, tmw, xs, ws, m, np, nbs, splits, work, out, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

// The driver's tensor-map encoder, looked up once through the runtime (the
// library links no driver library of its own).
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
// boxes of box_inner x box_outer.
bool encode_2d(CUtensorMap* map, const void* base, long inner, long outer,
               long stride, int box_inner, int box_outer,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Once, when the library is loaded (never inside a graph capture): lets
// every instantiation of the tiled kernel take its shared memory.
int vlut_tiled_init() {
  const cudaError_t errs[] = {
      tiled_opt_in<32, 128, false>(),  tiled_opt_in<64, 128, false>(),
      tiled_opt_in<128, 128, false>(), tiled_opt_in<128, 256, false>(),
      tiled_opt_in<32, 128, true>(),   tiled_opt_in<64, 128, true>(),
      tiled_opt_in<128, 128, true>(),  tiled_opt_in<128, 256, true>()};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// out (m, np) = epilogue(x (m, k) int8 @ trits(packed)); x rows of stride
// ldx, 16-byte aligned; (bm, bn) one of (32, 128), (64, 128), (128, 128),
// (128, 256), np % bn == 0; splits divides the kp / kb pack blocks, and
// with splits > 1 work is m * np + the number of output tiles of zeroed
// int32.
int vlut_tiled_gemm(const void* x, long ldx, int k, const void* xs,
                    const void* packed, const void* ws, int m, int kp, int np,
                    int kb, int i1, int bm, int bn, int splits, void* work,
                    void* out, int out_bf16, void* stream) {
  const int nb = kp / kb;
  if (m <= 0 || kb != (i1 ? 160 : 128) || (bn != 128 && bn != 256) ||
      np % bn || splits < 1 || nb % splits || (splits > 1 && !work) ||
      ldx % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // x in boxes of one mma chunk (32 bytes) x bm rows, with the 32-byte
  // swizzle; the packed rows in boxes of one stage (bn bytes x 32 or 64
  // rows: the 256-column tile and i1's 128-row tile step one pack block)
  const int ks = (bn == 256 || (bm == 128 && i1)) ? 1 : 2;
  CUtensorMap tmx, tmw;
  if (!encode_2d(&tmx, x, k, m, ldx, 32, bm, CU_TENSOR_MAP_SWIZZLE_32B) ||
      !encode_2d(&tmw, packed, np, kp / (kb / vlut::kSlab), np, bn,
                 ks * vlut::kSlab, CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* xsp = static_cast<const float*>(xs);
  auto* wsp = static_cast<const float*>(ws);
  auto* wk = static_cast<int*>(work);
  const int nbs = nb / splits;
#define VLUT_TILED(BM, BN)                                                   \
  (i1 ? launch_tiled<BM, BN, true>(st, tmx, tmw, xsp, wsp, m, np, nbs, splits, \
                                   wk, out, out_bf16)                          \
      : launch_tiled<BM, BN, false>(st, tmx, tmw, xsp, wsp, m, np, nbs,        \
                                    splits, wk, out, out_bf16))
  if (bn == 256) {
    return bm == 128 ? VLUT_TILED(128, 256) : static_cast<int>(cudaErrorInvalidValue);
  }
  switch (bm) {
    case 32: return VLUT_TILED(32, 128);
    case 64: return VLUT_TILED(64, 128);
    case 128: return VLUT_TILED(128, 128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VLUT_TILED
}

}  // extern "C"
