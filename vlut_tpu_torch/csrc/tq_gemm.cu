// TQ2_0 / TQ1_0 baseline GEMM for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the TPU kernel vlut_tpu/ops/tq.py:tq_gemm (_tq_kernel; the
// pallas_call at :182): out (M, N) = xs * sum over 256-row K blocks of
// (x_b . trits_b) * d_b, with per-(block, column) fp16 scales d_b, int8 x,
// an int32 dot per block and a float32 sum across blocks.
//
// What bounds it on an H100: at M = 32 each packed weight byte is used by
// 32 rows, so the bytes bound it (llama3_8b dxff, K 4096 x N 14336: 14.7 MB
// of tq2 bytes plus 0.46 MB of scales, about 5 us at 3.35 TB/s); at M = 256
// the int8 operations do (30 GOP, about 15 us at 1,979 TOP/s).
//
// Layout.  The TQ byte layouts are slabs: in tq2 field q of byte row j of a
// block is K offset 64q + j; in tq1 digit q of row j < 48 is K offset
// 48q + j and digit q of row 48 + w is 240 + 4q + w (rows 48-51 have no
// fifth digit).  So the four rows j..j+3 (j % 4 == 0) of one column give,
// at one field or digit, four consecutive K that lie in one 32-deep mma
// chunk at a 4-aligned offset: exactly one B register of mma.sync
// m16n8k32 (lane 4g + t holds K 4t..4t+3 of column g, and 16 + 4t..).
// The decode therefore writes whole 32-bit words at their logical K
// position, and the mma's A is x in its natural order.  The 128-row tile
// writes trits {-1, 0, 1} (two more operations per word); the 32-row
// tiles, whose decode weighs more against their mma, write the stored
// fields {0, 1, 2} as uint8 and take the row sums of x by one more mma per
// chunk against ones: the exact dot with the trits is the dot with the
// fields less the row sum (the Pallas kernel's bias correction).  Each was
// measured the faster for its tiles (PERF.md §6).
//
// Design.  A block computes a BM x BN tile (32 x 64, 32 x 128 or 128 x 64,
// chosen with a split of K by ops/tq.py:tq_plan); its 8 warps sit as
// 2 (M) x 4 (N), or 4 x 2 in the 128-row tile.  One stage of a ring of 4
// holds one 256-row K block: the x tile as 2 boxes of BM rows x 128 bytes
// (four mma chunks each, in the TMA's 128-byte swizzle, read by ldmatrix),
// the block's packed rows (64 or 52 x BN) and its BN fp16 scales, all
// copied by the TMA unit (a 2-D tensor map per operand, encoded per call
// on the host; rows past M and columns past N come back zero), asked for
// by one thread.  The packed bytes of the next stage are decoded once into
// a double-buffered B tile in the mma's fragment order (one 16-byte slot
// per chunk pair, n-tile and lane; an XOR of the slot index keeps the
// decode's stores and the mma's loads conflict-free), interleaved with the
// current stage's four rounds of fragment loads and mma.  What bounds it
// now: the shared-memory traffic of the fragments and the decode, and at
// M 32 the fixed cost per K block and per call (PERF.md §6).
//
// Float order.  The scales vary along K and cannot fold into the epilogue.
// The Pallas kernel sums `acc + dot*s` over the blocks of one bk tile and
// adds the tile to its running sum; the JAX interpret run (XLA on the CPU,
// the reference the port is held to) contracts that chain into fused
// multiply-adds as follows, and this kernel computes exactly that, in
// registers after each block's 8 chunks: in a tile of two or more blocks
// p = d0, then p = fma(d0, s0, round(d1*s1)), then p = fma(d, s, p) per
// later block, then total = round(total + p); a one-block tile (bk = 256)
// is total = fma(d, s, total).  The epilogue multiplies by xs once.
// __fmul_rn / __fadd_rn keep nvcc from contracting the rest.  A split of K
// covers whole bk tiles: each tile's p goes to a float32 workspace, and the
// last block to arrive at the output tile's counter adds the partials in
// tile order, which is the same sequential sum.
//
// Not yet: wgmma (reads both operands from shared memory, which would lift
// the fragment-load bound); a producer warp and a persistent grid (the
// last wave of 448 tiles at M 256 dxff is 40% full).

#include <cuda.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQK = 256;
constexpr int kThreads = 256;

template <int BM, int BN, bool TQ1>
struct Cfg {
  static constexpr int kRpb = TQ1 ? 52 : 64;  // packed rows per K block
  // warps as 2 (M) x 4 (N), 4 x 2 for the 128-row tile: each warp's tile
  // is then 16 x 16, 16 x 32 or 32 x 32
  static constexpr int kWarpsM = BM == 128 ? 4 : 2, kWarpsN = 8 / kWarpsM;
  static constexpr int kMt = BM / (16 * kWarpsM), kNt = BN / (8 * kWarpsN);
  static constexpr bool kTrits = BM == 128;  // B as trits, else as fields
  static constexpr int kXBytes = BM * kQK;  // 2 boxes of BM rows x 128 bytes
  static constexpr int kRawBytes = 64 * BN;
  static constexpr int kScaleBytes = 2 * BN < 128 ? 128 : 2 * BN;
  static constexpr int kStage =
      (kXBytes + kRawBytes + kScaleBytes + 1023) / 1024 * 1024;
  static constexpr int kRing = 4;
  static constexpr int kBSlots = 4 * (BN / 8) * 32;  // uint4 per K block
  static constexpr int kSmem = kRing * kStage + 2 * kBSlots * 16;
  // decode units per K block: tq2 (t, cq) pairs, at BN 64 each cut in two
  // halves by field pair (so that four warps, one per scheduler, share the
  // decode), tq1 (row group, cq)
  static constexpr int kHalves = !TQ1 && BN == 64 ? 2 : 1;
  static constexpr int kUnits = TQ1 ? 13 * (BN / 4) : kHalves * BN;
  // per SM: 228 KB, less 1 KB reserved and 1 KB of static shared memory
  static_assert(kSmem + 2048 <= 228 * 1024, "shared memory");
  static_assert(kMt >= 1 && kNt >= 1 && BM * BN <= 8192, "tile");
  static_assert(TQ1 ? kUnits <= 4 * kThreads : kUnits <= kThreads, "units");
};

// mma.sync m16n8k32, int8 x (int8 trits or uint8 fields) -> int32,
// D = A B + D (A row-major 16 x 32, B column-major 32 x 8).  Per lane
// (g = lane / 4, t = lane % 4): A reg 0 holds row g at k = 4t..4t+3, reg 1
// row g+8 at the same k, regs 2 and 3 the same rows at k = 16+4t..; B reg 0
// holds column g at k = 4t..4t+3, reg 1 at k = 16+4t..; D holds rows g, g+8
// at columns 2t, 2t+1.  Not volatile: the compiler may move an mma past
// the next round's fragment loads.
template <bool TRITS>
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (TRITS) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// four bytes of fields {0, 1, 2} as the B tile holds them: trits (byte
// + 0x7f, at most 0x81, never carries; the xor takes 0x80 off) or as they are
template <bool TRITS>
__device__ __forceinline__ uint32_t b_word(uint32_t f) {
  return TRITS ? (f + 0x7f7f7f7fu) ^ 0x80808080u : f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The stage copies are the TMA unit's: one thread asks for a whole box of
// a tensor, the unit zero-fills what lies outside the tensor and counts the
// bytes it writes on an mbarrier, whose phase completes when the one
// arrival and every expected byte are in.
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

// brings a tensor map's descriptor to the TMA unit ahead of its first copy
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// orders the block's earlier shared-memory reads (made visible to this
// thread by a barrier) before its later TMA writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8 x 16-byte matrices: lanes 8i..8i+7 give the row addresses of
// matrix i, register i of lane 4g + t gets bytes 4t..4t+3 of its row g.
// Volatile (ordered with the barriers and mbarrier waits) but without a
// memory clobber, so that plain shared loads may move around it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
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

// The B tile of one K block.  K group G (K 4G..4G+3, G = 0..63) of column
// col sits in the 16-byte slot of (chunk pair G / 16, n-tile col / 8,
// lane 4(col % 8) + G % 4), word (G / 4) % 4: words 0 and 1 are B
// registers 0 and 1 of chunk 2qp, words 2 and 3 those of chunk 2qp + 1.
// The XOR permutes the slots inside an n-tile so that eight consecutive
// column quads (four n-tiles x two column halves) hit eight bank groups:
// the decode's stores are conflict-free, and the mma's loads (eight
// consecutive lanes of one n-tile) too.
template <int BN>
__device__ __forceinline__ int b_slot(int qp, int nt, int lane) {
  return (qp * (BN / 8) + nt) * 32 + (lane ^ (((nt & 3) << 1) | ((lane >> 4) & 1)));
}

// tq2 decode unit u < BN (one per thread of the first BN threads): K
// groups t + 4h (h = 0..3) of every field, i.e. packed rows 4t + 16h + i,
// of columns 4cq..4cq+3.  tq2_load reads its 16 words (a warp reads
// consecutive words of one or two rows) and transposes them, so that byte
// i of w[h][e] is row 4t + 16h + i of column 4cq + e; tq2_store then
// writes field q's four 16-byte slots: field q of those rows is K
// 64q + 4t + 16h + i, chunk 2q + h / 2, register h % 2.
template <int BN>
__device__ __forceinline__ void tq2_load(const uint8_t* raw, int u,
                                         uint32_t (&w)[4][4]) {
  const int t = u / (BN / 4), cq = u % (BN / 4);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[h][i] = *reinterpret_cast<const uint32_t*>(
          raw + (4 * t + 16 * h + i) * BN + 4 * cq);
    }
    transpose4(w[h]);
  }
}

template <int BN, bool TRITS>
__device__ __forceinline__ void tq2_store(const uint32_t (&w)[4][4], int u,
                                          int q, uint4* bt) {
  const int t = u / (BN / 4), cq = u % (BN / 4);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t r[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      r[h] = b_word<TRITS>((w[h][e] >> (2 * q)) & 0x03030303u);
    }
    const int col = 4 * cq + e;
    bt[b_slot<BN>(q, col >> 3, (col & 7) * 4 + t)] =
        make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// The five base-3 digits of two bytes x < 243, held in the two 16-bit
// halves of v, by independent multiply-shift divisions (trit_decode.cuh:
// decode_i1, vlut_tpu/ops/tq.py:_decode_block_fields); every product stays
// below 2^16, so the halves do not mix.  d[q] holds digit q in each half.
__device__ __forceinline__ void tq1_digits2(uint32_t v, uint32_t (&d)[5]) {
  const uint32_t t1 = ((v * 171u) >> 9) & 0x007f007fu;  // x / 3
  const uint32_t a = ((v * 57u) >> 9) & 0x001f001fu;    // x / 9
  const uint32_t b = ((v * 19u) >> 9) & 0x000f000fu;    // x / 27
  const uint32_t c = ((b * 11u) >> 5) & 0x00030003u;    // x / 81 = b / 3
  d[0] = v - 3u * t1;
  d[1] = t1 - 3u * a;
  d[2] = a - 3u * b;
  d[3] = b - 3u * c;
  d[4] = c;
}

// tq1 decode unit u: packed rows 4r4..4r4+3 (r4 = 0..12) of columns
// 4cq..4cq+3.  Digit q of those rows is K group 12q + r4 (r4 < 12) or
// 60 + q (rows 48-51); each goes to its slot word as one 32-bit store.
template <int BN, bool TRITS>
__device__ __forceinline__ void tq1_unit(const uint8_t* raw, int u,
                                         uint32_t* bt) {
  const int r4 = u / (BN / 4), cq = u % (BN / 4);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = *reinterpret_cast<const uint32_t*>(raw + (4 * r4 + i) * BN + 4 * cq);
  }
  transpose4(w);  // byte i of w[e]: row 4r4 + i of column 4cq + e
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // rows 0 and 2 in the halves of one word, rows 1 and 3 in the other
    uint32_t lo[5], hi[5], d[5];
    tq1_digits2(w[e] & 0x00ff00ffu, lo);
    tq1_digits2((w[e] >> 8) & 0x00ff00ffu, hi);
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      d[q] = b_word<TRITS>(lo[q] | (hi[q] << 8));  // byte i: row i
    }
    const int col = 4 * cq + e, nt = col >> 3, cl = (col & 7) * 4;
    auto put = [&](int grp, uint32_t v) {
      bt[4 * b_slot<BN>(grp >> 4, nt, cl + (grp & 3)) + ((grp >> 2) & 3)] = v;
    };
    if (r4 < 12) {
#pragma unroll
      for (int q = 0; q < 5; ++q) put(12 * q + r4, d[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) put(60 + q, d[q]);
    }
  }
}

// One block: the BM x BN tile at (blockIdx.y, blockIdx.x) over the bk
// tiles of split blockIdx.z (tiles [z * nk / splits, (z + 1) * nk /
// splits) of nk = kp / bk).  With splits > 1 each bk tile's partial p goes
// to part (nk x m x np floats) and counters (one int per output tile, zero
// on entry) elect the block that adds them.
template <int BM, int BN, bool TQ1>
__global__ void __launch_bounds__(kThreads, 1) tq_gemm_kernel(
    const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmw,
    const __grid_constant__ CUtensorMap tms, const float* __restrict__ xs,
    int m, int np, int nbt, int nk, int splits, float* part, int* counters,
    float* __restrict__ out) {
  using C = Cfg<BM, BN, TQ1>;
  constexpr int R = C::kRing, MT = C::kMt, NT = C::kNt;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint4* sb = reinterpret_cast<uint4*>(smem + R * C::kStage);  // [2][slots]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / C::kWarpsN) * MT * 16;
  const int wn = (warp % C::kWarpsN) * NT * 8;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int z = blockIdx.z;
  const int t_lo = z * nk / splits, t_hi = (z + 1) * nk / splits;
  const int b0 = t_lo * nbt, ns = (t_hi - t_lo) * nbt;
  auto sx = [&](int s) { return smem + (s % R) * C::kStage; };
  auto sraw = [&](int s) { return sx(s) + C::kXBytes; };
  auto ssc = [&](int s) {
    return reinterpret_cast<const __half2*>(sraw(s) + C::kRawBytes);
  };

  // Stage s (K block b0 + s) into ring slot s % R: thread 0 asks for the
  // two x boxes, the packed rows and the scales, all counted on full[s % R].
  __shared__ __align__(8) uint64_t full[R];
  auto load = [&](int s) {
    if (tid != 0 || s >= ns) return;
    const int b = b0 + s;
    uint64_t* bar = &full[s % R];
    mbar_arrive_expect(bar, C::kXBytes + C::kRpb * BN + 2 * BN);
    fence_proxy_async();
    const uint32_t dx = smem_addr(sx(s));
    tma_load_2d(dx, &tmx, b * kQK, m0, bar);
    tma_load_2d(dx + BM * 128, &tmx, b * kQK + 128, m0, bar);
    tma_load_2d(dx + C::kXBytes, &tmw, n0, b * C::kRpb, bar);
    tma_load_2d(dx + C::kXBytes + C::kRawBytes, &tms, n0, b, bar);
  };
  auto landed = [&](int s) { mbar_wait(&full[s % R], (s / R) & 1); };

  // this thread's decode units: tq2 one (threads < kUnits: unit tid % BN,
  // fields 2h..2h+1 of half h = tid / BN, or all four), tq1 up to four
  // (u = tid + 256 r, decoded in round r)
  const bool has2 = !TQ1 && tid < C::kUnits;
  const int u2 = tid % BN, half = tid / BN;
  auto mine = [&](int q) { return C::kHalves == 1 || q / 2 == half; };
  auto has1 = [&](int r) { return TQ1 && tid + kThreads * r < C::kUnits; };

  if (tid == 0) {
    prefetch_tensormap(&tmx);
    prefetch_tensormap(&tmw);
    prefetch_tensormap(&tms);
#pragma unroll
    for (int r = 0; r < R; ++r) mbar_init(&full[r], 1);
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < R - 1; ++s) load(s);
  landed(0);
  if constexpr (TQ1) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (has1(r)) {
        tq1_unit<BN, C::kTrits>(sraw(0), tid + kThreads * r,
                                reinterpret_cast<uint32_t*>(sb));
      }
    }
  } else if (has2) {
    uint32_t w[4][4];
    tq2_load<BN>(sraw(0), u2, w);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (mine(q)) tq2_store<BN, C::kTrits>(w, u2, q, sb);
    }
  }

  int acc[MT][NT][4], rs[MT][4];  // rs: the row sums of x (fields only)
  float p[MT][NT][4], total[MT][NT][4];
  float2 s0[NT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) rs[i][e] = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        p[i][j][e] = total[i][j][e] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) s0[j] = make_float2(0.0f, 0.0f);

  // lane's ldmatrix row: rows 0-7 / 8-15 for lanes 0-7 / 8-15, the same
  // rows 16 bytes on for lanes 16-31 (registers 0-3 = a0..a3 of m16n8k32).
  // A box row is 128 bytes (four chunks) whose 16-byte units the TMA's
  // 128-byte swizzle permutes by an XOR with the row % 8, so that the eight
  // rows of one ldmatrix matrix fall in eight bank groups.
  const uint32_t xrow = (wm + (lane & 15)) * 128;
  const int xhi = lane >> 4, xsw = lane & 7;
  auto xoff = [&](int c) {  // chunk c's 16-byte unit of this lane's row
    return (c >> 2) * BM * 128 + ((2 * (c & 3) + xhi) ^ xsw) * 16;
  };
  for (int i = 0; i < ns; ++i) {
    if (i + 1 < ns) landed(i + 1);
    __syncthreads();  // stage i - 1 is consumed, B tile i is written
    const bool dec = i + 1 < ns;
    uint4* bnext = sb + ((i + 1) & 1) * C::kBSlots;
    uint32_t w[4][4];
    if (!TQ1 && dec && has2) tq2_load<BN>(sraw(i + 1), u2, w);
    load(i + R - 1);
    const uint32_t xa = smem_addr(sx(i)) + xrow;
    const uint4* bt = sb + (i & 1) * C::kBSlots;
    // four rounds, one chunk pair each: fragment loads, one piece of the
    // next stage's decode (its arithmetic covers the loads' latency), mma
#pragma unroll
    for (int qp = 0; qp < 4; ++qp) {
      uint4 bv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) bv[nt] = bt[b_slot<BN>(qp, wn / 8 + nt, lane)];
      uint32_t a[2][MT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ldmatrix_x4(a[h][mt], xa + mt * 16 * 128 + xoff(2 * qp + h));
        }
      }
      if (dec) {
        if constexpr (TQ1) {
          if (has1(qp)) {
            tq1_unit<BN, C::kTrits>(sraw(i + 1), tid + kThreads * qp,
                                    reinterpret_cast<uint32_t*>(bnext));
          }
        } else if (has2 && mine(qp)) {
          tq2_store<BN, C::kTrits>(w, u2, qp, bnext);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (!C::kTrits) {
            mma<false>(rs[mt], a[h][mt], 0x01010101u, 0x01010101u);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma<C::kTrits>(acc[mt][nt], a[h][mt], h ? bv[nt].z : bv[nt].x,
                           h ? bv[nt].w : bv[nt].y);
          }
        }
      }
    }

    // the float chain of K block b0 + i (see the note at the top); d is
    // the exact int32 dot with the trits (with fields: less the row sum)
    const int it = i % nbt;
    const __half2* sc = ssc(i);
    float2 sv[NT];
    float d[MT][NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sv[nt] = __half22float2(sc[(wn + nt * 8) / 2 + t]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d[mt][nt][e] = static_cast<float>(acc[mt][nt][e] - rs[mt][e]);
          acc[mt][nt][e] = 0;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[mt][e] = 0;
    }
    // each statement once per (mt, nt, e), the branches taken once per block
#define VLUT_EACH(STMT)                                 \
  _Pragma("unroll") for (int mt = 0; mt < MT; ++mt) {   \
    _Pragma("unroll") for (int nt = 0; nt < NT; ++nt) { \
      _Pragma("unroll") for (int e = 0; e < 4; ++e) {   \
        STMT;                                           \
      }                                                 \
    }                                                   \
  }
    auto scale = [&](int nt, int e) { return (e & 1) ? sv[nt].y : sv[nt].x; };
    if (nbt == 1) {
      VLUT_EACH(total[mt][nt][e] = fmaf(d[mt][nt][e], scale(nt, e), total[mt][nt][e]))
    } else if (it == 0) {
      VLUT_EACH(p[mt][nt][e] = d[mt][nt][e])
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s0[nt] = sv[nt];
    } else if (it == 1) {
      VLUT_EACH(p[mt][nt][e] = fmaf(p[mt][nt][e], (e & 1) ? s0[nt].y : s0[nt].x,
                                    __fmul_rn(d[mt][nt][e], scale(nt, e))))
    } else {
      VLUT_EACH(p[mt][nt][e] = fmaf(d[mt][nt][e], scale(nt, e), p[mt][nt][e]))
    }
    if (nbt > 1 && it == nbt - 1) {
      if (splits > 1) {
        float* pt = part + static_cast<long>(t_lo + i / nbt) * m * np;
        VLUT_EACH({
          const int gm = m0 + wm + mt * 16 + g + 8 * (e >> 1);
          const int col = n0 + wn + nt * 8 + 2 * t + (e & 1);
          if (gm < m && col < np) {
            __stcg(pt + static_cast<long>(gm) * np + col, p[mt][nt][e]);
          }
        })
      } else {
        VLUT_EACH(total[mt][nt][e] = __fadd_rn(total[mt][nt][e], p[mt][nt][e]))
      }
    }
  }

  if (splits > 1) {
    // thread 0's acquire-release add publishes the block's partials (the
    // barrier before it orders every thread's stores) and, in the last
    // block, takes the other splits' (the barrier after it orders every
    // thread's loads): the pattern of CUTLASS's semaphores, without a fence
    // per thread
    __shared__ int last;
    __syncthreads();
    if (tid == 0) {
      int prev;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(prev)
                   : "l"(counters + blockIdx.y * gridDim.x + blockIdx.x)
                   : "memory");
      last = prev == splits - 1;
    }
    __syncthreads();
    if (!last) return;
    // the partials of every bk tile, added in tile order; one tile's loads
    // all in flight at once
    VLUT_EACH(total[mt][nt][e] = 0.0f)
    for (int kt = 0; kt < nk; ++kt) {
      const float* pt = part + static_cast<long>(kt) * m * np;
      VLUT_EACH({
        const int gm = m0 + wm + mt * 16 + g + 8 * (e >> 1);
        const int col = n0 + wn + nt * 8 + 2 * t + (e & 1);
        if (gm < m && col < np) {
          total[mt][nt][e] = __fadd_rn(
              total[mt][nt][e], __ldcg(pt + static_cast<long>(gm) * np + col));
        }
      })
    }
  }
  VLUT_EACH({
    const int gm = m0 + wm + mt * 16 + g + 8 * (e >> 1);
    const int col = n0 + wn + nt * 8 + 2 * t + (e & 1);
    if (gm < m && col < np) {
      out[static_cast<long>(gm) * np + col] = __fmul_rn(total[mt][nt][e], xs[gm]);
    }
  })
#undef VLUT_EACH
}

// Above 48 KB a kernel takes dynamic shared memory only after opting in.
template <int BM, int BN, bool TQ1>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(tq_gemm_kernel<BM, BN, TQ1>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<BM, BN, TQ1>::kSmem);
}

template <int BM, int BN, bool TQ1>
int launch(cudaStream_t st, const CUtensorMap& tmx, const CUtensorMap& tmw,
           const CUtensorMap& tms, const float* xs, int m, int np, int nbt,
           int nk, int splits, float* part, int* counters, float* out) {
  const dim3 grid((np + BN - 1) / BN, (m + BM - 1) / BM, splits);
  tq_gemm_kernel<BM, BN, TQ1><<<grid, kThreads, Cfg<BM, BN, TQ1>::kSmem, st>>>(
      tmx, tmw, tms, xs, m, np, nbt, nk, splits, part, counters, out);
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

// A 2-D tensor of `type` (inner x outer elements, rows `stride` bytes
// apart) cut into boxes of box_inner x box_outer.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
               long inner, long outer, long stride, int box_inner,
               int box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Once, when the library is loaded (never inside a graph capture): lets
// every instantiation take its shared memory.
int vlut_tq_init() {
  const cudaError_t errs[] = {
      opt_in<32, 64, false>(), opt_in<32, 128, false>(),
      opt_in<128, 64, false>(), opt_in<32, 64, true>(),
      opt_in<32, 128, true>(), opt_in<128, 64, true>()};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// out (m, np) = xs * sum_b (x_b . trits_b) * scales[b], the float order of
// the note at the top; x (m, kp) int8 rows of stride ldx, packed (kp/256 *
// rpb, np) uint8 (rpb 64 tq2, 52 tq1), scales (kp/256, np) fp16, xs (m,)
// f32, out (m, np) f32.  x, packed and scales 16-byte aligned, ldx and np
// multiples of 16; bk % 256 == 0 and kp % bk == 0; (bm, bn) one of the
// instantiated tiles; splits <= kp / bk, 1 when bk == 256; with splits > 1
// part holds kp / bk * m * np floats and counters one int per output tile,
// zero on entry.
int vlut_tq_gemm(const void* x, long ldx, const void* xs, const void* packed,
                 const void* scales, int m, int kp, int np, int tq1, int bk,
                 int bm, int bn, int splits, void* part, void* counters,
                 void* out, void* stream) {
  const int nk = bk > 0 ? kp / bk : 0;
  if (m <= 0 || np <= 0 || np % 16 || kp <= 0 || kp % kQK || bk % kQK ||
      kp % bk || ldx % 16 || splits < 1 || splits > nk ||
      (bk == kQK && splits > 1) || (splits > 1 && (!part || !counters)) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(scales) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rpb = tq1 ? 52 : 64, nb = kp / kQK;
  // x in boxes of four mma chunks (128 bytes) x bm rows, with the 128-byte
  // swizzle; the packed rows of one K block x bn columns; bn scales
  CUtensorMap tmx, tmw, tms;
  if (!encode_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, kp, m, ldx, 128, bm,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, np,
                 static_cast<long>(nb) * rpb, np, bn, rpb,
                 CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_2d(&tms, CU_TENSOR_MAP_DATA_TYPE_UINT16, scales, np, nb,
                 2L * np, bn, 1, CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* xsp = static_cast<const float*>(xs);
  auto* pp = static_cast<float*>(part);
  auto* cp = static_cast<int*>(counters);
  auto* o = static_cast<float*>(out);
  const int nbt = bk / kQK;
#define VLUT_TQ(BM, BN)                                                       \
  (tq1 ? launch<BM, BN, true>(st, tmx, tmw, tms, xsp, m, np, nbt, nk, splits, \
                              pp, cp, o)                                      \
       : launch<BM, BN, false>(st, tmx, tmw, tms, xsp, m, np, nbt, nk,        \
                               splits, pp, cp, o))
  switch (bm * 1000 + bn) {
    case 32064: return VLUT_TQ(32, 64);
    case 32128: return VLUT_TQ(32, 128);
    case 128064: return VLUT_TQ(128, 64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VLUT_TQ
}

}  // extern "C"
