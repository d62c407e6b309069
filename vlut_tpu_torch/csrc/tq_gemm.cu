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
// Layout.  The TQ byte layouts are slabs like the i2/i1 ones
// (csrc/trit_decode.cuh): in tq2 field q of byte row j of a block is K
// offset q*64 + j; in tq1 digit q of row j < 48 is K offset q*48 + j and
// digit q of row 48 + w is 240 + q*4 + w (rows 48-51 have no fifth digit).
// The kernel walks a block's packed rows as two stages of 32 slab rows; the
// mma's 32-deep chunk c of a stage takes slab rows 8c..8c+7 with their four
// fields, so one packed byte decodes to one B-fragment register, and tq1's
// fifth digits form a fifth chunk per stage (as i1 does in ternary_gemm.cu).
// The A fragments hold x in that same K order, written once per call by
// tq_xfrag_kernel; slots that hold no weight get zero x codes, so whatever
// trit their byte decodes to contributes nothing.
//
// Design.  One block of 8 warps per (up to 64 rows) x 32 columns.  Like
// ternary_gemm.cu's decode GEMM, each lane reads the 32-bit word of columns
// n0+4g..n0+4g+3 of its slab rows straight from device memory into
// registers (the byte of column n0 + 4g + nt is n-tile nt's B register),
// the next round's words in flight while the current ones are decoded, and
// its A fragments with one 16-byte load each (from L2).  The K blocks go in
// rounds of 8: warp w computes the exact int32 dot (mma.sync m16n8k32) of
// block 8r + w, the 8 dots meet in shared memory, and every thread then
// carries its column's float32 sums through the 8 blocks in order.
//
// Float order.  The scales vary along K and cannot fold into the epilogue.
// The Pallas kernel sums `acc + dot*s` over the blocks of one bk tile and
// adds the tile to its running sum; the JAX interpret run (XLA on the CPU,
// the reference the port is held to) contracts that chain into fused
// multiply-adds as follows, and this kernel computes exactly that: in a
// tile of two or more blocks p = fma(d0, s0, round(d1*s1)), then
// p = fma(d, s, p) per later block, then total = round(total + p); a
// one-block tile is total = fma(d, s, total).  The epilogue multiplies by
// xs once.  __fmul_rn / __fadd_rn keep nvcc from contracting the rest.
//
// Not yet: cp.async/TMA staging, split-K for narrow N, wgmma.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trit_decode.cuh"

namespace {

constexpr int kQK = 256;
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kBN = 32, kLd = kBN + 1;  // dots row stride: conflict-free
constexpr int kRound = kWarps;          // K blocks per round, one per warp
constexpr int kMaxMT = 4;               // 16-row m-tiles per block

// mma.sync m16n8k32 s8 x s8 -> s32 (fragment layout: see ternary_gemm.cu)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four packed tq2 bytes (four columns) -> four B registers: register i
// holds column i's trits, byte q = field q (a 4 x 4 byte transpose).
__device__ __forceinline__ void decode_tq2_word(uint32_t w, uint32_t (&r)[4]) {
  uint32_t f[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[q] = static_cast<uint32_t>(vlut::fields_to_trits((w >> (2 * q)) & 0x03030303u));
  }
  const uint32_t t0 = __byte_perm(f[0], f[1], 0x5140);
  const uint32_t t1 = __byte_perm(f[0], f[1], 0x7362);
  const uint32_t t2 = __byte_perm(f[2], f[3], 0x5140);
  const uint32_t t3 = __byte_perm(f[2], f[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// K offset inside a block of field q of slab row j, or -1 where the slot
// holds no weight.
template <bool TQ1>
__device__ __forceinline__ int k_offset(int j, int q) {
  if (!TQ1) return q * 64 + j;
  if (j < 48) return q * 48 + j;
  if (j < 52 && q < 4) return 240 + 4 * q + (j - 48);
  return -1;
}

// x (m, kp) int8 -> A fragments.  Fragment (b, ch, mt) is 32 lanes x 4
// registers; chunk ch = st * (4 [+1]) + c.  Register r of lane 4g+t covers
// row mt*16 + g + 8(r & 1) and slab rows 32st + 8c + t + 4(r >> 1) with
// byte q = field q (c < 4), or, in tq1's fifth chunk, byte i = the fifth
// digit of slab row 32st + 8i + t + 4(r >> 1).
template <bool TQ1>
__global__ void tq_xfrag_kernel(const int8_t* __restrict__ x, long ldx, int m,
                                int nb, int mtl, uint4* __restrict__ afrag) {
  constexpr int kPer = TQ1 ? 5 : 4, kNch = 2 * kPer;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long>(nb) * kNch * mtl * 32) return;
  const int lane = static_cast<int>(idx & 31);
  long f = idx >> 5;
  const int mt = static_cast<int>(f % mtl);
  f /= mtl;
  const int ch = static_cast<int>(f % kNch), b = static_cast<int>(f / kNch);
  const int st = ch / kPer, c = ch % kPer, g = lane >> 2, t = lane & 3;
  uint32_t reg[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = mt * 16 + g + 8 * (r & 1);
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 32 * st + (c < 4 ? 8 * c : 8 * i) + t + 4 * (r >> 1);
      const int kk = k_offset<TQ1>(j, c < 4 ? i : 4);
      const int8_t v = (row < m && kk >= 0)
          ? x[static_cast<long>(row) * ldx + static_cast<long>(b) * kQK + kk] : 0;
      word |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * i);
    }
    reg[r] = word;
  }
  afrag[idx] = make_uint4(reg[0], reg[1], reg[2], reg[3]);
}

template <bool TQ1, int MT>
__global__ void __launch_bounds__(kThreads) tq_gemm_kernel(
    const uint4* __restrict__ afrag, int mtl, const float* __restrict__ xs,
    const uint8_t* __restrict__ packed, const __half* __restrict__ scales,
    int m, int nb, int n, int nbt, float* __restrict__ out) {
  constexpr int kRpb = TQ1 ? 52 : 64, kPer = TQ1 ? 5 : 4, kNch = 2 * kPer;
  constexpr int kRowsB = MT * 16, kEl = kRowsB / 8;
  extern __shared__ int dots[];  // [kRound][kRowsB][kLd]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt0 = blockIdx.x * kMaxMT, n0 = blockIdx.y * kBN;
  const uint8_t* wp = packed + n0 + 4 * g;

  // words [st][c][h]: slab row 32st + 8c + t + 4h of block b (zero past
  // the block's rows or past the last block)
  auto load = [&](uint32_t (&w)[2][4][2], int b) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 32 * st + 8 * c + t + 4 * h;
          w[st][c][h] = (b < nb && j < kRpb)
              ? *reinterpret_cast<const uint32_t*>(
                    wp + (static_cast<long>(b) * kRpb + j) * n)
              : 0u;
        }
      }
    }
  };

  // the float32 sums of column n0 + col, rows r0 + 8i of the block
  const int col = tid & 31, r0 = tid >> 5;
  float part[kEl], total[kEl], s_first = 0.0f;
#pragma unroll
  for (int i = 0; i < kEl; ++i) part[i] = total[i] = 0.0f;

  uint32_t w[2][4][2], wn[2][4][2];
  load(w, warp);
  const int rounds = (nb + kRound - 1) / kRound;
  for (int rd = 0; rd < rounds; ++rd) {
    const int b = rd * kRound + warp;
    load(wn, b + kRound);
    float sv[kRound];
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      const int bb = rd * kRound + i;
      sv[i] = bb < nb ? __half2float(scales[static_cast<long>(bb) * n + n0 + col])
                      : 0.0f;
    }
    if (b < nb) {
      int acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
        }
      }
      auto frag = [&](int ch, int mt) {
        return afrag[((static_cast<long>(b) * kNch + ch) * mtl + mt0 + mt) * 32 + lane];
      };
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        uint32_t b5[4][2] = {};  // tq1: fifth-digit B registers per n-tile
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint32_t bf[2][4];  // [h][n-tile]
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (TQ1) {
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                int t5;
                bf[h][nt] = static_cast<uint32_t>(
                    vlut::decode_i1((w[st][c][h] >> (8 * nt)) & 0xffu, &t5));
                b5[nt][h] |= (static_cast<uint32_t>(t5) & 0xffu) << (8 * c);
              }
            } else {
              decode_tq2_word(w[st][c][h], bf[h]);
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (mt0 + mt >= mtl) continue;
            const uint4 av = frag(st * kPer + c, mt);
            const uint32_t a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a, bf[0][nt], bf[1][nt]);
          }
        }
        if constexpr (TQ1) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (mt0 + mt >= mtl) continue;
            const uint4 av = frag(st * kPer + 4, mt);
            const uint32_t a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a, b5[nt][0], b5[nt][1]);
          }
        }
      }
      // D register e: row g + 8(e >> 1), mma column 2t + (e & 1) of n-tile
      // nt, which is column 4(2t + (e & 1)) + nt of the block
      int* dw = dots + warp * kRowsB * kLd;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dw[(mt * 16 + g + 8 * (e >> 1)) * kLd + 4 * (2 * t + (e & 1)) + nt] =
                acc[mt][nt][e];
          }
        }
      }
    }
    __syncthreads();
    // the float32 sums through this round's blocks, in order
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      const int bb = rd * kRound + i;
      if (bb >= nb) break;
      const int it = bb % nbt;
      const float s = sv[i];
      const int* dr = dots + i * kRowsB * kLd;
#pragma unroll
      for (int el = 0; el < kEl; ++el) {
        const float dv = static_cast<float>(dr[(r0 + 8 * el) * kLd + col]);
        if (nbt == 1) {
          total[el] = fmaf(dv, s, total[el]);
        } else if (it == 0) {
          part[el] = dv;
        } else if (it == 1) {
          part[el] = fmaf(part[el], s_first, __fmul_rn(dv, s));
        } else {
          part[el] = fmaf(dv, s, part[el]);
        }
        if (nbt > 1 && it == nbt - 1) total[el] = __fadd_rn(total[el], part[el]);
      }
      if (it == 0) s_first = s;
    }
    __syncthreads();  // the dots are read before the next round writes them
#pragma unroll
    for (int st = 0; st < 2; ++st) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        w[st][c][0] = wn[st][c][0];
        w[st][c][1] = wn[st][c][1];
      }
    }
  }

#pragma unroll
  for (int el = 0; el < kEl; ++el) {
    const int gm = mt0 * 16 + r0 + 8 * el;
    if (gm >= m) continue;
    out[static_cast<long>(gm) * n + n0 + col] = __fmul_rn(total[el], xs[gm]);
  }
}

template <int MT>
constexpr int smem_bytes() {
  return kRound * MT * 16 * kLd * static_cast<int>(sizeof(int));
}

// Above 48 KB a kernel takes dynamic shared memory only after opting in.
template <bool TQ1, int MT>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(tq_gemm_kernel<TQ1, MT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<MT>());
}

template <bool TQ1, int MT>
int launch_gemm(dim3 grid, cudaStream_t st, const uint4* af, int mtl,
                const float* xs, const uint8_t* pk, const __half* sc, int m,
                int nb, int n, int nbt, float* out) {
  tq_gemm_kernel<TQ1, MT><<<grid, kThreads, smem_bytes<MT>(), st>>>(
      af, mtl, xs, pk, sc, m, nb, n, nbt, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool TQ1>
int launch(const int8_t* x, long ldx, const float* xs, const uint8_t* pk,
           const __half* sc, int m, int kp, int n, int bk, uint4* af,
           float* out, cudaStream_t st) {
  constexpr int kNch = TQ1 ? 10 : 8;
  const int nb = kp / kQK, mtl = (m + 15) / 16;
  const long frags = static_cast<long>(nb) * kNch * mtl * 32;
  tq_xfrag_kernel<TQ1><<<static_cast<unsigned>((frags + 255) / 256), 256, 0, st>>>(
      x, ldx, m, nb, mtl, af);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the M groups of one column tile run next to each other (their weights
  // stay in L2)
  const dim3 grid((mtl + kMaxMT - 1) / kMaxMT, n / kBN);
  const int nbt = bk / kQK;
  switch (mtl < kMaxMT ? mtl : kMaxMT) {
    case 1: return launch_gemm<TQ1, 1>(grid, st, af, mtl, xs, pk, sc, m, nb, n, nbt, out);
    case 2: return launch_gemm<TQ1, 2>(grid, st, af, mtl, xs, pk, sc, m, nb, n, nbt, out);
    case 3: return launch_gemm<TQ1, 3>(grid, st, af, mtl, xs, pk, sc, m, nb, n, nbt, out);
    default: return launch_gemm<TQ1, 4>(grid, st, af, mtl, xs, pk, sc, m, nb, n, nbt, out);
  }
}

}  // namespace

extern "C" {

// Once, when the library is loaded (never inside a graph capture): lets
// every instantiation take its shared memory.
int vlut_tq_init() {
  const cudaError_t errs[] = {
      opt_in<false, 1>(), opt_in<false, 2>(), opt_in<false, 3>(),
      opt_in<false, 4>(), opt_in<true, 1>(),  opt_in<true, 2>(),
      opt_in<true, 3>(),  opt_in<true, 4>()};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Bytes of the A-fragment scratch that vlut_tq_gemm needs.
long vlut_tq_afrag_bytes(int m, int kp, int tq1) {
  return static_cast<long>(kp / kQK) * (tq1 ? 10 : 8) * ((m + 15) / 16) * 512;
}

// out (m, n) = xs * sum_b (x_b . trits_b) * scales[b]; x (m, kp) int8 rows
// of stride ldx; packed (kp/256 * rpb, n) uint8 (rpb 64 tq2, 52 tq1),
// scales (kp/256, n) fp16, xs (m,) f32, out (m, n) f32; n % 32 == 0, kp % bk == 0,
// bk % 256 == 0; afrag: vlut_tq_afrag_bytes of scratch (16-byte aligned).
// Two launches: the A fragments, then the GEMM.
int vlut_tq_gemm(const void* x, long ldx, const void* xs, const void* packed,
                 const void* scales, int m, int kp, int n, int tq1, int bk,
                 void* afrag, void* out, void* stream) {
  if (m <= 0 || n % kBN || kp % kQK || bk % kQK || kp % bk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* xp = static_cast<const int8_t*>(x);
  auto* xsp = static_cast<const float*>(xs);
  auto* pk = static_cast<const uint8_t*>(packed);
  auto* sc = static_cast<const __half*>(scales);
  auto* af = static_cast<uint4*>(afrag);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tq1 ? launch<true>(xp, ldx, xsp, pk, sc, m, kp, n, bk, af, o, st)
             : launch<false>(xp, ldx, xsp, pk, sc, m, kp, n, bk, af, o, st);
}

}  // extern "C"
