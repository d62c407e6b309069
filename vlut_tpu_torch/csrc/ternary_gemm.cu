// Ternary GEMM kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces three TPU kernels of vlut_tpu/ops/pallas_gemm.py:
//   * ternary_gemm_decode (_decode_kernel): prologue (RMSNorm / silu*up
//     [+ sub-norm] / nothing) -> bf16 round -> per-row int8 quant, ternary
//     GEMM, epilogue (acc*xs)*ws [+ residual in the output dtype].
//     Here: vlut_quant_prologue + vlut_decode_gemm.
//   * ternary_gemm_fused_quant (_fused_gemm_kernel): the same two launches
//     with the prologue in plain mode (quantize once per call, not per
//     block as the TPU kernel does).
//   * ternary_gemm_pallas (_gemm_kernel): tiled GEMM on pre-quantized int8
//     activations.  Here: vlut_tiled_gemm.
//
// What bounds them on an H100: at decode sizes (M <= 64) each packed weight
// byte is used by at most 64 rows, so moving the weights from memory is the
// bound; the prefill GEMM (M = 4096) is bound by int8 operations.  Both
// GEMMs run the dot on the int8 tensor cores (mma.sync m16n8k32) with the
// K order of each 32-deep mma chunk chosen so that one packed byte decodes
// to exactly one B-fragment register (see tiled_gemm_kernel).  The decode
// GEMM streams every packed byte once, straight from memory into
// registers (a warp reads four full 32-byte sectors per load), with the
// next pack block's loads in flight while the current one is decoded; it
// has no shared-memory staging, no cp.async/TMA ring and no wgmma yet.
// The tiled GEMM decodes each staged byte once into shared memory; it has
// no copy/compute overlap yet.
//
// The Pallas decode kernel keeps the quantized x in scratch across a
// sequential grid.  Hopper blocks run in parallel and share nothing, so the
// prologue is its own launch that writes the int8 codes once, already in
// the decode GEMM's mma A-fragment order (see afrag_byte), so every GEMM
// warp reads its A registers with one 16-byte load per fragment (from L1
// or L2: all warps read the same, small, x).

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

constexpr int kPrologueThreads = 1024;

__device__ float block_reduce(float v, bool is_max, float* sh) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = lane < (kPrologueThreads / 32) ? sh[lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  return v;  // every thread holds the result
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

// Byte offset of the int8 code of x row `row`, slab row j (0..31) of pack
// block b, field q, in the decode GEMM's A fragments.  Fragment (b, c, mt)
// is 32 lanes x 4 registers (16 bytes per lane, contiguous); nc chunks per
// pack block (4, or 5 for i1), mtl 16-row tiles.  Chunk c < 4 takes slab
// rows 8c..8c+7: register r of lane 4g+t holds tile row g + 8(r & 1) at
// slab row 8c + t + 4(r >> 1), byte q = field q.  i1's fifth chunk (q = 4)
// holds, in byte i of register r of lane 4g+t, slab row 8i + t + 4(r >> 1).
__device__ __forceinline__ long afrag_byte(int row, int b, int j, int q,
                                           int nc, int mtl) {
  const int c = q < 4 ? j >> 3 : 4, byte = q < 4 ? q : j >> 3;
  const int t = j & 3, half = (j >> 2) & 1;
  const int mt = row >> 4, g = row & 7, reg = ((row >> 3) & 1) + 2 * half;
  const long frag = (static_cast<long>(b) * nc + c) * mtl + mt;
  return ((frag * 32 + g * 4 + t) * 4 + reg) * 4 + byte;
}

// One block per row of the padded M (mtl * 16 rows; rows >= m get zero
// codes): the decode prologue and the int8 quantization.  Each thread
// quantizes the r codes of one slab row (K = b*kb + q*32 + j) and stores
// the four of fields 0..3 as one word.
__global__ void __launch_bounds__(kPrologueThreads) quant_prologue_kernel(
    const void* x1, const void* x2, long ld, int in_bf16, int k, int kp,
    const float* g, int mode, int sub_norm, float norm_n, float eps, int kb,
    int m, int mtl, int8_t* afrag, float* xs) {
  __shared__ float sh[32];
  const int row = blockIdx.x;
  const bool live = row < m;  // uniform per block
  const long base = static_cast<long>(row) * ld;
  const bool normed = mode == kNorm || sub_norm;

  auto pre = [&](int i) -> float {
    float v = load_f(x1, base + i, in_bf16);
    if (mode == kSiluMul) {
      v = v * (1.0f / (1.0f + expf(-v))) * load_f(x2, base + i, in_bf16);
      if (sub_norm) v = bf16_round(v);  // silu*up is materialized in bf16
    }
    return v;
  };

  float inv_rms = 1.0f;
  if (live && normed) {
    float ss = 0.0f;
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      const float v = pre(i);
      ss += v * v;
    }
    ss = block_reduce(ss, false, sh);
    inv_rms = 1.0f / sqrtf(ss / norm_n + eps);
  }
  auto h = [&](int i) -> float {
    float v = pre(i);
    if (normed) v = v * inv_rms * g[i];
    if (mode != kPlain) v = bf16_round(v);
    return v;
  };

  float inv = 0.0f;
  if (live) {
    float amax = 0.0f;
    for (int i = threadIdx.x; i < k; i += blockDim.x) amax = fmaxf(amax, fabsf(h(i)));
    amax = block_reduce(amax, true, sh);
    inv = amax > 0.0f ? 127.0f / fmaxf(amax, 1e-30f) : 0.0f;
    // amax * (1/127), as the Pallas kernels compute their amax / 127.0
    if (threadIdx.x == 0) xs[row] = amax * (1.0f / 127.0f);
  }

  const int r = kb / kSlab, slab_rows = kp / r;
  auto code = [&](int i) -> uint32_t {
    const float v = live && i < k ? h(i) : 0.0f;
    // rintf rounds half to even, as jnp.round does
    return static_cast<uint8_t>(static_cast<int8_t>(
        fminf(fmaxf(rintf(v * inv), -127.0f), 127.0f)));
  };
  for (int sr = threadIdx.x; sr < slab_rows; sr += blockDim.x) {
    const int b = sr / kSlab, j = sr % kSlab, k0 = b * kb + j;
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) word |= code(k0 + q * kSlab) << (8 * q);
    *reinterpret_cast<uint32_t*>(afrag + afrag_byte(row, b, j, 0, r, mtl)) = word;
    if (r == 5) {
      afrag[afrag_byte(row, b, j, 4, r, mtl)] =
          static_cast<int8_t>(code(k0 + 4 * kSlab));
    }
  }
}

// Four packed i2 bytes (four columns) -> four B registers: register i
// holds column i's trits, byte q = field q.  A 4 x 4 byte transpose of the
// per-field planes.
__device__ __forceinline__ void decode_i2_word(uint32_t w, uint32_t (&r)[4]) {
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

// Small-M GEMM on the tensor cores.  One block per 32 output columns; its
// kDecodeWarps warps take interleaved pack blocks of K and meet in shared
// memory.  Lane 4g+t reads the 32-bit word of columns n0+4g..n0+4g+3 of
// slab rows 8c+t and 8c+t+4 for each chunk c: byte nt of the word is the
// B register of n-tile nt (mma column g of n-tile nt is column
// n0 + 4g + nt), so the weights need no staging.  MTL = ceil(M / 16) tiles
// of A come from the prologue's fragments.
constexpr int kDecodeWarps = 16;

template <int MTL, bool I1>
__global__ void __launch_bounds__(kDecodeWarps * 32) decode_gemm_kernel(
    const uint4* __restrict__ afrag, const float* __restrict__ xs,
    const uint8_t* __restrict__ packed, const float* __restrict__ ws, int m,
    int nb, int np, const void* res, int res_ld, int n_res, void* out,
    int out_bf16) {
  constexpr int NC = I1 ? 5 : 4;
  __shared__ int sacc[MTL * 16][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 32;
  const uint8_t* wp = packed + n0 + 4 * g;

  int acc[MTL][4][4];
#pragma unroll
  for (int i = 0; i < MTL; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }

  // word 2c + h: slab row 8c + t + 4h of pack block b
  auto load = [&](uint32_t (&w)[8], int b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long sr = static_cast<long>(b) * kSlab + 8 * (i >> 1) + t + 4 * (i & 1);
      w[i] = *reinterpret_cast<const uint32_t*>(wp + sr * np);
    }
  };
  uint32_t w[8], wn[8];
  if (warp < nb) load(w, warp);
  for (int b = warp; b < nb; b += kDecodeWarps) {
    if (b + kDecodeWarps < nb) load(wn, b + kDecodeWarps);
    uint32_t b5[4][2] = {};  // i1: fifth-digit B registers per n-tile
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t bf[2][4];  // [h][n-tile]
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (I1) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            int t5;
            bf[hh][nt] = static_cast<uint32_t>(
                vlut::decode_i1((w[2 * c + hh] >> (8 * nt)) & 0xffu, &t5));
            b5[nt][hh] |= (static_cast<uint32_t>(t5) & 0xffu) << (8 * c);
          }
        } else {
          decode_i2_word(w[2 * c + hh], bf[hh]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MTL; ++mt) {
        const uint4 av = afrag[((static_cast<long>(b) * NC + c) * MTL + mt) * 32 + lane];
        const uint32_t a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a, bf[0][nt], bf[1][nt]);
      }
    }
    if (I1) {
#pragma unroll
      for (int mt = 0; mt < MTL; ++mt) {
        const uint4 av = afrag[((static_cast<long>(b) * NC + 4) * MTL + mt) * 32 + lane];
        const uint32_t a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a, b5[nt][0], b5[nt][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = wn[i];
  }

  for (int i = threadIdx.x; i < MTL * 16 * 32; i += blockDim.x) {
    sacc[i / 32][i % 32] = 0;
  }
  __syncthreads();
  // D register e: row g + 8(e >> 1), mma column 2t + (e & 1)
#pragma unroll
  for (int mt = 0; mt < MTL; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        atomicAdd(&sacc[mt * 16 + g + 8 * (e >> 1)][4 * (2 * t + (e & 1)) + nt],
                  acc[mt][nt][e]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m * 32; i += blockDim.x) {
    const int mm = i / 32, col = n0 + (i % 32);
    const bool has_res = res != nullptr && col < n_res;
    const float v = epilogue(sacc[mm][i % 32], xs[mm], ws[col],
                             has_res ? res : nullptr,
                             static_cast<long>(mm) * res_ld + col, out_bf16);
    store_f(out, static_cast<long>(mm) * np + col, v, out_bf16);
  }
}

template <int MTL>
void launch_decode(bool i1, dim3 grid, cudaStream_t st, const uint4* afrag,
                   const float* xs, const uint8_t* packed, const float* ws,
                   int m, int nb, int np, const void* res, int res_ld,
                   int n_res, void* out, int out_bf16) {
  if (i1) {
    decode_gemm_kernel<MTL, true><<<grid, kDecodeWarps * 32, 0, st>>>(
        afrag, xs, packed, ws, m, nb, np, res, res_ld, n_res, out, out_bf16);
  } else {
    decode_gemm_kernel<MTL, false><<<grid, kDecodeWarps * 32, 0, st>>>(
        afrag, xs, packed, ws, m, nb, np, res, res_ld, n_res, out, out_bf16);
  }
}

// Tiled GEMM on natural-layout int8 x (M, K) on the int8 tensor cores.
// Block tile 128 x 128, one pack block of K (32 slab rows) per step; the
// 8 warps sit as 2 (M) x 4 (N), each with a 64 x 32 tile of 4 x 4
// mma_s8 accumulators.  The mma's K order inside a pack block is the slab
// order: chunk c takes slab rows j = 8c..8c+7 with their four fields, so
// one packed byte decodes to exactly one B register (byte q = trit of
// field q), and the matching A register is the word of x codes at
// K = b*kb + q*32 + j, q = 0..3, which the staging loop gathers into
// shared memory.  i1's fifth digits form a fifth chunk whose registers
// hold the digits of four consecutive slab rows.  Each packed byte is
// decoded once per block, at staging.
constexpr int kBM = 128, kBN = 128, kPad = 8;  // pad: conflict-free frags

template <bool I1>
__global__ void __launch_bounds__(256) tiled_gemm_kernel(
    const int8_t* __restrict__ x, long ldx, int k,
    const float* __restrict__ xs, const uint8_t* __restrict__ packed,
    const float* __restrict__ ws, int m, int kp, int np, int kb, void* out,
    int out_bf16) {
  // x codes of fields 0..3 per (slab row, m); decoded trits per (row, n)
  __shared__ __align__(16) uint32_t sa[kSlab][kBM + kPad];
  __shared__ __align__(16) uint32_t sb[kSlab][kBN + kPad];
  // i1 fifth plane, four slab rows per word: x per (m, j/4), trits (n, j/4)
  constexpr int k5 = I1 ? kSlab / 4 + 1 : 1;
  __shared__ __align__(16) uint32_t sa5[I1 ? kBM : 1][k5];
  __shared__ __align__(16) uint32_t sb5[I1 ? kBN : 1][k5];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int segs = kb / 16;  // 16-byte segments of x per row and block
  const bool x_vec = (ldx % 16) == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
    }
  }

  const int nb = kp / kb;
  for (int b = 0; b < nb; ++b) {
    // x: 16 consecutive K of one row lie in one field q, slab rows j..j+15
    for (int i = tid; i < kBM * segs; i += blockDim.x) {
      const int mm = i / segs, seg = i % segs;
      const int gm = m0 + mm, gk = b * kb + seg * 16;
      const int q = seg >> 1, j = (seg & 1) * 16;
      alignas(16) int8_t v[16];
      if (x_vec && gm < m && gk + 16 <= k) {
        *reinterpret_cast<int4*>(v) = *reinterpret_cast<const int4*>(
            x + static_cast<long>(gm) * ldx + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          v[e] = (gm < m && gk + e < k) ? x[static_cast<long>(gm) * ldx + gk + e] : 0;
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (q < 4) {
          reinterpret_cast<int8_t*>(&sa[j + e][mm])[q] = v[e];
        } else {
          reinterpret_cast<int8_t*>(&sa5[mm][(j + e) >> 2])[(j + e) & 3] = v[e];
        }
      }
    }
    // weights: one 16-byte load per thread (32 rows x 128 columns)
    {
      const int rr = tid >> 3, c16 = (tid & 7) * 16;
      const uint4 w = *reinterpret_cast<const uint4*>(
          packed + static_cast<long>(b * kSlab + rr) * np + n0 + c16);
      const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
      uint32_t d[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const uint32_t byte = (wv[e >> 2] >> (8 * (e & 3))) & 0xffu;
        if (I1) {
          int t5;
          d[e] = vlut::decode_i1(byte, &t5);
          reinterpret_cast<int8_t*>(&sb5[c16 + e][rr >> 2])[rr & 3] =
              static_cast<int8_t>(t5);
        } else {
          d[e] = vlut::decode_i2(byte);
        }
      }
#pragma unroll
      for (int e = 0; e < 16; e += 4) {
        *reinterpret_cast<uint4*>(&sb[rr][c16 + e]) =
            make_uint4(d[e], d[e + 1], d[e + 2], d[e + 3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < (I1 ? 5 : 4); ++c) {
      uint32_t a[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm + mt * 16 + g;
        if (c < 4) {
          const int j = c * 8 + t;
          a[mt][0] = sa[j][r];
          a[mt][1] = sa[j][r + 8];
          a[mt][2] = sa[j + 4][r];
          a[mt][3] = sa[j + 4][r + 8];
        } else {
          a[mt][0] = sa5[r][t];
          a[mt][1] = sa5[r + 8][t];
          a[mt][2] = sa5[r][t + 4];
          a[mt][3] = sa5[r + 8][t + 4];
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn + nt * 8 + g;
        if (c < 4) {
          bf[nt][0] = sb[c * 8 + t][col];
          bf[nt][1] = sb[c * 8 + t + 4][col];
        } else {
          bf[nt][0] = sb5[col][t];
          bf[nt][1] = sb5[col][t + 4];
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], bf[nt][0], bf[nt][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm + mt * 16 + g + 8 * h;
      if (gm >= m) continue;
      const float xsv = xs[gm];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = epilogue(acc[mt][nt][2 * h + e], xsv, ws[col + e],
                                   nullptr, 0, out_bf16);
          store_f(out, static_cast<long>(gm) * np + col + e, v, out_bf16);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x1/x2: (m, k) rows with stride ld, bf16 or f32.  Writes afrag
// (kp/kb * r * mtl * 512 bytes: the decode GEMM's A fragments, rows
// m..16*mtl-1 zero) and xs (m,) f32.
int vlut_quant_prologue(const void* x1, const void* x2, long ld, int in_bf16,
                        int k, int kp, const float* g, int mode, int sub_norm,
                        float norm_n, float eps, int kb, int m, int mtl,
                        void* afrag, void* xs, void* stream) {
  quant_prologue_kernel<<<mtl * 16, kPrologueThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x1, x2, ld, in_bf16, k, kp, g, mode, sub_norm, norm_n, eps, kb, m, mtl,
      static_cast<int8_t*>(afrag), static_cast<float*>(xs));
  return static_cast<int>(cudaGetLastError());
}

// out (m, np) = epilogue(afrag @ trits(packed)); m <= 64, np % 32 == 0,
// nb = kp / kb pack blocks.
int vlut_decode_gemm(const void* afrag, const void* xs, const void* packed,
                     const void* ws, int m, int nb, int np, int i1,
                     const void* res, int res_ld, int n_res, void* out,
                     int out_bf16, void* stream) {
  const dim3 grid(np / 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* af = static_cast<const uint4*>(afrag);
  auto* xsp = static_cast<const float*>(xs);
  auto* pk = static_cast<const uint8_t*>(packed);
  auto* wsp = static_cast<const float*>(ws);
  switch ((m + 15) / 16) {
    case 1: launch_decode<1>(i1, grid, st, af, xsp, pk, wsp, m, nb, np, res, res_ld, n_res, out, out_bf16); break;
    case 2: launch_decode<2>(i1, grid, st, af, xsp, pk, wsp, m, nb, np, res, res_ld, n_res, out, out_bf16); break;
    case 3: launch_decode<3>(i1, grid, st, af, xsp, pk, wsp, m, nb, np, res, res_ld, n_res, out, out_bf16); break;
    case 4: launch_decode<4>(i1, grid, st, af, xsp, pk, wsp, m, nb, np, res, res_ld, n_res, out, out_bf16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (m, np) = epilogue(x (m, k) int8 @ trits(packed)); np % 128 == 0.
int vlut_tiled_gemm(const void* x, long ldx, int k, const void* xs,
                    const void* packed, const void* ws, int m, int kp, int np,
                    int kb, int i1, void* out, int out_bf16, void* stream) {
  const dim3 grid(np / kBN, (m + kBM - 1) / kBM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<const int8_t*>(x);
  auto* xsp = static_cast<const float*>(xs);
  auto* pk = static_cast<const uint8_t*>(packed);
  auto* wsp = static_cast<const float*>(ws);
  if (i1) {
    tiled_gemm_kernel<true><<<grid, 256, 0, st>>>(xp, ldx, k, xsp, pk, wsp, m, kp, np, kb, out, out_bf16);
  } else {
    tiled_gemm_kernel<false><<<grid, 256, 0, st>>>(xp, ldx, k, xsp, pk, wsp, m, kp, np, kb, out, out_bf16);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
