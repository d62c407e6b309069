// Trit decode shared by the port's ternary GEMM kernels.
//
// Replaces the TPU decode helper vlut_tpu/ops/pallas_gemm.py:_unpack_tile
// (byte branch).  Byte layout (vlut_tpu/ops/packing.py):
//     byte[block b, row j, col n] field q  <->  W[b*kb + q*32 + j, n]
// with kb = 128 (i2, four 2-bit fields) or 160 (i1, five base-3 digits), so
// one packed byte carries the trits of one column at four (five) K indices
// that are 32 apart.  The decode turns one byte into a 32-bit word holding
// four signed int8 trits, one int8 mma B-fragment register (byte q = the
// trit at K offset q*32); i1's fifth digit comes back as a separate int.
//
// The TPU decodes to fields {0,1,2} and subtracts the K-block row sum of x
// from the accumulator; here the decode goes straight to trits
// {-1,0,+1}, which gives the identical int32 accumulator.

#pragma once
#include <stdint.h>

namespace vlut {

constexpr int kSlab = 32;  // kb / r for both formats

// four bytes of fields {0,1,2} -> four bytes of trits {-1,0,1} (no borrow:
// each byte is raised to >= 0x80 before the per-byte subtract)
__device__ __forceinline__ int fields_to_trits(uint32_t f) {
  return (int)(((f | 0x80808080u) - 0x01010101u) ^ 0x80808080u);
}

// i2: field q is bits 2q..2q+1; spread them to byte q of the word.
__device__ __forceinline__ int decode_i2(uint32_t b) {
  const uint32_t f = (b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u;
  return fields_to_trits(f);
}

// i1: base-3 digits by independent multiply-shift divisions, exact for
// x < 243 (vlut_tpu/ops/pallas_gemm.py:117-132).  Digits 0..3 go to the
// returned word, digit 4 (minus one) to *t5.
__device__ __forceinline__ int decode_i1(uint32_t x, int* t5) {
  const uint32_t t1 = (x * 171u) >> 9;  // x / 3
  const uint32_t a = (x * 57u) >> 9;    // x / 9
  const uint32_t b = (x * 19u) >> 9;    // x / 27
  const uint32_t c = (x * 405u) >> 15;  // x / 81
  const uint32_t f = (x - 3u * t1) | ((t1 - 3u * a) << 8) |
                     ((a - 3u * b) << 16) | ((b - 3u * c) << 24);
  *t5 = (int)c - 1;
  return fields_to_trits(f);
}

}  // namespace vlut
