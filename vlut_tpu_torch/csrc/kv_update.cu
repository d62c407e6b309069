// KV-cache row writer for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces vlut_tpu/ops/kv_update.py:write_rows_pair_pallas
// (_write2_kernel) and write_rows_pallas (_write_kernel): for every slot b,
// copy the new row u[b] (one token: Hkv * hd elements) into
// cache[b, start[b]], in place.  One block per slot; the block copies the
// row with 16-byte loads and stores when the row size allows.  It moves
// exactly B rows (2 * B * Hkv * hd * 2 bytes for a bf16 K/V pair), so
// memory latency and the launch bound it; nothing else is read.  A start
// outside [0, S) writes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void copy_row(uint8_t* dst, const uint8_t* src,
                                         long n) {
  if ((n & 15) == 0 && ((reinterpret_cast<uintptr_t>(dst) |
                         reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    for (long i = threadIdx.x; i < n / 16; i += blockDim.x) {
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    }
  } else {
    for (long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__global__ void write_rows_kernel(uint8_t* kc, uint8_t* vc,
                                  const uint8_t* ku, const uint8_t* vu,
                                  const int32_t* start, int s,
                                  long row_bytes) {
  const int b = blockIdx.x;
  const int pos = start[b];
  if (pos < 0 || pos >= s) return;
  const long dst = (static_cast<long>(b) * s + pos) * row_bytes;
  const long src = static_cast<long>(b) * row_bytes;
  copy_row(kc + dst, ku + src, row_bytes);
  if (vc != nullptr) copy_row(vc + dst, vu + src, row_bytes);
}

}  // namespace

extern "C" {

// kc/vc: (b, s, ...) contiguous caches; ku/vu: (b, 1, ...) rows of
// row_bytes bytes; start: (b,) int32.  vc/vu may be null (one array).
int vlut_write_rows(void* kc, void* vc, const void* ku, const void* vu,
                    const void* start, int b, int s, long row_bytes,
                    void* stream) {
  write_rows_kernel<<<b, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(kc), static_cast<uint8_t*>(vc),
      static_cast<const uint8_t*>(ku), static_cast<const uint8_t*>(vu),
      static_cast<const int32_t*>(start), s, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
