// KV-cache row writer for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces vlut_tpu/ops/kv_update.py:write_rows_pair_pallas
// (_write2_kernel) and write_rows_pallas (_write_kernel): for every slot b,
// copy the new row u[b] (one token) into cache[b, start[b]], in place.
//
// One launch writes every array of a layer's update: K and V, and for the
// int8 cache its two float32 scale planes too (at most kMaxArrays).  The
// threads cover (slot, array, chunk) in one wave, one chunk each: 16 bytes
// where the array's row size and both base pointers allow it, else the
// largest of 8, 4, 2 or 1 bytes that they allow.  Rows are read with the
// slot stride the layer gives them (V is a column slice of the fused qkv
// output), and the starts as int32 or int64, so the wrapper launches no
// cast or copy before the kernel.  The kernel moves exactly the B rows of
// each array, read once and written once; for a layer that is a few KB to
// a few hundred KB, so the launch and one memory round trip bound it, not
// the bytes.  A start outside [0, S) writes nothing.
//
// The launch allows programmatic stream serialization: the blocks may be
// scheduled while the kernel before them drains, and each waits
// (griddepcontrol.wait) before it reads anything.  On an H100 (700 W) it
// took 0.12-0.59 us off a call at every shape of bench/kv_study.py, whose
// no_pdl build is this source launched without it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxArrays = 4;
constexpr int kThreads = 256;

struct Arrays {
  uint8_t* cache[kMaxArrays];
  const uint8_t* row[kMaxArrays];
  long row_ld[kMaxArrays];     // bytes from one slot's row to the next
  long row_bytes[kMaxArrays];  // bytes of one row (one cache row)
  int unit_log2[kMaxArrays];   // log2 of a chunk's bytes
  int first[kMaxArrays];       // the array's first chunk within a slot
};

__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src,
                                           int lg) {
  switch (lg) {
    case 4:
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      break;
    case 3:
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      break;
    case 2:
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(src);
      break;
    case 1:
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
      break;
    default:
      *dst = *src;
  }
}

__global__ void __launch_bounds__(kThreads)
    write_rows_kernel(const Arrays a, int n, const void* start, int start64,
                      int b, int s, int per_slot) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long t = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long>(b) * per_slot) return;
  const int slot = static_cast<int>(t / per_slot);
  const int c = static_cast<int>(t - static_cast<long>(slot) * per_slot);
  const long pos = start64 ? static_cast<const long long*>(start)[slot]
                           : static_cast<const int*>(start)[slot];
  if (pos < 0 || pos >= s) return;
  // the array this chunk belongs to, by selects (no indexed parameter load)
  uint8_t* cache = a.cache[0];
  const uint8_t* row = a.row[0];
  long ld = a.row_ld[0], rb = a.row_bytes[0];
  int lg = a.unit_log2[0], first = 0;
#pragma unroll
  for (int j = 1; j < kMaxArrays; ++j) {
    if (j < n && c >= a.first[j]) {
      cache = a.cache[j];
      row = a.row[j];
      ld = a.row_ld[j];
      rb = a.row_bytes[j];
      lg = a.unit_log2[j];
      first = a.first[j];
    }
  }
  const long off = static_cast<long>(c - first) << lg;
  copy_chunk(cache + (static_cast<long>(slot) * s + pos) * rb + off,
             row + static_cast<long>(slot) * ld + off, lg);
}

// The largest chunk (log2 bytes, at most 16 bytes) that divides the row
// size, the slot stride and both base addresses.
int unit_log2(const void* cache, const void* row, long ld, long rb) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(cache) |
                         reinterpret_cast<uintptr_t>(row) |
                         static_cast<uintptr_t>(ld) |
                         static_cast<uintptr_t>(rb);
  int lg = 4;
  while (lg > 0 && (bits & ((uintptr_t{1} << lg) - 1)) != 0) --lg;
  return lg;
}

}  // namespace

extern "C" {

// n arrays (1..4) of one layer: caches[i] a contiguous (b, s, ...) cache of
// row_bytes[i] bytes per row, rows[i] its (b, 1, ...) new rows, slot i's
// row at rows[i] + b * row_ld[i] bytes; start (b,) int32, or int64 with
// start64.
int vlut_write_rows(int n, void* const* caches, const void* const* rows,
                    const long* row_ld, const long* row_bytes,
                    const void* start, int start64, int b, int s,
                    void* stream) {
  if (n < 1 || n > kMaxArrays) return static_cast<int>(cudaErrorInvalidValue);
  Arrays a = {};
  int per_slot = 0;
  for (int i = 0; i < n; ++i) {
    a.cache[i] = static_cast<uint8_t*>(caches[i]);
    a.row[i] = static_cast<const uint8_t*>(rows[i]);
    a.row_ld[i] = row_ld[i];
    a.row_bytes[i] = row_bytes[i];
    a.unit_log2[i] = unit_log2(caches[i], rows[i], row_ld[i], row_bytes[i]);
    a.first[i] = per_slot;
    per_slot += static_cast<int>(row_bytes[i] >> a.unit_log2[i]);
  }
  if (b <= 0 || per_slot == 0) return 0;
  const long threads = static_cast<long>(b) * per_slot;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((threads + kThreads - 1) /
                                           kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, write_rows_kernel, a, n, start, start64, b, s, per_slot);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
