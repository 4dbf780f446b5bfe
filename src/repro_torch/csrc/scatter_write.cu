// scatter_write: row[idx[i]] = val[i], IN PLACE, over an int64 row (heap
// words or packed lock words).  Port of repro/kernels/scatter_write.py
// (scatter_write_flat).  The TPU kernel returned a fresh copy of the
// heap, because jax arrays are immutable, and seeded it in grid step 0
// before the later steps scattered; CUDA blocks run in no order, so a
// seed step would race the scatter.  The port's heap is a mutable
// device buffer and the write lands in place: no seed, no copy.
//
// Addresses are unique (write sets are dict-keyed) or, where a caller
// repeats one, carry the same value (the lock-release sweep), so the
// order among threads never matters.
//
// Bound on the card: bytes (8-byte index, 8-byte value read, 8-byte
// word written per element); at the main path's sizes the launch
// dominates.  One thread per element; a ragged N is masked here.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_write_kernel(int64_t* __restrict__ row,
                                     int64_t row_len,
                                     const int64_t* __restrict__ idx,
                                     const int64_t* __restrict__ val,
                                     int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t a = idx[i];
  // bounds are checked on the host before the launch; never write
  // outside the row even so
  if (a >= 0 && a < row_len) row[a] = val[i];
}

}  // namespace

extern "C" int scatter_write_i64(void* row, long long row_len,
                                 const void* idx, const void* val,
                                 long long n, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  scatter_write_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(row), row_len, static_cast<const int64_t*>(idx),
      static_cast<const int64_t*>(val), n);
  return static_cast<int>(cudaGetLastError());
}
