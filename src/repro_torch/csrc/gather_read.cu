// gather_read: out[i] = row[idx[i]] over an int64 row (heap words or
// packed lock words).  Port of repro/kernels/gather_read.py
// (gather_read_flat), which took the whole heap as one VMEM block and
// gathered an int32 address tile per grid step.
//
// Bound on the card: bytes.  Each element reads an 8-byte index and an
// 8-byte row word and writes 8 bytes; the row is read in place, never
// copied.  At the main path's 256-word chunks that is 6 KB, a few
// nanoseconds of HBM time, so the launch itself is what costs.  Design:
// one thread per element, no shared memory; a ragged N is masked here,
// so the host pads nothing.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void gather_read_kernel(const int64_t* __restrict__ row,
                                   int64_t row_len,
                                   const int64_t* __restrict__ idx,
                                   int64_t n, int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t a = idx[i];
  // the host checks bounds before every launch; the guard keeps a bad
  // index from reading outside the row all the same
  out[i] = (a >= 0 && a < row_len) ? row[a] : 0;
}

}  // namespace

extern "C" int gather_read_i64(const void* row, long long row_len,
                               const void* idx, long long n, void* out,
                               void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  gather_read_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(row), row_len,
      static_cast<const int64_t*>(idx), n, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
