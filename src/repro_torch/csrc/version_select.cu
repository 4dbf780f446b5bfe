// version_select: per row of newest-first (ts, data) mirror slots, the
// first data whose ts is strictly below r_clock, and whether one was
// found.  Port of repro/kernels/version_select.py (version_select_flat),
// which took int32 timestamps rebased to the reader's clock and found
// the slot with argmax; here timestamps and the clock are int64 as
// stored (the empty-slot sentinel 2^62 fails the test by itself) and the
// first match is taken by an explicit scan, newest first.  A row with no
// match returns its slot-0 data with ok = 0, as argmax did.
//
// Bound on the card: bytes (2 x 8 x D read, 12 written per row); at
// the mirror's depth of 4 and the main path's few hundred rows the
// launch dominates.  One thread per row; a ragged N is masked here.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void version_select_kernel(const int64_t* __restrict__ ts,
                                      const int64_t* __restrict__ data,
                                      int64_t n, int64_t depth,
                                      int64_t r_clock,
                                      int64_t* __restrict__ val,
                                      int32_t* __restrict__ ok) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t* t = ts + i * depth;
  const int64_t* d = data + i * depth;
  int64_t v = d[0];
  int32_t found = 0;
  for (int64_t j = 0; j < depth; ++j) {
    if (t[j] < r_clock) {
      v = d[j];
      found = 1;
      break;
    }
  }
  val[i] = v;
  ok[i] = found;
}

}  // namespace

extern "C" int version_select_i64(const void* ts, const void* data,
                                  long long n, long long depth,
                                  long long r_clock, void* val, void* ok,
                                  void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  version_select_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ts), static_cast<const int64_t*>(data), n,
      depth, r_clock, static_cast<int64_t*>(val), static_cast<int32_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
