// validate: the per-entry read-set predicate of commit-time
// revalidation over gathered lock fields.  Port of
// repro/kernels/validate.py (validate_readset_flat), which took int32
// versions rebased to the reader's clock; here versions, seen versions
// and the clock are int64 as stored, so nothing is rebased or clipped.
//
//   mode 0 (V_LT): own lock passes; else free, unflagged, ver <  r_clock
//   mode 1 (V_LE): unlocked or own, and ver <= r_clock
//   mode 2 (V_EQ): unlocked or own, and ver == seen
//
// meta bit0 = locked, bit1 = flag; own is the holder tid.  Writes the
// [N] int32 mask and clears *all_ok (set to all ones first, on the same
// stream) with atomicAnd wherever an entry fails.
//
// Bound on the card: bytes (8 + 4 + 4 + 8 read, 4 written per entry);
// at read sets of a few thousand entries the launch dominates.  One
// thread per entry; a ragged N is masked here, so no padding entries.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void validate_kernel(const int64_t* __restrict__ ver,
                                const int32_t* __restrict__ own,
                                const int32_t* __restrict__ meta,
                                const int64_t* __restrict__ seen, int64_t n,
                                int64_t r_clock, int64_t tid, int64_t mode,
                                int32_t* __restrict__ mask,
                                int32_t* __restrict__ all_ok) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int32_t m = meta[i];
  const bool locked = (m & 1) != 0;
  const bool flagged = (m & 2) != 0;
  const bool mine = locked && static_cast<int64_t>(own[i]) == tid;
  bool ok;
  if (mode == 0) {
    ok = mine || (!locked && !flagged && ver[i] < r_clock);
  } else if (mode == 1) {
    ok = (!locked || mine) && ver[i] <= r_clock;
  } else {
    ok = (!locked || mine) && ver[i] == seen[i];
  }
  mask[i] = ok ? 1 : 0;
  if (!ok) atomicAnd(all_ok, 0);
}

}  // namespace

extern "C" int validate_readset_i64(const void* ver, const void* own,
                                    const void* meta, const void* seen,
                                    long long n, long long r_clock,
                                    long long tid, long long mode,
                                    void* mask, void* all_ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // all bits set = "every entry valid" until a failing entry clears it
  cudaError_t err = cudaMemsetAsync(all_ok, 0xFF, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  validate_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int64_t*>(ver), static_cast<const int32_t*>(own),
      static_cast<const int32_t*>(meta), static_cast<const int64_t*>(seen),
      n, r_clock, tid, mode, static_cast<int32_t*>(mask),
      static_cast<int32_t*>(all_ok));
  return static_cast<int>(cudaGetLastError());
}
