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
//
// validate_words: a commit's whole bulk revalidation in ONE launch.  The
// revalidation it replaces gathered the lock words (a gather_read launch
// after a host->device index copy), split them into fields with ~7
// elementwise ops and two casts, copied the seen versions to the card,
// memset the flag, launched the kernel above and compared the flag: ~15
// device operations and two copies for a predicate that reads 28 bytes an
// entry.  Here each thread gathers its entry's packed lock word
// (core/engine/arrayheap.py: version bits 18..63, tid + 2 bits 2..17,
// locked bit 1, flag bit 0), splits it and evaluates the same predicate.
// The read set is its (lock index, seen version) pairs, int64, as the
// host builds them in one pass over the read-set tuples.  Up to
// kParamEntries entries they ride in the launch's parameters (16 KB); a
// larger read set arrives in one pinned copy, enqueued by the same C
// call.  The verdict: up to kOneCta entries one CTA of 1024 threads ANDs
// its entries with __syncthreads_and and writes the 0-d bool itself (no
// memset, no atomics); above, a grid whose warps vote, after a memset of
// the bool to true, and a failing warp stores false.  The [N] int32 mask
// is written only when asked for.  Bound: bytes, 24 an entry (index, seen
// and word read) plus 4 for a mask.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

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

constexpr int kParamEntries = 1024;
constexpr int kOneCta = 8192;
constexpr int kWordsThreads = 1024;
constexpr int kTidBias = 2, kTidMask = 0xFFFF, kVerShift = 18;

// a read set's (lock index, seen version) pairs, passed by value
struct WordsParam {
  int64_t pairs[2 * kParamEntries];
};

__global__ void __launch_bounds__(kWordsThreads)
    validate_words_kernel(const int64_t* __restrict__ words,
                          int64_t n_words, const int64_t* __restrict__ dev,
                          const __grid_constant__ WordsParam prm, int64_t n,
                          int64_t r_clock, int64_t tid, int64_t mode,
                          int32_t* __restrict__ mask, bool* __restrict__ ok) {
  bool all = true;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += step) {
    const int64_t at = dev ? dev[2 * i] : prm.pairs[2 * i];
    // bounds are checked by the host; the guard keeps a bad index from
    // reading outside the row all the same (an unlocked word of version 0)
    const int64_t w = (at >= 0 && at < n_words) ? words[at] : 0;
    const int64_t ver = w >> kVerShift;
    const int64_t own = ((w >> 2) & kTidMask) - kTidBias;
    const bool locked = (w & 2) != 0;
    const bool flagged = (w & 1) != 0;
    const bool mine = locked && own == tid;
    bool e;
    if (mode == 0) {
      e = mine || (!locked && !flagged && ver < r_clock);
    } else if (mode == 1) {
      e = (!locked || mine) && ver <= r_clock;
    } else {
      e = (!locked || mine) &&
          ver == (dev ? dev[2 * i + 1] : prm.pairs[2 * i + 1]);
    }
    if (mask) mask[i] = e ? 1 : 0;
    all = all && e;
  }
  if (gridDim.x == 1) {
    all = __syncthreads_and(all);
    if (threadIdx.x == 0) *ok = all;
  } else if (!__all_sync(0xffffffffu, all) && (threadIdx.x & 31) == 0) {
    *ok = false;   // every writer writes the same value
  }
}

}  // namespace

// words [n_words] int64 (the packed lock row).  The n (lock index, seen
// version) int64 pairs are either at host ``param`` (n <= 1024, passed by
// value) or at pinned ``host``, which this call copies to ``dev`` ([n, 2]
// int64 on the card) and marks with ``event`` behind the copy.  ``mask``
// ([n] int32) may be null; ``ok`` is one bool.
extern "C" int validate_words_i64(const void* words, long long n_words,
                                  const void* param, const void* host,
                                  void* dev, void* event, long long n,
                                  long long r_clock, long long tid,
                                  long long mode, void* mask, void* ok,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WordsParam prm;
  cudaError_t err;
  if (param) {
    if (n > kParamEntries) return static_cast<int>(cudaErrorInvalidValue);
    memcpy(prm.pairs, param, 16 * n);
    dev = nullptr;
  } else {
    err = cudaMemcpyAsync(dev, host, 16 * n, cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaEventRecord(static_cast<cudaEvent_t>(event), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  unsigned blocks = 1;
  if (n > kOneCta) {
    blocks = static_cast<unsigned>(
        (n + kWordsThreads - 1) / kWordsThreads < 1056
            ? (n + kWordsThreads - 1) / kWordsThreads
            : 1056);
    err = cudaMemsetAsync(ok, 1, sizeof(bool), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  validate_words_kernel<<<blocks, kWordsThreads, 0, s>>>(
      static_cast<const int64_t*>(words), n_words,
      static_cast<const int64_t*>(dev), prm, n, r_clock, tid, mode,
      static_cast<int32_t*>(mask), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

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
