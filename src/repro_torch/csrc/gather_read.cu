// gather_read: out[i] = row[idx[i]] over an int64 row (heap words or
// packed lock words) or an int32 row (the MVStore block and its ring rows,
// int32 as in the reference).  Port of repro/kernels/gather_read.py
// (gather_read_flat), which took the whole heap as one VMEM block and
// gathered an int32 address tile per grid step.
//
// Bound on the card: bytes.  Each element reads an 8-byte index and an
// 8-byte row word and writes 8 bytes; the row is read in place, never
// copied.  At the main path's 256-word chunks that is 6 KB, a few
// nanoseconds of HBM time, so the launch itself is what costs.  Design:
// one thread per element, no shared memory; a ragged N is masked here,
// so the host pads nothing.
//
// gather_bracketed: a bulk transactional read's three gathers — the lock
// word before, the heap word, the lock word after (core/engine/
// bulkread.py) — in ONE launch.  Each thread reads its element's lock
// word, then its heap word, then its lock word again, and writes them to
// rows 0 (pre), 2 (heap) and 1 (post) of one [4, N] int64 output: the two
// lock snapshots are adjacent, so the [2, N] pair the host verdict copies
// back is one contiguous view; row 3 receives the lock indices (the
// device index set bulkread.gather_lockver hands out); a versioned read's
// block has two more rows, which mirror_select (version_select.cu) fills
// behind this launch.  Why one
// launch is as sound as three: every device write of the STM's state —
// lock CAS and unlock, scatters, publishes — is a launch or copy on the
// one default stream (kernels/_lib.py), so no write can land while this
// kernel runs; its pre, heap and post words are at least as consistent as
// those of three launches, between which another thread's write may be
// enqueued.  The host's stability predicate, its verdict and the scalar
// fallback are unchanged.  Up to 256 elements (the scan chunk) the two
// index sets ride in the launch's parameters as int32 (2 KB, both rows
// shorter than 2^31 words), so a chunk costs no host->device copy;
// longer batches read them from a device block.  Bound: bytes, 56 per
// element (two indices read; three words read; four written) — 14 KB at
// 256 words: the launch is what costs, now one where it was three.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void gather_read_kernel(const T* __restrict__ row,
                                   int64_t row_len,
                                   const int64_t* __restrict__ idx,
                                   int64_t n, T* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t a = idx[i];
  // the host checks bounds before every launch; the guard keeps a bad
  // index from reading outside the row all the same
  out[i] = (a >= 0 && a < row_len) ? row[a] : T(0);
}

template <typename T>
int gather_read(const void* row, long long row_len, const void* idx,
                long long n, void* out, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  gather_read_kernel<T><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(row), row_len,
      static_cast<const int64_t*>(idx), n, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

constexpr int kParamIdx = 256;

// a chunk's lock indices and heap addresses, passed by value
struct ParamIdx {
  int32_t lock[kParamIdx];
  int32_t addr[kParamIdx];
};

// the lock word's loads are volatile so that the pre and post reads stay
// two loads, in order around the heap load, as the bracket is written
__global__ void gather_bracketed_kernel(const int64_t* __restrict__ words,
                                        int64_t words_len,
                                        const int64_t* __restrict__ heap,
                                        int64_t heap_len,
                                        const int64_t* __restrict__ idx,
                                        const __grid_constant__ ParamIdx pidx,
                                        int64_t n,
                                        int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t w = idx ? idx[i] : pidx.lock[i];
  const int64_t a = idx ? idx[n + i] : pidx.addr[i];
  // bounds as gather_read_kernel: checked by the host, guarded here
  const bool w_in = w >= 0 && w < words_len;
  const volatile int64_t* word = words + (w_in ? w : 0);
  const int64_t pre = w_in ? *word : 0;
  const int64_t val = (a >= 0 && a < heap_len) ? heap[a] : 0;
  const int64_t post = w_in ? *word : 0;
  out[i] = pre;
  out[n + i] = post;
  out[2 * n + i] = val;
  out[3 * n + i] = w;
}

}  // namespace

extern "C" int gather_read_i64(const void* row, long long row_len,
                               const void* idx, long long n, void* out,
                               void* stream) {
  return gather_read<int64_t>(row, row_len, idx, n, out, stream);
}

extern "C" int gather_read_i32(const void* row, long long row_len,
                               const void* idx, long long n, void* out,
                               void* stream) {
  return gather_read<int32_t>(row, row_len, idx, n, out, stream);
}

// gather_read_home_i64: the int64 gather with its indices from the host
// and its words copied home, in one call: the indices copied into the
// device scratch (16 bytes an element: indices, then words), one launch
// of gather_read_kernel, the words copied to host_out and waited for.
// The library is a PyDLL, so the caller keeps the interpreter lock
// through the whole call (kernels/gather_read.py, gather_read_home), and
// no two calls share the scratch at once
extern "C" int gather_read_home_i64(const void* row, long long row_len,
                                    const void* host_idx, long long n,
                                    void* scratch, void* host_out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* idx = static_cast<int64_t*>(scratch);
  int64_t* out = idx + n;
  cudaError_t err = cudaMemcpyAsync(idx, host_idx, 8 * n,
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int launched = gather_read<int64_t>(row, row_len, idx, n, out, s);
  if (launched) return launched;
  err = cudaMemcpyAsync(host_out, out, 8 * n, cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(s));
}

// idx: both index sets on the card ([2, N] int64), or null with
// host_idx: both on the host as int32 ([2, 256], N <= 256)
extern "C" int gather_bracketed_i64(const void* words, long long words_len,
                                    const void* heap, long long heap_len,
                                    const void* idx, const void* host_idx,
                                    long long n, void* out, void* stream) {
  ParamIdx pidx;
  if (!idx) {
    if (n > kParamIdx) return static_cast<int>(cudaErrorInvalidValue);
    memcpy(&pidx, host_idx, sizeof(pidx));
  }
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  gather_bracketed_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words), words_len,
      static_cast<const int64_t*>(heap), heap_len,
      static_cast<const int64_t*>(idx), pidx, n, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
