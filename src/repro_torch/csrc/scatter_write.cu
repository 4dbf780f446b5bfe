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
// dominates.  scatter_write_i64 takes both columns on the card (a values
// tensor already there): one element a thread.  Each random 8-byte store
// costs a 32-byte sector, which no load width changes: two elements a
// thread with 16-byte loads of each column measured the same on the card
// (scripts/ab_turns.py), so the simpler form stays.
//
// scatter_pairs_i64: the scatter from HOST columns in one C call.  The
// path it replaces made three device operations and two allocations a
// call (the values staged, the addresses staged, then the scatter).
// Here the host packs (index, value) int64 pairs, and:
//   * up to 1024 pairs ride in the launch's parameters (16 KB, a
//     __grid_constant__ struct): one launch, no copy;
//   * a longer batch sits in one pinned staging block: this call issues
//     one cudaMemcpyAsync to the block's device scratch, the kernel, and
//     the block's event behind the kernel, so the pool hands the block
//     (and its scratch) out again only once the kernel has read it;
//   * the fill form stores one value at every index (the commit's lock
//     release, every word the same at its version): indices only, up to
//     2048 in the parameters.
// Bounds are checked by the host in one pass and masked here.  A
// grid-stride loop over a grid that covers the batch (one pair a thread,
// one 16-byte load each when staged); the parameter route runs blocks of
// 64 threads, since its per-thread loads from the constant bank serialize
// within a warp.  Bound: bytes, 24 an element (16 for the pair, 8
// written), 16 in the fill form.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
// a parameter route's blocks: its threads load their pairs from the
// constant bank, where a warp's distinct addresses serialize, so small
// blocks spread a launch's loads over more SMs
constexpr int kParamThreads = 64;

unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

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

constexpr int kParamPairs = 1024;

// (index, value) pairs, or 2 x 1024 indices in the fill form, by value
struct PairParam {
  int64_t w[2 * kParamPairs];
};

__global__ void scatter_pairs_kernel(int64_t* __restrict__ row,
                                     int64_t row_len,
                                     const int64_t* __restrict__ dev,
                                     const __grid_constant__ PairParam prm,
                                     int64_t n, bool fill, int64_t value) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += step) {
    int64_t a, v = value;
    if (fill) {
      a = dev ? dev[i] : prm.w[i];
    } else if (dev) {
      const longlong2 p = reinterpret_cast<const longlong2*>(dev)[i];
      a = p.x;
      v = p.y;
    } else {
      a = prm.w[2 * i];
      v = prm.w[2 * i + 1];
    }
    if (a >= 0 && a < row_len) row[a] = v;
  }
}

}  // namespace

extern "C" int scatter_write_i64(void* row, long long row_len,
                                 const void* idx, const void* val,
                                 long long n, void* stream) {
  scatter_write_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(row), row_len, static_cast<const int64_t*>(idx),
      static_cast<const int64_t*>(val), n);
  return static_cast<int>(cudaGetLastError());
}

// n elements: (index, value) int64 pairs ([n, 2]), or indices alone
// ([n]) with fill != 0, every one stored as ``value``.  Either at host
// ``param`` (n <= 1024 pairs or 2048 fill indices, passed by value) or
// at pinned ``host``, which this call copies to ``dev`` (device scratch
// of the same size), then scatters from, then marks with ``event``.
extern "C" int scatter_pairs_i64(void* row, long long row_len,
                                 const void* param, const void* host,
                                 void* dev, void* event, long long n,
                                 long long fill, long long value,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = fill ? n : 2 * n;
  PairParam prm;
  cudaError_t err;
  if (param) {
    if (words > 2 * kParamPairs) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    memcpy(prm.w, param, 8 * words);
    dev = nullptr;
  } else {
    err = cudaMemcpyAsync(dev, host, 8 * words, cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = param ? kParamThreads : kThreads;
  scatter_pairs_kernel<<<blocks_for(n, threads), threads, 0, s>>>(
      static_cast<int64_t*>(row), row_len, static_cast<const int64_t*>(dev),
      prm, n, fill != 0, value);
  err = cudaGetLastError();
  if (err != cudaSuccess || param) return static_cast<int>(err);
  return static_cast<int>(
      cudaEventRecord(static_cast<cudaEvent_t>(event), s));
}
