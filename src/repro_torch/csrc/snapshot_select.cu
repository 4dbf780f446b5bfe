// snapshot_select: the MVStore's versioned block read.  Port of
// repro/kernels/snapshot_select.py (snapshot_select_flat), which
// scalar-prefetched the ring timestamps and picked the slot inside the
// BlockSpec index map, so each grid step fetched only the chosen row's
// tile.
//
// Here every block picks the slot itself from ts[R] (R is the ring depth,
// a handful of int32 words), exactly as the reference's argmax does:
// masked = (ts != -1 && ts <= read_clock) ? ts : -1, the FIRST maximum of
// masked wins, and with no valid slot that is slot 0 with ok = 0.  Then
// the grid copies only that row, row_bytes long, to out; block 0 writes
// ok as one byte, 0 or 1: the caller's 0-d torch.bool tensor.  The copy
// is dtype-agnostic (bytes, 16 at a time when aligned) and masks its own
// ragged tail — the TPU version asserted n % tile == 0.
//
// Bound on the card: bytes — one row read and one row written (2 x 4 x n
// for an int32 block of n words; 8 MB at n = 1,000,000, 2.4 us at
// 3.35 TB/s).  The slot scan is R loads per block from L2.
#include <cuda_runtime.h>
#include <cstdint>

#include "copy_bytes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr int32_t kNoTs = -1;

__global__ void snapshot_select_kernel(const uint8_t* __restrict__ ring,
                                       int64_t n_slots, int64_t row_bytes,
                                       const int32_t* __restrict__ ts,
                                       int64_t read_clock,
                                       uint8_t* __restrict__ out,
                                       uint8_t* __restrict__ ok) {
  __shared__ int64_t slot;
  if (threadIdx.x == 0) {
    int64_t best = 0;
    int32_t best_ts = kNoTs;
    bool any = false;
    for (int64_t r = 0; r < n_slots; ++r) {
      const int32_t t = ts[r];
      const bool valid = t != kNoTs && static_cast<int64_t>(t) <= read_clock;
      const int32_t masked = valid ? t : kNoTs;
      if (r == 0 || masked > best_ts) {
        best = r;
        best_ts = masked;
      }
      any = any || valid;
    }
    slot = best;
    if (blockIdx.x == 0) *ok = any ? 1 : 0;
  }
  __syncthreads();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  repro_torch::copy_bytes(ring + slot * row_bytes, out, nullptr, row_bytes,
                          tid, stride);
}

}  // namespace

extern "C" int snapshot_select_rows(const void* ring, long long n_slots,
                                    long long row_bytes, const void* ts,
                                    long long read_clock, void* out,
                                    void* ok, void* stream) {
  int64_t blocks = (row_bytes / 16 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  snapshot_select_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ring), n_slots, row_bytes,
      static_cast<const int32_t*>(ts), read_clock,
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
