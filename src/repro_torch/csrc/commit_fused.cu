// commit_fused: publish a group of conflict-disjoint transactions.  Port
// of repro/kernels/commit_fused.py (commit_fused_flat), which decided
// every member in grid step 0, seeded the output heap there, and then
// scattered one write tile per grid step, redirecting a failed member's
// addresses one past the end so jax scatter dropped them.
//
// CUDA blocks run in no order, so the one TPU launch becomes two on the
// same stream:
//   1. decide: every read entry and every write-lock entry of the packed
//      batches computes its predicate and clears its member's ok[seg]
//      with atomicAnd (ok was set to all ones by a memset just before);
//      the other blocks of the same launch copy heap_in to heap_out when
//      the publish is out of place;
//   2. publish: each write row of a surviving member stores its value
//      (masked rows of failed members and the ragged edge store nothing,
//      so the host pads nothing), and each lock entry gets its release
//      word: release_word where its member survived, its own word
//      otherwise.
// Lock words are the packed int64 words of ArrayLockTable (bits 18..63
// version, 2..17 tid + 2, bit 1 locked, bit 0 flag); versions, clocks and
// seen versions are compared as int64, with no rebasing.
//
//   mode 0 (V_LT): own lock passes; else free, unflagged, ver <  r_clock
//   mode 1 (V_LE): unlocked or own, and ver <= r_clock
//   mode 2 (V_EQ): unlocked or own, and ver == seen
//   a write lock is claimable iff it is neither locked nor flagged, or
//   it is locked by the member itself.
//
// Bound on the card: bytes.  Read entries move 24 bytes (word, seen,
// segment), lock entries 16 read + 8 written, write rows 16 + one value
// read and one value written, plus 2 x the heap for an out-of-place
// publish.  At the group trial's shape (8 members, 8192 rows of each
// batch) that is well under a microsecond of HBM time, so the two
// launches are what a call costs; the MVStore publish (one member, two
// rows, a 1,000,000-word int32 row out of place) is bound by its 8 MB
// copy.
#include <cuda_runtime.h>
#include <cstdint>

#include "copy_bytes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCopyBlocks = 132 * 8;
constexpr int kVerShift = 18;
constexpr int64_t kTidMask = 0xFFFF;
constexpr int64_t kTidBias = 2;

struct Fields {
  int64_t ver;
  int64_t own;
  bool locked;
  bool flagged;
};

__device__ __forceinline__ Fields unpack(int64_t w) {
  Fields f;
  f.ver = w >> kVerShift;
  f.own = ((w >> 2) & kTidMask) - kTidBias;
  f.locked = ((w >> 1) & 1) != 0;
  f.flagged = (w & 1) != 0;
  return f;
}

__global__ void decide_kernel(
    const int64_t* __restrict__ r_words, const int64_t* __restrict__ r_seen,
    const int64_t* __restrict__ r_seg, int64_t n_r,
    const int64_t* __restrict__ l_words, const int64_t* __restrict__ l_seg,
    int64_t n_l, const int64_t* __restrict__ tids,
    const int64_t* __restrict__ r_clocks, int64_t mode,
    int32_t* __restrict__ ok, unsigned decide_blocks,
    const uint8_t* __restrict__ heap_in, uint8_t* __restrict__ heap_out,
    int64_t copy_bytes) {
  if (blockIdx.x >= decide_blocks) {
    const int64_t tid =
        static_cast<int64_t>(blockIdx.x - decide_blocks) * blockDim.x +
        threadIdx.x;
    const int64_t stride =
        static_cast<int64_t>(gridDim.x - decide_blocks) * blockDim.x;
    repro_torch::copy_bytes(heap_in, heap_out, copy_bytes, tid, stride);
    return;
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n_r) {
    const int64_t seg = r_seg[i];
    const Fields f = unpack(r_words[i]);
    const bool mine = f.locked && f.own == tids[seg];
    bool valid;
    if (mode == 0) {
      valid = mine || (!f.locked && !f.flagged && f.ver < r_clocks[seg]);
    } else if (mode == 1) {
      valid = (!f.locked || mine) && f.ver <= r_clocks[seg];
    } else {
      valid = (!f.locked || mine) && f.ver == r_seen[i];
    }
    if (!valid) atomicAnd(ok + seg, 0);
  } else if (i < n_r + n_l) {
    const int64_t j = i - n_r;
    const int64_t seg = l_seg[j];
    const Fields f = unpack(l_words[j]);
    const bool own = f.locked && f.own == tids[seg];
    if ((f.locked || f.flagged) && !own) atomicAnd(ok + seg, 0);
  }
}

template <typename T>
__global__ void publish_kernel(T* __restrict__ heap, int64_t h,
                               const int64_t* __restrict__ w_addr,
                               const T* __restrict__ w_val,
                               const int64_t* __restrict__ w_seg,
                               int64_t w_lo, int64_t w_hi,
                               const int64_t* __restrict__ l_words,
                               const int64_t* __restrict__ l_seg,
                               int64_t n_stamp, int64_t release_word,
                               const int32_t* __restrict__ ok,
                               int64_t* __restrict__ l_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t wi = w_lo + i;
  if (wi < w_hi && ok[w_seg[wi]] != 0) {
    const int64_t a = w_addr[wi];
    // the host checks bounds before every launch; never write outside
    // the heap all the same
    if (a >= 0 && a < h) heap[a] = w_val[wi];
  }
  if (i < n_stamp) l_out[i] = ok[l_seg[i]] != 0 ? release_word : l_words[i];
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T>
int commit_fused(const void* heap_in, void* heap_out, long long h,
                 long long copy_heap, const void* w_addr, const void* w_val,
                 const void* w_seg, long long w_lo, long long w_hi,
                 const void* l_words, const void* l_seg, long long n_l,
                 long long n_stamp, const void* r_words, const void* r_seen,
                 const void* r_seg, long long n_r, const void* tids,
                 const void* r_clocks, long long n_txn, long long mode,
                 long long release_word, void* ok, void* l_out,
                 long long phases, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phases & 1) {
    // all bits set = "member survives" until an entry clears it
    cudaError_t err = cudaMemsetAsync(ok, 0xFF, n_txn * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t nbytes = copy_heap ? h * static_cast<int64_t>(sizeof(T))
                                     : 0;
    const unsigned decide = blocks_for(n_r + n_l);
    int64_t copy = (nbytes / 16 + kThreads - 1) / kThreads;
    if (nbytes && copy == 0) copy = 1;
    if (copy > kMaxCopyBlocks) copy = kMaxCopyBlocks;
    if (decide + copy > 0) {
      decide_kernel<<<decide + static_cast<unsigned>(copy), kThreads, 0,
                      s>>>(
          static_cast<const int64_t*>(r_words),
          static_cast<const int64_t*>(r_seen),
          static_cast<const int64_t*>(r_seg), n_r,
          static_cast<const int64_t*>(l_words),
          static_cast<const int64_t*>(l_seg), n_l,
          static_cast<const int64_t*>(tids),
          static_cast<const int64_t*>(r_clocks), mode,
          static_cast<int32_t*>(ok), decide,
          static_cast<const uint8_t*>(heap_in),
          static_cast<uint8_t*>(heap_out), nbytes);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (phases & 2) {
    const int64_t rows = w_hi - w_lo;
    const int64_t n = rows > n_stamp ? rows : n_stamp;
    if (n > 0) {
      publish_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(
          static_cast<T*>(heap_out), h, static_cast<const int64_t*>(w_addr),
          static_cast<const T*>(w_val), static_cast<const int64_t*>(w_seg),
          w_lo, w_hi, static_cast<const int64_t*>(l_words),
          static_cast<const int64_t*>(l_seg), n_stamp, release_word,
          static_cast<const int32_t*>(ok), static_cast<int64_t*>(l_out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define COMMIT_FUSED_ENTRY(NAME, T)                                         \
  extern "C" int NAME(                                                      \
      const void* heap_in, void* heap_out, long long h, long long copy_heap, \
      const void* w_addr, const void* w_val, const void* w_seg,             \
      long long w_lo, long long w_hi, const void* l_words,                  \
      const void* l_seg, long long n_l, long long n_stamp,                  \
      const void* r_words, const void* r_seen, const void* r_seg,           \
      long long n_r, const void* tids, const void* r_clocks,                \
      long long n_txn, long long mode, long long release_word, void* ok,    \
      void* l_out, long long phases, void* stream) {                        \
    return commit_fused<T>(heap_in, heap_out, h, copy_heap, w_addr, w_val,  \
                           w_seg, w_lo, w_hi, l_words, l_seg, n_l, n_stamp, \
                           r_words, r_seen, r_seg, n_r, tids, r_clocks,     \
                           n_txn, mode, release_word, ok, l_out, phases,    \
                           stream);                                         \
  }

COMMIT_FUSED_ENTRY(commit_fused_i64, int64_t)
COMMIT_FUSED_ENTRY(commit_fused_i32, int32_t)
