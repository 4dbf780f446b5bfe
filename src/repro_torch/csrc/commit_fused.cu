// commit_fused: publish a group of conflict-disjoint transactions, and
// optionally refresh one version-ring row with the result.  Port of
// repro/kernels/commit_fused.py (commit_fused_flat), which decided every
// member in grid step 0, seeded the output heap there, and then
// scattered one write tile per grid step, redirecting a failed member's
// addresses one past the end so jax scatter dropped them; and of the
// ring refresh that rides the same call in repro/kernels/ops.py
// (commit_fused's ring / ring_ts / ring_slot: the new row written into
// ring[ring_slot], commit_ver into ring_ts[ring_slot]).
//
// One C call does the whole publish on the one stream, its arguments
// read from a header the wrapper writes (CommitCall):
//   0. one cudaMemcpyAsync of the call's host columns (write rows, values
//      in the heap's dtype, segment ids, seen versions, tids, clocks, the
//      lock words the caller did not pass as device tensors, and ok's
//      initial bytes, all 1) from the wrapper's pinned staging block into
//      the call's device block; an event recorded right after it tells
//      the wrapper when the staging block may be written again;
//   1. decide: every read entry and every write-lock entry of the packed
//      batches computes its predicate and stores 0 into its member's ok
//      byte when it fails (every store writes the same 0, so no atomic is
//      needed); the other blocks of the same launch copy heap_in to
//      heap_out (out of place) and to the ring row (refresh), reading
//      each chunk of the old row once;
//   2. publish: each write row of a surviving member stores its value
//      into heap_out and the ring row (masked rows of failed members and
//      the ragged edge store nothing, so the host pads nothing), each
//      lock entry gets its release word — (commit_ver << 18) | unlocked
//      where its member survived, its own word otherwise — and one thread
//      stamps ring_ts[slot] = commit_ver.
// A publish with no read or lock entries and at most 64 rows — the
// MVStore's — takes commit_rows instead: no copy at all, its rows in the
// publish launch's parameters (RowsCall), after the same copy phase.
// CUDA blocks run in no order, so the TPU kernel's grid step 0 becomes
// launch 1 and its scatter steps launch 2.  Lock words are the packed
// int64 words of ArrayLockTable (bits 18..63 version, 2..17 tid + 2, bit
// 1 locked, bit 0 flag); versions, clocks and seen versions are compared
// as int64, with no rebasing.
//
//   mode 0 (V_LT): own lock passes; else free, unflagged, ver <  r_clock
//   mode 1 (V_LE): unlocked or own, and ver <= r_clock
//   mode 2 (V_EQ): unlocked or own, and ver == seen
//   a write lock is claimable iff it is neither locked nor flagged, or
//   it is locked by the member itself.
//
// Bound on the card: bytes.  Read entries move 16 bytes (word, segment;
// 24 with the seen version in mode 2), lock entries 16 read + 8 written,
// write rows 16 + one value read and one value written, plus the heap
// read once and written once per output (the new block, the ring row).
// At the group trial's shape (8 members, 8192 rows of each batch) that is
// well under a microsecond of HBM time; the MVStore publish (one member,
// two rows, a 1,000,000-word int32 block out of place, ring refreshed) is
// bound by its 12 MB of copies, 3.6 us.  What a call costs above that is
// the host's: the design keeps it to one C call of at most one copy and
// two launches, with no allocation or launch the result does not need.
#include <cuda_runtime.h>
#include <cstdint>

#include "copy_bytes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCopyBlocks = 132 * 8;
constexpr int kVerShift = 18;
constexpr int64_t kTidMask = 0xFFFF;
constexpr int64_t kTidBias = 2;
constexpr int64_t kUnlockedWord = ((-1 + kTidBias) & kTidMask) << 2;

// phases of one C call (the wrapper's fault split runs them apart)
constexpr long long kDecide = 1;
constexpr long long kPublish = 2;
constexpr long long kStampTs = 4;

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
    uint8_t* __restrict__ ok, unsigned decide_blocks,
    const uint8_t* __restrict__ heap_in, uint8_t* __restrict__ heap_out,
    uint8_t* __restrict__ ring_row, int64_t copy_bytes) {
  if (blockIdx.x >= decide_blocks) {
    const int64_t tid =
        static_cast<int64_t>(blockIdx.x - decide_blocks) * blockDim.x +
        threadIdx.x;
    const int64_t stride =
        static_cast<int64_t>(gridDim.x - decide_blocks) * blockDim.x;
    repro_torch::copy_bytes(heap_in, heap_out, ring_row, copy_bytes, tid,
                            stride);
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
    if (!valid) ok[seg] = 0;
  } else if (i < n_r + n_l) {
    const int64_t j = i - n_r;
    const int64_t seg = l_seg[j];
    const Fields f = unpack(l_words[j]);
    const bool own = f.locked && f.own == tids[seg];
    if ((f.locked || f.flagged) && !own) ok[seg] = 0;
  }
}

template <typename T>
__global__ void publish_kernel(T* __restrict__ heap, T* __restrict__ ring_row,
                               int64_t h, const int64_t* __restrict__ w_addr,
                               const T* __restrict__ w_val,
                               const int64_t* __restrict__ w_seg,
                               int64_t w_lo, int64_t w_hi,
                               const int64_t* __restrict__ l_words,
                               const int64_t* __restrict__ l_seg,
                               int64_t n_stamp, int64_t release_word,
                               const uint8_t* __restrict__ ok,
                               int64_t* __restrict__ l_out,
                               void* __restrict__ ring_ts, int64_t ts_bytes,
                               int64_t commit_ver) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t wi = w_lo + i;
  if (wi < w_hi && ok[w_seg[wi]] != 0) {
    const int64_t a = w_addr[wi];
    // the host checks bounds before every launch; never write outside
    // the heap all the same
    if (a >= 0 && a < h) {
      const T v = w_val[wi];
      heap[a] = v;
      if (ring_row) ring_row[a] = v;
    }
  }
  if (i < n_stamp) l_out[i] = ok[l_seg[i]] != 0 ? release_word : l_words[i];
  if (i == 0 && ts_bytes == 4) {
    *static_cast<int32_t*>(ring_ts) = static_cast<int32_t>(commit_ver);
  } else if (i == 0 && ts_bytes == 8) {
    *static_cast<int64_t*>(ring_ts) = commit_ver;
  }
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// One call's arguments, int64 words in this order: the wrapper writes
// them at the head of its pinned staging block (kernels/commit_fused.py,
// _call_words), so the ctypes call carries two arguments.  Column
// offsets are in int64 words from staged_dev, where ok's bytes sit.
struct CommitCall {
  int64_t heap_in, heap_out, h;
  int64_t ring_row, ring_ts, ts_bytes;
  int64_t staged_host, staged_dev, staged_bytes, event;
  int64_t l_words, r_words, l_out;
  int64_t n, n_l, n_r, mode, commit_ver;
  int64_t o_wa, o_ws, o_ls, o_rs, o_rn, o_td, o_rc, o_v;
  int64_t phases, w_lo, w_hi, n_stamp;
};
static_assert(sizeof(CommitCall) == 30 * sizeof(int64_t),
              "CommitCall is 30 int64 words");

template <typename P>
P* ptr(int64_t p) {
  return reinterpret_cast<P*>(static_cast<uintptr_t>(p));
}

template <typename T>
int commit_fused(const CommitCall& c, cudaStream_t s) {
  cudaError_t err;
  if (c.staged_bytes > 0) {
    err = cudaMemcpyAsync(ptr<void>(c.staged_dev), ptr<const void>(
                              c.staged_host), c.staged_bytes,
                          cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaEventRecord(ptr<CUevent_st>(c.event), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t* cols = ptr<const int64_t>(c.staged_dev);
  uint8_t* ok = ptr<uint8_t>(c.staged_dev);
  if (c.phases & kDecide) {
    uint8_t* out = c.heap_out != c.heap_in ? ptr<uint8_t>(c.heap_out)
                                           : nullptr;
    uint8_t* row = ptr<uint8_t>(c.ring_row);
    const int64_t nbytes =
        (out || row) ? c.h * static_cast<int64_t>(sizeof(T)) : 0;
    const unsigned decide = blocks_for(c.n_r + c.n_l);
    int64_t copy = (nbytes / 16 + kThreads - 1) / kThreads;
    if (nbytes && copy == 0) copy = 1;
    if (copy > kMaxCopyBlocks) copy = kMaxCopyBlocks;
    if (decide + copy > 0) {
      decide_kernel<<<decide + static_cast<unsigned>(copy), kThreads, 0,
                      s>>>(
          ptr<const int64_t>(c.r_words), cols + c.o_rn, cols + c.o_rs,
          c.n_r, ptr<const int64_t>(c.l_words), cols + c.o_ls, c.n_l,
          cols + c.o_td, cols + c.o_rc, c.mode, ok, decide,
          ptr<const uint8_t>(c.heap_in), out, row, nbytes);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (c.phases & kPublish) {
    const int64_t rows = c.w_hi - c.w_lo;
    const int64_t stamp = (c.phases & kStampTs) ? c.ts_bytes : 0;
    int64_t n = rows > c.n_stamp ? rows : c.n_stamp;
    if (stamp && n == 0) n = 1;
    if (n > 0) {
      publish_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(
          ptr<T>(c.heap_out), ptr<T>(c.ring_row), c.h, cols + c.o_wa,
          reinterpret_cast<const T*>(cols + c.o_v), cols + c.o_ws, c.w_lo,
          c.w_hi, ptr<const int64_t>(c.l_words), cols + c.o_ls, c.n_stamp,
          (c.commit_ver << kVerShift) | kUnlockedWord, ok,
          ptr<int64_t>(c.l_out), ptr<void>(c.ring_ts), stamp,
          c.commit_ver);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The MVStore's publish shape: no read or lock entries, so every member
// survives, and a handful of rows.  Such a call stages nothing: its rows
// ride in the publish launch's parameters (RowsCall, by value), ok is
// written as all ones by the same launch, and only the copy phase
// (decide_kernel with no decide blocks) runs before it.
constexpr int kSmallRows = 64;

struct Rows {
  int64_t addr[kSmallRows];
  int64_t val[kSmallRows];
};

struct RowsCall {
  int64_t heap_in, heap_out, h, ring_row, ring_ts, ts_bytes;
  int64_t ok, n_txn, n, commit_ver;
  Rows rows;
};

template <typename T>
__global__ void publish_rows_kernel(T* __restrict__ heap,
                                    T* __restrict__ ring_row, int64_t h,
                                    const __grid_constant__ Rows rows,
                                    int64_t n, uint8_t* __restrict__ ok,
                                    int64_t n_txn, void* __restrict__ ring_ts,
                                    int64_t ts_bytes, int64_t commit_ver) {
  for (int64_t t = threadIdx.x; t < n_txn; t += blockDim.x) ok[t] = 1;
  const int64_t i = threadIdx.x;
  if (i < n) {
    const int64_t a = rows.addr[i];
    if (a >= 0 && a < h) {
      const T v = static_cast<T>(rows.val[i]);
      heap[a] = v;
      if (ring_row) ring_row[a] = v;
    }
  }
  if (i == 0 && ts_bytes == 4) {
    *static_cast<int32_t*>(ring_ts) = static_cast<int32_t>(commit_ver);
  } else if (i == 0 && ts_bytes == 8) {
    *static_cast<int64_t*>(ring_ts) = commit_ver;
  }
}

template <typename T>
int commit_rows(const RowsCall& c, cudaStream_t s) {
  if (c.n > kSmallRows) return static_cast<int>(cudaErrorInvalidValue);
  uint8_t* out = c.heap_out != c.heap_in ? ptr<uint8_t>(c.heap_out)
                                         : nullptr;
  uint8_t* row = ptr<uint8_t>(c.ring_row);
  if (out || row) {
    const int64_t nbytes = c.h * static_cast<int64_t>(sizeof(T));
    int64_t copy = (nbytes / 16 + kThreads - 1) / kThreads;
    if (copy == 0) copy = 1;
    if (copy > kMaxCopyBlocks) copy = kMaxCopyBlocks;
    decide_kernel<<<static_cast<unsigned>(copy), kThreads, 0, s>>>(
        nullptr, nullptr, nullptr, 0, nullptr, nullptr, 0, nullptr, nullptr,
        0, nullptr, 0, ptr<const uint8_t>(c.heap_in), out, row, nbytes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  publish_rows_kernel<T><<<1, kSmallRows, 0, s>>>(
      ptr<T>(c.heap_out), ptr<T>(c.ring_row), c.h, c.rows, c.n,
      ptr<uint8_t>(c.ok), c.n_txn, ptr<void>(c.ring_ts), c.ts_bytes,
      c.commit_ver);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int commit_rows_i64(const void* call, void* stream) {
  return commit_rows<int64_t>(*static_cast<const RowsCall*>(call),
                              static_cast<cudaStream_t>(stream));
}

extern "C" int commit_rows_i32(const void* call, void* stream) {
  return commit_rows<int32_t>(*static_cast<const RowsCall*>(call),
                              static_cast<cudaStream_t>(stream));
}

extern "C" int commit_fused_i64(const void* call, void* stream) {
  return commit_fused<int64_t>(*static_cast<const CommitCall*>(call),
                               static_cast<cudaStream_t>(stream));
}

extern "C" int commit_fused_i32(const void* call, void* stream) {
  return commit_fused<int32_t>(*static_cast<const CommitCall*>(call),
                               static_cast<cudaStream_t>(stream));
}
