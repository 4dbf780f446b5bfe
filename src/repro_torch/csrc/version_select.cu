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
//
// mirror_select: a versioned bulk read's whole mirror resolve in ONE
// launch — what the reference's PackedVLT.select (repro/core/vlt.py)
// computes with a seqlock-bracketed row gather, a way match and
// version_select over the matched ways.  The path it replaces gathered
// seq, the way addresses, the (ts, data) slots of every way and seq again
// with four advanced-indexing ops, ran version_select over N x ways rows
// and matched the way on the host.  Here each thread takes one element
// (lock index b, address a) and, in order: loads seq[b] (volatile), the
// row's way addresses (one 16-byte load at two ways), takes the first way
// equal to a (the sentinels NO_ADDR = -1 and UNPACKABLE = -2 never match
// an address >= 0), loads that way's ts and data slots as 16-byte
// vectors, scans ts newest first for the first ts < r_clock, loads
// seq[b] again, and writes the value to out[0][i] and a code to
// out[1][i]: way + 1 when the row was stable (both seq loads equal and
// even), matched and found, else 0.  Every lane's value is defined as in
// the plain version (kernels/version_select.py): the first way that
// matched, or way 0; its first slot below the clock, or slot 0.  Why the
// bracket holds: every write of the mirror is a launch or copy on the one
// default stream (kernels/_lib.py), so none lands while this kernel runs
// and the two seq loads see the same word; the bracket still rejects a
// row a writer left odd, as the reference's does.  Up to 256 elements
// the lock indices (int32, the table is shorter than 2^31 rows) and the
// addresses (int64, compared as stored) ride in the launch's parameters
// (3 KB), in blocks of 64 threads (a warp's loads from the constant bank
// serialize, so small blocks spread them over more SMs); a longer chunk
// reads both from the device copy the bracketed gather staged for it
// ([2, N] int64).  Bound: bytes, 116 an element (the index and address,
// seq, two way addresses, one way's four ts and four data slots read, two
// words written), 29 KB at a 256-word chunk: the launch is what costs.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

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

constexpr int kParamIdx = 256;
constexpr int kParamThreads = 64;

// a chunk's lock indices and addresses, passed by value
struct MirrorParam {
  int32_t idx[kParamIdx];
  int64_t addr[kParamIdx];
};

// slots j, j+1 of a way (16-byte aligned: the wrapper checks the base
// and an even depth)
__device__ __forceinline__ longlong2 pair_at(const int64_t* p, int64_t j) {
  return *reinterpret_cast<const longlong2*>(p + j);
}

__global__ void mirror_select_kernel(const int64_t* __restrict__ seq,
                                     const int64_t* __restrict__ way_addr,
                                     const int64_t* __restrict__ tsdata,
                                     int64_t size, int64_t ways,
                                     int64_t depth, bool vec,
                                     const int64_t* __restrict__ idx,
                                     const __grid_constant__ MirrorParam prm,
                                     int64_t n, int64_t r_clock,
                                     int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t b = idx ? idx[i] : prm.idx[i];
  const int64_t a = idx ? idx[n + i] : prm.addr[i];
  int64_t val = 0, code = 0;
  // bounds are checked by the host; the guard keeps a bad index from
  // reading outside the mirror all the same (value 0, code 0)
  if (b >= 0 && b < size) {
    const volatile int64_t* s = seq + b;
    const int64_t s1 = *s;
    const int64_t* row = way_addr + b * ways;
    int64_t way = -1;
    if (ways == 2 && vec) {
      const longlong2 r = pair_at(row, 0);
      way = (r.x >= 0 && r.x == a) ? 0 : (r.y >= 0 && r.y == a) ? 1 : -1;
    } else {
      for (int64_t w = 0; w < ways; ++w) {
        const int64_t r = row[w];
        if (r >= 0 && r == a) {
          way = w;
          break;
        }
      }
    }
    const int64_t* t = tsdata + (b * ways + (way < 0 ? 0 : way)) * depth;
    const int64_t* d = t + size * ways * depth;
    int64_t first = -1;
    if (vec && depth == 4) {
      // the way's four ts and four data slots: four loads in flight
      const longlong2 t01 = pair_at(t, 0), t23 = pair_at(t, 2);
      const longlong2 d01 = pair_at(d, 0), d23 = pair_at(d, 2);
      const int64_t tv[4] = {t01.x, t01.y, t23.x, t23.y};
      const int64_t dv[4] = {d01.x, d01.y, d23.x, d23.y};
      val = dv[0];
      // unrolled, so tv and dv stay in registers
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        if (tv[j] < r_clock) {
          first = j;
          val = dv[j];
        }
      }
    } else if (vec) {
      for (int64_t j = 0; j < depth && first < 0; j += 2) {
        const longlong2 tp = pair_at(t, j);
        if (tp.x < r_clock) {
          first = j;
        } else if (tp.y < r_clock) {
          first = j + 1;
        }
      }
      val = d[first < 0 ? 0 : first];
    } else {
      for (int64_t j = 0; j < depth; ++j) {
        if (t[j] < r_clock) {
          first = j;
          break;
        }
      }
      val = d[first < 0 ? 0 : first];
    }
    const int64_t s2 = *s;
    if (s1 == s2 && (s1 & 1) == 0 && way >= 0 && first >= 0) {
      code = way + 1;
    }
  }
  out[i] = val;
  out[n + i] = code;
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

// seq [size], way_addr [size, ways], tsdata [2, size, ways, depth], all
// int64 on the card.  idx: both index sets on the card ([2, N] int64:
// lock indices, then addresses), or null with host_idx / host_addr (N <=
// 256: int32 lock indices and int64 addresses on the host).  vec: the
// ways and slots may be loaded as 16-byte vectors.  out: [2, N] int64.
extern "C" int mirror_select_i64(const void* seq, const void* way_addr,
                                 const void* tsdata, long long size,
                                 long long ways, long long depth,
                                 long long vec, const void* idx,
                                 const void* host_idx, const void* host_addr,
                                 long long n, long long r_clock, void* out,
                                 void* stream) {
  MirrorParam prm;
  if (!idx) {
    if (n > kParamIdx) return static_cast<int>(cudaErrorInvalidValue);
    memcpy(prm.idx, host_idx, sizeof(int32_t) * n);
    memcpy(prm.addr, host_addr, sizeof(int64_t) * n);
  }
  // the parameter route's per-thread loads from the constant bank
  // serialize within a warp: small blocks spread them over more SMs
  const int threads = idx ? kThreads : kParamThreads;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  mirror_select_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(seq),
      static_cast<const int64_t*>(way_addr),
      static_cast<const int64_t*>(tsdata), size, ways, depth, vec != 0,
      static_cast<const int64_t*>(idx), prm, n, r_clock,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
