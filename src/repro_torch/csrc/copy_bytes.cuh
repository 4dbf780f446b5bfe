// copy_bytes: a grid-stride row copy shared by the kernels that seed
// output rows from an input row (snapshot_select's slot copy;
// commit_fused's new block and ring row, together, reading each chunk of
// the input once).  out_b may be null.  16-byte loads and stores when
// every pointer is 16-byte aligned, bytes otherwise; every thread of the
// grid takes its share, so a caller launches with any grid.
#pragma once
#include <cstdint>

namespace repro_torch {

__device__ __forceinline__ void copy_bytes(const uint8_t* __restrict__ in,
                                           uint8_t* __restrict__ out_a,
                                           uint8_t* __restrict__ out_b,
                                           int64_t nbytes, int64_t tid,
                                           int64_t stride) {
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(in) |
        reinterpret_cast<uintptr_t>(out_a) |
        reinterpret_cast<uintptr_t>(out_b)) & 15) == 0) {
    const int64_t n16 = nbytes >> 4;
    const int4* s = reinterpret_cast<const int4*>(in);
    int4* a = reinterpret_cast<int4*>(out_a);
    int4* b = reinterpret_cast<int4*>(out_b);
    for (int64_t k = tid; k < n16; k += stride) {
      const int4 v = s[k];
      if (a) a[k] = v;
      if (b) b[k] = v;
    }
    done = n16 << 4;
  }
  for (int64_t k = done + tid; k < nbytes; k += stride) {
    const uint8_t v = in[k];
    if (out_a) out_a[k] = v;
    if (out_b) out_b[k] = v;
  }
}

}  // namespace repro_torch
