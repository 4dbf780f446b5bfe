// copy_bytes: a grid-stride row copy shared by the kernels that seed an
// output row from an input row (commit_fused's out-of-place publish,
// snapshot_select's slot copy).  16-byte loads and stores when both
// pointers are 16-byte aligned, bytes otherwise; every thread of the
// grid takes its share, so a caller launches with any grid.
#pragma once
#include <cstdint>

namespace repro_torch {

__device__ __forceinline__ void copy_bytes(const uint8_t* __restrict__ in,
                                           uint8_t* __restrict__ out,
                                           int64_t nbytes, int64_t tid,
                                           int64_t stride) {
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(in) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
    const int64_t n16 = nbytes >> 4;
    const int4* s = reinterpret_cast<const int4*>(in);
    int4* d = reinterpret_cast<int4*>(out);
    for (int64_t k = tid; k < n16; k += stride) d[k] = s[k];
    done = n16 << 4;
  }
  for (int64_t k = done + tid; k < nbytes; k += stride) out[k] = in[k];
}

}  // namespace repro_torch
