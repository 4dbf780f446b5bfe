// ssd_tiles: what the SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu) share: the problem's dimensions, the 64-row tiles of
// bf16 rows in swizzled shared memory with their ldmatrix addresses, and
// the split of an f32 operand into bf16 hi + lo for the tensor cores.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "mma_bf16.cuh"

namespace repro_torch {
namespace ssd {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;              // rows of a query tile and of a key tile
constexpr int kNMax = 128;          // largest d_state
constexpr int kPMax = 64;           // largest head dim (and the padded one)
constexpr int kQMax = 1024;         // largest chunk
constexpr int kTPad = kT + 4;       // row stride of the f32 transposed tiles

struct Dims {
  int H, P, N, Q;
  int nc;       // chunks, S / Q
  int nt;       // 64-row tiles of a chunk
  int Qp;       // nt * 64: the row stride of the C.B^T scratch
  int n_pairs;  // tile pairs at or below the diagonal, nt (nt + 1) / 2
  int BH;       // B * H
  int BCH;      // B * nc * H
};

// v as bf16 hi + lo (hi = v rounded, lo = the rest rounded)
__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// an A fragment's pair (lo column first) of f32 values as hi and lo
// bf16 pairs
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  bf16 ah, al, bh, bl;
  split_bf16(a, ah, al);
  split_bf16(b, bh, bl);
  hi = pack_bf16(__bfloat162float(ah), __bfloat162float(bh));
  lo = pack_bf16(__bfloat162float(al), __bfloat162float(bl));
}

// Rows [0, n_valid) and columns [0, D) of a [64][kD] bf16 tile of g (row
// stride rs elements) into the swizzled tile sm; the rest zero.  vec:
// every row's 16-byte chunks are 16-byte aligned, so each is one cp.async
// (zero-filled past D or n_valid); otherwise masked element loads.
template <int kD>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g,
                                          long long rs, int n_valid, int D,
                                          bool vec) {
  constexpr int kChunks = kD / 8;
  for (int idx = threadIdx.x; idx < kT * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bf16* src = g + r * rs + c;
    bf16* dst = sm + swz<kD>(r, c);
    const bool ok_row = r < n_valid;
    if (vec) {
      const bool ok = ok_row && c < D;
      cp_async16(smem_addr(dst), ok ? src : g, ok ? 16 : 0);
    } else {
      __align__(16) bf16 e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = (ok_row && c + j < D) ? src[j] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(e);
    }
  }
}

// ldmatrix address of an A fragment (16 rows from r0, 16 columns from c0)
// held in a [rows][kD] tile row-major: rows are the M axis
template <int kD>
__device__ __forceinline__ uint32_t a_addr(const bf16* sm, int r0, int c0,
                                           int lane) {
  return smem_addr(sm + swz<kD>(r0 + (lane & 15), c0 + (lane >> 4) * 8));
}

// ldmatrix.trans address of an A fragment (M rows from m0, K from k0)
// held in a [K][kD] tile (the M axis along the row): lanes 8-15 take M + 8,
// lanes 16-31 K + 8
template <int kD>
__device__ __forceinline__ uint32_t at_addr(const bf16* sm, int k0, int m0,
                                            int lane) {
  return smem_addr(sm + swz<kD>(k0 + (lane & 7) + ((lane >> 4) & 1) * 8,
                                m0 + ((lane >> 3) & 1) * 8));
}

// ldmatrix address of two B fragments (8-column tiles n0 and n0 + 8, K
// from k0) held in a [N][kD] tile (K along the row), as K^T in flash
template <int kD>
__device__ __forceinline__ uint32_t b_addr(const bf16* sm, int k0, int n0,
                                           int lane) {
  return smem_addr(sm + swz<kD>(n0 + (lane >> 4) * 8 + (lane & 7),
                                k0 + ((lane >> 3) & 1) * 8));
}

// ldmatrix.trans address of two B fragments (n0 and n0 + 8, K from k0)
// held in a [K][kD] tile (N along the row), as V in flash
template <int kD>
__device__ __forceinline__ uint32_t bt_addr(const bf16* sm, int k0, int n0,
                                            int lane) {
  return smem_addr(sm + swz<kD>(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                n0 + (lane >> 4) * 8));
}

inline Dims make_dims(long long B, long long S, long long H, long long P,
               long long N, long long Q) {
  Dims d;
  d.H = static_cast<int>(H);
  d.P = static_cast<int>(P);
  d.N = static_cast<int>(N);
  d.Q = static_cast<int>(Q);
  d.nc = static_cast<int>(S / Q);
  d.nt = static_cast<int>((Q + kT - 1) / kT);
  d.Qp = d.nt * kT;
  d.n_pairs = d.nt * (d.nt + 1) / 2;
  d.BH = static_cast<int>(B * H);
  d.BCH = static_cast<int>(B * d.nc * H);
  return d;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace ssd
}  // namespace repro_torch
