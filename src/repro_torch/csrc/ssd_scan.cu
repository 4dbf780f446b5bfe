// ssd_scan: the Mamba-2 SSD chunked scan of every Mamba layer's prefill.
// Port of repro/kernels/ssd_scan.py (ssd_scan_pallas), which ran a
// (batch, chunk) grid with the chunks innermost, carried the [H, N, P]
// inter-chunk state in VMEM scratch from one grid step to the next (zeroed
// at chunk 0), and looped over the heads inside a step with the chunk's
// C.B^T computed once and shared across them (B and C have no head axis).
//
// Per chunk of Q rows, all sums in f32 (bf16 inputs widened exactly):
//   dA = dt * A; cum = inclusive cumsum of dA over the chunk;
//   y[i] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) (C_i . state), cast to x's dtype;
//   state = exp(cum_last) state
//           + sum_j B_j^T (x_j exp(cum_last - cum_j) dt_j).
// Only j <= i is evaluated, so exp(cum_i - cum_j) never sees a positive
// exponent (cum falls: dt > 0, A < 0) and no inf is formed.
//
// Bound on the card: at mamba2-780m's prefill (B 1, S 512, H 48, P 64,
// N 128, Q 256) the scan needs 612.8 M multiply-adds (1.2 us at the bf16
// tensor-core peak, 18 us at the f32 peak off them) and moves ~9.8 MB
// (2.9 us): bytes, once the products run on the tensor cores.
//
// CUDA blocks run in no order, so the carry cannot ride from one block to
// the next; a design that walks the chunks in one CTA per (batch, head)
// gets 48 CTAs at B = 1 on 132 SMs.  Here the scan is the SSD
// decomposition, as four launches on the one stream from one C call:
//   1. cb    per (batch, chunk, 64x64 tile pair at or below the diagonal):
//            the chunk's C.B^T, ONCE for all heads (as the TPU kernel did),
//            into scratch [B, nc, Qp, Qp] f32 (Qp = Q rounded up to 64);
//   2. state per (batch, chunk, head): cum over the chunk (scratch
//            [B, nc, H, Q]) and the chunk-local state
//            B^T (x exp(cum_last - cum) dt) (scratch [B, nc, H, N, P]);
//   3. fold  per (batch, head, 1024 state elements): the short sequential
//            walk over the chunks, state_in[c] = the state entering chunk
//            c (in place of the local states), from init to final;
//   4. out   per (batch, chunk, head, 64-row query tile), heaviest tiles
//            first: y = sum over key tiles at or below the diagonal of
//            (CB o exp(cum_i - cum_j) o dt_j) x + exp(cum_i) C state_in.
// At the prefill shape stage 4 alone is 384 CTAs.
//
// bf16 (every serving prefill): the products run on the tensor cores as
// mma.sync m16n8k16 (bf16 operands, f32 sums) from XOR-swizzled bf16
// tiles read by ldmatrix; B, C and x tiles arrive by 16-byte cp.async
// (x through a two-stage ring in stage 4).  C.B^T has bf16 operands, so
// its products are exact.  Where the other operand is f32 (the weighted
// block against x, C against the state, B against x decay dt) it is split
// into bf16 hi + lo and multiplied twice: ~2^-16 relative, where a single
// bf16 rounding would take the f32 final state outside its 2e-3 over a
// 256-row chunk.
//
// f32 (the model checks): the same four stages on the FMA units over f32
// shared-memory tiles, so the arithmetic stays f32 (no TF32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using namespace repro_torch;
using bf16 = __nv_bfloat16;

constexpr int kT = 64;              // rows of a query tile and of a key tile
constexpr int kNMax = 128;          // largest d_state
constexpr int kPMax = 64;           // largest head dim (and the padded one)
constexpr int kQMax = 1024;         // largest chunk
constexpr int kTPad = kT + 4;       // row stride of the f32 transposed tiles
constexpr int kBsPad = kNMax + 4;   // row stride of B in the f32 state tile

// STAGES bits of the C entry points
constexpr int kStageCb = 1, kStageState = 2, kStageFold = 4, kStageOut = 8;

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

// The chunk's (qt, kt) tile pair of pair index t, kt <= qt.
__device__ __forceinline__ void tile_pair(int t, int& qt, int& kt) {
  qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= t) ++qt;
  kt = t - qt * (qt + 1) / 2;
}

// dtv[i] = dt of head h for the chunk's rows, then cum = the inclusive
// cumsum of dtv * a_h (a lane's run of rows, then a warp scan), both in
// shared memory, zero past Q up to Qp.  Ends synchronised.
__device__ __forceinline__ void chunk_cum(const float* __restrict__ dt,
                                          long long row0, int h, float a_h,
                                          const Dims& d, float* dtv,
                                          float* cum) {
  const int tid = threadIdx.x;
  for (int i = tid; i < d.Qp; i += blockDim.x) {
    dtv[i] = i < d.Q ? dt[(row0 + i) * d.H + h] : 0.f;
    if (i >= d.Q) cum[i] = 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    const int per = (d.Q + 31) / 32;
    const int lo = min(tid * per, d.Q), hi = min(lo + per, d.Q);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run = __fadd_rn(run, __fmul_rn(dtv[i], a_h));
      cum[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    const float excl = incl - run;
    for (int i = lo; i < hi; ++i) cum[i] += excl;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

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

// Stage 1: one 64x64 tile of a chunk's C.B^T; 4 warps of 16 query rows.
template <int kN>
__global__ void __launch_bounds__(128)
    ssd_scan_kernel_cb_mma(const bf16* __restrict__ Bm,
                           const bf16* __restrict__ Cm,
                           float* __restrict__ cb, Dims d, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sc = reinterpret_cast<bf16*>(smem_raw);   // [64][kN] C rows
  bf16* sb = sc + kT * kN;                        // [64][kN] B rows
  const int bc = blockIdx.x / d.n_pairs;          // b * nc + c
  int qt, kt;
  tile_pair(blockIdx.x % d.n_pairs, qt, kt);
  const long long row0 = static_cast<long long>(bc) * d.Q;
  const int i0 = qt * kT, j0 = kt * kT;
  load_tile<kN>(sc, Cm + (row0 + i0) * d.N, d.N, d.Q - i0, d.N, vec);
  load_tile<kN>(sb, Bm + (row0 + j0) * d.N, d.N, d.Q - j0, d.N, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a_addr<kN>(sc, warp * 16, kk * 16, lane), a[0], a[1], a[2],
            a[3]);
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b_addr<kN>(sb, kk * 16, nn * 16, lane), b0, b1, b2, b3);
      mma_bf16(s[2 * nn], a, b0, b1);
      mma_bf16(s[2 * nn + 1], a, b2, b3);
    }
  }
  const int g = lane >> 2, c4 = lane & 3;
  float* out = cb + (static_cast<long long>(bc) * d.Qp + i0) * d.Qp + j0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + r * 8;
      *reinterpret_cast<float2*>(&out[row * d.Qp + j * 8 + 2 * c4]) =
          make_float2(s[j][2 * r], s[j][2 * r + 1]);
    }
}

// Stage 2: cum and the chunk-local state of one (batch, chunk, head);
// kN / 16 warps of 16 state rows (n), 64 columns (p) each.
template <int kN>
__global__ void __launch_bounds__(kN * 2)
    ssd_scan_kernel_state_mma(const bf16* __restrict__ x,
                              const float* __restrict__ dt,
                              const float* __restrict__ A,
                              const bf16* __restrict__ Bm,
                              float* __restrict__ cum_out,
                              float* __restrict__ st_out, Dims d, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sb = reinterpret_cast<bf16*>(smem_raw);   // [2][64][kN] B rows
  bf16* sxh = sb + 2 * kT * kN;                   // [2][64][64] x, x w hi
  bf16* sxl = sxh + 2 * kT * kPMax;               // [64][64] x w, lo
  float* cum = reinterpret_cast<float*>(sxl + kT * kPMax);   // [Qp]
  float* dtv = cum + kQMax;                                  // [Qp]

  const int bc = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const long long row0 = static_cast<long long>(bc) * d.Q;
  const bool vec_b = vec & 1, vec_x = vec & 2;
  const long long xs = static_cast<long long>(d.H) * d.P;   // x row stride
  const bf16* xb = x + (row0 * d.H + h) * d.P;
  // key tile kt's B and x rows into ring slot kt & 1
  auto load = [&](int kt) {
    const int j0 = kt * kT, buf = kt & 1;
    load_tile<kN>(sb + buf * kT * kN, Bm + (row0 + j0) * d.N, d.N,
                  d.Q - j0, d.N, vec_b);
    load_tile<kPMax>(sxh + buf * kT * kPMax, xb + j0 * xs, xs, d.Q - j0,
                     d.P, vec_x);
    cp_async_commit();
  };
  load(0);   // lands while cum is computed
  chunk_cum(dt, row0, h, A[h], d, dtv, cum);
  float* cum_g = cum_out + static_cast<long long>(blockIdx.x) * d.Q;
  for (int i = threadIdx.x; i < d.Q; i += blockDim.x) cum_g[i] = cum[i];
  const float last = cum[d.Q - 1];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kt = 0; kt < d.nt; ++kt) {
    const int j0 = kt * kT, buf = kt & 1;
    if (kt + 1 < d.nt)
      load(kt + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();   // this tile's group has landed
    __syncthreads();
    bf16* sxt = sxh + buf * kT * kPMax;
    const bf16* sbt = sb + buf * kT * kN;
    // x_j (exp(cum_last - cum_j) dt_j), split; one owner per element
    for (int idx = threadIdx.x; idx < kT * kPMax; idx += blockDim.x) {
      const int r = idx / kPMax, off = swz<kPMax>(r, idx % kPMax);
      const int j = j0 + r;
      const float w = j < d.Q ? expf(last - cum[j]) * dtv[j] : 0.f;
      split_bf16(__bfloat162float(sxt[off]) * w, sxt[off], sxl[off]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4_trans(at_addr<kN>(sbt, kk * 16, warp * 16, lane), a[0], a[1],
                    a[2], a[3]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(bt_addr<kPMax>(sxt, kk * 16, nn * 16, lane), b0, b1,
                      b2, b3);
        mma_bf16(acc[2 * nn], a, b0, b1);
        mma_bf16(acc[2 * nn + 1], a, b2, b3);
        ldsm_x4_trans(bt_addr<kPMax>(sxl, kk * 16, nn * 16, lane), b0, b1,
                      b2, b3);
        mma_bf16(acc[2 * nn], a, b0, b1);
        mma_bf16(acc[2 * nn + 1], a, b2, b3);
      }
    }
    __syncthreads();   // this slot and sxl are free for the next tile
  }
  const int g = lane >> 2, c4 = lane & 3;
  float* st = st_out + static_cast<long long>(blockIdx.x) * d.N * d.P;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = warp * 16 + g + (e >> 1) * 8, p = j * 8 + 2 * c4 + (e & 1);
      if (n < d.N && p < d.P) st[n * d.P + p] = acc[j][e];
    }
}

// Stage 4: y of one 64-row query tile of one (batch, chunk, head); 4
// warps of 16 query rows, 64 columns (p) each.
template <int kN>
__global__ void __launch_bounds__(128)
    ssd_scan_kernel_out_mma(const bf16* __restrict__ x,
                            const float* __restrict__ dt,
                            const bf16* __restrict__ Cm,
                            const float* __restrict__ cb,
                            const float* __restrict__ cum_g,
                            const float* __restrict__ st_in,
                            bf16* __restrict__ y, Dims d, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sc = reinterpret_cast<bf16*>(smem_raw);   // [64][kN] C rows
  bf16* ssh = sc + kT * kN;                       // [kN][64] state, hi
  bf16* ssl = ssh + kN * kPMax;                   // [kN][64] state, lo
  bf16* sx = ssl + kN * kPMax;                    // [2][64][64] x ring
  float* cum = reinterpret_cast<float*>(sx + 2 * kT * kPMax);   // [Qp]
  float* dtv = cum + kQMax;                                     // [Qp]

  const int qt = d.nt - 1 - static_cast<int>(blockIdx.x / d.BCH);
  const int bch = blockIdx.x % d.BCH;   // (b * nc + c) * H + h
  const int bc = bch / d.H, h = bch % d.H;
  const long long row0 = static_cast<long long>(bc) * d.Q;
  const int i0 = qt * kT;
  const bool vec_c = vec & 1, vec_x = vec & 2;
  const long long xs = static_cast<long long>(d.H) * d.P;   // x row stride
  const bf16* xb = x + (row0 * d.H + h) * d.P;
  load_tile<kN>(sc, Cm + (row0 + i0) * d.N, d.N, d.Q - i0, d.N, vec_c);
  load_tile<kPMax>(sx, xb, xs, d.Q, d.P, vec_x);
  cp_async_commit();

  const float* stp = st_in + static_cast<long long>(bch) * d.N * d.P;
  if (d.P == kPMax) {
    // 16-byte loads, all of a thread's issued before the first is used
    constexpr int kPer = kN * kPMax / 4 / 128;
    float4 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int n = (threadIdx.x + k * 128) / (kPMax / 4);
      v[k] = n < d.N ? *reinterpret_cast<const float4*>(
                           &stp[(threadIdx.x + k * 128) * 4])
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = (threadIdx.x + k * 128) * 4;
      const int n = q / kPMax, p = q % kPMax;
      const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int off = swz<kPMax>(n, p + t);
        split_bf16(e[t], ssh[off], ssl[off]);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kN * kPMax; idx += blockDim.x) {
      const int n = idx / kPMax, p = idx % kPMax;
      const float v = (n < d.N && p < d.P) ? stp[n * d.P + p] : 0.f;
      const int off = swz<kPMax>(n, p);
      split_bf16(v, ssh[off], ssl[off]);
    }
  }
  const float* cg = cum_g + static_cast<long long>(bch) * d.Q;
  for (int i = threadIdx.x; i < d.Qp; i += blockDim.x) {
    cum[i] = i < d.Q ? cg[i] : 0.f;
    dtv[i] = i < d.Q ? dt[(row0 + i) * d.H + h] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int ia = i0 + warp * 16 + g, ib = ia + 8;   // this thread's rows
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // the carried state's term: C_i . state_in, then times exp(cum_i)
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a_addr<kN>(sc, warp * 16, kk * 16, lane), a[0], a[1], a[2],
            a[3]);
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(bt_addr<kPMax>(ssh, kk * 16, nn * 16, lane), b0, b1, b2,
                    b3);
      mma_bf16(acc[2 * nn], a, b0, b1);
      mma_bf16(acc[2 * nn + 1], a, b2, b3);
      ldsm_x4_trans(bt_addr<kPMax>(ssl, kk * 16, nn * 16, lane), b0, b1, b2,
                    b3);
      mma_bf16(acc[2 * nn], a, b0, b1);
      mma_bf16(acc[2 * nn + 1], a, b2, b3);
    }
  }
  const float ea = ia < d.Q ? expf(cum[ia]) : 0.f;
  const float eb = ib < d.Q ? expf(cum[ib]) : 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] *= ea;
    acc[j][1] *= ea;
    acc[j][2] *= eb;
    acc[j][3] *= eb;
  }

  // the chunk's own rows: key tiles at or below the diagonal
  const float* cbr = cb + static_cast<long long>(bc) * d.Qp * d.Qp;
  const float* cba = cbr + static_cast<long long>(ia) * d.Qp;
  const float* cbb = cbr + static_cast<long long>(ib) * d.Qp;
  const float ca = cum[ia], cbv = cum[ib];
  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    if (kt < qt)
      load_tile<kPMax>(sx + (st ^ 1) * kT * kPMax, xb + (kt + 1) * kT * xs,
                       xs, d.Q - (kt + 1) * kT, d.P, vec_x);
    cp_async_commit();
    // this thread's C.B^T entries of the tile pair, loaded while the x
    // tile lands: [kk][row ia, ia at j + 8, ib, ib at j + 8]
    float2 cbt[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j = kt * kT + kk * 16 + 2 * c4;
      cbt[kk][0] = *reinterpret_cast<const float2*>(&cba[j]);
      cbt[kk][1] = *reinterpret_cast<const float2*>(&cba[j + 8]);
      cbt[kk][2] = *reinterpret_cast<const float2*>(&cbb[j]);
      cbt[kk][3] = *reinterpret_cast<const float2*>(&cbb[j + 8]);
    }
    cp_async_wait<1>();   // this tile's group has landed
    __syncthreads();
    const bf16* sxt = sx + st * kT * kPMax;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // the weights W[i][j] = (CB o exp(cum_i - cum_j)) dt_j, j <= i, of
      // this thread's A fragment, split into hi and lo
      const int j = kt * kT + kk * 16 + 2 * c4;
      const float cbs[2][4] = {
          {cbt[kk][0].x, cbt[kk][0].y, cbt[kk][1].x, cbt[kk][1].y},
          {cbt[kk][2].x, cbt[kk][2].y, cbt[kk][3].x, cbt[kk][3].y}};
      const int jj[4] = {j, j + 1, j + 8, j + 9};
      float w[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? ib : ia;
        const float ci = r ? cbv : ca;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[r][e] = (jj[e] <= i && i < d.Q)
                        ? cbs[r][e] * expf(ci - cum[jj[e]]) * dtv[jj[e]]
                        : 0.f;
      }
      uint32_t ah[4], al[4];
      split_pair(w[0][0], w[0][1], ah[0], al[0]);
      split_pair(w[1][0], w[1][1], ah[1], al[1]);
      split_pair(w[0][2], w[0][3], ah[2], al[2]);
      split_pair(w[1][2], w[1][3], ah[3], al[3]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(bt_addr<kPMax>(sxt, kk * 16, nn * 16, lane), b0, b1,
                      b2, b3);
        mma_bf16(acc[2 * nn], ah, b0, b1);
        mma_bf16(acc[2 * nn + 1], ah, b2, b3);
        mma_bf16(acc[2 * nn], al, b0, b1);
        mma_bf16(acc[2 * nn + 1], al, b2, b3);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r ? ib : ia;
    if (i >= d.Q) continue;
    bf16* yrow = y + ((row0 + i) * d.H + h) * d.P;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = j * 8 + 2 * c4;
      if (p < d.P) yrow[p] = __float2bfloat16_rn(acc[j][2 * r]);
      if (p + 1 < d.P) yrow[p + 1] = __float2bfloat16_rn(acc[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA units (256 threads, 16 x 16)
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stage 1: one 64x64 tile of C.B^T, each thread a 4 x 4 block.
__global__ void __launch_bounds__(kFmaThreads)
    ssd_scan_kernel_cb_fma(const float* __restrict__ Bm,
                           const float* __restrict__ Cm,
                           float* __restrict__ cb, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                  // [kNMax][kTPad] C^T of the query tile
  float* bt = ct + kNMax * kTPad;    // [kNMax][kTPad] B^T of the key tile
  const int bc = blockIdx.x / d.n_pairs;
  int qt, kt;
  tile_pair(blockIdx.x % d.n_pairs, qt, kt);
  const long long row0 = static_cast<long long>(bc) * d.Q;
  const int i0 = qt * kT, j0 = kt * kT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int k = tid; k < kT * d.N; k += kFmaThreads) {
    const int r = k / d.N, n = k % d.N;
    ct[n * kTPad + r] = i0 + r < d.Q ? Cm[(row0 + i0 + r) * d.N + n] : 0.f;
    bt[n * kTPad + r] = j0 + r < d.Q ? Bm[(row0 + j0 + r) * d.N + n] : 0.f;
  }
  __syncthreads();
  float s[4][4] = {};
  for (int n = 0; n < d.N; ++n) {
    const float4 cv = ld4(&ct[n * kTPad + ty * 4]);
    const float4 bv = ld4(&bt[n * kTPad + tx * 4]);
    const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
    const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[r][q] = fmaf(ca[r], ba[q], s[r][q]);
  }
  float* out = cb + (static_cast<long long>(bc) * d.Qp + i0) * d.Qp + j0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(&out[(ty * 4 + r) * d.Qp + tx * 4]) =
        make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
}

// Stage 2: cum and the chunk-local state, each thread an 8 (n) x 4 (p)
// block of the [128][64] state.
__global__ void __launch_bounds__(kFmaThreads)
    ssd_scan_kernel_state_fma(const float* __restrict__ x,
                              const float* __restrict__ dt,
                              const float* __restrict__ A,
                              const float* __restrict__ Bm,
                              float* __restrict__ cum_out,
                              float* __restrict__ st_out, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                  // [kT][kBsPad] B rows of the key tile
  float* xs = bs + kT * kBsPad;      // [kT][kPMax] x w of the key tile
  float* cum = xs + kT * kPMax;      // [Qp]
  float* dtv = cum + kQMax;          // [Qp]
  const int bc = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const long long row0 = static_cast<long long>(bc) * d.Q;
  chunk_cum(dt, row0, h, A[h], d, dtv, cum);
  float* cum_g = cum_out + static_cast<long long>(blockIdx.x) * d.Q;
  for (int i = threadIdx.x; i < d.Q; i += kFmaThreads) cum_g[i] = cum[i];
  const float last = cum[d.Q - 1];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float sacc[8][4] = {};
  for (int kt = 0; kt < d.nt; ++kt) {
    const int j0 = kt * kT;
    __syncthreads();
    for (int k = tid; k < kT * kNMax; k += kFmaThreads) {
      const int r = k / kNMax, n = k % kNMax;
      bs[r * kBsPad + n] =
          (j0 + r < d.Q && n < d.N) ? Bm[(row0 + j0 + r) * d.N + n] : 0.f;
    }
    for (int k = tid; k < kT * kPMax; k += kFmaThreads) {
      const int r = k / kPMax, p = k % kPMax, j = j0 + r;
      xs[k] = (j < d.Q && p < d.P)
                  ? x[((row0 + j) * d.H + h) * d.P + p] *
                        (expf(last - cum[j]) * dtv[j])
                  : 0.f;
    }
    __syncthreads();
    const int jn = min(kT, d.Q - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float4 b_lo = ld4(&bs[jj * kBsPad + ty * 8]);
      const float4 b_hi = ld4(&bs[jj * kBsPad + ty * 8 + 4]);
      const float4 xv = ld4(&xs[jj * kPMax + tx * 4]);
      const float ba[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                           b_hi.x, b_hi.y, b_hi.z, b_hi.w};
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          sacc[r][q] = fmaf(ba[r], xa[q], sacc[r][q]);
    }
  }
  float* st = st_out + static_cast<long long>(blockIdx.x) * d.N * d.P;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = ty * 8 + r, p = tx * 4 + q;
      if (n < d.N && p < d.P) st[n * d.P + p] = sacc[r][q];
    }
}

// Stage 4: y of one 64-row query tile, each thread a 4 x 4 block.
__global__ void __launch_bounds__(kFmaThreads)
    ssd_scan_kernel_out_fma(const float* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ Cm,
                            const float* __restrict__ cb,
                            const float* __restrict__ cum_g,
                            const float* __restrict__ st_in,
                            float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                    // [kNMax][kTPad] C^T of the tile
  float* sst = ct + kNMax * kTPad;     // [kNMax][kPMax] state_in
  float* xs = sst + kNMax * kPMax;     // [kT][kPMax] x of the key tile
  float* sc = xs + kT * kPMax;         // [kT][kTPad] weights, transposed
  float* cum = sc + kT * kTPad;        // [Qp]
  float* dtv = cum + kQMax;            // [Qp]
  const int qt = d.nt - 1 - static_cast<int>(blockIdx.x / d.BCH);
  const int bch = blockIdx.x % d.BCH;
  const int bc = bch / d.H, h = bch % d.H;
  const long long row0 = static_cast<long long>(bc) * d.Q;
  const int i0 = qt * kT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* stp = st_in + static_cast<long long>(bch) * d.N * d.P;
  for (int k = tid; k < kNMax * kPMax; k += kFmaThreads) {
    const int n = k / kPMax, p = k % kPMax;
    sst[k] = (n < d.N && p < d.P) ? stp[n * d.P + p] : 0.f;
  }
  for (int k = tid; k < kT * d.N; k += kFmaThreads) {
    const int r = k / d.N, n = k % d.N;
    ct[n * kTPad + r] = i0 + r < d.Q ? Cm[(row0 + i0 + r) * d.N + n] : 0.f;
  }
  const float* cg = cum_g + static_cast<long long>(bch) * d.Q;
  for (int i = tid; i < d.Qp; i += kFmaThreads) {
    cum[i] = i < d.Q ? cg[i] : 0.f;
    dtv[i] = i < d.Q ? dt[(row0 + i) * d.H + h] : 0.f;
  }
  __syncthreads();

  // the carried state's term: exp(cum_i) (C_i . state_in)
  float acc[4][4] = {};
  for (int n = 0; n < d.N; ++n) {
    const float4 cv = ld4(&ct[n * kTPad + ty * 4]);
    const float4 sv = ld4(&sst[n * kPMax + tx * 4]);
    const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
    const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(ca[r], sa[q], acc[r][q]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    const float e = i < d.Q ? expf(cum[i]) : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] *= e;
  }

  const float* cbr = cb + static_cast<long long>(bc) * d.Qp * d.Qp;
  for (int kt = 0; kt <= qt; ++kt) {
    const int j0 = kt * kT;
    __syncthreads();   // the last pair's readers of xs/sc are done
    for (int k = tid; k < kT * kPMax; k += kFmaThreads) {
      const int r = k / kPMax, p = k % kPMax;
      xs[k] = (j0 + r < d.Q && p < d.P)
                  ? x[((row0 + j0 + r) * d.H + h) * d.P + p]
                  : 0.f;
    }
    // weights (cb * decay * dt, the reference's order), masked, stored
    // transposed so the product below reads four rows as one float4
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      const float4 v =
          ld4(&cbr[static_cast<long long>(i) * d.Qp + j0 + tx * 4]);
      const float va[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + tx * 4 + q;
        sc[(tx * 4 + q) * kTPad + ty * 4 + r] =
            (j <= i && i < d.Q) ? va[q] * expf(cum[i] - cum[j]) * dtv[j]
                                : 0.f;
      }
    }
    __syncthreads();
    const int jn = min(kT, d.Q - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float4 wv = ld4(&sc[jj * kTPad + ty * 4]);
      const float4 xv = ld4(&xs[jj * kPMax + tx * 4]);
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wa[r], xa[q], acc[r][q]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= d.Q) continue;
    float* yrow = y + ((row0 + i) * d.H + h) * d.P;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = tx * 4 + q;
      if (p < d.P) yrow[p] = acc[r][q];
    }
  }
}

// ---------------------------------------------------------------------------
// stage 3 (both dtypes) and the host side
// ---------------------------------------------------------------------------

// Stage 3: a thread walks the chunks in order for 4 state elements (4
// independent loads in flight); the local state of chunk c is replaced by
// the state entering it.
constexpr int kFoldPer = 4;

__global__ void __launch_bounds__(256)
    ssd_scan_kernel_fold(const float* __restrict__ cum,
                         const float* __restrict__ init,
                         float* __restrict__ st,
                         float* __restrict__ final_state, Dims d) {
  const int np = d.N * d.P;
  const int e = (blockIdx.y * blockDim.x + threadIdx.x) * kFoldPer;
  if (e >= np) return;
  const int n_el = min(kFoldPer, np - e);
  const int b = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const long long at = static_cast<long long>(blockIdx.x) * np + e;
  float run[kFoldPer];
#pragma unroll
  for (int t = 0; t < kFoldPer; ++t)
    run[t] = (init != nullptr && t < n_el) ? init[at + t] : 0.f;
  for (int c = 0; c < d.nc; ++c) {
    const long long bch = (static_cast<long long>(b) * d.nc + c) * d.H + h;
    float* slot = st + bch * np + e;
    const float decay = expf(cum[bch * d.Q + d.Q - 1]);
#pragma unroll
    for (int t = 0; t < kFoldPer; ++t) {
      if (t < n_el) {
        const float local = slot[t];
        slot[t] = run[t];
        run[t] = run[t] * decay + local;
      }
    }
  }
  if (final_state != nullptr) {
#pragma unroll
    for (int t = 0; t < kFoldPer; ++t)
      if (t < n_el) final_state[at + t] = run[t];
  }
}

Dims make_dims(long long B, long long S, long long H, long long P,
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int kN>
cudaError_t launch_mma(const bf16* x, const float* dt, const float* A,
                       const bf16* Bm, const bf16* Cm, const float* init,
                       bf16* y, float* final_state, float* cb, float* cum,
                       float* st, const Dims& d, long long B, int stages,
                       cudaStream_t s) {
  constexpr size_t kCbBytes = 2 * kT * kN * sizeof(bf16);
  constexpr size_t kStateBytes =
      (2 * kT * kN + 3 * kT * kPMax) * sizeof(bf16) +
      2 * kQMax * sizeof(float);
  constexpr size_t kOutBytes =
      (kT * kN + 2 * kN * kPMax + 2 * kT * kPMax) * sizeof(bf16) +
      2 * kQMax * sizeof(float);
  static bool done_cb[kMaxDevices] = {}, done_state[kMaxDevices] = {},
              done_out[kMaxDevices] = {};
  const bool vec_bc = d.N % 8 == 0 && aligned16(Bm) && aligned16(Cm);
  const bool vec_x = d.P % 8 == 0 && aligned16(x);
  cudaError_t err;
  if (stages & kStageCb) {
    err = allow_smem(done_cb, ssd_scan_kernel_cb_mma<kN>, kCbBytes);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel_cb_mma<kN>
        <<<static_cast<unsigned>(B * d.nc * d.n_pairs), 128, kCbBytes, s>>>(
            Bm, Cm, cb, d, vec_bc ? 1 : 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & kStageState) {
    err = allow_smem(done_state, ssd_scan_kernel_state_mma<kN>, kStateBytes);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel_state_mma<kN>
        <<<static_cast<unsigned>(d.BCH), kN * 2, kStateBytes, s>>>(
            x, dt, A, Bm, cum, st, d, (vec_bc ? 1 : 0) | (vec_x ? 2 : 0));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & kStageFold) {
    const dim3 grid(static_cast<unsigned>(d.BH),
                    static_cast<unsigned>((d.N * d.P + 256 * kFoldPer - 1) /
                                          (256 * kFoldPer)));
    ssd_scan_kernel_fold<<<grid, 256, 0, s>>>(cum, init, st, final_state, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & kStageOut) {
    err = allow_smem(done_out, ssd_scan_kernel_out_mma<kN>, kOutBytes);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel_out_mma<kN>
        <<<static_cast<unsigned>(d.nt * d.BCH), 128, kOutBytes, s>>>(
            x, dt, Cm, cb, cum, st, y, d,
            (vec_bc ? 1 : 0) | (vec_x ? 2 : 0));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t launch_fma(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* init,
                       float* y, float* final_state, float* cb, float* cum,
                       float* st, const Dims& d, long long B, int stages,
                       cudaStream_t s) {
  constexpr size_t kCbBytes = 2 * kNMax * kTPad * sizeof(float);
  constexpr size_t kStateBytes =
      (kT * kBsPad + kT * kPMax + 2 * kQMax) * sizeof(float);
  constexpr size_t kOutBytes = (kNMax * kTPad + kNMax * kPMax + kT * kPMax +
                                kT * kTPad + 2 * kQMax) *
                               sizeof(float);
  static bool done_cb[kMaxDevices] = {}, done_state[kMaxDevices] = {},
              done_out[kMaxDevices] = {};
  cudaError_t err;
  if (stages & kStageCb) {
    err = allow_smem(done_cb, ssd_scan_kernel_cb_fma, kCbBytes);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel_cb_fma<<<static_cast<unsigned>(B * d.nc * d.n_pairs),
                             kFmaThreads, kCbBytes, s>>>(Bm, Cm, cb, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & kStageState) {
    err = allow_smem(done_state, ssd_scan_kernel_state_fma, kStateBytes);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel_state_fma<<<static_cast<unsigned>(d.BCH), kFmaThreads,
                                kStateBytes, s>>>(x, dt, A, Bm, cum, st, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & kStageFold) {
    const dim3 grid(static_cast<unsigned>(d.BH),
                    static_cast<unsigned>((d.N * d.P + 256 * kFoldPer - 1) /
                                          (256 * kFoldPer)));
    ssd_scan_kernel_fold<<<grid, 256, 0, s>>>(cum, init, st, final_state, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & kStageOut) {
    err = allow_smem(done_out, ssd_scan_kernel_out_fma, kOutBytes);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel_out_fma<<<static_cast<unsigned>(d.nt * d.BCH),
                              kFmaThreads, kOutBytes, s>>>(
        x, dt, Cm, cb, cum, st, y, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x, y [B, S, H, P]; dt [B, S, H] f32; A [H] f32; Bm, Cm [B, S, N];
// init, final_state [B, H, N, P] f32, either may be null; all contiguous.
// Scratch: cb [B, nc, Qp, Qp], cum [B, nc, H, Q], st [B, nc, H, N, P], all
// f32 (nc = S / Q, Qp = Q rounded up to 64).  ``stages`` picks the
// launches (bits 1 cb, 2 state, 4 fold, 8 out; 15 is the whole scan);
// each reads only what the earlier stages write.  Needs S % Q == 0,
// Q <= 1024, N <= 128, P <= 64 (the wrapper checks).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* init,
                            void* y, void* final_state, void* cb, void* cum,
                            void* st, long long B, long long S, long long H,
                            long long P, long long N, long long Q,
                            long long stages, void* stream) {
  const Dims d = make_dims(B, S, H, P, N, Q);
  return static_cast<int>(launch_fma(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(init),
      static_cast<float*>(y), static_cast<float*>(final_state),
      static_cast<float*>(cb), static_cast<float*>(cum),
      static_cast<float*>(st), d, B, static_cast<int>(stages),
      static_cast<cudaStream_t>(stream)));
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm,
                             const void* init, void* y, void* final_state,
                             void* cb, void* cum, void* st, long long B,
                             long long S, long long H, long long P,
                             long long N, long long Q, long long stages,
                             void* stream) {
  const Dims d = make_dims(B, S, H, P, N, Q);
  auto run = N <= 64 ? &launch_mma<64> : &launch_mma<128>;
  return static_cast<int>(
      run(static_cast<const bf16*>(x), static_cast<const float*>(dt),
          static_cast<const float*>(A), static_cast<const bf16*>(Bm),
          static_cast<const bf16*>(Cm), static_cast<const float*>(init),
          static_cast<bf16*>(y), static_cast<float*>(final_state),
          static_cast<float*>(cb), static_cast<float*>(cum),
          static_cast<float*>(st), d, B, static_cast<int>(stages),
          static_cast<cudaStream_t>(stream)));
}
