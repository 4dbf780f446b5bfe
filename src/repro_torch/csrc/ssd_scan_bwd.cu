// ssd_scan_bwd: the gradient of the Mamba-2 SSD chunked scan (ssd_scan.cu),
// every Mamba layer's backward in training.
//
// It replaces no TPU kernel: the reference differentiates the XLA lowering
// of its chunked scan (repro/models/mamba.py under jax.grad).  The port did
// the same with autograd over its plain chunked scan, recomputed: at
// mamba2-780m's training shape (B 4, S 2048, H 48, P 64, N 128, Q 256) that
// built [B, nc, H, Q, Q] f32 squares of 403 MB each (the decay, CB o decay
// o dt, and their gradients), ~15 elementwise passes over them and ~70
// launches a layer.
//
// Per (batch, chunk, head), with M_ij = CB_ij exp(cum_i - cum_j) dt_j
// (j <= i), w_j = exp(cum_last - cum_j) dt_j, s the state entering the
// chunk, g the gradient of the state leaving it and dM_ij = dy_i . x_j:
//   D     = sum_i exp(cum_i) C_i^T dy_i;   G[c] = D[c] + exp(cum_last) G[c+1]
//   dx_j  = sum_{i >= j} M_ij dy_i + w_j (B_j g)
//   dC_i  = sum_h [sum_{j <= i} dM_ij decay_ij dt_j B_j + exp(cum_i) s dy_i]
//   dB_j  = sum_h [sum_{i >= j} dM_ij decay_ij dt_j C_i + w_j g x_j]
//   dcum  from the decay, the carried state and the state's decay; its
//         reverse cumsum within the chunk is d(dt A): ddt and dA.
// The forward leaves cum, C.B^T and the state entering each chunk in its
// scratch; the backward reads them there.  Five launches on the one stream
// from one C call:
//   a. dstate per (batch, chunk, head): D (the forward's stage 2, with C for
//             B and dy exp(cum) for x exp(cum_last - cum) dt);
//   b. fold   per (batch, head, 1024 state elements): the reverse walk over
//             the chunks, G[c + 1] written over D[c], dinit = G[0], and a
//             block's part of each chunk's exp(cum_last) <s, G[c + 1]>;
//   c. dx     per (batch, chunk, head, 64-row key tile): dx, the tile's
//             r_j and rd_j (dt_j's pull through the later rows and its
//             own) and dw_j (w_j's), and the tile's part of u_i (cum_i's
//             pull) for later rows;
//   d. dbc    per (batch, chunk, 64-row tile, dB or dC): dB or dC summed over
//             the heads inside the block, and dC's v_i (cum_i's pull
//             through the carried state);
//   e. dt     per head: dcum, its reverse cumsum, ddt and dA.
// The Q x Q squares never reach device memory: c and d form dy x^T one
// 64 x 64 block at a time on the tensor cores (mma.sync, exact bf16
// operands), weigh it in registers and multiply the weighed block on, an
// f32 weight split into bf16 hi + lo as the forward splits it (~2^-16
// relative).  Every sum across blocks is written as partials that a later
// launch adds in a fixed order, never by float atomics: a gradient is the
// same bits from run to run.
//
// Bound at that shape: ~0.3 GB moved (x, dy and dx in bf16, B, C, dB, dC,
// dt, ddt, cum, the f32 states read; the state gradient written and read),
// ~90 us at 3.35 TB/s; ~46 G multiply-adds with the split operands, ~90 us
// at the bf16 tensor-core peak.  Keeping the squares on chip is what brings
// the bytes to that bound; the products run at mma.sync's rate.
//
// bf16 only.  f32 inputs (the model checks) take the plain backward on an
// explicit, counted branch of the wrapper (kernels/ssd_scan.py,
// ``bwd_f32_plain``).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

#include "mma_bf16.cuh"
#include "ssd_tiles.cuh"

namespace {

using namespace repro_torch;
using namespace repro_torch::ssd;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFoldPer = 4;         // state elements a fold thread walks
constexpr int kFoldThreads = 256;
constexpr int kDtWarps = 16;        // chunks launch e takes at once

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// the sum of v over the four lanes of a quad (one fragment row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// a. D = sum_i exp(cum_i) C_i^T dy_i of one (batch, chunk, head) into the
// state gradient's slot; kN / 16 warps of 16 state rows (n), 64 columns (p)
// each.
template <int kN>
__global__ void __launch_bounds__(kN * 2)
    ssd_bwd_dstate_mma(const bf16* __restrict__ dy,
                       const bf16* __restrict__ Cm,
                       const float* __restrict__ cum_g,
                       float* __restrict__ gst, Dims d, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sc = reinterpret_cast<bf16*>(smem_raw);   // [2][64][kN] C rows
  bf16* syh = sc + 2 * kT * kN;                   // [2][64][64] dy, dy e hi
  bf16* syl = syh + 2 * kT * kPMax;               // [64][64] dy e, lo
  float* cum = reinterpret_cast<float*>(syl + kT * kPMax);   // [Qp]

  const int bc = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const long long row0 = static_cast<long long>(bc) * d.Q;
  const bool vec_c = vec & 1, vec_y = vec & 2;
  const long long ys = static_cast<long long>(d.H) * d.P;   // dy row stride
  const bf16* yb = dy + (row0 * d.H + h) * d.P;
  // query tile kt's C and dy rows into ring slot kt & 1
  auto load = [&](int kt) {
    const int i0 = kt * kT, buf = kt & 1;
    load_tile<kN>(sc + buf * kT * kN, Cm + (row0 + i0) * d.N, d.N,
                  d.Q - i0, d.N, vec_c);
    load_tile<kPMax>(syh + buf * kT * kPMax, yb + i0 * ys, ys, d.Q - i0,
                     d.P, vec_y);
    cp_async_commit();
  };
  load(0);
  const float* cg = cum_g + static_cast<long long>(blockIdx.x) * d.Q;
  for (int i = threadIdx.x; i < d.Qp; i += blockDim.x)
    cum[i] = i < d.Q ? cg[i] : 0.f;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kt = 0; kt < d.nt; ++kt) {
    const int i0 = kt * kT, buf = kt & 1;
    if (kt + 1 < d.nt)
      load(kt + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();   // this tile's group has landed
    __syncthreads();
    bf16* syt = syh + buf * kT * kPMax;
    const bf16* sct = sc + buf * kT * kN;
    // dy_i exp(cum_i), split; one owner per element
    for (int idx = threadIdx.x; idx < kT * kPMax; idx += blockDim.x) {
      const int r = idx / kPMax, off = swz<kPMax>(r, idx % kPMax);
      const int i = i0 + r;
      const float w = i < d.Q ? expf(cum[i]) : 0.f;
      split_bf16(bf(syt[off]) * w, syt[off], syl[off]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4_trans(at_addr<kN>(sct, kk * 16, warp * 16, lane), a[0], a[1],
                    a[2], a[3]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(bt_addr<kPMax>(syt, kk * 16, nn * 16, lane), b0, b1,
                      b2, b3);
        mma_bf16(acc[2 * nn], a, b0, b1);
        mma_bf16(acc[2 * nn + 1], a, b2, b3);
        ldsm_x4_trans(bt_addr<kPMax>(syl, kk * 16, nn * 16, lane), b0, b1,
                      b2, b3);
        mma_bf16(acc[2 * nn], a, b0, b1);
        mma_bf16(acc[2 * nn + 1], a, b2, b3);
      }
    }
    __syncthreads();   // this slot and syl are free for the next tile
  }
  const int g = lane >> 2, c4 = lane & 3;
  float* out = gst + static_cast<long long>(blockIdx.x) * d.N * d.P;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = warp * 16 + g + (e >> 1) * 8, p = j * 8 + 2 * c4 + (e & 1);
      if (n < d.N && p < d.P) out[n * d.P + p] = acc[j][e];
    }
}

// b. The reverse fold of one (batch, head), kFoldPer state elements a
// thread: the slot of chunk c holds D[c] and takes G[c + 1], the gradient
// of the state leaving chunk c (dfinal, or zeros, after the last); G[c] =
// D[c] + exp(cum_last) G[c + 1]; dinit = G[0].  The block writes its part
// of exp(cum_last) <s, G[c + 1]> for every chunk (s: the state entering it,
// the forward's scratch), which launch e sums.
__global__ void __launch_bounds__(kFoldThreads)
    ssd_bwd_fold(const float* __restrict__ cum,
                 const float* __restrict__ st_in,
                 const float* __restrict__ dfinal, float* __restrict__ gst,
                 float* __restrict__ sig, float* __restrict__ dinit, Dims d) {
  __shared__ float red[kFoldThreads / 32];
  const int np = d.N * d.P;
  const int e = (blockIdx.y * kFoldThreads + threadIdx.x) * kFoldPer;
  const int n_el = max(0, min(kFoldPer, np - e));
  const int b = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long at = static_cast<long long>(blockIdx.x) * np + e;
  float run[kFoldPer];
#pragma unroll
  for (int t = 0; t < kFoldPer; ++t)
    run[t] = (dfinal != nullptr && t < n_el) ? dfinal[at + t] : 0.f;
  for (int c = d.nc - 1; c >= 0; --c) {
    const long long bch = (static_cast<long long>(b) * d.nc + c) * d.H + h;
    float* slot = gst + bch * np + e;
    const float* sp = st_in + bch * np + e;
    const float el = expf(cum[bch * d.Q + d.Q - 1]);
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < kFoldPer; ++t) {
      if (t < n_el) {
        const float dd = slot[t];
        slot[t] = run[t];
        part = fmaf(sp[t], run[t], part);
        run[t] = dd + el * run[t];
      }
    }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float tot = 0.f;
      for (int w = 0; w < kFoldThreads / 32; ++w) tot += red[w];
      sig[bch * gridDim.y + blockIdx.y] = el * tot;
    }
    __syncthreads();
  }
  if (dinit != nullptr) {
#pragma unroll
    for (int t = 0; t < kFoldPer; ++t)
      if (t < n_el) dinit[at + t] = run[t];
  }
}

// c. One 64-row key tile of one (batch, chunk, head); 4 warps of 16 key
// rows (j), 64 columns each.  First the state's term: B_j g (g split into
// hi + lo) gives dw_j = (B_j g) . x_j and, times w_j, starts dx_j.  Then
// the query tiles at and after it (i >= j): T^T = x dy^T on the tensor
// cores, weighed in registers by C.B^T (the forward's scratch, through a
// shared ring) and the decay into M^T, whose product with dy adds to dx;
// r_j sums the weighed T over i, and the tile's part of u_i sums it times
// dt_j over j.
template <int kN>
__global__ void __launch_bounds__(128, 1)
    ssd_bwd_dx_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const bf16* __restrict__ Bm, const bf16* __restrict__ dy,
                   const float* __restrict__ cb,
                   const float* __restrict__ cum_g,
                   const float* __restrict__ gst, bf16* __restrict__ dx,
                   float* __restrict__ rr, float* __restrict__ rd,
                   float* __restrict__ dwv, float* __restrict__ up, Dims d,
                   int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sb = reinterpret_cast<bf16*>(smem_raw);   // [64][kN] B rows
  bf16* sx = sb + kT * kN;                        // [64][64] x rows
  bf16* sgh = sx + kT * kPMax;                    // [kN][64] g, hi
  bf16* sgl = sgh + kN * kPMax;                   // [kN][64] g, lo
  bf16* sdy = sgl + kN * kPMax;                   // [2][64][64] dy ring
  // [2][64][kTPad] C.B^T ring: rows i of the query tile, columns j
  float* scb = reinterpret_cast<float*>(sdy + 2 * kT * kPMax);
  float* ured = scb + 2 * kT * kTPad;             // [4][64] u's sums by warp
  float* cum = ured + 4 * kT;                     // [Qp]
  float* dtv = cum + d.Qp;                        // [Qp]

  const int jt = static_cast<int>(blockIdx.x / d.BCH);   // heaviest first
  const int bch = blockIdx.x % d.BCH;   // (b * nc + c) * H + h
  const int bc = bch / d.H, h = bch % d.H;
  const long long row0 = static_cast<long long>(bc) * d.Q;
  const int j0 = jt * kT;
  const bool vec_b = vec & 1, vec_x = vec & 2;
  const long long xs = static_cast<long long>(d.H) * d.P;   // x row stride
  const bf16* xb = x + (row0 * d.H + h) * d.P;
  const bf16* yb = dy + (row0 * d.H + h) * d.P;
  const float* cbc = cb + static_cast<long long>(bc) * d.Qp * d.Qp;
  load_tile<kN>(sb, Bm + (row0 + j0) * d.N, d.N, d.Q - j0, d.N, vec_b);
  load_tile<kPMax>(sx, xb + j0 * xs, xs, d.Q - j0, d.P, vec_x);
  cp_async_commit();
  // query tile it's dy rows and its C.B^T block (rows i, this tile's
  // columns j; 16-byte aligned, Qp being a multiple of 64) into ring slot
  // (it - jt) & 1
  auto load_q = [&](int it) {
    const int i0 = it * kT, buf = (it - jt) & 1;
    load_tile<kPMax>(sdy + buf * kT * kPMax, yb + i0 * xs, xs, d.Q - i0,
                     d.P, vec_x);
    float* dst = scb + buf * kT * kTPad;
    for (int idx = threadIdx.x; idx < kT * (kT / 4); idx += blockDim.x) {
      const int r = idx / (kT / 4), c = (idx % (kT / 4)) * 4;
      cp_async16(smem_addr(dst + r * kTPad + c),
                 cbc + static_cast<long long>(i0 + r) * d.Qp + j0 + c, 16);
    }
    cp_async_commit();
  };
  load_q(jt);
  // g, the gradient of the state leaving this chunk, as bf16 hi + lo
  const float* gp = gst + static_cast<long long>(bch) * d.N * d.P;
  if (d.P == kPMax) {
    // 16-byte loads, all of a thread's issued before the first is used
    constexpr int kPer = kN * kPMax / 4 / 128;
    float4 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = (threadIdx.x + k * 128) * 4;
      v[k] = q / kPMax < d.N ? *reinterpret_cast<const float4*>(&gp[q])
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = (threadIdx.x + k * 128) * 4;
      const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int off = swz<kPMax>(q / kPMax, q % kPMax + t);
        split_bf16(e[t], sgh[off], sgl[off]);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kN * kPMax; idx += blockDim.x) {
      const int n = idx / kPMax, p = idx % kPMax;
      const float v = (n < d.N && p < d.P) ? gp[n * d.P + p] : 0.f;
      const int off = swz<kPMax>(n, p);
      split_bf16(v, sgh[off], sgl[off]);
    }
  }
  const float* cg = cum_g + static_cast<long long>(bch) * d.Q;
  for (int i = threadIdx.x; i < d.Qp; i += blockDim.x) {
    cum[i] = i < d.Q ? cg[i] : 0.f;
    dtv[i] = i < d.Q ? dt[(row0 + i) * d.H + h] : 0.f;
  }
  cp_async_wait<1>();   // B and x have landed
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;   // this thread's tile rows
  const int ja = j0 + ra, jb = j0 + rb;        // ... as rows of the chunk
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // B_j g
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a_addr<kN>(sb, warp * 16, kk * 16, lane), a[0], a[1], a[2],
            a[3]);
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(bt_addr<kPMax>(sgh, kk * 16, nn * 16, lane), b0, b1, b2,
                    b3);
      mma_bf16(acc[2 * nn], a, b0, b1);
      mma_bf16(acc[2 * nn + 1], a, b2, b3);
      ldsm_x4_trans(bt_addr<kPMax>(sgl, kk * 16, nn * 16, lane), b0, b1, b2,
                    b3);
      mma_bf16(acc[2 * nn], a, b0, b1);
      mma_bf16(acc[2 * nn + 1], a, b2, b3);
    }
  }
  // dw_j = (B_j g) . x_j, then dx_j starts at w_j B_j g
  float dwa = 0.f, dwb = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = j * 8 + 2 * c4;
    dwa += acc[j][0] * bf(sx[swz<kPMax>(ra, p)]) +
           acc[j][1] * bf(sx[swz<kPMax>(ra, p + 1)]);
    dwb += acc[j][2] * bf(sx[swz<kPMax>(rb, p)]) +
           acc[j][3] * bf(sx[swz<kPMax>(rb, p + 1)]);
  }
  dwa = quad_sum(dwa);
  dwb = quad_sum(dwb);
  const float last = cum[d.Q - 1];
  const float cja = cum[ja], cjb = cum[jb], dtja = dtv[ja], dtjb = dtv[jb];
  const float wa = ja < d.Q ? expf(last - cja) * dtja : 0.f;
  const float wb = jb < d.Q ? expf(last - cjb) * dtjb : 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] *= wa;
    acc[j][1] *= wa;
    acc[j][2] *= wb;
    acc[j][3] *= wb;
  }

  // r_j over i > j and the diagonal's t_jj, this thread's columns
  float sa = 0.f, sb_ = 0.f, da = 0.f, db = 0.f;
  for (int it = jt; it < d.nt; ++it) {
    const int i0 = it * kT, buf = (it - jt) & 1;
    if (it + 1 < d.nt)
      load_q(it + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();   // this tile's group has landed
    __syncthreads();
    const bf16* syt = sdy + buf * kT * kPMax;
    const float* scbt = scb + buf * kT * kTPad;
    // T^T[j][i] = x_j . dy_i
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4(a_addr<kPMax>(sx, warp * 16, kk * 16, lane), a[0], a[1], a[2],
              a[3]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b_addr<kPMax>(syt, kk * 16, nn * 16, lane), b0, b1, b2, b3);
        mma_bf16(s[2 * nn], a, b0, b1);
        mma_bf16(s[2 * nn + 1], a, b2, b3);
      }
    }
    // weigh: t = T CB decay (into r_j and u_i), M^T = CB decay dt_j (kept
    // in s); only i >= j (and i < Q) is evaluated, so no exponent is
    // positive.  The diagonal's t stays out of r and u: its pull on cum
    // cancels exactly (decay exp(0)), and summed in it would leave a
    // rounding of its size where a steep decay leaves it alone
    float col[8][2];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = n8 * 8 + 2 * c4 + (e & 1), i = i0 + il;
        const bool lower = e >> 1;
        const int j = lower ? jb : ja;
        const float cl =
            (i >= j && i < d.Q)
                ? scbt[il * kTPad + (lower ? rb : ra)] *
                      expf(cum[i] - (lower ? cjb : cja))
                : 0.f;
        const float t = s[n8][e] * cl;
        const float tc = i == j ? 0.f : t;
        const float dj = lower ? dtjb : dtja;
        if (lower) {
          sb_ += tc;
          db += t - tc;
        } else {
          sa += tc;
          da += t - tc;
        }
        if (e < 2)
          col[n8][e] = tc * dj;
        else
          col[n8][e & 1] += tc * dj;
        s[n8][e] = cl * dj;
      }
    }
    // u's part: the column sums over this warp's 16 rows, then the warps'
    // sums in order (below, after the barrier)
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v = col[n8][q];
        v += __shfl_xor_sync(kFull, v, 4);
        v += __shfl_xor_sync(kFull, v, 8);
        v += __shfl_xor_sync(kFull, v, 16);
        if (g == 0) ured[warp * kT + n8 * 8 + 2 * c4 + q] = v;
      }
    }
    // dx += M^T dy, M^T split into hi and lo A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(bt_addr<kPMax>(syt, kk * 16, nn * 16, lane), b0, b1,
                      b2, b3);
        mma_bf16(acc[2 * nn], ah, b0, b1);
        mma_bf16(acc[2 * nn + 1], ah, b2, b3);
        mma_bf16(acc[2 * nn], al, b0, b1);
        mma_bf16(acc[2 * nn + 1], al, b2, b3);
      }
    }
    __syncthreads();   // u's warp sums are in; every warp is done with this slot
    if (threadIdx.x < kT && i0 + threadIdx.x < d.Q)
      up[(static_cast<long long>(bch) * d.nt + jt) * d.Qp + i0 +
         threadIdx.x] = ured[threadIdx.x] + ured[kT + threadIdx.x] +
                        ured[2 * kT + threadIdx.x] +
                        ured[3 * kT + threadIdx.x];
  }
  cp_async_wait<0>();

  sa = quad_sum(sa);
  sb_ = quad_sum(sb_);
  da = quad_sum(da);
  db = quad_sum(db);
  if (c4 == 0) {
    const long long at = static_cast<long long>(bch) * d.Q;
    if (ja < d.Q) {
      rr[at + ja] = sa;
      rd[at + ja] = da;
      dwv[at + ja] = dwa;
    }
    if (jb < d.Q) {
      rr[at + jb] = sb_;
      rd[at + jb] = db;
      dwv[at + jb] = dwb;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = r ? jb : ja;
    if (j >= d.Q) continue;
    bf16* row = dx + ((row0 + j) * d.H + h) * d.P;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int p = jj * 8 + 2 * c4;
      if (p < d.P) row[p] = __float2bfloat16_rn(acc[jj][2 * r]);
      if (p + 1 < d.P) row[p + 1] = __float2bfloat16_rn(acc[jj][2 * r + 1]);
    }
  }
}

// d. dC (rows: a query tile, i) or dB (rows: a key tile, j) of one (batch,
// chunk), summed over the heads inside the block; 8 warps, warp w rows
// (w & 3) * 16 and the half (w >> 2) of the kN columns.  R is the rows'
// tile of dy (dC) or x (dB) of a head.
//   The carried state's term, head by head: T = R S^T (S the state
//   entering the chunk for dC, g for dB, split into hi + lo) times
//   exp(cum_i) (dC) or w_j (dB); dC's rows also give v_i = exp(cum_i) C_i .
//   (dy_i S^T).
//   Then each tile pair (the other tile at or before the rows', for dC;
//   at or after, for dB), head by head: T = R K^T (K the other tile's x
//   for dC, dy for dB) weighed by exp(cum_i - cum_j) dt_j over j <= i and
//   summed into the pair's dCB block in registers; split into hi + lo
//   through shared memory, the block is multiplied by the other tile's B
//   (dC) or C (dB) rows.
template <int kN>
__global__ void __launch_bounds__(256, 1)
    ssd_bwd_dbc_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                    const bf16* __restrict__ dy,
                    const float* __restrict__ cum_g,
                    const float* __restrict__ st_in,
                    const float* __restrict__ gst, bf16* __restrict__ dB,
                    bf16* __restrict__ dC, float* __restrict__ vv, Dims d,
                    int vec) {
  constexpr int kNH = kN / 2;   // a warp's columns
  constexpr int kJ = kNH / 8;   // ... as 8-column tiles
  constexpr int kSPer = kN * kPMax / 256;   // state elements a thread loads
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sR = reinterpret_cast<bf16*>(smem_raw);   // [2][64][64] R ring
  // [2][64][64] K ring; the state's phase: the C rows [64][kN] (dC)
  bf16* sK = sR + 2 * kT * kPMax;
  // [2][64][kN] the other tile's B or C rows, by pair parity; the state's
  // phase: S hi, S lo [kN][64] each
  bf16* sO = sK + 2 * kT * kPMax;
  bf16* sWh = sO + 2 * kT * kN;                   // [64][64] dCB block, hi
  bf16* sWl = sWh + kT * kT;                      // lo
  // [2][4][64]: cum of R's rows, cum of K's, dt of R's, dt of K's (the
  // state's phase: cum, dt, and at [2][0] the chunk's last cum)
  float* sv = reinterpret_cast<float*>(sWl + kT * kT);
  float* vred = sv + 2 * 4 * kT;                  // [2][64] v by half

  const int BC = static_cast<int>(gridDim.x) / (2 * d.nt);   // B * nc
  const int q = blockIdx.x / (2 * BC);                       // heaviest first
  const int bc = (blockIdx.x % (2 * BC)) >> 1;
  const bool is_c = blockIdx.x & 1;
  const int rt = is_c ? d.nt - 1 - q : q;
  const int r0 = rt * kT;
  const int n_pairs = is_c ? rt + 1 : d.nt - rt;
  const long long row0 = static_cast<long long>(bc) * d.Q;
  const bf16* rsrc = is_c ? dy : x;
  const bf16* ksrc = is_c ? x : dy;
  const bf16* osrc = is_c ? Bm : Cm;
  const float* ssrc = is_c ? st_in : gst;
  const bool vec_bc = vec & 1, vec_x = vec & 2;
  const long long xs = static_cast<long long>(d.H) * d.P;   // x row stride
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3, wr = warp & 3, wc = warp >> 2;
  const int rla = wr * 16 + g, rlb = rla + 8;   // this thread's tile rows

  float acc[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // ---- the carried state's term, head by head
  bf16* ssh = sO;
  bf16* ssl = sO + kN * kPMax;
  auto load_r = [&](int h) {
    load_tile<kPMax>(sR + (h & 1) * kT * kPMax,
                     rsrc + ((row0 + r0) * d.H + h) * d.P, xs, d.Q - r0, d.P,
                     vec_x);
    cp_async_commit();
  };
  float sreg[kSPer];
  auto load_s = [&](int h) {
    const float* sp =
        ssrc + (static_cast<long long>(bc) * d.H + h) * d.N * d.P;
#pragma unroll
    for (int k = 0; k < kSPer; ++k) {
      const int idx = tid + k * 256, n = idx / kPMax, p = idx % kPMax;
      sreg[k] = (n < d.N && p < d.P) ? sp[n * d.P + p] : 0.f;
    }
  };
  auto scal_s = [&](int h) -> float {
    const long long cm = (static_cast<long long>(bc) * d.H + h) * d.Q;
    if (tid < kT) return r0 + tid < d.Q ? cum_g[cm + r0 + tid] : 0.f;
    if (tid < 2 * kT) {
      const int i = r0 + tid - kT;
      return i < d.Q ? dt[(row0 + i) * d.H + h] : 0.f;
    }
    return tid == 2 * kT ? cum_g[cm + d.Q - 1] : 0.f;
  };
  if (is_c)
    load_tile<kN>(sK, Cm + (row0 + r0) * d.N, d.N, d.Q - r0, d.N, vec_bc);
  load_r(0);   // commits the C rows with it
  load_s(0);
  float pre = scal_s(0);
  for (int h = 0; h < d.H; ++h) {
    const int buf = h & 1;
    // this head's state, split (the last head's readers are done)
#pragma unroll
    for (int k = 0; k < kSPer; ++k) {
      const int idx = tid + k * 256;
      const int off = swz<kPMax>(idx / kPMax, idx % kPMax);
      split_bf16(sreg[k], ssh[off], ssl[off]);
    }
    if (tid <= 2 * kT) sv[buf * 4 * kT + tid] = pre;
    if (h + 1 < d.H) {
      load_r(h + 1);
      load_s(h + 1);
      pre = scal_s(h + 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();   // this head's R has landed
    __syncthreads();
    const bf16* srt = sR + buf * kT * kPMax;
    const float* svb = sv + buf * 4 * kT;
    float t[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4(a_addr<kPMax>(srt, wr * 16, kk * 16, lane), a[0], a[1], a[2],
              a[3]);
#pragma unroll
      for (int nn = 0; nn < kJ / 2; ++nn) {
        const int n0 = wc * kNH + nn * 16;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b_addr<kPMax>(ssh, kk * 16, n0, lane), b0, b1, b2, b3);
        mma_bf16(t[2 * nn], a, b0, b1);
        mma_bf16(t[2 * nn + 1], a, b2, b3);
        ldsm_x4(b_addr<kPMax>(ssl, kk * 16, n0, lane), b0, b1, b2, b3);
        mma_bf16(t[2 * nn], a, b0, b1);
        mma_bf16(t[2 * nn + 1], a, b2, b3);
      }
    }
    // the rows' scale: exp(cum_i) (dC) or w_j (dB)
    float sa, sb;
    if (is_c) {
      sa = r0 + rla < d.Q ? expf(svb[rla]) : 0.f;
      sb = r0 + rlb < d.Q ? expf(svb[rlb]) : 0.f;
    } else {
      const float last = svb[2 * kT];
      sa = r0 + rla < d.Q ? expf(last - svb[rla]) * svb[kT + rla] : 0.f;
      sb = r0 + rlb < d.Q ? expf(last - svb[rlb]) * svb[kT + rlb] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      acc[j][0] += sa * t[j][0];
      acc[j][1] += sa * t[j][1];
      acc[j][2] += sb * t[j][2];
      acc[j][3] += sb * t[j][3];
    }
    if (is_c) {
      float va = 0.f, vb = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int n = wc * kNH + j * 8 + 2 * c4;
        va += t[j][0] * bf(sK[swz<kN>(rla, n)]) +
              t[j][1] * bf(sK[swz<kN>(rla, n + 1)]);
        vb += t[j][2] * bf(sK[swz<kN>(rlb, n)]) +
              t[j][3] * bf(sK[swz<kN>(rlb, n + 1)]);
      }
      va = quad_sum(va);
      vb = quad_sum(vb);
      if (c4 == 0) {
        vred[wc * kT + rla] = sa * va;
        vred[wc * kT + rlb] = sb * vb;
      }
    }
    __syncthreads();   // v's halves are in; this head's readers are done
    if (is_c && tid < kT && r0 + tid < d.Q)
      vv[(static_cast<long long>(bc) * d.H + h) * d.Q + r0 + tid] =
          vred[tid] + vred[kT + tid];
  }
  cp_async_wait<0>();
  __syncthreads();   // sK and sO go back to the pairs

  // ---- the tile pairs: iteration k is pair k / H, head k % H
  const int n_iter = n_pairs * d.H;
  auto load_it = [&](int k) {
    const int pi = k / d.H, h = k % d.H, buf = k & 1;
    const int o0 = (is_c ? pi : rt + pi) * kT;
    load_tile<kPMax>(sR + buf * kT * kPMax,
                     rsrc + ((row0 + r0) * d.H + h) * d.P, xs, d.Q - r0, d.P,
                     vec_x);
    load_tile<kPMax>(sK + buf * kT * kPMax,
                     ksrc + ((row0 + o0) * d.H + h) * d.P, xs, d.Q - o0, d.P,
                     vec_x);
    if (h == 0)
      load_tile<kN>(sO + (pi & 1) * kT * kN, osrc + (row0 + o0) * d.N, d.N,
                    d.Q - o0, d.N, vec_bc);
    cp_async_commit();
  };
  // thread tid's scalar of iteration k: [cum R, cum K, dt R, dt K][tid & 63]
  auto scal_p = [&](int k) -> float {
    const int pi = k / d.H, h = k % d.H, which = tid >> 6;
    const int o0 = (is_c ? pi : rt + pi) * kT;
    const int i = ((which & 1) ? o0 : r0) + (tid & 63);
    if (i >= d.Q) return 0.f;
    return which < 2
               ? cum_g[(static_cast<long long>(bc) * d.H + h) * d.Q + i]
               : dt[(row0 + i) * d.H + h];
  };
  load_it(0);
  sv[tid] = scal_p(0);
  float wacc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) wacc[j][e] = 0.f;
  for (int k = 0; k < n_iter; ++k) {
    const int buf = k & 1, pi = k / d.H, h = k % d.H;
    const int o0 = (is_c ? pi : rt + pi) * kT;
    if (k + 1 < n_iter) {
      load_it(k + 1);
      pre = scal_p(k + 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();   // this iteration's group has landed
    __syncthreads();
    const bf16* srt = sR + buf * kT * kPMax;
    const bf16* skt = sK + buf * kT * kPMax;
    const float* svb = sv + buf * 4 * kT;
    float t[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4(a_addr<kPMax>(srt, wr * 16, kk * 16, lane), a[0], a[1], a[2],
              a[3]);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b_addr<kPMax>(skt, kk * 16, wc * 32 + nn * 16, lane), b0, b1,
                b2, b3);
        mma_bf16(t[2 * nn], a, b0, b1);
        mma_bf16(t[2 * nn + 1], a, b2, b3);
      }
    }
    // weigh by exp(cum_i - cum_j) dt_j over j <= i < Q
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = (e >> 1) ? rlb : rla;
        const int kl = wc * 32 + n8 * 8 + 2 * c4 + (e & 1);
        const int rpos = r0 + rl, kpos = o0 + kl;
        const float cr = svb[rl], ck = svb[kT + kl];
        if (is_c) {
          if (kpos <= rpos && rpos < d.Q)
            wacc[n8][e] += t[n8][e] * (expf(cr - ck) * svb[3 * kT + kl]);
        } else {
          if (kpos >= rpos && kpos < d.Q)
            wacc[n8][e] += t[n8][e] * (expf(ck - cr) * svb[2 * kT + rl]);
        }
      }
    }
    if (h == d.H - 1) {
      // the pair's dCB block, split, through shared memory, times the
      // other tile's rows
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
        const int col = wc * 32 + n8 * 8 + 2 * c4;
        uint32_t hi, lo;
        split_pair(wacc[n8][0], wacc[n8][1], hi, lo);
        *reinterpret_cast<uint32_t*>(&sWh[swz<kT>(rla, col)]) = hi;
        *reinterpret_cast<uint32_t*>(&sWl[swz<kT>(rla, col)]) = lo;
        split_pair(wacc[n8][2], wacc[n8][3], hi, lo);
        *reinterpret_cast<uint32_t*>(&sWh[swz<kT>(rlb, col)]) = hi;
        *reinterpret_cast<uint32_t*>(&sWl[swz<kT>(rlb, col)]) = lo;
#pragma unroll
        for (int e = 0; e < 4; ++e) wacc[n8][e] = 0.f;
      }
      __syncthreads();
      const bf16* sot = sO + (pi & 1) * kT * kN;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        ldsm_x4(a_addr<kT>(sWh, wr * 16, kk * 16, lane), ah[0], ah[1], ah[2],
                ah[3]);
        ldsm_x4(a_addr<kT>(sWl, wr * 16, kk * 16, lane), al[0], al[1], al[2],
                al[3]);
#pragma unroll
        for (int nn = 0; nn < kJ / 2; ++nn) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(bt_addr<kN>(sot, kk * 16, wc * kNH + nn * 16, lane),
                        b0, b1, b2, b3);
          mma_bf16(acc[2 * nn], ah, b0, b1);
          mma_bf16(acc[2 * nn + 1], ah, b2, b3);
          mma_bf16(acc[2 * nn], al, b0, b1);
          mma_bf16(acc[2 * nn + 1], al, b2, b3);
        }
      }
    }
    __syncthreads();   // every warp is done with this iteration's buffers
    if (k + 1 < n_iter) sv[(buf ^ 1) * 4 * kT + tid] = pre;
  }
  cp_async_wait<0>();

  bf16* out = is_c ? dC : dB;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (r ? rlb : rla);
    if (row >= d.Q) continue;
    bf16* o = out + (row0 + row) * d.N;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int n = wc * kNH + j * 8 + 2 * c4;
      if (n < d.N) o[n] = __float2bfloat16_rn(acc[j][2 * r]);
      if (n + 1 < d.N) o[n + 1] = __float2bfloat16_rn(acc[j][2 * r + 1]);
    }
  }
}

// e. cum's gradient, its reverse cumsum within the chunk, and the gradients
// of dt and A, for one head over every (batch, chunk): warp w takes the
// chunks w, w + kDtWarps, ...; a lane a run of a chunk's rows.  dcum_i =
// u_i - dt_i r_i + v_i - dw_i w_i, plus on the last row the fold's sums
// and sum_j dw_j w_j; d(dt A)_k = sum_{i >= k} dcum_i; ddt_k = r_k + rd_k +
// dw_k exp(cum_last - cum_k) + A d(dt A)_k.
__global__ void __launch_bounds__(kDtWarps * 32, 1)
    ssd_bwd_dt(const float* __restrict__ dt, const float* __restrict__ A,
               const float* __restrict__ cum_g, const float* __restrict__ rr,
               const float* __restrict__ rd, const float* __restrict__ dwv,
               const float* __restrict__ up,
               const float* __restrict__ vv, const float* __restrict__ sig,
               int n_sig, float* __restrict__ ddt, float* __restrict__ dA,
               Dims d, int BC) {
  __shared__ float part[kDtWarps];
  const int h = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float a = A[h];
  const int per = (d.Q + 31) / 32;
  const int lo = min(lane * per, d.Q), hi = min(lo + per, d.Q);
  float da = 0.f;
  for (int bc = warp; bc < BC; bc += kDtWarps) {
    const long long bch = static_cast<long long>(bc) * d.H + h;
    const long long row0 = static_cast<long long>(bc) * d.Q;
    const float* cm = cum_g + bch * d.Q;
    const float* r = rr + bch * d.Q;
    const float* r_d = rd + bch * d.Q;
    const float* dw = dwv + bch * d.Q;
    const float* v = vv + bch * d.Q;
    const float* u = up + bch * d.nt * d.Qp;
    const float last = cm[d.Q - 1];
    float s1 = 0.f;
    for (int j = lo; j < hi; ++j)
      s1 += dw[j] * (expf(last - cm[j]) * dt[(row0 + j) * d.H + h]);
    s1 = warp_sum(s1);
    float sg = 0.f;
    for (int y = 0; y < n_sig; ++y) sg += sig[bch * n_sig + y];
    auto dcum = [&](int i) -> float {
      const float dti = dt[(row0 + i) * d.H + h];
      float ui = 0.f;
      for (int t = 0; t <= i / kT; ++t) ui += u[t * d.Qp + i];
      float out = ui - dti * r[i] + v[i] - dw[i] * (expf(last - cm[i]) * dti);
      if (i == d.Q - 1) out += sg + s1;
      return out;
    };
    float tot = 0.f;
    for (int i = lo; i < hi; ++i) tot += dcum(i);
    // the rows after this lane's run: a suffix scan over the lanes
    float incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(kFull, incl, off);
      if (lane + off < 32) incl += o;
    }
    float run = incl - tot;
    for (int i = hi - 1; i >= lo; --i) {
      run += dcum(i);
      const long long at = (row0 + i) * d.H + h;
      ddt[at] = r[i] + r_d[i] + dw[i] * expf(last - cm[i]) + a * run;
      da += dt[at] * run;
    }
  }
  da = warp_sum(da);
  if (lane == 0) part[warp] = da;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int w = 0; w < kDtWarps; ++w) tot += part[w];
    dA[h] = tot;
  }
}

template <int kN>
cudaError_t launch_bwd(const bf16* x, const float* dt, const float* A,
                       const bf16* Bm, const bf16* Cm, const bf16* dy,
                       const float* dfinal, const float* cb, const float* cum,
                       const float* st, bf16* dx, float* ddt, float* dA,
                       bf16* dB, bf16* dC, float* dinit, float* gst,
                       float* sig, float* up, float* rr, float* rd,
                       float* dwv, float* vv, const Dims& d, long long B,
                       cudaStream_t s) {
  constexpr size_t kDstateBytes =
      (2 * kT * kN + 3 * kT * kPMax) * sizeof(bf16) + kQMax * sizeof(float);
  // launch c's cum and dt take the chunk's Qp rows, so two blocks fit an
  // SM at Q = 256; the opt-in is for the largest chunk
  constexpr size_t kDxFixed =
      (kT * kN + kT * kPMax + 2 * kN * kPMax + 2 * kT * kPMax) *
          sizeof(bf16) +
      (2 * kT * kTPad + 4 * kT) * sizeof(float);
  const size_t dx_bytes = kDxFixed + 2 * d.Qp * sizeof(float);
  constexpr size_t kDbcBytes =
      (4 * kT * kPMax + 2 * kT * kN + 2 * kT * kT) * sizeof(bf16) +
      (2 * 4 * kT + 2 * kT) * sizeof(float);
  static bool done_a[kMaxDevices] = {}, done_c[kMaxDevices] = {},
              done_d[kMaxDevices] = {};
  const bool vec_bc = d.N % 8 == 0 && aligned16(Bm) && aligned16(Cm);
  const bool vec_x = d.P % 8 == 0 && aligned16(x) && aligned16(dy);
  const int vec = (vec_bc ? 1 : 0) | (vec_x ? 2 : 0);
  const int BC = static_cast<int>(B * d.nc);
  const int n_sig = (d.N * d.P + kFoldThreads * kFoldPer - 1) /
                    (kFoldThreads * kFoldPer);
  cudaError_t err = allow_smem(done_a, ssd_bwd_dstate_mma<kN>, kDstateBytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_dstate_mma<kN><<<static_cast<unsigned>(d.BCH), kN * 2,
                           kDstateBytes, s>>>(dy, Cm, cum, gst, d, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 fold_grid(static_cast<unsigned>(d.BH),
                       static_cast<unsigned>(n_sig));
  ssd_bwd_fold<<<fold_grid, kFoldThreads, 0, s>>>(cum, st, dfinal, gst, sig,
                                                  dinit, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = allow_smem(done_c, ssd_bwd_dx_mma<kN>,
                   kDxFixed + 2 * kQMax * sizeof(float));
  if (err != cudaSuccess) return err;
  ssd_bwd_dx_mma<kN><<<static_cast<unsigned>(d.nt * d.BCH), 128, dx_bytes,
                       s>>>(x, dt, Bm, dy, cb, cum, gst, dx, rr, rd, dwv, up,
                            d, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = allow_smem(done_d, ssd_bwd_dbc_mma<kN>, kDbcBytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_dbc_mma<kN><<<static_cast<unsigned>(2 * BC * d.nt), 256, kDbcBytes,
                        s>>>(x, dt, Bm, Cm, dy, cum, st, gst, dB, dC, vv, d,
                             vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dt<<<static_cast<unsigned>(d.H), kDtWarps * 32, 0, s>>>(
      dt, A, cum, rr, rd, dwv, up, vv, sig, n_sig, ddt, dA, d, BC);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx [B, S, H, P] bf16; dt, ddt [B, S, H] f32; A, dA [H] f32; Bm, Cm,
// dB, dC [B, S, N] bf16; dfinal, dinit [B, H, N, P] f32, either may be null;
// the forward's scratch: cb [B, nc, Qp, Qp], cum [B, nc, H, Q], st (the
// state entering each chunk) [B, nc, H, N, P]; the backward's: gst
// [B, nc, H, N, P], sig [B, nc, H, ceil(N P / 1024)], up [B, nc, H, nt, Qp],
// rr, rd, dwv, vv [B, nc, H, Q], all f32; all contiguous, cb 16-byte
// aligned.
// The five launches in order, each reading what the earlier ones write.
// Needs S % Q == 0, Q <= 1024, N <= 128, P <= 64 (the wrapper checks).
extern "C" int ssd_scan_bwd_bf16(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* cb,
    const void* cum, const void* st, void* dx, void* ddt, void* dA, void* dB,
    void* dC, void* dinit, void* gst, void* sig, void* up, void* rr,
    void* rd, void* dwv, void* vv, long long B, long long S, long long H,
    long long P, long long N, long long Q, void* stream) {
  const Dims d = make_dims(B, S, H, P, N, Q);
  auto run = N <= 64 ? &launch_bwd<64> : &launch_bwd<128>;
  return static_cast<int>(run(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy),
      static_cast<const float*>(dfinal), static_cast<const float*>(cb),
      static_cast<const float*>(cum), static_cast<const float*>(st),
      static_cast<bf16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dA), static_cast<bf16*>(dB), static_cast<bf16*>(dC),
      static_cast<float*>(dinit), static_cast<float*>(gst),
      static_cast<float*>(sig), static_cast<float*>(up),
      static_cast<float*>(rr), static_cast<float*>(rd),
      static_cast<float*>(dwv), static_cast<float*>(vv), d, B,
      static_cast<cudaStream_t>(stream)));
}
