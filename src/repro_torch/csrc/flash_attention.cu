// flash_attention: the prefill attention forward, causal or not, with
// grouped-query heads.  Port of repro/kernels/flash_attention.py
// (flash_attention_nhd), which ran a (batch*heads, q-block, kv-block) grid
// with the kv axis innermost and carried the online-softmax statistics
// m, l and the f32 accumulator in VMEM scratch from one kv grid step to
// the next.
//
// CUDA blocks run at the same time and in no order, so nothing can ride
// from one block to another: ONE CTA owns a (batch, head, query tile)
// and walks the kv tiles itself, in order, with m, l and the accumulator
// in registers.  The arithmetic is the TPU kernel's:
//   s = (q . k) * scale in f32 (bf16 products are exact in f32);
//   causal: s = -1e30 where row < col, and kv tiles strictly above the
//   diagonal of the tile's last row are skipped;
//   m' = max(m, rowmax s); p = exp(s - m'); corr = exp(m - m');
//   l = l * corr + rowsum p; acc = acc * corr + cast<V>(p) . v (f32 sums);
//   out = acc / max(l, 1e-30), cast to q's dtype.
// Grouped-query attention reads kv head h / G instead of repeating K and
// V.  Ragged tiles are masked here, not padded: query rows past Sq are
// never stored, key rows past Sk load as zeros and get no weight (p = 0).
// Any head dim D <= 256; q, k, v and o are addressed through their batch,
// sequence and head strides (unit-stride D).
//
// bf16 (every serving prefill and training forward): FlashAttention-2's
// shape on the tensor cores.  Bound on the card: at qwen2.5-3b's prefill
// (S=512, 16 heads, D=128, causal) the bytes (4.7 MB, 1.4 us at 3.35
// TB/s) and the operations (1.07 GFLOP, 1.1 us at the bf16 tensor-core
// peak) are close; at S=2048 the operations bound it (17 GFLOP).  Design:
//  - a CTA of 4 warps takes a 64-row query tile, 16 rows a warp, and
//    walks 64-row kv tiles; both products run on the tensor cores as
//    mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (bf16 operands,
//    f32 sums: exactly the products the TPU kernel asks for);
//  - Q, K and V stay bf16 in shared memory, each row's 16-byte chunks
//    XOR-swizzled by (row & 7), so ldmatrix (ldmatrix.trans for V) reads
//    them without bank conflicts; the head dim is padded to 64, 128 or
//    256 and the padded columns load as zeros and are never stored;
//  - K and V arrive through 16-byte cp.async.cg copies into a two-stage
//    ring: the next kv tile loads while the current one computes;
//  - the online softmax runs on the S accumulator fragments (a row's max
//    and sum over its quad of threads: two shuffles), and P is rounded to
//    bf16 pairs in registers and fed straight back as the A operand of
//    P.V: FlashAttention-2's register reuse, and the TPU kernel's
//    rounding point for p;
//  - only tiles on the diagonal or the ragged edge are masked; causal
//    grids schedule the heaviest query tiles first;
//  - Q is ldmatrix'd from shared memory at every k-step (at D=256 the
//    accumulators alone take 128 registers a thread); the output is
//    staged through Q's shared memory and written with 16-byte stores.
//  Shared memory: (64 + 2 x 2 x 64) rows x D_pad x 2 bytes = 40, 80 or
//  160 KB, so 2 CTAs fit on an SM at D <= 128 and one at D = 256.
//
// f32 (the model and train checks only): the FMA design of the first
// port, every tile staged in shared memory as f32 (Q and K transposed)
// and each of 128 threads computing a kRows x 8 block of scores; a
// 64-row query tile for D <= 128 and a 32-row one for D <= 256 (181 KB of
// shared memory).  TF32 tensor cores keep ~3 decimal digits, too few for
// the f32 route's 2e-4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using namespace repro_torch;

constexpr int kBK = 64;              // key rows of a kv tile
constexpr int kThreads = 128;        // 4 warps
constexpr float kNegInf = -1e30f;    // the TPU kernel's mask value

struct Strides {
  long long b, s, h;
};

struct Problem {
  int H, G, Sq, Sk, D, n_qtiles, BH, causal;
  Strides qs, ks, vs, os;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;              // query rows of a CTA (16 a warp)

// Byte offsets, in a swizzled [rows][kD] tile, of the 16-byte chunks
// 2j + c0 (j < 4) of row ``row``, whose low three bits are this lane's
// (lane & 7).  Every row an ldmatrix lane addresses here is such a row
// plus a multiple of 8, so the swizzle of chunk 8i + 2j + c0 of row
// row + 8t is fixed per lane: off[j] + i * 128 + t * 8 * kD * 2 bytes, the
// rest of every address a compile-time constant.
template <int kD>
__device__ __forceinline__ void lane_offsets(uint32_t* off, int row, int c0,
                                             int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    off[j] = (row * kD + (((2 * j + c0) ^ lane) & 7) * 8) * 2;
}

// Chunk (r, c) of a tile: see load_tile.
template <int kD>
__device__ __forceinline__ void load_chunk(bf16* sm, const bf16* g,
                                           const bf16* src, int r, int c,
                                           bool ok_row, int D, bool vec) {
  bf16* dst = sm + swz<kD>(r, c);
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

// One [64][kD] tile, rows [0, n_valid) and columns [0, D) of g (row
// stride rs elements), into the swizzled tile sm.  vec: D % 8 == 0 and
// every row 16-byte aligned, so each 16-byte chunk is one cp.async (the
// chunks past D or n_valid copy 0 bytes: zero fill); otherwise masked
// element loads, zero-filled, stored as one 16-byte chunk.
template <int kD>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g,
                                          long long rs, int n_valid, int D,
                                          bool vec, int tid) {
  constexpr int kChunks = kD / 8;
  constexpr int kStep = kThreads / kChunks;   // rows between its chunks
  const int c = (tid % kChunks) * 8;          // this thread's column
  const int r0 = tid / kChunks;
  const bf16* src = g + r0 * rs + c;
  if constexpr (kD <= 128) {
#pragma unroll
    for (int i = 0; i < 64 / kStep; ++i) {
      const int r = r0 + i * kStep;
      load_chunk<kD>(sm, g, src + i * kStep * rs, r, c, r < n_valid, D, vec);
    }
  } else {
    // not unrolled: unrolled, each chunk's address offset was hoisted
    // out of the kv loop into registers of its own, and D=256 spilled
    const long long step = kStep * rs;
#pragma unroll 1
    for (int r = r0; r < 64; r += kStep, src += step)
      load_chunk<kD>(sm, g, src, r, c, r < n_valid, D, vec);
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel_mma(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ o, Problem p, int vec) {
  constexpr int kN = kD / 8;         // 8-column output tiles of a warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][kD]
  bf16* sk = sq + kBQ * kD;                       // [2][kBK][kD]
  bf16* sv = sk + 2 * kBK * kD;                   // [2][kBK][kD]

  // causal: the heaviest query tiles (most kv tiles) are handed out first
  const int t_lin = blockIdx.x / p.BH;
  const int tile = p.causal ? p.n_qtiles - 1 - t_lin : t_lin;
  const int bh = blockIdx.x % p.BH;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = p.D, Sk = p.Sk;

  const bf16* qb = q + b * p.qs.b + h * p.qs.h + q0 * p.qs.s;
  const bf16* kb = k + b * p.ks.b + hk * p.ks.h;
  const bf16* vb = v + b * p.vs.b + hk * p.vs.h;
  const bool vq = vec & 1, vk = vec & 2, vv = vec & 4, vo = vec & 8;

  int n_kt = (Sk + kBK - 1) / kBK;
  if (p.causal) {
    const int last_row = min(q0 + kBQ, p.Sq) - 1;
    n_kt = min(n_kt, last_row / kBK + 1);
  }

  load_tile<kD>(sq, qb, p.qs.s, p.Sq - q0, D, vq, tid);
  load_tile<kD>(sk, kb, p.ks.s, Sk, D, vk, tid);
  load_tile<kD>(sv, vb, p.vs.s, Sk, D, vv, tid);
  cp_async_commit();

  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this thread's two rows (g and g + 8 of the warp's 16): running max and
  // its own share of the row sum (the quad's shares add up at the end)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int g = lane >> 2, c4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  // ldmatrix rows and chunks of this lane: A (Q) and B (K)
  // non-transposed, B (V) transposed
  uint32_t q_off[4], k_off[4], v_off[4];
  lane_offsets<kD>(q_off, warp * 16 + (lane & 15), lane >> 4, lane);
  lane_offsets<kD>(k_off, (lane >> 4) * 8 + (lane & 7), (lane >> 3) & 1,
                   lane);
  lane_offsets<kD>(v_off, (lane & 7) + ((lane >> 3) & 1) * 8, lane >> 4,
                   lane);
  const uint32_t sq_a = smem_addr(sq);

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kBK;
    const int st = it & 1;
    if (it + 1 < n_kt) {
      const int k1 = k0 + kBK;
      load_tile<kD>(sk + (st ^ 1) * kBK * kD, kb + k1 * p.ks.s, p.ks.s,
                    Sk - k1, D, vk, tid);
      load_tile<kD>(sv + (st ^ 1) * kBK * kD, vb + k1 * p.vs.s, p.vs.s,
                    Sk - k1, D, vv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this tile's group has landed
    __syncthreads();
    const uint32_t kt_a = smem_addr(sk + st * kBK * kD);
    const uint32_t vt_a = smem_addr(sv + st * kBK * kD);

    // S = Q K^T: 16 rows x 64 keys a warp, as 8 tiles of 16 x 8
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(sq_a + q_off[kk & 3] + (kk >> 2) * 128, a[0], a[1], a[2],
              a[3]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(kt_a + k_off[kk & 3] + (kk >> 2) * 128 + nn * 16 * kD * 2,
                b0, b1, b2, b3);
        mma_bf16(s[2 * nn], a, b0, b1);
        mma_bf16(s[2 * nn + 1], a, b2, b3);
      }
    }

    // scale; mask only the tiles on the diagonal or the ragged edge
    const bool masked = (p.causal && k0 + kBK - 1 > q0) || k0 + kBK > Sk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (masked) {
          const int col = k0 + j * 8 + 2 * c4 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (p.causal && row < col) x = kNegInf;
          if (col >= Sk) x = -INFINITY;   // ragged tail: no weight at all
        }
        s[j][e] = x;
      }

    // online softmax on the fragments: a row lives in one quad of lanes
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = __expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = __expf(s[j][2 * r] - m_new);
        const float p1 = __expf(s[j][2 * r + 1] - m_new);
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        rs += p0 + p1;
      }
      l[r] = l[r] * corr[r] + rs;
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: P (bf16, from registers) is the A operand, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nn = 0; nn < kN / 2; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(
            vt_a + v_off[nn & 3] + (nn >> 2) * 128 + kk * 16 * kD * 2, b0,
            b1, b2, b3);
        mma_bf16(acc[2 * nn], a, b0, b1);
        mma_bf16(acc[2 * nn + 1], a, b2, b3);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-30), staged in this warp's own rows of Q's tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + r * 8;
      *reinterpret_cast<uint32_t*>(sq + swz<kD>(row, n * 8 + 2 * c4)) =
          pack_bf16(acc[n][2 * r] / l[r], acc[n][2 * r + 1] / l[r]);
    }
  __syncwarp();
  bf16* ob = o + b * p.os.b + h * p.os.h;
  for (int idx = lane; idx < 16 * (kD / 8); idx += 32) {
    const int r = idx / (kD / 8);
    const int c = (idx % (kD / 8)) * 8;
    const int row = q0 + warp * 16 + r;
    if (row >= p.Sq || c >= D) continue;
    const bf16* src = sq + swz<kD>(warp * 16 + r, c);
    bf16* dst = ob + row * p.os.s + c;
    if (vo) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && c + j < D; ++j) dst[j] = src[j];
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

// kDMax: the largest head dim; kRows: query rows of a thread (the CTA's
// 16 row groups x 8 column lanes give a 16 * kRows-row query tile)
template <int kDMax, int kRows>
struct F32Tile {
  static constexpr int kBQ = 16 * kRows;
  static constexpr int kCols = 8;               // score columns a thread
  static constexpr int kDCols = kDMax / 8;      // output columns a thread
  static constexpr int kPadQ = kBQ + 4;         // row stride of Q^T, P^T
  static constexpr int kPadK = kBK + 4;         // row stride of K^T
  // qt[kDMax][kPadQ] Q^T, kt[kDMax][kPadK] K^T, vs[kBK][kDMax] V,
  // pt[kBK][kPadQ] P^T
  static constexpr int kFloats =
      kDMax * kPadQ + kDMax * kPadK + kBK * kDMax + kBK * kPadQ;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int kDMax, int kRows>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel_fma(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, Problem p) {
  using C = F32Tile<kDMax, kRows>;
  constexpr int kBQf = C::kBQ, kCols = C::kCols, kDCols = C::kDCols;
  constexpr int kPadQ = C::kPadQ, kPadK = C::kPadK;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + kDMax * kPadQ;
  float* vs = kt + kDMax * kPadK;
  float* pt = vs + kBK * kDMax;

  const int t_lin = blockIdx.x / p.BH;
  const int tile = p.causal ? p.n_qtiles - 1 - t_lin : t_lin;
  const int bh = blockIdx.x % p.BH;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = tile * kBQf;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 7;   // score columns tx*8.., output columns tx+8j
  const int ty = tid >> 3;  // query rows ty*kRows ..
  const int D = p.D, Sk = p.Sk;

  const float* qb = q + b * p.qs.b + h * p.qs.h;
  const float* kb = k + b * p.ks.b + hk * p.ks.h;
  const float* vb = v + b * p.vs.b + hk * p.vs.h;

  // a warp loads 32 consecutive columns of one row at a time
  for (int r = warp; r < kBQf; r += kThreads / 32)
    for (int d = lane; d < D; d += 32)
      qt[d * kPadQ + r] =
          q0 + r < p.Sq ? qb[static_cast<long long>(q0 + r) * p.qs.s + d]
                        : 0.f;

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[r][j] = 0.f;
  }

  int n_kt = (Sk + kBK - 1) / kBK;
  if (p.causal) {
    const int last_row = min(q0 + kBQf, p.Sq) - 1;
    n_kt = min(n_kt, last_row / kBK + 1);
  }

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kBK;
    __syncthreads();  // the last tile's readers are done (and Q is staged)
    for (int c = warp; c < kBK; c += kThreads / 32) {
      const bool ok = k0 + c < Sk;
      const long long ks = static_cast<long long>(k0 + c) * p.ks.s;
      const long long vsr = static_cast<long long>(k0 + c) * p.vs.s;
      for (int d = lane; d < D; d += 32) {
        kt[d * kPadK + c] = ok ? kb[ks + d] : 0.f;
        vs[c * kDMax + d] = ok ? vb[vsr + d] : 0.f;
      }
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = qt[d * kPadQ + ty * kRows + r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = kt[d * kPadK + tx * kCols + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

    // scale, mask, and the online-softmax update of this tile
    float corr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + ty * kRows + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = k0 + tx * kCols + c;
        float x = s[r][c] * p.scale;
        if (p.causal && row < col) x = kNegInf;
        if (col >= Sk) x = -INFINITY;  // ragged tail: no weight at all
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float pc = expf(s[r][c] - m_new);
        s[r][c] = pc;
        rs += pc;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * corr[r] + rs;
      m[r] = m_new;
    }
    // P^T (V is f32: the TPU kernel's cast of p to v's dtype is exact)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pt[(tx * kCols + c) * kPadQ + ty * kRows + r] = s[r][c];
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[r][j] *= corr[r];
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = pt[c * kPadQ + ty * kRows + r];
#pragma unroll
      for (int j = 0; j < kDCols; ++j) {
        if (tx + 8 * j < D) {
          const float vv = vs[c * kDMax + tx + 8 * j];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][j] = fmaf(pv[r], vv, acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty * kRows + r;
    if (row >= p.Sq) continue;
    float* orow = o + b * p.os.b + h * p.os.h +
                  static_cast<long long>(row) * p.os.s;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      const int d = tx + 8 * j;
      if (d < D) orow[d] = acc[r][j] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

Problem make_problem(long long B, long long H, long long KV, long long Sq,
                     long long Sk, long long D, long long bq,
                     const long long* st, double scale, long long causal) {
  Problem p;
  p.H = static_cast<int>(H);
  p.G = static_cast<int>(H / KV);
  p.Sq = static_cast<int>(Sq);
  p.Sk = static_cast<int>(Sk);
  p.D = static_cast<int>(D);
  p.n_qtiles = static_cast<int>((Sq + bq - 1) / bq);
  p.BH = static_cast<int>(B * H);
  p.causal = causal ? 1 : 0;
  p.qs = Strides{st[0], st[1], st[2]};
  p.ks = Strides{st[3], st[4], st[5]};
  p.vs = Strides{st[6], st[7], st[8]};
  p.os = Strides{st[9], st[10], st[11]};
  p.scale = static_cast<float>(scale);
  return p;
}

// 16-byte chunks of a [.., .., .., D] bf16 tensor start 16-byte aligned
bool chunks_aligned(const void* ptr, const long long* st, long long D) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 && D % 8 == 0 &&
         st[0] % 8 == 0 && st[1] % 8 == 0 && st[2] % 8 == 0;
}

template <int kD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               const Problem& p, int vec, void* stream) {
  constexpr size_t kBytes = (kBQ + 4 * kBK) * kD * sizeof(bf16);
  static bool done[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(done, flash_attention_kernel_mma<kD>, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_kernel_mma<kD>
      <<<static_cast<unsigned>(p.n_qtiles * p.BH), kThreads, kBytes,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o), p, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int kDMax, int kRows>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               const Problem& p, void* stream) {
  constexpr size_t kBytes = F32Tile<kDMax, kRows>::kBytes;
  static bool done[kMaxDevices] = {};
  cudaError_t err = allow_smem(
      done, flash_attention_kernel_fma<kDMax, kRows>, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_kernel_fma<kDMax, kRows>
      <<<static_cast<unsigned>(p.n_qtiles * p.BH), kThreads, kBytes,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, KV, D], o [B, Sq, H, D]; ``strides`` holds
// the (batch, seq, head) strides of q, k, v and o, in elements.  D <= 256
// (the wrapper checks); returns cudaErrorInvalidValue above.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, long long B,
                                   long long H, long long KV, long long Sq,
                                   long long Sk, long long D,
                                   const void* strides, double scale,
                                   long long causal, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  if (D <= 128)
    return launch_fma<128, 4>(
        q, k, v, o,
        make_problem(B, H, KV, Sq, Sk, D, F32Tile<128, 4>::kBQ, st, scale,
                     causal),
        stream);
  if (D <= 256)
    return launch_fma<256, 2>(
        q, k, v, o,
        make_problem(B, H, KV, Sq, Sk, D, F32Tile<256, 2>::kBQ, st, scale,
                     causal),
        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, long long B,
                                    long long H, long long KV, long long Sq,
                                    long long Sk, long long D,
                                    const void* strides, double scale,
                                    long long causal, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  const Problem p =
      make_problem(B, H, KV, Sq, Sk, D, kBQ, st, scale, causal);
  const int vec = (chunks_aligned(q, st, D) ? 1 : 0) |
                  (chunks_aligned(k, st + 3, D) ? 2 : 0) |
                  (chunks_aligned(v, st + 6, D) ? 4 : 0) |
                  (chunks_aligned(o, st + 9, D) ? 8 : 0);
  if (D <= 64) return launch_mma<64>(q, k, v, o, p, vec, stream);
  if (D <= 128) return launch_mma<128>(q, k, v, o, p, vec, stream);
  if (D <= 256) return launch_mma<256>(q, k, v, o, p, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
