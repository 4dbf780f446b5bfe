// ssd_scan: the Mamba-2 SSD chunked scan of every Mamba layer's prefill.
// Port of repro/kernels/ssd_scan.py (ssd_scan_pallas), which ran a
// (batch, chunk) grid with the chunks innermost, carried the [H, N, P]
// inter-chunk state in VMEM scratch from one grid step to the next (zeroed
// at chunk 0), and looped over the heads inside a step with the chunk's
// C.B^T shared across them.
//
// CUDA blocks run at the same time and in no order, so the carry cannot
// ride across blocks: here ONE CTA owns a (batch, head) and walks the
// chunks itself, in order, with that head's [N, P] state in shared memory
// (128 x 64 f32 = 32 KB at mamba2-780m's width; all heads' 1.5 MB would
// not fit).  The state starts from ``init`` when one is given (zeros
// otherwise) and is written to ``final`` after the last chunk when asked:
// a serving prefill carries it into decode.  Per chunk of Q rows, all in
// f32 (bf16 inputs widened exactly):
//   dA = dt * A; cum = inclusive cumsum of dA over the chunk;
//   y[i] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) (C_i . state), cast to x's dtype;
//   state = exp(cum_last) state
//           + sum_j B_j^T (x_j exp(cum_last - cum_j) dt_j).
// Only j <= i is evaluated, so exp(cum_i - cum_j) never sees a positive
// exponent (cum falls: dt > 0, A < 0) and no inf is formed.
//
// The Q x Q decay-weighted matrix of one head (256 x 256 f32 = 256 KB)
// does not fit in shared memory, so the chunk is tiled by 64 query rows
// and, for each query tile, by the 64-row key tiles at or below its
// diagonal: a tile pair computes its C.B^T block, weights and masks it,
// and multiplies it into the tile's output at once.  C.B^T is thus
// recomputed by every head's CTA (the TPU kernel computed it once per
// chunk): at the prefill shape (Q 256, N 128, 48 heads) that is half of
// the kernel's multiply-adds, the price of needing no second launch and no
// scratch in device memory.  The P axis is not split across CTAs (48 CTAs
// at B = 1 on 132 SMs): splitting it would repeat C.B^T per tile as well.
//
// Bound on the card: at the prefill shape (B 1, S 512, H 48, P 64, N 128)
// the work the scan needs is ~0.6 G multiply-adds (18 us at the f32 peak)
// against ~10 MB moved (3 us): operations.  This first kernel runs on the
// FMA units over f32 shared-memory tiles, far from that; tensor-core
// (mma/wgmma) tiles and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kT = 64;              // rows of a query tile and of a key tile
constexpr int kNMax = 128;          // largest d_state
constexpr int kPMax = 64;           // largest head dim
constexpr int kQMax = 1024;         // largest chunk
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kTPad = kT + 4;       // row stride of the transposed tiles
constexpr int kBsPad = kNMax + 4;   // row stride of B in the state update

// st[kNMax][kPMax] state; ct[kNMax][kTPad] C^T of the query tile;
// bt[kNMax][kTPad] B^T of the key tile (the state update reuses it as
// bs[kT][kBsPad]); xs[kT][kPMax] x of the key tile; sc[kT][kTPad] the
// weighted block, transposed (sc[j][i]); cum[kQMax], dtv[kQMax]
constexpr int kSmemFloats = kNMax * kPMax + 2 * kNMax * kTPad + kT * kPMax +
                            kT * kTPad + 2 * kQMax;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

static_assert(kT == 16 * 4 && kPMax == 16 * 4 && kNMax == 16 * 8,
              "thread layout");
static_assert(kT * kBsPad <= kNMax * kTPad, "bs fits in bt");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ init,
                    T* __restrict__ y, float* __restrict__ final_state, int S,
                    int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;
  float* ct = st + kNMax * kPMax;
  float* bt = ct + kNMax * kTPad;
  float* bs = bt;
  float* xs = bt + kNMax * kTPad;
  float* sc = xs + kT * kPMax;
  float* cum = sc + kT * kTPad;
  float* dtv = cum + kQMax;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float a_h = A[h];
  const long long row0 = static_cast<long long>(b) * S;  // first (b, s) row
  const long long state0 = (static_cast<long long>(b) * H + h) * N * P;

  for (int i = tid; i < kNMax * kPMax; i += kThreads) {
    const int n = i / kPMax, p = i % kPMax;
    st[i] = (init != nullptr && n < N && p < P) ? init[state0 + n * P + p]
                                                 : 0.f;
  }

  const int n_chunks = S / Q;
  const int n_tiles = (Q + kT - 1) / kT;
  for (int c = 0; c < n_chunks; ++c) {
    const long long s0 = row0 + static_cast<long long>(c) * Q;
    __syncthreads();  // the last chunk's readers of cum/dtv/state are done
    for (int i = tid; i < Q; i += kThreads) dtv[i] = dt[(s0 + i) * H + h];
    __syncthreads();
    if (tid < 32) {  // cum: a lane's run of rows, then a warp scan
      const int per = (Q + 31) / 32;
      const int lo = min(tid * per, Q), hi = min(lo + per, Q);
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

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int i0 = qt * kT;
      __syncthreads();  // cum is written; the last tile's readers are done
      for (int k = tid; k < kT * N; k += kThreads) {
        const int r = k / N, n = k % N;
        ct[n * kTPad + r] =
            i0 + r < Q ? to_f32(Cm[(s0 + i0 + r) * N + n]) : 0.f;
      }
      __syncthreads();

      // the carried state's term: exp(cum_i) (C_i . state)
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(
            &ct[n * kTPad + ty * 4]);
        const float4 sv = *reinterpret_cast<const float4*>(
            &st[n * kPMax + tx * 4]);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][q] = fmaf(ca[r], sa[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        const float e = i < Q ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= e;
      }

      // the chunk's own rows: key tiles at or below the diagonal
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * kT;
        __syncthreads();  // the last pair's readers of bt/xs/sc are done
        for (int k = tid; k < kT * N; k += kThreads) {
          const int r = k / N, n = k % N;
          bt[n * kTPad + r] =
              j0 + r < Q ? to_f32(Bm[(s0 + j0 + r) * N + n]) : 0.f;
        }
        for (int k = tid; k < kT * kPMax; k += kThreads) {
          const int r = k / kPMax, p = k % kPMax;
          xs[k] = (j0 + r < Q && p < P)
                      ? to_f32(x[((s0 + j0 + r) * H + h) * P + p])
                      : 0.f;
        }
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(
              &ct[n * kTPad + ty * 4]);
          const float4 bv = *reinterpret_cast<const float4*>(
              &bt[n * kTPad + tx * 4]);
          const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
          const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              s[r][q] = fmaf(ca[r], ba[q], s[r][q]);
        }
        // weight (cb * decay * dt, the reference's order) and mask; store
        // transposed so the product below reads four rows as one float4
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + tx * 4 + q;
          float w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty * 4 + r;
            w[r] = (j <= i && i < Q)
                       ? s[r][q] * expf(cum[i] - cum[j]) * dtv[j]
                       : 0.f;
          }
          *reinterpret_cast<float4*>(&sc[(tx * 4 + q) * kTPad + ty * 4]) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();
        const int jn = min(kT, Q - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const float4 wv = *reinterpret_cast<const float4*>(
              &sc[jj * kTPad + ty * 4]);
          const float4 xv = *reinterpret_cast<const float4*>(
              &xs[jj * kPMax + tx * 4]);
          const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[r][q] = fmaf(wa[r], xa[q], acc[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i >= Q) continue;
        T* yrow = y + ((s0 + i) * H + h) * P;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx * 4 + q;
          if (p < P) yrow[p] = from_f32<T>(acc[r][q]);
        }
      }
    }

    // the state for the next chunk; every y of this chunk has read the old
    // one (the syncs of the key-tile loop follow the last read)
    const float last = cum[Q - 1];
    float sacc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) sacc[r][q] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int j0 = kt * kT;
      __syncthreads();
      for (int k = tid; k < kT * kNMax; k += kThreads) {
        const int r = k / kNMax, n = k % kNMax;
        bs[r * kBsPad + n] = (j0 + r < Q && n < N)
                                 ? to_f32(Bm[(s0 + j0 + r) * N + n])
                                 : 0.f;
      }
      for (int k = tid; k < kT * kPMax; k += kThreads) {
        const int r = k / kPMax, p = k % kPMax;
        const int j = j0 + r;
        xs[k] = (j < Q && p < P)
                    ? to_f32(x[((s0 + j) * H + h) * P + p]) *
                          (expf(last - cum[j]) * dtv[j])
                    : 0.f;
      }
      __syncthreads();
      const int jn = min(kT, Q - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float4 b_lo = *reinterpret_cast<const float4*>(
            &bs[jj * kBsPad + ty * 8]);
        const float4 b_hi = *reinterpret_cast<const float4*>(
            &bs[jj * kBsPad + ty * 8 + 4]);
        const float4 xv = *reinterpret_cast<const float4*>(
            &xs[jj * kPMax + tx * 4]);
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
    const float decay = expf(last);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float* sp = &st[(ty * 8 + r) * kPMax + tx * 4 + q];
        *sp = *sp * decay + sacc[r][q];  // each element has one owner
      }
  }

  if (final_state != nullptr) {
    __syncthreads();
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P, p = i % P;
      final_state[state0 + i] = st[n * kPMax + p];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* final_state,
           long long B, long long S, long long H, long long P, long long N,
           long long Q, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<static_cast<unsigned>(B * H), kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(final_state),
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(P),
      static_cast<int>(N), static_cast<int>(Q));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y [B, S, H, P]; dt [B, S, H] f32; A [H] f32; Bm, Cm [B, S, N];
// init, final_state [B, H, N, P] f32, either may be null; all contiguous.
// Needs S % Q == 0, Q <= 1024, N <= 128, P <= 64 (the wrapper checks).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* init,
                            void* y, void* final_state, long long B,
                            long long S, long long H, long long P, long long N,
                            long long Q, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, init, y, final_state, B, S, H, P, N,
                       Q, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* init,
                             void* y, void* final_state, long long B,
                             long long S, long long H, long long P,
                             long long N, long long Q, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, final_state, B, S,
                               H, P, N, Q, stream);
}
