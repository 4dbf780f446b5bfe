// flash_attention: the prefill attention forward, causal or not, with
// grouped-query heads.  Port of repro/kernels/flash_attention.py
// (flash_attention_nhd), which ran a (batch*heads, q-block, kv-block) grid
// with the kv axis innermost and carried the online-softmax statistics
// m, l and the f32 accumulator in VMEM scratch from one kv grid step to
// the next.
//
// CUDA blocks run at the same time and in no order, so nothing can ride
// from one block to another: here ONE CTA owns a (batch, head, 64-row
// query tile) and walks the kv tiles itself, in order, with m, l and the
// accumulator in registers.  The arithmetic is the TPU kernel's:
//   s = (q . k) * scale in f32 (bf16 inputs widened exactly to f32);
//   causal: s = -1e30 where row < col, and kv tiles strictly above the
//   diagonal of the tile's last row are skipped;
//   m' = max(m, rowmax s); p = exp(s - m'); corr = exp(m - m');
//   l = l * corr + rowsum p; acc = acc * corr + cast<V>(p) . v (f32 sums);
//   out = acc / max(l, 1e-30), cast to q's dtype.
// Grouped-query attention reads kv head h / G instead of repeating K and
// V.  Ragged tiles are masked here, not padded: query rows past Sq are
// neither read nor written, and key rows past Sk load as zeros and get
// no weight (p = 0).  Any head dim D <= 128; q, k, v and o are addressed
// through their batch, sequence and head strides (unit-stride D).
//
// The design is the simple one: every operand tile is staged in shared
// memory as f32 (Q and K transposed, so one float4 holds four rows or
// four columns), and each of the 128 threads computes a 4 x 8 block of
// scores and a 4 x 16 block of the output with plain FMAs.  Bound on the
// card: at qwen2.5-3b's prefill (S=512, 16 heads, D=128, causal) the
// bytes (q, k, v, o: 4.7 MB, 1.4 us at 3.35 TB/s) and the operations
// (1.07 GFLOP, 1.1 us at the bf16 tensor-core peak) are close; this
// kernel runs on the FMA units, far from either bound.  wgmma, TMA and a
// tuned tile are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

namespace {

constexpr int kBQ = 64;              // query rows of a CTA
constexpr int kBK = 64;              // key rows of a kv tile
constexpr int kDMax = 128;           // largest head dim
constexpr int kThreads = 128;        // 16 row groups x 8 column lanes
constexpr int kRows = 4;             // query rows of a thread
constexpr int kCols = 8;             // score columns of a thread
constexpr int kDCols = kDMax / 8;    // output columns of a thread
constexpr int kPad = kBQ + 4;        // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;    // the TPU kernel's mask value

// qt[kDMax][kPad] Q^T, kt[kDMax][kPad] K^T, vs[kBK][kDMax] V,
// pt[kBK][kPad] P^T, all f32
constexpr int kSmemFloats = 2 * kDMax * kPad + kBK * kDMax + kBK * kPad;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

static_assert(kBQ == 16 * kRows && kBK == 8 * kCols, "thread layout");

struct Strides {
  long long b, s, h;
};

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
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H,
                           int G, int Sq, int Sk, int D, int n_qtiles,
                           Strides qs, Strides ks, Strides vst, Strides os,
                           float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + kDMax * kPad;
  float* vs = kt + kDMax * kPad;
  float* pt = vs + kBK * kDMax;

  const int tile = blockIdx.x % n_qtiles;
  const int bh = blockIdx.x / n_qtiles;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / G;
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 7;   // score columns tx*8.., output columns tx+8j
  const int ty = tid >> 3;  // query rows ty*4 .. ty*4+3

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vst.b + hk * vst.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    float x = 0.f;
    if (q0 + r < Sq) x = to_f32(qb[static_cast<long long>(q0 + r) * qs.s + d]);
    qt[d * kPad + r] = x;
  }

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[r][j] = 0.f;
  }

  int n_kt = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q0 + kBQ, Sq) - 1;
    n_kt = min(n_kt, last_row / kBK + 1);
  }

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kBK;
    __syncthreads();  // the last tile's readers are done (and Q is staged)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i - (i / D) * D;
      float xk = 0.f, xv = 0.f;
      if (k0 + c < Sk) {
        xk = to_f32(kb[static_cast<long long>(k0 + c) * ks.s + d]);
        xv = to_f32(vb[static_cast<long long>(k0 + c) * vst.s + d]);
      }
      kt[d * kPad + c] = xk;
      vs[c * kDMax + d] = xv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 qa =
          *reinterpret_cast<const float4*>(&qt[d * kPad + ty * kRows]);
      const float4 k_lo =
          *reinterpret_cast<const float4*>(&kt[d * kPad + tx * kCols]);
      const float4 k_hi =
          *reinterpret_cast<const float4*>(&kt[d * kPad + tx * kCols + 4]);
      const float qv[kRows] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[kCols] = {k_lo.x, k_lo.y, k_lo.z, k_lo.w,
                               k_hi.x, k_hi.y, k_hi.z, k_hi.w};
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
        float x = s[r][c] * scale;
        if (causal && row < col) x = kNegInf;
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
        const float p = expf(s[r][c] - m_new);
        s[r][c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * corr[r] + rs;
      m[r] = m_new;
    }
    // P^T, cast to V's dtype as the TPU kernel casts p before P.V
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float4 p4;
      p4.x = to_f32(from_f32<T>(s[0][c]));
      p4.y = to_f32(from_f32<T>(s[1][c]));
      p4.z = to_f32(from_f32<T>(s[2][c]));
      p4.w = to_f32(from_f32<T>(s[3][c]));
      *reinterpret_cast<float4*>(&pt[(tx * kCols + c) * kPad + ty * kRows]) =
          p4;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[r][j] *= corr[r];
    for (int c = 0; c < kBK; ++c) {
      const float4 pa =
          *reinterpret_cast<const float4*>(&pt[c * kPad + ty * kRows]);
      const float pv[kRows] = {pa.x, pa.y, pa.z, pa.w};
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
    if (row >= Sq) continue;
    T* orow = o + b * os.b + h * os.h + static_cast<long long>(row) * os.s;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      const int d = tx + 8 * j;
      if (d < D) orow[d] = from_f32<T>(acc[r][j] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, long long B,
           long long H, long long KV, long long Sq, long long Sk, long long D,
           const long long* st, double scale, long long causal,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_qtiles = (Sq + kBQ - 1) / kBQ;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  flash_attention_kernel<T>
      <<<static_cast<unsigned>(n_qtiles * B * H), kThreads, kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), static_cast<int>(H),
          static_cast<int>(H / KV), static_cast<int>(Sq),
          static_cast<int>(Sk), static_cast<int>(D),
          static_cast<int>(n_qtiles), qs, ks, vs, os,
          static_cast<float>(scale), static_cast<int>(causal));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, KV, D], o [B, Sq, H, D]; ``strides`` holds
// the (batch, seq, head) strides of q, k, v and o, in elements.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, long long B,
                                   long long H, long long KV, long long Sq,
                                   long long Sk, long long D,
                                   const void* strides, double scale,
                                   long long causal, void* stream) {
  return launch<float>(q, k, v, o, B, H, KV, Sq, Sk, D,
                       static_cast<const long long*>(strides), scale, causal,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, long long B,
                                    long long H, long long KV, long long Sq,
                                    long long Sk, long long D,
                                    const void* strides, double scale,
                                    long long causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, D,
                               static_cast<const long long*>(strides), scale,
                               causal, stream);
}
