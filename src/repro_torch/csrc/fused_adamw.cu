// fused_adamw: one AdamW step on one parameter leaf, with the versioned
// ring write fused in.  Port of repro/kernels/fused_adamw.py
// (fused_adamw_flat), which tiled the flattened leaf in 2048-element
// BlockSpecs (the wrapper picked a tile that divides n), read lr, scale
// and the bias corrections b1c, b2c as prefetched scalars, and wrote
// p' twice while it was resident in VMEM: into the live parameter and
// into ring row ``slot`` (ring aliased in -> out, the other rows never
// moved).
//
// Here it is one elementwise pass over n elements: a grid-stride loop
// with 64-bit offsets (the largest leaf, qwen2.5-3b's stacked FFN weight,
// is 811,597,824 elements) masks the ragged tail itself, so n needs no
// tile that divides it and no padding.  lr, scale, b1c, b2c and the ring
// slot are read from device memory, as the TPU kernel read its prefetched
// scalars, so the step that computes them (from the gradients' global
// norm) never waits for the host.  The arithmetic is the TPU kernel's, in
// its order, every operation rounded on its own (the _rn intrinsics keep
// nvcc from contracting a multiply and an add into one FMA, so the result
// is the plain PyTorch version's bit for bit):
//   g = g * scale;  m' = b1 m + (1 - b1) g;  v' = b2 v + ((1 - b2) g) g;
//   step = (m' / b1c) / (sqrt(v' / b2c) + eps) + wd p;  p' = p - lr step;
// with p and g widened to f32 exactly.  m' and v' are written over m and
// v in place; p' goes to p_out (a new tensor: readers of the old live
// block keep it whole) and, when a ring is given, to ring row ``slot`` in
// place.  p and the ring are bf16 or f32 alike; g is bf16 or f32 and is
// widened in registers, so the trainer hands the bf16 gradient over as
// autograd made it.
//
// Bound on the card: bytes.  Each element reads p, g (2 B each in bf16),
// m and v (4 B each) and writes p', m', v' and the ring row: 24 B per
// bf16 parameter, 81.6 GB for qwen2.5-3b's 3.40 B parameters, 24.4 ms a
// step at 3.35 TB/s.  The loop does 2-byte and 4-byte loads, coalesced
// across the warp; vector loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename P, typename G>
__global__ void fused_adamw_kernel(const P* __restrict__ p,
                                   const G* __restrict__ g,
                                   float* __restrict__ m,
                                   float* __restrict__ v,
                                   P* __restrict__ p_out, P* ring,
                                   const int64_t* __restrict__ slot,
                                   const float* __restrict__ scalars,
                                   int64_t n, float b1, float one_minus_b1,
                                   float b2, float one_minus_b2, float eps,
                                   float wd) {
  const float lr = scalars[0];
  const float scale = scalars[1];
  const float b1c = scalars[2];
  const float b2c = scalars[3];
  P* row = ring == nullptr ? nullptr : ring + slot[0] * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const float gi = __fmul_rn(widen(g[i]), scale);
    const float mi =
        __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(one_minus_b1, gi));
    const float vi = __fadd_rn(__fmul_rn(b2, v[i]),
                               __fmul_rn(__fmul_rn(one_minus_b2, gi), gi));
    const float pi = widen(p[i]);
    const float upd = __fadd_rn(
        __fdiv_rn(__fdiv_rn(mi, b1c),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, b2c)), eps)),
        __fmul_rn(wd, pi));
    const P out = narrow<P>(__fsub_rn(pi, __fmul_rn(lr, upd)));
    m[i] = mi;
    v[i] = vi;
    p_out[i] = out;
    if (row != nullptr) row[i] = out;
  }
}

template <typename P, typename G>
int launch(const void* p, const void* g, void* m, void* v, void* p_out,
           void* ring, const void* slot, const void* scalars, long long n,
           double b1, double b2, double eps, double wd, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_adamw_kernel<P, G>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const P*>(p), static_cast<const G*>(g),
          static_cast<float*>(m), static_cast<float*>(v),
          static_cast<P*>(p_out), static_cast<P*>(ring),
          static_cast<const int64_t*>(slot),
          static_cast<const float*>(scalars), n, static_cast<float>(b1),
          static_cast<float>(1.0 - b1), static_cast<float>(b2),
          static_cast<float>(1.0 - b2), static_cast<float>(eps),
          static_cast<float>(wd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p, p_out [n] and ring [R, n] (or null) of the parameter type; g [n] of
// the gradient type; m, v [n] f32, updated in place; slot int64 [1] and
// scalars f32 [4] = (lr, scale, b1c, b2c) on the device.  The constants
// arrive as doubles, and 1 - b1, 1 - b2 are taken in double before the
// cast to f32, as the reference folds its Python-float constants.
#define FUSED_ADAMW_ENTRY(NAME, P, G)                                       \
  extern "C" int NAME(const void* p, const void* g, void* m, void* v,       \
                      void* p_out, void* ring, const void* slot,            \
                      const void* scalars, long long n, double b1,          \
                      double b2, double eps, double wd, void* stream) {     \
    return launch<P, G>(p, g, m, v, p_out, ring, slot, scalars, n, b1, b2,  \
                        eps, wd, stream);                                   \
  }

FUSED_ADAMW_ENTRY(fused_adamw_f32_f32, float, float)
FUSED_ADAMW_ENTRY(fused_adamw_f32_bf16, float, __nv_bfloat16)
FUSED_ADAMW_ENTRY(fused_adamw_bf16_f32, __nv_bfloat16, float)
FUSED_ADAMW_ENTRY(fused_adamw_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
