// staging: the host side of the port's host->device copies (no kernel).
// The wrappers stage host arrays in pinned blocks they reuse
// (kernels/_lib.py, StagingPool): each block carries an event, recorded
// right behind the block's copy on the one stream, and the pool hands a
// block out again only once its event reports the copy done, so a block
// is never written while a copy out of it is pending and no call waits.
// stage_copy is one cudaMemcpyAsync plus that record; commit_fused.cu
// does the same inside its own call.
#include <cuda_runtime.h>

extern "C" int staging_event_create(void** event) {
  return static_cast<int>(cudaEventCreateWithFlags(
      reinterpret_cast<cudaEvent_t*>(event), cudaEventDisableTiming));
}

// 0 once every copy recorded before it is done (or nothing was
// recorded), cudaErrorNotReady (600) while one is pending
extern "C" int staging_event_query(void* event) {
  return static_cast<int>(cudaEventQuery(static_cast<cudaEvent_t>(event)));
}

extern "C" int stage_copy(void* dst, const void* src, long long nbytes,
                          void* event, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemcpyAsync(dst, src, nbytes, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaEventRecord(static_cast<cudaEvent_t>(event), s));
}
