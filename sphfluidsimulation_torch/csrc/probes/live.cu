// Device liveness probe: o = x + c on f32[8, 128], with c a scalar the caller
// takes from the clock, so no cached result can answer for a dead card.
//
// Replaces the TPU probe kernels bench.py:95 (_PROBE_PALLAS, the kernel _k)
// and scripts/probe_compact_tpu.py:119 (wait_tpu's kernel k): a fresh build
// and launch whose sum the caller checks (probes/live.py::probe_device runs
// it in a child process it can kill).
//
// What bounds it on the H100: nothing but the launch itself (8 KB read and
// written). The design is the simplest kernel that proves the card runs
// code: one thread per element.
#include <cuda_runtime.h>

namespace {

__global__ void live_kernel(const float* __restrict__ x,
                            const float* __restrict__ c,
                            float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + __ldg(c);
}

}  // namespace

// c is a one-element device array (the TPU probe's c_ref); n elements.
extern "C" int probe_live(const float* x, const float* c, float* out, int n,
                          void* stream) {
  if (n > 0)
    live_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(x, c, out,
                                                                    n);
  return (int)cudaGetLastError();
}
