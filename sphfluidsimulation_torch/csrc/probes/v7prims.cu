// The primitives probe of the compact-lane kernel's design: a bulk copy of a
// dynamic slice of a table into fast on-chip memory, a scalar read from it
// that picks a dynamic row of a block, and a lane roll of that block by a
// runtime shift with a funnel merge.
//
// Replaces the TPU probe kernel scripts/probe_v7_prims.py:63 (main()'s
// pallas_call of kernel), with its arguments: off i32[1], x f32[64, 128],
// table i32[65536]; out f32[16, 128]:
//   smem  = table[off : off + 16384]      (pltpu.make_async_copy to SMEM)
//   row   = smem[7], sh = smem[11]
//   out[0:8]  = roll(x[row : row + 8], sh, lanes)
//   out[8:16] = where(lane < sh, roll(x[row + 8 : row + 16], sh), out[0:8])
// with roll(v, sh)[l] = v[(l - sh) mod 128], numpy's np.roll.
//
// On the H100 the copy is one cp.async.bulk (the 1-D form of the Tensor
// Memory Accelerator) of 64 KB into dynamic shared memory, completing on an
// mbarrier; the block waits on the barrier's phase. The bulk copy needs its
// global source and shared destination 16-byte aligned and its size a
// multiple of 16, so off must be a multiple of 4 (the TPU needed a multiple
// of 1024, its i32 HBM tiling); the kernel writes NaN everywhere for an off
// that is not, or whose slice or rows fall outside the arrays. The two
// dynamic rows are loaded into shared memory, and each thread writes the
// rolled lanes it owns.
//
// What bounds it on the H100: the launch and the 64 KB copy's latency
// (about 80 KB moved in all).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlice = 1 << 14;
constexpr int kLanes = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__global__ void __launch_bounds__(kThreads)
v7_kernel(const int* __restrict__ off_p, const float* __restrict__ x,
          const int* __restrict__ table, float* __restrict__ out, int x_rows,
          int table_len) {
  extern __shared__ __align__(128) int slice[];   // kSlice ints
  __shared__ __align__(16) float blk[16][kLanes];
  __shared__ __align__(8) uint64_t bar;
  const int off = __ldg(off_p);
  if (off < 0 || (off & 3) != 0 || off > table_len - kSlice) {
    for (int k = threadIdx.x; k < 16 * kLanes; k += kThreads)
      out[k] = __int_as_float(0x7fc00000);
    return;
  }
  const uint32_t b = smem_addr(&bar);
  constexpr uint32_t kBytes = kSlice * sizeof(int);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(b), "r"(kBytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(slice)),
        "l"(table + off), "r"(kBytes), "r"(b)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(0)
        : "memory");
  }
  const int row = slice[7];      // the scalar reads
  const int sh = slice[11];
  if (row < 0 || row > x_rows - 16) {
    for (int k = threadIdx.x; k < 16 * kLanes; k += kThreads)
      out[k] = __int_as_float(0x7fc00000);
    return;
  }
  for (int k = threadIdx.x; k < 16 * kLanes; k += kThreads)
    blk[k / kLanes][k % kLanes] = x[(size_t)row * kLanes + k];
  __syncthreads();
  const int shift = ((sh % kLanes) + kLanes) % kLanes;
  for (int k = threadIdx.x; k < 8 * kLanes; k += kThreads) {
    const int r = k / kLanes, l = k % kLanes;
    const int src = (l - shift + kLanes) % kLanes;
    const float top = blk[r][src];
    out[k] = top;
    out[8 * kLanes + k] = l < sh ? blk[8 + r][src] : top;
  }
}

}  // namespace

// off: i32[1] on the card; x f32[x_rows, 128]; table i32[table_len];
// out f32[16, 128].
extern "C" int probe_v7prims(const int* off, const float* x, const int* table,
                             float* out, int x_rows, int table_len,
                             void* stream) {
  constexpr int kDyn = kSlice * sizeof(int);
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        v7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDyn);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  v7_kernel<<<1, kThreads, kDyn, (cudaStream_t)stream>>>(off, x, table, out,
                                                         x_rows, table_len);
  return (int)cudaGetLastError();
}
