// Shared device code of the sorted-frame SPH kernels (density.cu,
// fused_substep.cu): the scalar block, the fresh-cell computation and the
// reference's 27-cell candidate walk over the anchor-sorted particle array.
//
// Layout (ops/frame.py): particles are sorted by anchor cell (the flat id of
// the clamped 3D cell); start[c] .. start[c+1] is cell c's run; occ[j] says
// j is in the reference bucket (raw id in range, rank in its run below the
// voxel capacity); raw[j] is the reference's unchecked flat id, which equals
// the anchor id for every in-cube position.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sph {

constexpr float kEps = 1e-6f;   // VelPos.compute:5
constexpr int kBlock = 128;

// Scalar block written by ops/sph_kernels.py::scal_block.
struct Scalars {
  float h, h2, c_poly6, c_grad, mass, gas_k, rho0, visc, stiff, damping,
      grav_y, dt;
};

__device__ __forceinline__ Scalars load_scalars(const float* __restrict__ s) {
  return Scalars{__ldg(s + 0), __ldg(s + 1), __ldg(s + 2),  __ldg(s + 3),
                 __ldg(s + 4), __ldg(s + 5), __ldg(s + 6),  __ldg(s + 7),
                 __ldg(s + 8), __ldg(s + 9), __ldg(s + 10), __ldg(s + 11)};
}

// Fresh cell coordinate trunc(p * (R-1)) (VelPos.compute:58). The float to
// int conversion rounds toward zero, saturates and maps NaN to 0, as XLA's
// and ops/sph_math.py::trunc_i32 do. The clamp to [-2, R+1] only moves
// cells whose whole window lies outside the grid.
__device__ __forceinline__ int fresh_coord(float p, int r) {
  const int c = (int)(p * (float)(r - 1));
  return min(max(c, -2), r + 1);
}

// j's raw cell, decoded, within Chebyshev distance 1 of (cx, cy, cz).
__device__ __forceinline__ bool raw_near(int raw, int cx, int cy, int cz,
                                         int r) {
  const int rr = r * r;
  const int z = raw / rr;
  const int rem = raw - z * rr;
  const int y = rem / r;
  const int x = rem - y * r;
  return abs(x - cx) <= 1 && abs(y - cy) <= 1 && abs(z - cz) <= 1;
}

// Calls visit(j) for every j of the reference candidate set of a particle
// whose fresh cell is (cx, cy, cz): the anchor cells of the 3x3x3 window
// that lie in the grid, z outer, y middle, x inner, each run in sorted
// order and cut to its first `cap` slots (cap < 0: uncapped; slots past the
// capacity are never occupied, so the cut is exact). The membership gate is
// the JAX kernels' (pallas_sph.py:1145-1164): j occupied and its RAW cell
// within distance 1. A j whose raw id equals the walked cell passes without
// decoding; only aliased out-of-cube spawns reach the decode.
template <typename Visit>
__device__ __forceinline__ void for_each_candidate(
    int cx, int cy, int cz, int r, int cap, const int* __restrict__ start,
    const int* __restrict__ raw, const uint8_t* __restrict__ occ,
    Visit&& visit) {
  const int x0 = max(cx - 1, 0), x1 = min(cx + 1, r - 1);
  const int y0 = max(cy - 1, 0), y1 = min(cy + 1, r - 1);
  const int z0 = max(cz - 1, 0), z1 = min(cz + 1, r - 1);
  for (int z = z0; z <= z1; ++z) {
    for (int y = y0; y <= y1; ++y) {
      const int line = (z * r + y) * r;
      for (int x = x0; x <= x1; ++x) {
        const int cell = line + x;
        const int s = __ldg(start + cell);
        int e = __ldg(start + cell + 1);
        if (cap >= 0) e = min(e, s + cap);
        for (int j = s; j < e; ++j) {
          if (!__ldg(occ + j)) continue;
          const int rj = __ldg(raw + j);
          if (rj != cell && !raw_near(rj, cx, cy, cz, r)) continue;
          visit(j);
        }
      }
    }
  }
}

}  // namespace sph
