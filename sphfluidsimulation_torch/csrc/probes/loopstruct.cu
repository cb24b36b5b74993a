// The loop-structure probe of the force walk: how much of a force pass is
// the walk (loop control, the candidate's address and membership chain) and
// how much the pair arithmetic.
//
// Replaces the TPU probe kernel scripts/probe_loopstruct_tpu.py:167
// (build_call's pallas_call of kernel(variant, ...)), in two forms.
//
// The synthetic form (synth_kernel) computes what the script's kernel
// computes, on the script's inputs (probes/loopstruct.py::synth_inputs):
// tiles of 64 rows, each walking 9 lines (chunk intervals [k0, k1)) of a
// window f32[97, 8, 128] of 128-candidate chunks, 11 chunks a tile, with the
// full pair (six sums) or, in B, the pair stripped to one masked add:
//   A  nested line -> chunk loops, the chunk loop 4 chunks a step
//   B  A's walk, each candidate reduced to acc += x_j * lane_gate
//   C  the tile's flat 16-entry chunk list, fully unrolled, gated
//   D  the flat list in one dynamic loop, 4 entries a step
//   E  nested loops, 8 chunks a step
// A step's chunks past the line's (list's) end are evaluated with lane gate
// 0, as in the script (and as the port's window walk evaluates the second
// slot of a step), so A, C, D and E compute the same sums, and the steps
// they waste differ. The script's gate passes a candidate whose decoded
// cell lies within 1 of cell (0, 0, 0) (|c - r * 0| <= 1).
//
// The frame form (frame_kernel) asks the same question of the port's own
// walk, K3's without extensions (window_walk.cuh), on a real frame:
//   A_f  range_walk<2, true, false> with the full pair (K3's code)
//   B_f  the same walk with the pair stripped to sum += use ? x_j : 0
//   D_f  a flat per-row list of slot ranges, built by a pre-pass
//        (ranges_kernel), walked in one dynamic loop, 2 slots a step
//   E_f  range_walk's enumeration, 4 slots a step
// All four keep the walk order (ascending slot within a range, ranges in
// window order), so A_f, D_f and E_f sum the same terms in the same order.
// B_f / A_f is the walk's share of K3's time.
//
// What bounds it on the H100: one thread per row, the window or the frame
// served by L1/L2 (the synthetic window is 397 KB, read by every tile; a
// warp's 32 rows read the same candidate, a broadcast). The FP32 pair
// arithmetic bounds the full pair; B's and B_f's work is the walk itself.
#include "../window_walk.cuh"

namespace {

// ------------------------------------------------------------ synthetic --

constexpr int kLanes = 128;
constexpr int kFeat = 8;
constexpr int kRows = 64;
constexpr int kLines = 9;
constexpr int kMaxC = 16;
constexpr int kR = 47;

struct SynthArgs {
  const float* __restrict__ win;     // f32[w_rows, 8, 128]
  const int* __restrict__ tiles;     // i32[T, 2 * 9]: (k0, k1) per line
  const int* __restrict__ counts;    // i32[T]: lines
  const int* __restrict__ flat;      // i32[T, 16]: chunk list, -1 padded
  const int* __restrict__ fcnt;      // i32[T]: list length
  const float* __restrict__ rows;    // f32[T, 64, 8]
  float* __restrict__ out;           // f32[T, 64, 8]
  int n_tiles, w_rows;
};

struct SynthRow {
  float rx, ry, rz, rvx, rvy, rvz, press_i;
};

// One chunk (128 candidates at blk = win + ku * 1024) for one row, with the
// script's _pair_full (kFull) or _pair_min, gated by lane_gate (0 or 1).
template <bool kFull>
__device__ __forceinline__ void eval_chunk(const float* __restrict__ blk,
                                           float lane_gate,
                                           const SynthRow& w,
                                           float (&acc)[6]) {
  const float h = (float)(1.0 / (kR - 1));
  const float h2 = h * h;
  const float cgh6 = (float)(45.0 / 3.14159265358979323846) / (h2 * h2 * h2);
#pragma unroll 4
  for (int l = 0; l < kLanes; ++l) {
    const float xj = __ldg(blk + l);
    if constexpr (!kFull) {
      acc[0] += xj * lane_gate;
    } else {
      const float cid = __ldg(blk + 3 * kLanes + l);
      const float cz = floorf((cid + 0.5f) / (float)(kR * kR));
      const float rem = cid - cz * (float)(kR * kR);
      const float cy = floorf((rem + 0.5f) / (float)kR);
      const float cx = rem - cy * (float)kR;
      const bool member = cid >= 0.f && fabsf(cx - w.rx * 0.f) <= 1.f &&
                          fabsf(cy - w.ry * 0.f) <= 1.f &&
                          fabsf(cz - w.rz * 0.f) <= 1.f;
      const float gate = (member ? 1.f : 0.f) * lane_gate;
      const float dx = w.rx - xj;
      const float dy = w.ry - __ldg(blk + kLanes + l);
      const float dz = w.rz - __ldg(blk + 2 * kLanes + l);
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float rho_j = __ldg(blk + 7 * kLanes + l);
      const bool rho_ok = rho_j > 1e-6f;
      const float inv_rho = (rho_ok ? 1.f : 0.f) / (rho_ok ? rho_j : 1.f);
      const float abs_r = sqrtf(r2);
      const float rs = rsqrtf(fmaxf(r2, 1e-30f));
      const float diff = h - abs_r;
      const bool valid = diff > 1e-6f && abs_r > 1e-6f;
      const float gwp = valid ? cgh6 * diff * diff * diff * rs : 0.f;
      const float gwv = abs_r < h ? cgh6 * diff : 0.f;
      const float press_j = 150.f * (rho_j - 1.5f);
      const float pc = gate * (w.press_i + press_j) * 0.5f * inv_rho * gwp;
      acc[0] += pc * dx;
      acc[1] += pc * dy;
      acc[2] += pc * dz;
      const float vc = gate * gwv * inv_rho;
      acc[3] += vc * (__ldg(blk + 4 * kLanes + l) - w.rvx);
      acc[4] += vc * (__ldg(blk + 5 * kLanes + l) - w.rvy);
      acc[5] += vc * (__ldg(blk + 6 * kLanes + l) - w.rvz);
    }
  }
}

// kVariant 0-4: A-E. One block per tile, one thread per row.
template <int kVariant>
__global__ void __launch_bounds__(kRows) synth_kernel(SynthArgs a) {
  constexpr bool kFull = kVariant != 1;
  const int tile = blockIdx.x;
  const float* __restrict__ rw =
      a.rows + ((size_t)tile * kRows + threadIdx.x) * kFeat;
  const SynthRow w{rw[0], rw[1], rw[2], rw[3], rw[4], rw[5],
                   150.f * (rw[6] - 1.5f)};
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const auto chunk = [&](int ku, float lane_gate) {
    eval_chunk<kFull>(a.win + (size_t)ku * kFeat * kLanes, lane_gate, w, acc);
  };
  if constexpr (kVariant == 2) {                                  // C
#pragma unroll
    for (int j = 0; j < kMaxC; ++j) {
      const int e = __ldg(a.flat + tile * kMaxC + j);
      chunk(max(e, 0), e >= 0 ? 1.f : 0.f);
    }
  } else if constexpr (kVariant == 3) {                           // D
    const int n = __ldg(a.fcnt + tile);
#pragma unroll 1
    for (int it = 0; it < (n + 3) / 4; ++it) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = it * 4 + u;
        const int e = __ldg(a.flat + tile * kMaxC + min(k, kMaxC - 1));
        chunk(max(e, 0), k < n && e >= 0 ? 1.f : 0.f);
      }
    }
  } else {                                                        // A B E
    constexpr int kUnroll = kVariant == 4 ? 8 : 4;
    const int lines = __ldg(a.counts + tile);
#pragma unroll 1
    for (int i = 0; i < lines; ++i) {
      const int k0 = __ldg(a.tiles + tile * 2 * kLines + 2 * i);
      const int k1 = __ldg(a.tiles + tile * 2 * kLines + 2 * i + 1);
#pragma unroll 1
      for (int it = 0; it < (k1 - k0 + kUnroll - 1) / kUnroll; ++it) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 + it * kUnroll + u;
          chunk(min(k, a.w_rows - 1), k < k1 ? 1.f : 0.f);
        }
      }
    }
  }
  // the six sums (B: its one) in lanes 0-5, zeros after
  float4* __restrict__ o = reinterpret_cast<float4*>(
      a.out + ((size_t)tile * kRows + threadIdx.x) * kFeat);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], 0.f, 0.f);
}

// ---------------------------------------------------------------- frame --

// The ranges of range_walk (window_walk.cuh) of a row whose fresh cell is
// (cx, cy, cz), whole grid, handed to range(q, e, line + x0, x1 - x0) in
// walk order: the same enumeration, line by line, a cell whose run the
// capacity does not cut continuing into the next.
template <typename Range>
__device__ __forceinline__ void for_each_range(int cx, int cy, int cz, int r,
                                               int cap,
                                               const int* __restrict__ start,
                                               Range&& range) {
  const int x0 = max(cx - 1, 0), x1 = min(cx + 1, r - 1);
  const int y0 = max(cy - 1, 0), y1 = min(cy + 1, r - 1);
  const int z0 = max(cz - 1, 0), z1 = min(cz + 1, r - 1);
  for (int z = z0; z <= z1; ++z) {
    for (int y = y0; y <= y1; ++y) {
      const int line = (z * r + y) * r;
      const int* const sl = start + line;
      int end = __ldg(sl + x0);
      for (int x = x0; x <= x1; ++x) {
        int q = end;
        end = __ldg(sl + x + 1);
        int e = cap >= 0 ? min(end, q + cap) : end;
        while (e == end && x < x1) {
          ++x;
          end = __ldg(sl + x + 1);
          e = cap >= 0 ? min(end, e + cap) : end;
        }
        range(q, e, line + x0, x1 - x0);
      }
    }
  }
}

// range_walk's membership gate for slot j of row i on the line whose first
// window cell is lx0 and whose window is span + 1 cells wide.
__device__ __forceinline__ bool member(const sph::WalkArgs& a, int j, int i,
                                       int lx0, int span, int cx, int cy,
                                       int cz) {
  if (!__ldg(a.occ + j) || j == i) return false;
  const int rj = __ldg(a.raw + j);
  return (unsigned)(rj - lx0) <= (unsigned)span ||
         sph::raw_near(rj, cx, cy, cz, a.r);
}

// Slots q .. e - 1 of one range, kStep a step, each handed to pair(j, use);
// a step's slots past e repeat e - 1 with use = false.
template <int kStep, typename Member, typename Pair>
__device__ __forceinline__ void step_range(int q, int e, Member&& is_member,
                                           Pair&& pair) {
  for (; q < e; q += kStep) {
    pair(q, is_member(q));
#pragma unroll
    for (int u = 1; u < kStep; ++u) {
      const int qu = min(q + u, e - 1);
      pair(qu, q + u < e && is_member(qu));
    }
  }
}

// D_f's pre-pass: row i's non-empty ranges as (q, e, line + x0, x1 - x0),
// entry t at ranges[t * n + i], and their count: at most 27 (9 lines, each
// cut by the capacity into at most 3 ranges).
__global__ void __launch_bounds__(sph::kBlock)
ranges_kernel(sph::WalkArgs a, int4* __restrict__ ranges,
              int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float4 p = __ldg(a.rows + 2 * i);
  int t = 0;
  for_each_range(sph::fresh_coord(p.x, a.r), sph::fresh_coord(p.y, a.r),
                 sph::fresh_coord(p.z, a.r), a.r, a.cap, a.start,
                 [&](int q, int e, int lx0, int span) {
                   if (q < e) ranges[(size_t)t++ * a.n + i] =
                       make_int4(q, e, lx0, span);
                 });
  count[i] = t;
}

// kVariant 0 A_f, 1 B_f, 2 D_f, 3 E_f. A_f, D_f and E_f write K3's raw sums
// f32[N, 12] (sph_common.cuh::store_sums), B_f its one sum f32[N].
template <int kVariant>
__global__ void __launch_bounds__(sph::kBlock)
frame_kernel(sph::WalkArgs a, const int4* __restrict__ ranges,
             const int* __restrict__ count, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const sph::Scalars s = sph::load_scalars(a.scal);
  const sph::Particle p = sph::load_particle(a.rows, i);
  const int r = a.r;
  const int cx = sph::fresh_coord(p.px, r), cy = sph::fresh_coord(p.py, r),
            cz = sph::fresh_coord(p.pz, r);
  if constexpr (kVariant == 1) {
    float sum = 0.f;
    sph::range_walk<2, true, false>(
        cx, cy, cz, i, r, a.cap, 0, r, a.start, a.raw, a.occ,
        [&](int q, bool use) {
          const float xj = __ldg(a.rows + 2 * q).x;
          sum = use ? sum + xj : sum;
        });
    out[i] = sum;
    return;
  }
  sph::PairSums acc;
  if constexpr (kVariant == 0) {
    sph::window_pair_sums<false, false>(s, p, i, a, acc);
  } else {
    const float press_i = s.gas_k * (p.rho - s.rho0);
    const float vmu = p.rho > sph::kEps ? s.visc : 1.f;
    const auto pair = [&](int q, bool use) {
      float4 qa = __ldg(a.rows + 2 * q), qb = __ldg(a.rows + 2 * q + 1);
      float press_j, inv_j;
      sph::candidate<false>(s, qa, qb, press_j, inv_j,
                            [&] { return __ldg(a.pj + q); });
      sph::add_pair_pj<false, sph::kFacc>(s, p, press_i, vmu, qa, qb,
                                          press_j, inv_j, use, acc);
    };
    if constexpr (kVariant == 3) {
      for_each_range(cx, cy, cz, r, a.cap, a.start,
                     [&](int q, int e, int lx0, int span) {
                       step_range<4>(q, e, [&](int j) {
                         return member(a, j, i, lx0, span, cx, cy, cz);
                       }, pair);
                     });
    } else {
      // one dynamic loop over the row's slots, 2 a step, moving to the
      // next range when a range ends
      const int n_ranges = __ldg(count + i);
      int t = 0, q = 0, e = 0, lx0 = 0, span = 0;
      while (true) {
        if (q >= e) {
          if (t == n_ranges) break;
          const int4 rg = __ldg(ranges + (size_t)t++ * a.n + i);
          q = rg.x;
          e = rg.y;
          lx0 = rg.z;
          span = rg.w;
        }
        pair(q, member(a, q, i, lx0, span, cx, cy, cz));
        const int q2 = min(q + 1, e - 1);
        pair(q2, q2 > q && member(a, q2, i, lx0, span, cx, cy, cz));
        q += 2;
      }
    }
  }
  sph::store_sums<sph::kFacc>(reinterpret_cast<float4*>(out), i, acc);
}

}  // namespace

// variant 0-4: A-E on n_tiles tiles of the window f32[w_rows, 8, 128].
extern "C" int probe_loopstruct_synth(int variant, const float* win,
                                      const int* tiles, const int* counts,
                                      const int* flat, const int* fcnt,
                                      const float* rows, float* out,
                                      int n_tiles, int w_rows, void* stream) {
  using Kernel = void (*)(SynthArgs);
  static const Kernel kernels[5] = {synth_kernel<0>, synth_kernel<1>,
                                    synth_kernel<2>, synth_kernel<3>,
                                    synth_kernel<4>};
  if (variant < 0 || variant > 4) return (int)cudaErrorInvalidValue;
  const SynthArgs a{win, tiles, counts, flat, fcnt, rows, out, n_tiles,
                    w_rows};
  if (n_tiles > 0)
    kernels[variant]<<<n_tiles, kRows, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// D_f's pre-pass: ranges int4[27, n] and count i32[n] of the rows
// f32[n, 8] on the frame (start, cap) at resolution r.
extern "C" int probe_loopstruct_ranges(const float* rows, const int* start,
                                       int* ranges, int* count, int n, int r,
                                       int cap, void* stream) {
  const sph::WalkArgs a{reinterpret_cast<const float4*>(rows), nullptr,
                        start, nullptr, nullptr, nullptr, n, r, cap, 0, r};
  if (n > 0)
    ranges_kernel<<<(n + sph::kBlock - 1) / sph::kBlock, sph::kBlock, 0,
                    (cudaStream_t)stream>>>(a, reinterpret_cast<int4*>(ranges),
                                            count);
  return (int)cudaGetLastError();
}

// variant 0-3: A_f, B_f, D_f (reads ranges and count), E_f; K3's inputs
// (sph_forces, without band or extensions).
extern "C" int probe_loopstruct_frame(int variant, const float* rows,
                                      const float* pj, const int* start,
                                      const int* raw, const uint8_t* occ,
                                      const float* scal, const int* ranges,
                                      const int* count, float* out, int n,
                                      int r, int cap, void* stream) {
  using Kernel = void (*)(sph::WalkArgs, const int4*, const int*, float*);
  static const Kernel kernels[4] = {frame_kernel<0>, frame_kernel<1>,
                                    frame_kernel<2>, frame_kernel<3>};
  if (variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
  const sph::WalkArgs a{reinterpret_cast<const float4*>(rows),
                        reinterpret_cast<const float2*>(pj),
                        start, raw, occ, scal, n, r, cap, 0, r};
  if (n > 0)
    kernels[variant]<<<(n + sph::kBlock - 1) / sph::kBlock, sph::kBlock, 0,
                       (cudaStream_t)stream>>>(
        a, reinterpret_cast<const int4*>(ranges), count, out);
  return (int)cudaGetLastError();
}
