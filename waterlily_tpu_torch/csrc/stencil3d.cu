// Dense-layout stencil kernels of the static-body main path, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// waterlily_tpu_torch/ops/_build.py; every entry launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
//
// Layout, indexing and thread shape: see stencil_common.cuh.
//
// What bounds these kernels on an H100 (3.35 TB/s HBM3): the Poisson and BDIM
// kernels do < 1 flop per byte, so each is bound by memory traffic.  The
// bytes each must move per cell are given beside each kernel; time = bytes x
// cells / 3.35 TB/s is the floor.  They rely on the caches for the stencil
// reuse; K12 runs on the shared-memory tiles of convdiff_tile.cuh, K15 and
// K13 on the red-black cascade of rb_cascade.cuh where it wins.

#include "rb_cascade.cuh"

namespace {

// ------------------------------------------------------------ K12 conv_diff
// Replaces waterlily_tpu/ops/pallas3d.py:274 conv_diff3d_generic and the
// slab fixes its caller composes (models/flow.py:295-323): the whole jnp
// formula of models/flow.py:276-292 at every cell, ghosts included, with
// roll-wrap reads, and in the directions whose bit is set in PER the
// periodic phiuP fluxes.  The tiled core of convdiff_tile.cuh (what bounds
// it and what the design does are written there) with the plain store as
// its epilogue; one instantiation per scheme and periodic mask.
// Bytes: reads u (3 fields), writes r (3 fields): 24 B/cell, 0.12 ms at 258^3
// at the HBM roofline.
struct StoreRhs {
  struct Pre {};
  float* __restrict__ r;
  __device__ __forceinline__ Pre pre(const Grid3&, int, int, int, int64_t) const {
    return {};
  }
  __device__ __forceinline__ void operator()(const Grid3& g, int, int, int,
                                             int64_t c, const float (&ri)[3],
                                             const float (&)[3],
                                             const Pre&) const {
#pragma unroll
    for (int i = 0; i < 3; ++i) r[(int64_t)i * g.n + c] = ri[i];
  }
};

template <int SCHEME>
cudaError_t launch_conv_diff(const float* u, const float* nu, float* r,
                             int per, const Grid3& g, cudaStream_t s) {
  StoreRhs epi = {r};
  switch (per) {
#define WLT_CONV_DIFF_CASE(P) \
  case P:                     \
    return launch_conv_diff_tile<SCHEME, P>(u, nu, g, epi, s);
    WLT_CONV_DIFF_CASE(0)
    WLT_CONV_DIFF_CASE(1)
    WLT_CONV_DIFF_CASE(2)
    WLT_CONV_DIFF_CASE(3)
    WLT_CONV_DIFF_CASE(4)
    WLT_CONV_DIFF_CASE(5)
    WLT_CONV_DIFF_CASE(6)
    WLT_CONV_DIFF_CASE(7)
#undef WLT_CONV_DIFF_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ K14 bdim
// Replaces waterlily_tpu/ops/pallas3d.py:372 bdim3d (with fp = u0 + dt f - V
// fused in, models/flow.py:367-377).  Interior faces only; ghosts copy u.
// Bytes per component: reads u, u0, f, V, mu0, mu1[i, 0..2], writes out:
// 9 fields = 36 B/cell, 108 B/cell for the vector, 0.55 ms at 258^3 at the
// HBM roofline.  fp is recomputed at the 6 neighbours from cached u0/f/V
// instead of being stored (saves a 12 B/cell write and re-read).
__device__ __forceinline__ float fstar(const float* __restrict__ u0,
                                       const float* __restrict__ f,
                                       const float* __restrict__ V, float dt,
                                       int64_t k) {
  return u0[k] + dt * f[k] - V[k];
}

// the update of component i at the interior cell c:
// 1/2 sum_j mu1[i,j] (f*(+e_j) - f*(-e_j)) + V + mu0 f*
__device__ __forceinline__ float bdim_update_at(const float* __restrict__ u0,
                                                const float* __restrict__ f,
                                                const float* __restrict__ V,
                                                const float* __restrict__ mu0,
                                                const float* __restrict__ mu1,
                                                float dt, const Grid3& g,
                                                int i, int64_t c) {
  int64_t ci = (int64_t)i * g.n + c;
  const float* u0i = u0 + (int64_t)i * g.n;
  const float* fi = f + (int64_t)i * g.n;
  const float* Vi = V + (int64_t)i * g.n;
  float acc = 0.f;
  for (int j = 0; j < 3; ++j) {
    int64_t s = stride(g, j);
    float d = fstar(u0i, fi, Vi, dt, c + s) - fstar(u0i, fi, Vi, dt, c - s);
    acc = acc + mu1[(int64_t)(i * 3 + j) * g.n + c] * d;
  }
  return 0.5f * acc + V[ci] + mu0[ci] * fstar(u0i, fi, Vi, dt, c);
}

__global__ void bdim_kernel(const float* __restrict__ u,
                            const float* __restrict__ u0,
                            const float* __restrict__ f,
                            const float* __restrict__ V,
                            const float* __restrict__ mu0,
                            const float* __restrict__ mu1, float dt,
                            float* __restrict__ out, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int i = blockIdx.z / g.nx;
  int x = blockIdx.z - i * g.nx;
  if (z >= g.nz || y >= g.ny) return;
  int64_t c = at(g, x, y, z);
  int64_t ci = (int64_t)i * g.n + c;
  if (!interior(g, x, y, z)) {
    out[ci] = u[ci];
    return;
  }
  out[ci] = u[ci] + bdim_update_at(u0, f, V, mu0, mu1, dt, g, i, c);
}

// ------------------------------------------------------------ K2 bdim_band
// Replaces waterlily_tpu/ops/pallas_flat.py:665 bdim_band: the BDIM update
// where the caller knows the x rows [lo, hi) outside which the moments are
// the far field (mu1 = 0, V = 0, mu0 = 1 but 0 on component i's face-1
// plane of each non-periodic direction):
//   rows outside [lo, hi):  u_i + inside_i (u0_i + dt f_i)
//   rows inside:            K14's update, f* read at the 6 neighbours, which
//                           may lie in the rows next to the band
// with inside_i the interior minus that face-1 plane (bit i of per set:
// direction i periodic, the plane stays).  The TPU runs two passes and a
// scatter (the far-field formula everywhere, bdim_k on the slab with a +-1
// halo, the slab written back); here one launch covers the field: x is the
// slowest axis and a block is one x row, so the row test is uniform over a
// block and costs no divergence.  V, mu0 and mu1 are never read outside the
// slab [lo-1, hi+1): the rows of the band read V (through f*) at rows lo-1
// and hi, where it is 0 because the caller's band holds every row with a
// cell off the far field (`_band_box` of simulation.py).  hi <= lo: the
// far-field formula everywhere.
// Bytes per cell (3 components): 48 outside the band (u, u0, f in, out),
// 108 inside (K14's count); the floor is their row-weighted sum over 3.35
// TB/s, 0.25 ms at 258^3 with an empty band.
__global__ void bdim_band_kernel(const float* __restrict__ u,
                                 const float* __restrict__ u0,
                                 const float* __restrict__ f,
                                 const float* __restrict__ V,
                                 const float* __restrict__ mu0,
                                 const float* __restrict__ mu1, float dt,
                                 int lo, int hi, int per,
                                 float* __restrict__ out, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int i = blockIdx.z / g.nx;
  int x = blockIdx.z - i * g.nx;
  if (z >= g.nz || y >= g.ny) return;
  int64_t c = at(g, x, y, z);
  int64_t ci = (int64_t)i * g.n + c;
  float ui = u[ci];
  if (interior(g, x, y, z)) {
    if (x >= lo && x < hi) {
      ui = ui + bdim_update_at(u0, f, V, mu0, mu1, dt, g, i, c);
    } else {
      int face = i == 0 ? x : (i == 1 ? y : z);
      if (face != 1 || ((per >> i) & 1)) ui = ui + (u0[ci] + dt * f[ci]);
    }
  }
  out[ci] = ui;
}

// ------------------------------------------------------------ K16 mult
// Replaces waterlily_tpu/ops/pallas3d.py:504 mult3d (poisson.py:87-90).
// A x = D x + sum_d (L_d x(-e_d) + L_d(+e_d) x(+e_d)) on the interior, zero
// ghosts.  Bytes: reads x, L (3), D, writes out: 24 B/cell, 0.12 ms at 258^3
// at the HBM roofline; the 6 neighbour reads of x and the 3 shifted reads of
// L come from cache.
__global__ void mult_kernel(const float* __restrict__ x,
                            const float* __restrict__ L,
                            const float* __restrict__ D,
                            float* __restrict__ out, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int xi = blockIdx.z;
  if (z >= g.nz || y >= g.ny) return;
  int64_t c = at(g, xi, y, z);
  out[c] = interior(g, xi, y, z) ? apply_A(x, L, D, g, c) : 0.f;
}

// ------------------------------------------------------------ K15 gs_incr
// Replaces waterlily_tpu/ops/pallas3d.py:416 gs_incr3d and :497
// jacobi_incr3d (poisson.py:128-184, non-periodic).
//   eps = r iD (zero ghosts); per colour: eps[colour cells] = gauss(eps);
//   x += w eps; r -= w A eps.
// Routes, chosen from the arguments and the shape (gs_incr_route):
// * float32 with 1 to RB_MAX_IT colours on a level of at least
//   GS_INCR_TILE_MIN_CELLS cells: one launch of the tiled cascade
//   (rb_cascade.cuh, form RB_GS_INCR: stage 0 forms e0 = r iD, the tail x',
//   r'), which must move x, r, L (3), D, iD in and x', r' out: 36 B/cell,
//   0.185 ms at 258^3 at the roofline.
// * Jacobi (no colours), more colours, bf16 and smaller levels: one launch
//   per colour plus one increment launch.  The colour sweep updates eps in
//   place: a cell's 6 neighbours all have the other colour, so no thread
//   reads a value another thread of the same launch writes.  Bytes: init
//   12 B/cell; a sweep reads r, iD, L (3), eps and writes half of eps:
//   ~26 B/cell; the increment reads x, r, eps, L (3), D and writes x, r:
//   36 B/cell.  With 4 colours ~152 B/cell, 0.78 ms at 258^3 at the
//   roofline.  Jacobi fuses eps = r iD into the increment: 36 B/cell.
// The size rule: the cascade marches one block an SM in lock-step at a
// near-fixed cost per step (~2 us at 258^3), so on a small level its march
// loses to the few bytes of the per-colour launches.  Device time per call
// with 4 colours, both routes in one call on an H100 (PERF.md section 6):
// 258^3 0.574 against 1.060 ms, 322x130x130 0.193 / 0.341, 130^3 0.089 /
// 0.145, 162x66x66 (706K cells) 0.037 / 0.044; 66^3 (287K) 0.025 / 0.024,
// 82x34x34 0.0180 / 0.0175, 34^3 0.016 / 0.015, 18^3 0.015 / 0.014.  The
// threshold sits between the largest level that lost and the smallest that
// won.
//
// MP instantiations (pallas_flat.py:759 gs_incr and :891 jacobi_incr with
// mp=True; the arithmetic is in stencil_common.cuh): L, D, iD and the eps
// scratch are bf16, the residual is rounded to bf16 where the correction
// reads it, A eps is accumulated in bf16, and x += w eps, r -= w A eps are
// float32.  Jacobi must move x, r in and out (16 B) and the five bf16
// coefficients (10 B): 26 B/cell against 36 in float32, 0.13 ms at 258^3.
constexpr int64_t GS_INCR_TILE_MIN_CELLS = 500000;

template <int IT>
__global__ void __launch_bounds__(RbShape<IT>::NT, 1)
    gs_incr_tile_kernel(const float* __restrict__ x,
                        const float* __restrict__ r,
                        const float* __restrict__ L,
                        const float* __restrict__ D,
                        const float* __restrict__ iD, float omega,
                        unsigned cmask, int xc, float* __restrict__ x_out,
                        float* __restrict__ r_out, Grid3 g) {
  float acc_s = 0.f, acc_m = 0.f;
  rb_cascade<IT, RB_GS_INCR>(x, r, nullptr, L, D, iD, omega, cmask, 0u, xc,
                             x_out, r_out, acc_s, acc_m, g);
}

template <int IT>
cudaError_t launch_gs_incr_it(const float* x, const float* r, const float* L,
                              const float* D, const float* iD, float omega,
                              unsigned cmask, float* x_out, float* r_out,
                              const Grid3& g, cudaStream_t s) {
  static int slots = 0;
  constexpr int smem = rb_smem<IT, RB_GS_INCR>();
  dim3 grid;
  int xc;
  cudaError_t err =
      rb_cascade_grid<IT>(gs_incr_tile_kernel<IT>, smem, slots, g, grid, xc);
  if (err != cudaSuccess) return err;
  gs_incr_tile_kernel<IT><<<grid, RbShape<IT>::NT, smem, s>>>(
      x, r, L, D, iD, omega, cmask, xc, x_out, r_out, g);
  return cudaGetLastError();
}

// colour k of the list as bit k of a mask
__host__ unsigned color_mask(const int* colors, int ncolors) {
  unsigned cmask = 0;
  for (int k = 0; k < ncolors; ++k) cmask |= (unsigned)(colors[k] & 1) << k;
  return cmask;
}

__host__ bool gs_incr_tile_ok(int ncolors, bool mp) {
  return !mp && ncolors >= 1 && ncolors <= RB_MAX_IT;
}

// 1: the cascade, 0: the per-colour launches
__host__ int gs_incr_route(const Grid3& g, int ncolors, bool mp) {
  return gs_incr_tile_ok(ncolors, mp) && g.n >= GS_INCR_TILE_MIN_CELLS;
}

template <bool MP>
__global__ void eps_init_kernel(const float* __restrict__ r,
                                const coef_t<MP>* __restrict__ iD,
                                coef_t<MP>* __restrict__ eps, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int x = blockIdx.z;
  if (z >= g.nz || y >= g.ny) return;
  int64_t c = at(g, x, y, z);
  bool m = interior(g, x, y, z);
  if constexpr (MP) {
    eps[c] = m ? bmul(rb(r[c]), iD[c]) : rb(0.f);
  } else {
    eps[c] = m ? r[c] * iD[c] : 0.f;
  }
}

// eps at cell k: read from eps, or (Jacobi) computed as r iD with zero ghosts
template <bool FROM_R, bool MP>
__device__ __forceinline__ coef_t<MP> eps_at(const coef_t<MP>* __restrict__ eps,
                                             const float* __restrict__ r,
                                             const coef_t<MP>* __restrict__ iD,
                                             const Grid3& g, int x, int y,
                                             int z, int64_t k) {
  if (FROM_R) {
    bool m = interior(g, x, y, z);
    if constexpr (MP) {
      return m ? bmul(rb(r[k]), iD[k]) : rb(0.f);
    } else {
      return m ? r[k] * iD[k] : 0.f;
    }
  }
  return eps[k];
}

template <bool FROM_R, bool MP>
__global__ void increment_kernel(const float* __restrict__ x,
                                 const float* __restrict__ r,
                                 const coef_t<MP>* __restrict__ L,
                                 const coef_t<MP>* __restrict__ D,
                                 const coef_t<MP>* __restrict__ iD,
                                 const coef_t<MP>* __restrict__ eps,
                                 float omega, float* __restrict__ x_out,
                                 float* __restrict__ r_out, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int xi = blockIdx.z;
  if (z >= g.nz || y >= g.ny) return;
  int64_t c = at(g, xi, y, z);
  float e = 0.f, ae = 0.f;
  if (interior(g, xi, y, z)) {
    coef_t<MP> ec = eps_at<FROM_R, MP>(eps, r, iD, g, xi, y, z, c);
    coef_t<MP> acc;
    if constexpr (MP) {
      acc = bmul(ec, D[c]);
    } else {
      acc = ec * D[c];
    }
    const int p[3] = {xi, y, z};
    for (int d = 0; d < 3; ++d) {
      int64_t st = stride(g, d);
      const coef_t<MP>* Ld = L + (int64_t)d * g.n;
      int lo[3] = {p[0], p[1], p[2]};
      int hi[3] = {p[0], p[1], p[2]};
      lo[d] -= 1;
      hi[d] += 1;
      coef_t<MP> el = eps_at<FROM_R, MP>(eps, r, iD, g, lo[0], lo[1], lo[2], c - st);
      coef_t<MP> eh = eps_at<FROM_R, MP>(eps, r, iD, g, hi[0], hi[1], hi[2], c + st);
      if constexpr (MP) {
        acc = badd(badd(acc, bmul(el, Ld[c])), bmul(eh, Ld[c + st]));
      } else {
        acc = acc + el * Ld[c];
        acc = acc + eh * Ld[c + st];
      }
    }
    if constexpr (MP) {
      e = fb(ec);
      ae = fb(acc);
    } else {
      e = ec;
      ae = acc;
    }
  }
  if constexpr (MP) {
    x_out[c] = __fadd_rn(x[c], __fmul_rn(omega, e));
    r_out[c] = __fsub_rn(r[c], __fmul_rn(omega, ae));
  } else {
    x_out[c] = x[c] + omega * e;
    r_out[c] = r[c] - omega * ae;
  }
}

// route: 1 the cascade (float32, 1 to RB_MAX_IT colours), 0 the per-colour
// launches, which need the eps scratch
template <bool MP>
cudaError_t launch_gs_incr(const float* x, const float* r, const coef_t<MP>* L,
                           const coef_t<MP>* D, const coef_t<MP>* iD,
                           coef_t<MP>* eps, float* x_out, float* r_out,
                           const int* colors, int ncolors, float omega,
                           int route, const Grid3& g, cudaStream_t s) {
  if (route == 1) {
    if constexpr (!MP) {
      const unsigned cm = color_mask(colors, ncolors);
#define WLT_GS_CASE(IT)                                                   \
  case IT:                                                                \
    return launch_gs_incr_it<IT>(x, r, L, D, iD, omega, cm, x_out, r_out, \
                                 g, s)
      switch (ncolors) {
        WLT_GS_CASE(1);
        WLT_GS_CASE(2);
        WLT_GS_CASE(3);
        WLT_GS_CASE(4);
        default: break;
      }
#undef WLT_GS_CASE
    }
    return cudaErrorInvalidValue;
  }
  if (route != 0) return cudaErrorInvalidValue;
  dim3 block(BZ, BY);
  dim3 grid = grid_of(g, 1);
  cudaError_t err;
  if (ncolors == 0) {
    increment_kernel<true, MP><<<grid, block, 0, s>>>(x, r, L, D, iD, nullptr,
                                                      omega, x_out, r_out, g);
    return cudaGetLastError();
  }
  eps_init_kernel<MP><<<grid, block, 0, s>>>(r, iD, eps, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int k = 0; k < ncolors; ++k) {
    gs_sweep_kernel<MP><<<grid, block, 0, s>>>(r, L, iD, eps, colors[k], g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  increment_kernel<false, MP><<<grid, block, 0, s>>>(x, r, L, D, iD, eps, omega,
                                                     x_out, r_out, g);
  return cudaGetLastError();
}

// ------------------------------------------------------------ K13 gauss_sweeps
// Replaces waterlily_tpu/ops/pallas3d.py:312 gauss_sweeps3d and :366
// gauss_sweep3d (poisson.py:163-172, the periodic smoother path): per
// colour, the periodic ghost planes of eps are refreshed (perBC!: plane 0
// takes plane n-2, plane n-1 takes plane 1, direction by direction in the
// caller's order), then the cells of that colour are updated in place.  The
// refresh before a sweep is part of the arithmetic: a cell next to a
// periodic face reads its partner plane through the ghost, and that value
// must be the one the previous colour's sweep wrote (with an odd interior
// extent the partner has the same colour as the cell).  The call must move
// eps, r, L (3), iD in and eps out: 28 B/cell, 0.144 ms at 258^3.
// Routes, chosen from the arguments and the shape (gauss_sweeps_tile_ok):
// * 1 to RB_MAX_IT colours and an even interior extent in every periodic
//   direction: one launch of the tiled cascade (rb_cascade.cuh, form
//   RB_SWEEPS: stage 0 takes e0 from eps, the tail writes eps'; the
//   periodic ghosts are images of their sources, and the last colour leaves
//   them alone as the reference does).  No size rule: against the 13 to 17
//   launches of the other route it won at every level timed, device time
//   with 4 colours, x, y, z periodic, on an H100 (PERF.md section 6): 258^3
//   0.552 against 0.870 ms, 130^3 0.088 / 0.144, 66^3 0.029 / 0.049, 18^3
//   0.020 / 0.037, and the drag stack down to 82x34x34 0.023 / 0.042.
// * otherwise a copy of eps into the output, then per colour a launch of
//   per_ghost_kernel per periodic direction and one of gs_sweep_kernel on
//   the output in place: the sweep ~26 B/cell, the refresh 8 B per ghost
//   cell.  An odd periodic extent must take it: a face cell's partner has
//   its own colour, and the cascade would read the partner's new value.

template <int IT>
__global__ void __launch_bounds__(RbShape<IT>::NT, 1)
    gauss_sweeps_tile_kernel(const float* __restrict__ eps,
                             const float* __restrict__ r,
                             const float* __restrict__ L,
                             const float* __restrict__ iD, unsigned cmask,
                             unsigned per, int xc,
                             float* __restrict__ eps_out, Grid3 g) {
  float acc_s = 0.f, acc_m = 0.f;
  rb_cascade<IT, RB_SWEEPS>(nullptr, r, eps, L, nullptr, iD, 0.f, cmask, per,
                            xc, eps_out, nullptr, acc_s, acc_m, g);
}

template <int IT>
cudaError_t launch_gauss_sweeps_it(const float* eps, const float* r,
                                   const float* L, const float* iD,
                                   unsigned cmask, unsigned per,
                                   float* eps_out, const Grid3& g,
                                   cudaStream_t s) {
  static int slots = 0;
  constexpr int smem = rb_smem<IT, RB_SWEEPS>();
  dim3 grid;
  int xc;
  cudaError_t err = rb_cascade_grid<IT>(gauss_sweeps_tile_kernel<IT>, smem,
                                        slots, g, grid, xc);
  if (err != cudaSuccess) return err;
  gauss_sweeps_tile_kernel<IT><<<grid, RbShape<IT>::NT, smem, s>>>(
      eps, r, L, iD, cmask, per, xc, eps_out, g);
  return cudaGetLastError();
}

// per: bit j set = direction j periodic
__host__ bool gauss_sweeps_tile_ok(const Grid3& g, int ncolors,
                                   unsigned per) {
  const int dims[3] = {g.nx, g.ny, g.nz};
  for (int j = 0; j < 3; ++j)
    if ((per >> j & 1u) && (dims[j] < 4 || (dims[j] - 2) % 2 != 0))
      return false;
  return ncolors >= 1 && ncolors <= RB_MAX_IT;
}

__global__ void per_ghost_kernel(float* eps, int j, Grid3 g) {
  // one thread per cell of the two ghost planes of direction j; the plane
  // spans the other two directions (a, b) in full
  const int dims[3] = {g.nx, g.ny, g.nz};
  int ka = j == 0 ? 1 : 0, kb = j == 2 ? 1 : 2;
  int b = blockIdx.x * BZ + threadIdx.x;
  int a = blockIdx.y * BY + threadIdx.y;
  if (a >= dims[ka] || b >= dims[kb]) return;
  int p[3];
  p[ka] = a;
  p[kb] = b;
  int n = dims[j];
  p[j] = n - 2;
  float lo = eps[at(g, p[0], p[1], p[2])];
  p[j] = 1;
  float hi = eps[at(g, p[0], p[1], p[2])];
  p[j] = 0;
  eps[at(g, p[0], p[1], p[2])] = lo;
  p[j] = n - 1;
  eps[at(g, p[0], p[1], p[2])] = hi;
}

}  // namespace

extern "C" {

const char* wlt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// per: bit j set = direction j periodic
int wlt_conv_diff(const float* u, const float* nu, float* r, int64_t nx,
                  int64_t ny, int64_t nz, int scheme_id, int per,
                  void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  cudaStream_t s = (cudaStream_t)stream;
  switch (scheme_id) {
    case 0: return (int)launch_conv_diff<0>(u, nu, r, per, g, s);
    case 1: return (int)launch_conv_diff<1>(u, nu, r, per, g, s);
    case 2: return (int)launch_conv_diff<2>(u, nu, r, per, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int wlt_bdim(const float* u, const float* u0, const float* f, const float* V,
             const float* mu0, const float* mu1, float dt, float* out,
             int64_t nx, int64_t ny, int64_t nz, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  bdim_kernel<<<grid_of(g, 3), dim3(BZ, BY), 0, (cudaStream_t)stream>>>(
      u, u0, f, V, mu0, mu1, dt, out, g);
  return (int)cudaGetLastError();
}

int wlt_mult(const float* x, const float* L, const float* D, float* out,
             int64_t nx, int64_t ny, int64_t nz, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  mult_kernel<<<grid_of(g, 1), dim3(BZ, BY), 0, (cudaStream_t)stream>>>(
      x, L, D, out, g);
  return (int)cudaGetLastError();
}

// band rows [lo, hi) with 1 <= lo < hi <= nx - 1, or hi <= lo for none;
// per: bit j set = direction j periodic
int wlt_bdim_band(const float* u, const float* u0, const float* f,
                  const float* V, const float* mu0, const float* mu1, float dt,
                  int lo, int hi, int per, float* out, int64_t nx, int64_t ny,
                  int64_t nz, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  bdim_band_kernel<<<grid_of(g, 3), dim3(BZ, BY), 0, (cudaStream_t)stream>>>(
      u, u0, f, V, mu0, mu1, dt, lo, hi, per, out, g);
  return (int)cudaGetLastError();
}

// 1 if wlt_gs_incr (mp = 0) or wlt_gs_incr_mp (mp = 1) with ncolors
// colours on this shape takes the cascade (no eps scratch), 0 if it takes
// the per-colour launches
int wlt_gs_incr_route(int64_t nx, int64_t ny, int64_t nz, int ncolors,
                      int mp) {
  return gs_incr_route(make_grid(nx, ny, nz), ncolors, mp != 0);
}

// eps: scratch field of the per-colour route (unused with no colours);
// route: as wlt_gs_incr_route gives it (1 needs float32 and 1 to
// RB_MAX_IT colours)
int wlt_gs_incr(const float* x, const float* r, const float* L,
                const float* D, const float* iD, float* eps, float* x_out,
                float* r_out, const int* colors, int ncolors, float omega,
                int route, int64_t nx, int64_t ny, int64_t nz, void* stream) {
  return (int)launch_gs_incr<false>(x, r, L, D, iD, eps, x_out, r_out, colors,
                                    ncolors, omega, route,
                                    make_grid(nx, ny, nz),
                                    (cudaStream_t)stream);
}

// the mixed-precision instantiation: L, D, iD and the eps scratch are
// bf16; route 0
int wlt_gs_incr_mp(const float* x, const float* r, const bf16* L,
                   const bf16* D, const bf16* iD, bf16* eps, float* x_out,
                   float* r_out, const int* colors, int ncolors, float omega,
                   int route, int64_t nx, int64_t ny, int64_t nz,
                   void* stream) {
  return (int)launch_gs_incr<true>(x, r, L, D, iD, eps, x_out, r_out, colors,
                                   ncolors, omega, route,
                                   make_grid(nx, ny, nz),
                                   (cudaStream_t)stream);
}

// 1 if wlt_gauss_sweeps with ncolors colours and the periodic directions
// of the mask per (bit j: direction j) takes the cascade on this shape
int wlt_gauss_sweeps_route(int64_t nx, int64_t ny, int64_t nz, int ncolors,
                           int per) {
  return gauss_sweeps_tile_ok(make_grid(nx, ny, nz), ncolors, (unsigned)per);
}

// eps_out = the sweeps of eps, which is not modified; perdir lists the
// periodic directions in the order their ghosts are refreshed (nper of
// them, none for a plain sweep); route: as wlt_gauss_sweeps_route gives it
// (1 needs 1 to RB_MAX_IT colours and even periodic extents)
int wlt_gauss_sweeps(const float* eps, float* eps_out, const float* r,
                     const float* L, const float* iD, const int* colors,
                     int ncolors, const int* perdir, int nper, int route,
                     int64_t nx, int64_t ny, int64_t nz, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  const int dims[3] = {g.nx, g.ny, g.nz};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  unsigned per = 0;
  for (int q = 0; q < nper; ++q) {
    if (perdir[q] < 0 || perdir[q] > 2) return (int)cudaErrorInvalidValue;
    per |= 1u << perdir[q];
  }
  if (route == 1) {
    if (!gauss_sweeps_tile_ok(g, ncolors, per))
      return (int)cudaErrorInvalidValue;
    const unsigned cm = color_mask(colors, ncolors);
#define WLT_SW_CASE(IT)                                                  \
  case IT:                                                               \
    return (int)launch_gauss_sweeps_it<IT>(eps, r, L, iD, cm, per, eps_out, \
                                           g, s)
    switch (ncolors) {
      WLT_SW_CASE(1);
      WLT_SW_CASE(2);
      WLT_SW_CASE(3);
      WLT_SW_CASE(4);
      default: return (int)cudaErrorInvalidValue;
    }
#undef WLT_SW_CASE
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  err = cudaMemcpyAsync(eps_out, eps, g.n * sizeof(float),
                        cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  dim3 block(BZ, BY);
  for (int k = 0; k < ncolors; ++k) {
    for (int q = 0; q < nper; ++q) {
      int j = perdir[q];
      int ka = j == 0 ? 1 : 0, kb = j == 2 ? 1 : 2;
      dim3 pg((dims[kb] + BZ - 1) / BZ, (dims[ka] + BY - 1) / BY);
      per_ghost_kernel<<<pg, block, 0, s>>>(eps_out, j, g);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    gs_sweep_kernel<false><<<grid_of(g, 1), block, 0, s>>>(r, L, iD, eps_out,
                                                           colors[k], g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
