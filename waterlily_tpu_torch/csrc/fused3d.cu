// Fused kernels of the flat engine (engine="flat"), on the dense layout, for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// waterlily_tpu_torch/ops/_build.py; every entry launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
//
// Layout, indexing and thread shape: see stencil_common.cuh.  The TPU
// kernels these replace (waterlily_tpu/ops/pallas_flat.py) run on the (x,
// y*z) lane layout; here the same formulas run one thread per cell on dense
// (nx, ny, nz) fields.
//
// What bounds them on an H100 (3.35 TB/s HBM3): all but K1 do < 1 flop per
// byte, so each is bound by memory traffic; the bytes each must move per
// cell are given beside it (floor = bytes x cells / 3.35 TB/s).  The stencil
// reuse is left to L1/L2 as in stencil3d.cu; K1 runs on the shared-memory
// tiles of convdiff_tile.cuh, K7 on the cascade of rb_cascade.cuh.
// Reductions are deterministic: per-block partials in a fixed tree order,
// then one block that folds them (a float atomicAdd would change the L1
// norm, and with it the iteration count, from run to run); the CFL max is
// an integer atomicMax on the bits of a non-negative float, which is
// order-free.

#include "rb_cascade.cuh"

namespace {

constexpr int NT = BZ * BY;  // threads per block
constexpr int RT = 1024;     // threads of the final reduction block

// ------------------------------------------------------------ reductions
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Sum and max of (s, m) over the block, in a fixed order; the result is in
// thread 0.  `nthreads` is a multiple of 32, at most 1024.
__device__ __forceinline__ void block_sum_max(float& s, float& m,
                                              int nthreads) {
  __shared__ float ws[32], wm[32];
  int t = threadIdx.x + blockDim.x * threadIdx.y;
  int lane = t & 31, warp = t >> 5, nw = nthreads >> 5;
  s = warp_sum(s);
  m = warp_max(m);
  if (lane == 0) {
    ws[warp] = s;
    wm[warp] = m;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < nw ? ws[lane] : 0.f;
    m = lane < nw ? wm[lane] : 0.f;
    s = warp_sum(s);
    m = warp_max(m);
  }
}

__device__ __forceinline__ int64_t block_linear() {
  return blockIdx.x + (int64_t)gridDim.x * (blockIdx.y + (int64_t)gridDim.y *
                                                             blockIdx.z);
}

// out[0] = sum of partials[0, n), out[1] = max of partials[n, 2n): each
// thread folds a fixed stride of the partials, then the block tree.
__global__ void fold_partials_kernel(const float* __restrict__ partials,
                                     int64_t n, float* __restrict__ out) {
  float s = 0.f, m = 0.f;
  for (int64_t k = threadIdx.x; k < n; k += RT) {
    s += partials[k];
    m = fmaxf(m, partials[n + k]);
  }
  block_sum_max(s, m, RT);
  if (threadIdx.x == 0) {
    out[0] = s;
    out[1] = m;
  }
}

// ------------------------------------------------------------ K1
// Replaces waterlily_tpu/ops/pallas_flat.py:376 conv_diff_k in its fused
// mode (cheap=(u0, dt, keep_base, scale), f_rows): the conv-diff RHS
//   f_i = sum_j phi - phi(+e_j)   on interior cells, 0 on ghosts
// (the flat engine's ghost rule, models/flowflat.py:81 -- not K12's, which
// defines f at ghosts), and the far-field BDIM + interior scale
//   u_new_i = scale (keep_base u_i + mm_i (u0_i + dt f_i))   interior
//           = u_i                                            ghosts
// with mm_i zero on component i's face-1 plane (pallas_flat.py:573-585).
// f is written only on x rows [f_lo, f_hi): the caller reads it on the body
// slab alone.  Bytes: reads u (3), u0 (3), writes u_new (3): 36 B/cell, and f
// (3) on the rows of the slab: 12 B/cell there, 48 B/cell when every row is
// asked for; with the slab on a third of the rows 40 B/cell, 0.21 ms at
// 258^3 at the HBM roofline.  The RHS comes from the tiled core of
// convdiff_tile.cuh (walled: PER = 0); this epilogue reads u0 once,
// coalesced, before the step's fluxes, and takes u at the cell from the tile.
struct BdimEpilogue {
  struct Pre {
    float u0[3];
  };
  const float* __restrict__ u0;
  float dt, keep_base, scale;
  int f_lo, f_hi;
  float* __restrict__ u_new;
  float* __restrict__ f;
  // u0 at an interior cell (never read on ghosts)
  __device__ __forceinline__ Pre pre(const Grid3& g, int x, int y, int z,
                                     int64_t c) const {
    Pre p = {};
    if (interior(g, x, y, z)) {
#pragma unroll
      for (int i = 0; i < 3; ++i) p.u0[i] = u0[(int64_t)i * g.n + c];
    }
    return p;
  }
  __device__ __forceinline__ void operator()(const Grid3& g, int x, int y,
                                             int z, int64_t c,
                                             const float (&ri)[3],
                                             const float (&uc)[3],
                                             const Pre& p) const {
    const bool m = interior(g, x, y, z);
    const bool wf = x >= f_lo && x < f_hi;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      int64_t ci = (int64_t)i * g.n + c;
      float fi = m ? ri[i] : 0.f;
      if (wf) f[ci] = fi;
      float ui = uc[i];
      if (m) {
        int face = i == 0 ? x : (i == 1 ? y : z);
        float mm = face == 1 ? 0.f : 1.f;
        ui = scale * (keep_base * ui + mm * (p.u0[i] + dt * fi));
      }
      u_new[ci] = ui;
    }
  }
};

// ------------------------------------------------------------ BC!
// The BC! update (ops/bc.py bc_vector, src/core.jl:199-224) is a sequence of
// where-steps over directions j = x, y, z: Dirichlet U on the ghost slabs
// and the first interior face of the normal component, copies of the
// neighbour slab into the ghost slabs of the tangential ones.  A corner or
// edge ghost reads what an earlier step wrote elsewhere, so one thread per
// cell composes the index map: undo the steps last-first.  Returns true when
// a step wrote U at (x, y, z); otherwise moves (x, y, z) to the cell whose
// pre-BC value lands there.  With save_exit the x-high ghost plane of
// component 0 (the convective exit plane) keeps its value: no Dirichlet
// step writes it, and the tangential y and z copies that follow in the
// sequence still move its edge cells (ops/pallas_flat.py:1049-1073).
__device__ __forceinline__ bool bc_source(const Grid3& g, int i, bool save_exit,
                                          int& x, int& y, int& z) {
  if (i == 2) {
    if (z == 0 || z == 1 || z == g.nz - 1) return true;
  } else if (z == 0) {
    z = 1;
  } else if (z == g.nz - 1) {
    z = g.nz - 2;
  }
  if (i == 1) {
    if (y == 0 || y == 1 || y == g.ny - 1) return true;
  } else if (y == 0) {
    y = 1;
  } else if (y == g.ny - 1) {
    y = g.ny - 2;
  }
  if (i == 0) {
    if (x == 0 || x == 1 || (x == g.nx - 1 && !save_exit)) return true;
  } else if (x == 0) {
    x = 1;
  } else if (x == g.nx - 1) {
    x = g.nx - 2;
  }
  return false;
}

struct Ubc {
  float v[3];
};

// BC'd value of component i at (x, y, z)
__device__ __forceinline__ float bc_value(const float* __restrict__ u,
                                          const Ubc& U, const Grid3& g, int i,
                                          bool save_exit, int x, int y, int z) {
  if (bc_source(g, i, save_exit, x, y, z)) return U.v[i];
  return u[(int64_t)i * g.n + at(g, x, y, z)];
}

// ------------------------------------------------------------ K8
// Replaces waterlily_tpu/ops/pallas_flat.py:1143 bc_div_k (with the x ghost
// rows of _bc_ghost_rows, :1107, in-kernel): u_bc = BC!(u) and
//   div = sum_i u_bc_i(+e_i) - u_bc_i   on interior cells, 0 on ghosts.
// Bytes: reads u (3), writes u_bc (3) and div: 28 B/cell, 0.14 ms at 258^3
// at the HBM roofline.
__global__ void bc_div_kernel(const float* __restrict__ u, Ubc U,
                              float* __restrict__ u_bc,
                              float* __restrict__ div, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int x = blockIdx.z;
  if (z >= g.nz || y >= g.ny) return;
  int64_t c = at(g, x, y, z);
  bool m = interior(g, x, y, z);
  float s = 0.f;
  for (int i = 0; i < 3; ++i) {
    float v = bc_value(u, U, g, i, false, x, y, z);
    u_bc[(int64_t)i * g.n + c] = v;
    if (m) {
      int p[3] = {x, y, z};
      p[i] += 1;
      s = s + (bc_value(u, U, g, i, false, p[0], p[1], p[2]) - v);
    }
  }
  div[c] = s;
}

// ------------------------------------------------------------ K9
// Replaces waterlily_tpu/ops/pallas_flat.py:1201 projbc_k (+ _proj_row,
// :1188): u_i -= L_i (x - x(-e_i)) on interior cells, then BC! (with
// save_exit the exit plane of u_0 keeps its pre-projection value: it is a
// ghost plane, never corrected), then with want_cfl the CFL summand
//   s = sum_i max(0, u_i(+e_i)) + max(0, -u_i)
// maxed over the interior into *smax (atomicMax on the float bits; s >= 0).
// A ghost thread recomputes the projected value at its BC source cell (the
// x ghost rows copy the projected neighbour row, as _proj_row does).
// Bytes: reads u (3), x, L (3), writes u (3): 40 B/cell, 0.21 ms at 258^3
// at the HBM roofline.
__device__ __forceinline__ float proj_value(const float* __restrict__ u,
                                            const float* __restrict__ xp,
                                            const float* __restrict__ L,
                                            const Ubc& U, const Grid3& g,
                                            int i, bool save_exit, int x,
                                            int y, int z) {
  if (bc_source(g, i, save_exit, x, y, z)) return U.v[i];
  int64_t c = at(g, x, y, z);
  float v = u[(int64_t)i * g.n + c];
  if (interior(g, x, y, z))
    v = v - L[(int64_t)i * g.n + c] * (xp[c] - xp[c - stride(g, i)]);
  return v;
}

template <bool CFL>
__global__ void projbc_kernel(const float* __restrict__ u,
                              const float* __restrict__ xp,
                              const float* __restrict__ L, Ubc U,
                              bool save_exit, float* __restrict__ u_out,
                              float* __restrict__ smax, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int x = blockIdx.z;
  bool valid = z < g.nz && y < g.ny;
  float s = 0.f;
  if (valid) {
    int64_t c = at(g, x, y, z);
    bool m = interior(g, x, y, z);
    for (int i = 0; i < 3; ++i) {
      float v = proj_value(u, xp, L, U, g, i, save_exit, x, y, z);
      u_out[(int64_t)i * g.n + c] = v;
      if (CFL && m) {
        int p[3] = {x, y, z};
        p[i] += 1;
        float up = proj_value(u, xp, L, U, g, i, save_exit, p[0], p[1], p[2]);
        s = s + fmaxf(up, 0.f) + fmaxf(-v, 0.f);
      }
    }
  }
  if (CFL) {
    float unused = 0.f;
    block_sum_max(unused, s, NT);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      atomicMax(reinterpret_cast<int*>(smax), __float_as_int(s));
  }
}

// ------------------------------------------------------------ K10
// Replaces waterlily_tpu/ops/pallas_flat.py:1076 bc_k (BC! alone, ±
// save_exit; the flat engine's bc_vector_flat, ops/flat.py:222): K8
// without the divergence, one thread per cell writing all three
// components.  Bytes: reads u (3), writes u_bc (3): 24 B/cell, 0.12 ms at
// 258^3 at the HBM roofline.
__global__ void bc_kernel(const float* __restrict__ u, Ubc U, bool save_exit,
                          float* __restrict__ u_bc, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int x = blockIdx.z;
  if (z >= g.nz || y >= g.ny) return;
  int64_t c = at(g, x, y, z);
  for (int i = 0; i < 3; ++i)
    u_bc[(int64_t)i * g.n + c] = bc_value(u, U, g, i, save_exit, x, y, z);
}

// ------------------------------------------------------------ K11
// Replaces waterlily_tpu/ops/pallas_flat.py:1279 div_k (div_flat,
// ops/flat.py:372): the cell-centred divergence
//   div = sum_i u_i(+e_i) - u_i   on interior cells, 0 on ghosts.
// Bytes: reads u (3), writes div: 16 B/cell, 0.08 ms at 258^3 at the HBM
// roofline.
__global__ void div_kernel(const float* __restrict__ u,
                           float* __restrict__ div, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int x = blockIdx.z;
  if (z >= g.nz || y >= g.ny) return;
  int64_t c = at(g, x, y, z);
  float s = 0.f;
  if (interior(g, x, y, z)) {
    for (int i = 0; i < 3; ++i) {
      const float* ui = u + (int64_t)i * g.n;
      s = s + (ui[c + stride(g, i)] - ui[c]);
    }
  }
  div[c] = s;
}

// ------------------------------------------------------------ K6 / K7
// Replaces waterlily_tpu/ops/pallas_flat.py:896 incr_gs (the fused fine
// tail of each MG iteration) and, with no colours, :1307 increment_k:
//   r1 = r - w A eps;  e = RB sweeps of r1 (e = r1 iD, then each colour);
//   x' = x + w (eps + e);  r' = r1 - w A e          (interior cells)
// with no colours: x' = x + w eps, r' = r - w A eps.  Ghosts keep x and r.
// With norms it also reduces (sum |r'|, max |r'|) over every cell.
// Routes, chosen from the arguments and the shape (incr_gs_route): 1 to
// RB_MAX_IT colours are one launch of the tiled cascade below
// (incr_gs_tile_kernel, float32 or bf16) and the fold of its norm
// partials; no colours (K6) is one pass of incr_tail_kernel, 32 B/cell,
// 0.16 ms at 258^3; more than RB_MAX_IT colours take a head pass (r1 into
// r_out, e), K15's colour sweep per colour, a tail pass (x', r', the norm
// partials) and the fold: ~180 B/cell with 4 colours, which is what the
// cascade replaces.  The bf16 form keeps the per-colour launches on levels
// below INCR_GS_MP_TILE_MIN_CELLS cells (measured: see below).
//
// The cascade (rb_cascade.cuh, form RB_INCR_GS, MP for bf16; what bounds it
// and what the design does are written there) with its norms reduced in
// the block's fixed tree into per-block partials.
template <int IT, bool NORMS, bool MP>
__global__ void __launch_bounds__(RbShape<IT>::NT, 1)
    incr_gs_tile_kernel(const float* __restrict__ x,
                        const float* __restrict__ r,
                        const float* __restrict__ eps,
                        const coef_t<MP>* __restrict__ L,
                        const coef_t<MP>* __restrict__ D,
                        const coef_t<MP>* __restrict__ iD, float omega,
                        unsigned cmask, int xc, float* __restrict__ x_out,
                        float* __restrict__ r_out,
                        float* __restrict__ partials, Grid3 g) {
  float acc_s = 0.f, acc_m = 0.f;
  rb_cascade<IT, NORMS ? RB_INCR_GS_NORMS : RB_INCR_GS, MP>(
      x, r, eps, L, D, iD, omega, cmask, 0u, xc, x_out, r_out, acc_s, acc_m,
      g);
  if (NORMS) {
    block_sum_max(acc_s, acc_m, RbShape<IT>::NT);
    if (threadIdx.x == 0) {
      const int64_t b = block_linear();
      const int64_t nb = (int64_t)gridDim.x * gridDim.y * gridDim.z;
      partials[b] = acc_s;
      partials[nb + b] = acc_m;
    }
  }
}

// each instantiation finds its own resident block slots: a bf16 form with
// other registers or shared memory gets the grid of its own occupancy
template <int IT, bool NORMS, bool MP>
cudaError_t incr_gs_tile_grid(const Grid3& g, dim3& grid, int& xc) {
  static int slots = 0;
  return rb_cascade_grid<IT>(
      incr_gs_tile_kernel<IT, NORMS, MP>,
      rb_smem<IT, NORMS ? RB_INCR_GS_NORMS : RB_INCR_GS, MP>(), slots, g, grid,
      xc);
}

template <int IT, bool NORMS, bool MP>
cudaError_t launch_incr_gs_it(const float* x, const float* r,
                              const float* eps, const coef_t<MP>* L,
                              const coef_t<MP>* D, const coef_t<MP>* iD,
                              float omega, unsigned cmask, float* x_out,
                              float* r_out, float* partials, float* norms,
                              const Grid3& g, cudaStream_t s) {
  dim3 grid;
  int xc;
  cudaError_t err = incr_gs_tile_grid<IT, NORMS, MP>(g, grid, xc);
  if (err != cudaSuccess) return err;
  incr_gs_tile_kernel<IT, NORMS, MP>
      <<<grid, RbShape<IT>::NT,
         rb_smem<IT, NORMS ? RB_INCR_GS_NORMS : RB_INCR_GS, MP>(), s>>>(
          x, r, eps, L, D, iD, omega, cmask, xc, x_out, r_out, partials, g);
  if ((err = cudaGetLastError()) != cudaSuccess || !NORMS) return err;
  int64_t nb = (int64_t)grid.x * grid.y * grid.z;
  fold_partials_kernel<<<1, RT, 0, s>>>(partials, nb, norms);
  return cudaGetLastError();
}

template <bool NORMS, bool MP>
cudaError_t launch_incr_gs_tile(const float* x, const float* r,
                                const float* eps, const coef_t<MP>* L,
                                const coef_t<MP>* D, const coef_t<MP>* iD,
                                float omega, const int* colors, int ncolors,
                                float* x_out, float* r_out, float* partials,
                                float* norms, const Grid3& g,
                                cudaStream_t s) {
  unsigned cmask = 0;
  for (int k = 0; k < ncolors; ++k) cmask |= (unsigned)(colors[k] & 1) << k;
#define WLT_IG_CASE(IT)                                                    \
  case IT:                                                                 \
    return launch_incr_gs_it<IT, NORMS, MP>(x, r, eps, L, D, iD, omega,    \
                                            cmask, x_out, r_out, partials, \
                                            norms, g, s)
  switch (ncolors) {
    WLT_IG_CASE(1);
    WLT_IG_CASE(2);
    WLT_IG_CASE(3);
    WLT_IG_CASE(4);
    default: return cudaErrorInvalidValue;
  }
#undef WLT_IG_CASE
}

// the blocks of the grid of the cascade with norms, or -1 on an error
template <bool MP>
int64_t incr_gs_tile_blocks(const Grid3& g, int ncolors) {
  dim3 grid;
  int xc;
  cudaError_t err;
  switch (ncolors) {
    case 1: err = incr_gs_tile_grid<1, true, MP>(g, grid, xc); break;
    case 2: err = incr_gs_tile_grid<2, true, MP>(g, grid, xc); break;
    case 3: err = incr_gs_tile_grid<3, true, MP>(g, grid, xc); break;
    case 4: err = incr_gs_tile_grid<4, true, MP>(g, grid, xc); break;
    default: return -1;
  }
  return err == cudaSuccess ? (int64_t)grid.x * grid.y * grid.z : -1;
}

// ------------------------------------------------------------ K6, K7 per colour
// The per-colour route (more than RB_MAX_IT colours, bf16 on small levels)
// and K6.
// MP instantiation (pallas_flat.py:896 incr_gs with mp=True; the arithmetic
// is in stencil_common.cuh): L, D, iD and the e scratch are bf16.  r1 is
// formed in float32 from the float32 eps and the bf16 coefficients and kept
// in float32; the cascade reads its bf16 rounding; A e is accumulated in
// bf16; x', r' and the norms are float32.  The call must move x, r, eps in,
// x', r' out (20 B) and five bf16 coefficients (10 B): 30 B/cell against 40,
// 0.15 ms at 258^3.  It needs at least one colour: the increment alone (K6)
// has no mixed-precision form.
//
// The size rule of the bf16 cascade: its march's fixed cost per step loses
// to the per-colour launches on small levels.  Device time per call with
// norms, 4 / 2 colours, cascade against per-colour, both routes in one call
// on an H100 (PERF.md section 6): 258^3 0.704 / 0.532 against 0.942 /
// 0.665 ms, 322x130x130 0.239 / 0.178 against 0.314 / 0.227, 130^3 0.113 /
// 0.081 against 0.131 / 0.098; 98^3 (941K cells) 0.061 / 0.042 against
// 0.059 / 0.043, 162x66x66 (706K) 0.051 / 0.034 against 0.049 / 0.036;
// 82^3 (551K), 66^3, 50^3, 82x34x34 and 34^3 lost by 4-46 %.  The threshold
// sits between the largest level that lost with 4 colours and the smallest
// that won with both.
constexpr int64_t INCR_GS_MP_TILE_MIN_CELLS = 1000000;
template <bool MP>
__global__ void incr_head_kernel(const float* __restrict__ r,
                                 const float* __restrict__ eps,
                                 const coef_t<MP>* __restrict__ L,
                                 const coef_t<MP>* __restrict__ D,
                                 const coef_t<MP>* __restrict__ iD,
                                 float omega, float* __restrict__ r1,
                                 coef_t<MP>* __restrict__ e, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int x = blockIdx.z;
  if (z >= g.nz || y >= g.ny) return;
  int64_t c = at(g, x, y, z);
  float rv = r[c];
  if constexpr (MP) {
    bf16 ev = rb(0.f);
    if (interior(g, x, y, z)) {
      rv = __fsub_rn(rv, __fmul_rn(omega, apply_A_mixed(eps, L, D, g, c)));
      ev = bmul(rb(rv), iD[c]);
    }
    e[c] = ev;
  } else {
    float ev = 0.f;
    if (interior(g, x, y, z)) {
      rv = rv - omega * apply_A(eps, L, D, g, c);
      ev = rv * iD[c];
    }
    e[c] = ev;
  }
  r1[c] = rv;
}

// rin may alias r_out: each thread reads rin at its own cell only, before it
// writes r_out there.  e == nullptr (float32 only): the increment alone.
template <bool NORMS, bool MP>
__global__ void incr_tail_kernel(const float* __restrict__ x,
                                 const float* rin,
                                 const float* __restrict__ eps,
                                 const coef_t<MP>* __restrict__ e,
                                 const coef_t<MP>* __restrict__ L,
                                 const coef_t<MP>* __restrict__ D,
                                 float omega, float* __restrict__ x_out,
                                 float* r_out, float* __restrict__ partials,
                                 Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int xi = blockIdx.z;
  float a = 0.f;
  if (z < g.nz && y < g.ny) {
    int64_t c = at(g, xi, y, z);
    float xv = x[c], rv = rin[c];
    if (interior(g, xi, y, z)) {
      if constexpr (MP) {
        xv = __fadd_rn(xv, __fmul_rn(omega, __fadd_rn(eps[c], fb(e[c]))));
        rv = __fsub_rn(rv, __fmul_rn(omega, fb(apply_A_bf16(e, L, D, g, c))));
      } else if (e != nullptr) {
        xv = xv + omega * (eps[c] + e[c]);
        rv = rv - omega * apply_A(e, L, D, g, c);
      } else {
        xv = xv + omega * eps[c];
        rv = rv - omega * apply_A(eps, L, D, g, c);
      }
    }
    x_out[c] = xv;
    r_out[c] = rv;
    a = fabsf(rv);
  }
  if (NORMS) {
    float m = a;
    block_sum_max(a, m, NT);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      int64_t b = block_linear();
      int64_t nb = (int64_t)gridDim.x * gridDim.y * gridDim.z;
      partials[b] = a;
      partials[nb + b] = m;
    }
  }
}

// 1: the tiled cascade (1 to RB_MAX_IT colours; bf16 from
// INCR_GS_MP_TILE_MIN_CELLS cells), 0: K6 or the per-colour launches
__host__ int incr_gs_route(const Grid3& g, int ncolors, bool mp) {
  return ncolors >= 1 && ncolors <= RB_MAX_IT &&
         (!mp || g.n >= INCR_GS_MP_TILE_MIN_CELLS);
}

// e: scratch field (used by the per-colour route only); partials: 2 x
// wlt_incr_gs_partials floats and norms: 2 floats, both nullptr without
// norms; route: as incr_gs_route gives it (1 needs 1 to RB_MAX_IT
// colours).  r must not alias r_out: the cascade reads r at other blocks'
// cells.
template <bool MP>
cudaError_t launch_incr_gs(const float* x, const float* r, const float* eps,
                           const coef_t<MP>* L, const coef_t<MP>* D,
                           const coef_t<MP>* iD, coef_t<MP>* e, float* x_out,
                           float* r_out, const int* colors, int ncolors,
                           float omega, float* partials, float* norms,
                           int route, const Grid3& g, cudaStream_t s) {
  if (route == 1) {
    if (ncolors < 1 || ncolors > RB_MAX_IT) return cudaErrorInvalidValue;
    return norms == nullptr
               ? launch_incr_gs_tile<false, MP>(x, r, eps, L, D, iD, omega,
                                                colors, ncolors, x_out, r_out,
                                                nullptr, nullptr, g, s)
               : launch_incr_gs_tile<true, MP>(x, r, eps, L, D, iD, omega,
                                               colors, ncolors, x_out, r_out,
                                               partials, norms, g, s);
  }
  if (route != 0) return cudaErrorInvalidValue;
  dim3 block(BZ, BY);
  dim3 grid = grid_of(g, 1);
  cudaError_t err;
  const float* rin = r;
  const coef_t<MP>* ep = nullptr;
  if (MP && ncolors == 0) return cudaErrorInvalidValue;
  if (ncolors > 0) {
    incr_head_kernel<MP><<<grid, block, 0, s>>>(r, eps, L, D, iD, omega, r_out,
                                                e, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    for (int k = 0; k < ncolors; ++k) {
      gs_sweep_kernel<MP><<<grid, block, 0, s>>>(r_out, L, iD, e, colors[k], g);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    rin = r_out;
    ep = e;
  }
  if (norms == nullptr) {
    incr_tail_kernel<false, MP><<<grid, block, 0, s>>>(
        x, rin, eps, ep, L, D, omega, x_out, r_out, nullptr, g);
    return cudaGetLastError();
  }
  incr_tail_kernel<true, MP><<<grid, block, 0, s>>>(
      x, rin, eps, ep, L, D, omega, x_out, r_out, partials, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  int64_t nb = (int64_t)grid.x * grid.y * grid.z;
  fold_partials_kernel<<<1, RT, 0, s>>>(partials, nb, norms);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 if wlt_incr_gs (mp = 0) or wlt_incr_gs_mp (mp = 1) with ncolors
// colours on this shape takes the cascade, 0 if it takes K6 or the
// per-colour launches (which need the e scratch field)
int wlt_incr_gs_route(int64_t nx, int64_t ny, int64_t nz, int ncolors,
                      int mp) {
  return incr_gs_route(make_grid(nx, ny, nz), ncolors, mp != 0);
}

// the length of each half of the norm partials buffer of wlt_incr_gs (mp
// = 0) or wlt_incr_gs_mp (mp = 1) with ncolors colours on `route`: the
// blocks of the grid that the route and form launch, or -1 on an error
int64_t wlt_incr_gs_partials(int64_t nx, int64_t ny, int64_t nz, int ncolors,
                             int mp, int route) {
  Grid3 g = make_grid(nx, ny, nz);
  if (route == 1)
    return mp ? incr_gs_tile_blocks<true>(g, ncolors)
              : incr_gs_tile_blocks<false>(g, ncolors);
  dim3 gr = grid_of(g, 1);
  return (int64_t)gr.x * gr.y * gr.z;
}

int wlt_conv_diff_bdim(const float* u, const float* u0, const float* nu,
                       float dt, float keep_base, float scale, int f_lo,
                       int f_hi, float* u_new, float* f, int64_t nx,
                       int64_t ny, int64_t nz, int scheme_id, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  BdimEpilogue epi = {u0, dt, keep_base, scale, f_lo, f_hi, u_new, f};
  cudaStream_t s = (cudaStream_t)stream;
  switch (scheme_id) {
    case 0: return (int)launch_conv_diff_tile<0, 0>(u, nu, g, epi, s);
    case 1: return (int)launch_conv_diff_tile<1, 0>(u, nu, g, epi, s);
    case 2: return (int)launch_conv_diff_tile<2, 0>(u, nu, g, epi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int wlt_bc_div(const float* u, float u0, float u1, float u2, float* u_bc,
               float* div, int64_t nx, int64_t ny, int64_t nz, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  Ubc U = {{u0, u1, u2}};
  bc_div_kernel<<<grid_of(g, 1), dim3(BZ, BY), 0, (cudaStream_t)stream>>>(
      u, U, u_bc, div, g);
  return (int)cudaGetLastError();
}

// smax == nullptr: no CFL reduction
int wlt_projbc(const float* u, const float* xp, const float* L, float u0,
               float u1, float u2, int save_exit, float* u_out, float* smax,
               int64_t nx, int64_t ny, int64_t nz, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  Ubc U = {{u0, u1, u2}};
  bool se = save_exit != 0;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid = grid_of(g, 1), block(BZ, BY);
  if (smax == nullptr) {
    projbc_kernel<false><<<grid, block, 0, s>>>(u, xp, L, U, se, u_out,
                                                nullptr, g);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaMemsetAsync(smax, 0, sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  projbc_kernel<true><<<grid, block, 0, s>>>(u, xp, L, U, se, u_out, smax, g);
  return (int)cudaGetLastError();
}

int wlt_bc(const float* u, float u0, float u1, float u2, int save_exit,
           float* u_bc, int64_t nx, int64_t ny, int64_t nz, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  Ubc U = {{u0, u1, u2}};
  bc_kernel<<<grid_of(g, 1), dim3(BZ, BY), 0, (cudaStream_t)stream>>>(
      u, U, save_exit != 0, u_bc, g);
  return (int)cudaGetLastError();
}

int wlt_div(const float* u, float* div, int64_t nx, int64_t ny, int64_t nz,
            void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  div_kernel<<<grid_of(g, 1), dim3(BZ, BY), 0, (cudaStream_t)stream>>>(u, div,
                                                                       g);
  return (int)cudaGetLastError();
}

// route: as wlt_incr_gs_route gives it
int wlt_incr_gs(const float* x, const float* r, const float* eps,
                const float* L, const float* D, const float* iD, float* e,
                float* x_out, float* r_out, const int* colors, int ncolors,
                float omega, float* partials, float* norms, int route,
                int64_t nx, int64_t ny, int64_t nz, void* stream) {
  return (int)launch_incr_gs<false>(x, r, eps, L, D, iD, e, x_out, r_out,
                                    colors, ncolors, omega, partials, norms,
                                    route, make_grid(nx, ny, nz),
                                    (cudaStream_t)stream);
}

// the mixed-precision instantiation: L, D, iD and the e scratch are bf16;
// ncolors >= 1
int wlt_incr_gs_mp(const float* x, const float* r, const float* eps,
                   const bf16* L, const bf16* D, const bf16* iD, bf16* e,
                   float* x_out, float* r_out, const int* colors, int ncolors,
                   float omega, float* partials, float* norms, int route,
                   int64_t nx, int64_t ny, int64_t nz, void* stream) {
  return (int)launch_incr_gs<true>(x, r, eps, L, D, iD, e, x_out, r_out,
                                   colors, ncolors, omega, partials, norms,
                                   route, make_grid(nx, ny, nz),
                                   (cudaStream_t)stream);
}

}  // extern "C"
