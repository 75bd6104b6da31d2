// Dense-layout stencil kernels of the static-body main path, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// waterlily_tpu_torch/ops/_build.py; every entry launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
//
// Layout, indexing and thread shape: see stencil_common.cuh.
//
// What bounds these kernels on an H100 (3.35 TB/s HBM3): all five do < 1 flop
// per byte, so each is bound by memory traffic.  The bytes each must move per
// cell are given beside each kernel; time = bytes x cells / 3.35 TB/s is the
// floor.  This first version relies on the caches for the stencil reuse; a
// shared-memory tile with halos (the Hopper form of the TPU's x-row VMEM
// windows) is later work.

#include "stencil_common.cuh"

namespace {

// ------------------------------------------------------------ K12 conv_diff
// Replaces waterlily_tpu/ops/pallas3d.py:274 conv_diff3d_generic and the
// slab fixes its caller composes (models/flow.py:295-323): the whole jnp
// formula of models/flow.py:276-292.
//
// Flux of component i through the lower j-face of cell p, with roll-wrap
// reads ((k +- s) mod n), phiL at j-index 1 and phiR at j-index n-1; in the
// directions whose bit is set in PER the periodic phiuP fluxes instead
// (stencil_common.cuh flux).  One instantiation per scheme and periodic
// mask.
// Bytes: reads u (3 fields), writes r (3 fields): 24 B/cell, 0.12 ms at 258^3
// at the HBM roofline.  Each thread recomputes 6 fluxes from ~30 reads that
// the caches serve; the design keeps one thread per (cell, component) so all
// 3 x 3 flux pairs stay in registers and nothing else touches memory.
template <int SCHEME, int PER>
__global__ void conv_diff_kernel(const float* __restrict__ u,
                                 const float* __restrict__ nu_ptr,
                                 float* __restrict__ r, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int i = blockIdx.z / g.nx;
  int x = blockIdx.z - i * g.nx;
  if (z >= g.nz || y >= g.ny) return;
  r[(int64_t)i * g.n + at(g, x, y, z)] =
      conv_diff_at<SCHEME, PER>(u, g, *nu_ptr, i, x, y, z);
}

template <int SCHEME>
cudaError_t launch_conv_diff(const float* u, const float* nu, float* r,
                             int per, const Grid3& g, cudaStream_t s) {
  dim3 block(BZ, BY);
  dim3 grid = grid_of(g, 3);
  switch (per) {
#define WLT_CONV_DIFF_CASE(P)                                             \
  case P:                                                                 \
    conv_diff_kernel<SCHEME, P><<<grid, block, 0, s>>>(u, nu, r, g);      \
    break;
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
  return cudaGetLastError();
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
  const float* u0i = u0 + (int64_t)i * g.n;
  const float* fi = f + (int64_t)i * g.n;
  const float* Vi = V + (int64_t)i * g.n;
  float acc = 0.f;
  for (int j = 0; j < 3; ++j) {
    int64_t s = stride(g, j);
    float d = fstar(u0i, fi, Vi, dt, c + s) - fstar(u0i, fi, Vi, dt, c - s);
    acc = acc + mu1[(int64_t)(i * 3 + j) * g.n + c] * d;
  }
  float upd = 0.5f * acc + V[ci] + mu0[ci] * fstar(u0i, fi, Vi, dt, c);
  out[ci] = u[ci] + upd;
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
// One launch per colour plus one increment launch (the TPU kernel's
// communication-avoiding cascade is later work).  The colour sweep updates
// eps in place: a cell's 6 neighbours all have the other colour, so no
// thread reads a value another thread of the same launch writes.
// Bytes: init 12 B/cell; a sweep reads r, iD, L (3), eps and writes half of
// eps: ~26 B/cell; the increment reads x, r, eps, L (3), D and writes x, r:
// 36 B/cell.  With 4 colours ~152 B/cell, 0.78 ms at 258^3 at the roofline.
// Jacobi (no colours) fuses eps = r iD into the increment: 36 B/cell.
__global__ void eps_init_kernel(const float* __restrict__ r,
                                const float* __restrict__ iD,
                                float* __restrict__ eps, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int x = blockIdx.z;
  if (z >= g.nz || y >= g.ny) return;
  int64_t c = at(g, x, y, z);
  eps[c] = interior(g, x, y, z) ? r[c] * iD[c] : 0.f;
}

// eps at cell k: read from eps, or (Jacobi) computed as r iD with zero ghosts
template <bool FROM_R>
__device__ __forceinline__ float eps_at(const float* __restrict__ eps,
                                        const float* __restrict__ r,
                                        const float* __restrict__ iD,
                                        const Grid3& g, int x, int y, int z,
                                        int64_t k) {
  if (FROM_R) return interior(g, x, y, z) ? r[k] * iD[k] : 0.f;
  return eps[k];
}

template <bool FROM_R>
__global__ void increment_kernel(const float* __restrict__ x,
                                 const float* __restrict__ r,
                                 const float* __restrict__ L,
                                 const float* __restrict__ D,
                                 const float* __restrict__ iD,
                                 const float* __restrict__ eps, float omega,
                                 float* __restrict__ x_out,
                                 float* __restrict__ r_out, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int xi = blockIdx.z;
  if (z >= g.nz || y >= g.ny) return;
  int64_t c = at(g, xi, y, z);
  float e = 0.f, ae = 0.f;
  if (interior(g, xi, y, z)) {
    e = eps_at<FROM_R>(eps, r, iD, g, xi, y, z, c);
    ae = e * D[c];
    const int p[3] = {xi, y, z};
    for (int d = 0; d < 3; ++d) {
      int64_t st = stride(g, d);
      const float* Ld = L + (int64_t)d * g.n;
      int lo[3] = {p[0], p[1], p[2]};
      int hi[3] = {p[0], p[1], p[2]};
      lo[d] -= 1;
      hi[d] += 1;
      ae = ae + eps_at<FROM_R>(eps, r, iD, g, lo[0], lo[1], lo[2], c - st) * Ld[c];
      ae = ae + eps_at<FROM_R>(eps, r, iD, g, hi[0], hi[1], hi[2], c + st) * Ld[c + st];
    }
  }
  x_out[c] = x[c] + omega * e;
  r_out[c] = r[c] - omega * ae;
}

// ------------------------------------------------------------ K13 gauss_sweeps
// Replaces waterlily_tpu/ops/pallas3d.py:312 gauss_sweeps3d and :366
// gauss_sweep3d (poisson.py:163-172, the periodic smoother path): per
// colour, the periodic ghost planes of eps are refreshed (perBC!: plane 0
// takes plane n-2, plane n-1 takes plane 1, direction by direction in the
// caller's order), then gs_sweep_kernel updates the cells of that colour in
// place.  The refresh before a sweep is part of the arithmetic: a cell next
// to a periodic face reads its partner plane through the ghost, and that
// value must be the one the previous colour's sweep wrote (with an odd
// interior extent the partner has the same colour as the cell).
// Bytes per colour: the sweep ~26 B/cell, the refresh 8 B per ghost cell;
// the whole call must move eps, r, L (3), iD in and eps out: 28 B/cell.
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

int wlt_gs_incr(const float* x, const float* r, const float* L,
                const float* D, const float* iD, float* eps, float* x_out,
                float* r_out, const int* colors, int ncolors, float omega,
                int64_t nx, int64_t ny, int64_t nz, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  dim3 block(BZ, BY);
  dim3 grid = grid_of(g, 1);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (ncolors == 0) {
    increment_kernel<true><<<grid, block, 0, s>>>(x, r, L, D, iD, nullptr,
                                                  omega, x_out, r_out, g);
    return (int)cudaGetLastError();
  }
  eps_init_kernel<<<grid, block, 0, s>>>(r, iD, eps, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int k = 0; k < ncolors; ++k) {
    gs_sweep_kernel<<<grid, block, 0, s>>>(r, L, iD, eps, colors[k], g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  increment_kernel<false><<<grid, block, 0, s>>>(x, r, L, D, iD, eps, omega,
                                                 x_out, r_out, g);
  return (int)cudaGetLastError();
}

// eps is updated in place; perdir lists the periodic directions in the
// order their ghosts are refreshed (nper of them, none for a plain sweep)
int wlt_gauss_sweeps(float* eps, const float* r, const float* L,
                     const float* iD, const int* colors, int ncolors,
                     const int* perdir, int nper, int64_t nx, int64_t ny,
                     int64_t nz, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  const int dims[3] = {g.nx, g.ny, g.nz};
  dim3 block(BZ, BY);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  for (int k = 0; k < ncolors; ++k) {
    for (int q = 0; q < nper; ++q) {
      int j = perdir[q];
      if (j < 0 || j > 2) return (int)cudaErrorInvalidValue;
      int ka = j == 0 ? 1 : 0, kb = j == 2 ? 1 : 2;
      dim3 pg((dims[kb] + BZ - 1) / BZ, (dims[ka] + BY - 1) / BY);
      per_ghost_kernel<<<pg, block, 0, s>>>(eps, j, g);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    gs_sweep_kernel<<<grid_of(g, 1), block, 0, s>>>(r, L, iD, eps, colors[k], g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
