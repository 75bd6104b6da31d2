// Dense-layout stencil kernels of the static-body main path, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// waterlily_tpu_torch/ops/_build.py; every entry launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
//
// Layout: a scalar field is (nx, ny, nz) float32, contiguous, z fastest; a
// vector field (3, nx, ny, nz); a tensor field (3, 3, nx, ny, nz).  Offsets
// are 64-bit: mu1 at 258^3 holds 154 M elements.
//
// Threads: one per cell, a block is 32 (z) x 8 (y) cells of one x row, so a
// warp reads 32 consecutive floats (coalesced).  Grid = (ceil(nz/32),
// ceil(ny/8), nx * components).  Neighbour reads along y and x hit lines that
// the adjacent warps and blocks load too, so L1/L2 absorb most of the 7-point
// reuse.
//
// What bounds these kernels on an H100 (3.35 TB/s HBM3): all four do < 1 flop
// per byte, so each is bound by memory traffic.  The bytes each must move per
// cell are given beside each kernel; time = bytes x cells / 3.35 TB/s is the
// floor.  This first version relies on the caches for the stencil reuse; a
// shared-memory tile with halos (the Hopper form of the TPU's x-row VMEM
// windows) is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BZ = 32;
constexpr int BY = 8;

struct Grid3 {
  int nx, ny, nz;
  int64_t sx, sy, n;  // strides of x and y, cells per field
};

__host__ Grid3 make_grid(int64_t nx, int64_t ny, int64_t nz) {
  Grid3 g;
  g.nx = (int)nx;
  g.ny = (int)ny;
  g.nz = (int)nz;
  g.sy = nz;
  g.sx = ny * nz;
  g.n = nx * ny * nz;
  return g;
}

__device__ __forceinline__ bool interior(const Grid3& g, int x, int y, int z) {
  return x >= 1 && x <= g.nx - 2 && y >= 1 && y <= g.ny - 2 && z >= 1 &&
         z <= g.nz - 2;
}

__device__ __forceinline__ int wrap(int k, int n) {
  return k < 0 ? k + n : (k >= n ? k - n : k);
}

__device__ __forceinline__ int64_t at(const Grid3& g, int x, int y, int z) {
  return (int64_t)x * g.sx + (int64_t)y * g.sy + z;
}

// stride of spatial direction d
__device__ __forceinline__ int64_t stride(const Grid3& g, int d) {
  return d == 0 ? g.sx : (d == 1 ? g.sy : 1);
}

__host__ dim3 grid_of(const Grid3& g, int comps) {
  return dim3((g.nz + BZ - 1) / BZ, (g.ny + BY - 1) / BY, g.nx * comps);
}

// ------------------------------------------------------------ schemes
__device__ __forceinline__ float median3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// u = upstream, c = centre, d = downstream (models/flow.py quick/vanleer/cds)
template <int SCHEME>
__device__ __forceinline__ float scheme(float u, float c, float d) {
  if (SCHEME == 0) {  // median-limited QUICK
    return median3((5.f * c + 2.f * d - u) / 6.f, c,
                   median3(10.f * c - 9.f * u, c, d));
  } else if (SCHEME == 1) {  // van Leer with the divide-safe guard
    float denom = d - u;
    float safe = denom == 0.f ? 1.f : denom;
    float lim = c + (d - c) * (c - u) / safe;
    bool revert = (c <= fminf(u, d)) || (c >= fmaxf(u, d));
    return revert ? c : lim;
  } else {  // central difference
    return (c + d) / 2.f;
  }
}

// ------------------------------------------------------------ K12 conv_diff
// Replaces waterlily_tpu/ops/pallas3d.py:274 conv_diff3d_generic and the
// slab fixes its caller composes (models/flow.py:295-323): the whole jnp
// formula of models/flow.py:276-292 for non-periodic directions.
//
// Flux of component i through the lower j-face of cell p, with roll-wrap
// reads ((k +- s) mod n), phiL at j-index 1 and phiR at j-index n-1.
// Bytes: reads u (3 fields), writes r (3 fields): 24 B/cell, 0.12 ms at 258^3
// at the HBM roofline.  Each thread recomputes 6 fluxes from ~30 reads that
// the caches serve; the design keeps one thread per (cell, component) so all
// 3 x 3 flux pairs stay in registers and nothing else touches memory.
template <int SCHEME>
__device__ __forceinline__ float flux(const float* __restrict__ u,
                                      const Grid3& g, float nu, int i, int j,
                                      int px, int py, int pz) {
  const int dims[3] = {g.nx, g.ny, g.nz};
  int p[3] = {px, py, pz};
  const float* f = u + (int64_t)i * g.n;
  const float* uj = u + (int64_t)j * g.n;
  int n = dims[j];
  int pj = p[j];
  // advecting velocity: mean of u_j at p and at p - e_i (wrapped)
  int q[3] = {px, py, pz};
  q[i] = wrap(p[i] - 1, dims[i]);
  float uadv = 0.5f * (uj[at(g, p[0], p[1], p[2])] + uj[at(g, q[0], q[1], q[2])]);
  int m1[3] = {px, py, pz};
  m1[j] = wrap(pj - 1, n);
  float fc = f[at(g, p[0], p[1], p[2])];
  float fm1 = f[at(g, m1[0], m1[1], m1[2])];
  float v;
  if (pj == 1) {  // phiL: central upwind value at the first interior face
    int p2[3] = {px, py, pz};
    p2[j] = 2;
    float f2 = f[at(g, p2[0], p2[1], p2[2])];
    v = uadv > 0.f ? 0.5f * (fc + fm1) : scheme<SCHEME>(f2, fc, fm1);
  } else if (pj == n - 1) {  // phiR: top ghost face
    int p3[3] = {px, py, pz};
    p3[j] = n - 3;
    float fm3 = f[at(g, p3[0], p3[1], p3[2])];
    v = uadv < 0.f ? 0.5f * (fc + fm1) : scheme<SCHEME>(fm3, fm1, fc);
  } else {
    int a[3] = {px, py, pz};
    int b[3] = {px, py, pz};
    a[j] = wrap(pj - 2, n);
    b[j] = wrap(pj + 1, n);
    float fm2 = f[at(g, a[0], a[1], a[2])];
    float fp1 = f[at(g, b[0], b[1], b[2])];
    v = uadv > 0.f ? scheme<SCHEME>(fm2, fm1, fc) : scheme<SCHEME>(fp1, fc, fm1);
  }
  return uadv * v - nu * (fc - fm1);
}

template <int SCHEME>
__global__ void conv_diff_kernel(const float* __restrict__ u,
                                 const float* __restrict__ nu_ptr,
                                 float* __restrict__ r, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int i = blockIdx.z / g.nx;
  int x = blockIdx.z - i * g.nx;
  if (z >= g.nz || y >= g.ny) return;
  float nu = *nu_ptr;
  const int dims[3] = {g.nx, g.ny, g.nz};
  float ri = 0.f;
  for (int j = 0; j < 3; ++j) {
    int nb[3] = {x, y, z};
    nb[j] = wrap(nb[j] + 1, dims[j]);
    float phi = flux<SCHEME>(u, g, nu, i, j, x, y, z);
    float phi_up = flux<SCHEME>(u, g, nu, i, j, nb[0], nb[1], nb[2]);
    ri = ri + (phi - phi_up);
  }
  r[(int64_t)i * g.n + at(g, x, y, z)] = ri;
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
__device__ __forceinline__ float apply_A(const float* __restrict__ x,
                                         const float* __restrict__ L,
                                         const float* __restrict__ D,
                                         const Grid3& g, int64_t c) {
  float s = x[c] * D[c];
  for (int d = 0; d < 3; ++d) {
    int64_t st = stride(g, d);
    const float* Ld = L + (int64_t)d * g.n;
    s = s + x[c - st] * Ld[c];
    s = s + x[c + st] * Ld[c + st];
  }
  return s;
}

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

__global__ void gs_sweep_kernel(const float* __restrict__ r,
                                const float* __restrict__ L,
                                const float* __restrict__ iD,
                                float* eps, int color, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int x = blockIdx.z;
  if (z >= g.nz || y >= g.ny) return;
  if (!interior(g, x, y, z) || ((x + y + z) & 1) != color) return;
  int64_t c = at(g, x, y, z);
  float s = r[c];
  for (int d = 0; d < 3; ++d) {
    int64_t st = stride(g, d);
    const float* Ld = L + (int64_t)d * g.n;
    s = s - (eps[c - st] * Ld[c] + eps[c + st] * Ld[c + st]);
  }
  eps[c] = s * iD[c];
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

}  // namespace

extern "C" {

const char* wlt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int wlt_conv_diff(const float* u, const float* nu, float* r, int64_t nx,
                  int64_t ny, int64_t nz, int scheme_id, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  dim3 block(BZ, BY);
  dim3 grid = grid_of(g, 3);
  cudaStream_t s = (cudaStream_t)stream;
  switch (scheme_id) {
    case 0: conv_diff_kernel<0><<<grid, block, 0, s>>>(u, nu, r, g); break;
    case 1: conv_diff_kernel<1><<<grid, block, 0, s>>>(u, nu, r, g); break;
    case 2: conv_diff_kernel<2><<<grid, block, 0, s>>>(u, nu, r, g); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

}  // extern "C"
