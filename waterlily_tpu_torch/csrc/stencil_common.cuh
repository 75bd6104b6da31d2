// Shared pieces of the dense-layout kernels (stencil3d.cu, fused3d.cu): the
// grid indexing, the convection schemes and the conv-diff flux, the Poisson
// operator A x, the red-black colour sweep, and the bf16 arithmetic of the
// mixed-precision smoothers.  Everything is in an anonymous namespace, so
// each source that includes it gets its own copy.
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
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

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

// ------------------------------------------------------------ conv-diff flux
// Flux of component i through the lower j-face of cell p (models/flow.py:
// 276-292), with roll-wrap reads ((k +- s) mod n), phiL at j-index 1 and
// phiR at j-index n-1.  At interior cells and their +e_j neighbours no read
// wraps, so this is also the flat engine's in-stencil form
// (ops/pallas_flat.py:378-387).
//
// Bit j of PER marks direction j periodic (phiuP, models/flow.py:204-241):
// the first-slab flux is the generic formula with its second-upwind value
// read from the periodic partner n-3 (not the roll-wrap ghost n-1), and the
// top-ghost flux at n-1 is that same first-slab flux.  PER is a template
// parameter: with a run-time mask the coordinate arrays below could not stay
// in registers (a 120-byte stack frame and 3x the time of the walled
// kernel, measured on the H100).
template <int SCHEME, int PER>
__device__ __forceinline__ float flux(const float* __restrict__ u,
                                      const Grid3& g, float nu, int i, int j,
                                      int px, int py, int pz) {
  const int dims[3] = {g.nx, g.ny, g.nz};
  int p[3] = {px, py, pz};
  int n = dims[j];
  const bool pdir = (PER >> j) & 1;
  if (pdir && p[j] == n - 1) p[j] = 1;  // phi_hi = phi_lo
  const float* f = u + (int64_t)i * g.n;
  const float* uj = u + (int64_t)j * g.n;
  int pj = p[j];
  // advecting velocity: mean of u_j at p and at p - e_i (wrapped)
  int q[3] = {p[0], p[1], p[2]};
  q[i] = wrap(p[i] - 1, dims[i]);
  float uadv = 0.5f * (uj[at(g, p[0], p[1], p[2])] + uj[at(g, q[0], q[1], q[2])]);
  int m1[3] = {p[0], p[1], p[2]};
  m1[j] = wrap(pj - 1, n);
  float fc = f[at(g, p[0], p[1], p[2])];
  float fm1 = f[at(g, m1[0], m1[1], m1[2])];
  float v;
  if (!pdir && pj == 1) {  // phiL: central upwind value at the first interior face
    int p2[3] = {p[0], p[1], p[2]};
    p2[j] = 2;
    float f2 = f[at(g, p2[0], p2[1], p2[2])];
    v = uadv > 0.f ? 0.5f * (fc + fm1) : scheme<SCHEME>(f2, fc, fm1);
  } else if (!pdir && pj == n - 1) {  // phiR: top ghost face
    int p3[3] = {p[0], p[1], p[2]};
    p3[j] = n - 3;
    float fm3 = f[at(g, p3[0], p3[1], p3[2])];
    v = uadv < 0.f ? 0.5f * (fc + fm1) : scheme<SCHEME>(fm3, fm1, fc);
  } else {
    int a[3] = {p[0], p[1], p[2]};
    int b[3] = {p[0], p[1], p[2]};
    a[j] = (pdir && pj == 1) ? n - 3 : wrap(pj - 2, n);
    b[j] = wrap(pj + 1, n);
    float fm2 = f[at(g, a[0], a[1], a[2])];
    float fp1 = f[at(g, b[0], b[1], b[2])];
    v = uadv > 0.f ? scheme<SCHEME>(fm2, fm1, fc) : scheme<SCHEME>(fp1, fc, fm1);
  }
  return uadv * v - nu * (fc - fm1);
}

// r_i at cell (x, y, z): sum over j of phi - phi(+e_j), the +e_j index
// wrapped
template <int SCHEME, int PER>
__device__ __forceinline__ float conv_diff_at(const float* __restrict__ u,
                                              const Grid3& g, float nu, int i,
                                              int x, int y, int z) {
  const int dims[3] = {g.nx, g.ny, g.nz};
  float ri = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    int nb[3] = {x, y, z};
    nb[j] = wrap(nb[j] + 1, dims[j]);
    float phi = flux<SCHEME, PER>(u, g, nu, i, j, x, y, z);
    float phi_up = flux<SCHEME, PER>(u, g, nu, i, j, nb[0], nb[1], nb[2]);
    ri = ri + (phi - phi_up);
  }
  return ri;
}

// ------------------------------------------------------------ A x
// A x = D x + sum_d (L_d x(-e_d) + L_d(+e_d) x(+e_d)) at an interior cell
// (poisson.py:87-90)
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

// ------------------------------------------------------------ bf16
// The mixed-precision smoothers (ops/pallas_flat.py gs_incr, incr_gs with
// mp=True) read L, D, iD as bf16 and keep the correction e, every product,
// sum and difference of the colour sweeps and the accumulation of A e in
// bf16; x and r stay float32.  A bf16 operation here is the float32
// operation on the two bf16 values followed by one round-to-nearest-even to
// bf16: what torch does for bf16 tensors, so the kernels and their plain
// versions round at the same places.  The _rn intrinsics are never
// contracted into fused multiply-adds, which would skip a rounding that the
// plain version makes.  MP is a template parameter of the smoother kernels:
// the float32 instantiations keep their code and registers.
typedef __nv_bfloat16 bf16;

// type of the coefficients and of the correction scratch of an instantiation
template <bool MP>
using coef_t = typename std::conditional<MP, bf16, float>::type;

__device__ __forceinline__ bf16 rb(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float fb(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 bmul(bf16 a, bf16 b) {
  return rb(__fmul_rn(fb(a), fb(b)));
}
__device__ __forceinline__ bf16 badd(bf16 a, bf16 b) {
  return rb(__fadd_rn(fb(a), fb(b)));
}
__device__ __forceinline__ bf16 bsub(bf16 a, bf16 b) {
  return rb(__fsub_rn(fb(a), fb(b)));
}

// A e accumulated in bf16 at an interior cell, in the order of
// pallas_flat.py:850-857: e D, then per direction
// (acc + e(-e_d) L_d) + e(+e_d) L_d(+e_d)
__device__ __forceinline__ bf16 apply_A_bf16(const bf16* __restrict__ e,
                                             const bf16* __restrict__ L,
                                             const bf16* __restrict__ D,
                                             const Grid3& g, int64_t c) {
  bf16 s = bmul(e[c], D[c]);
  for (int d = 0; d < 3; ++d) {
    int64_t st = stride(g, d);
    const bf16* Ld = L + (int64_t)d * g.n;
    s = badd(badd(s, bmul(e[c - st], Ld[c])), bmul(e[c + st], Ld[c + st]));
  }
  return s;
}

// A x in float32 from a float32 x and bf16 coefficients, each operation
// rounded on its own (pallas_flat.py:944-953: r1 of the fused tail), in the
// same order as apply_A_bf16
__device__ __forceinline__ float apply_A_mixed(const float* __restrict__ x,
                                               const bf16* __restrict__ L,
                                               const bf16* __restrict__ D,
                                               const Grid3& g, int64_t c) {
  float s = __fmul_rn(x[c], fb(D[c]));
  for (int d = 0; d < 3; ++d) {
    int64_t st = stride(g, d);
    const bf16* Ld = L + (int64_t)d * g.n;
    s = __fadd_rn(__fadd_rn(s, __fmul_rn(x[c - st], fb(Ld[c]))),
                  __fmul_rn(x[c + st], fb(Ld[c + st])));
  }
  return s;
}

// ------------------------------------------------------------ colour sweep
// One red-black sweep in place: the interior cells of index-sum parity
// `color` take eps = (r - sum of L-weighted neighbours of eps) iD.  A cell's
// 6 neighbours all have the other colour, so no thread reads a value another
// thread of the same launch writes.  Reads r, iD, L (3), eps and writes half
// of eps: ~26 B/cell in float32.  MP: the residual is rounded to bf16 as it
// is read, L, iD and eps are bf16 (~16 B/cell), and the update is
// s = r; s = s - (e(-e_d) L_d + e(+e_d) L_d(+e_d)) per direction; e = s iD,
// each a bf16 operation (pallas_flat.py:826-840).
template <bool MP>
__global__ void gs_sweep_kernel(const float* __restrict__ r,
                                const coef_t<MP>* __restrict__ L,
                                const coef_t<MP>* __restrict__ iD,
                                coef_t<MP>* eps, int color, Grid3 g) {
  int z = blockIdx.x * BZ + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  int x = blockIdx.z;
  if (z >= g.nz || y >= g.ny) return;
  if (!interior(g, x, y, z) || ((x + y + z) & 1) != color) return;
  int64_t c = at(g, x, y, z);
  if constexpr (MP) {
    bf16 s = rb(r[c]);
    for (int d = 0; d < 3; ++d) {
      int64_t st = stride(g, d);
      const bf16* Ld = L + (int64_t)d * g.n;
      s = bsub(s, badd(bmul(eps[c - st], Ld[c]), bmul(eps[c + st], Ld[c + st])));
    }
    eps[c] = bmul(s, iD[c]);
  } else {
    float s = r[c];
    for (int d = 0; d < 3; ++d) {
      int64_t st = stride(g, d);
      const float* Ld = L + (int64_t)d * g.n;
      s = s - (eps[c - st] * Ld[c] + eps[c + st] * Ld[c + st]);
    }
    eps[c] = s * iD[c];
  }
}

}  // namespace
