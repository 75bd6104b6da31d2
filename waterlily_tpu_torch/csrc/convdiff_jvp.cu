// K12's forward-mode rule: the tangent of the conv-diff RHS, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// waterlily_tpu_torch/ops/_build.py; the entry launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
//
// What it computes (ops/stencil3d.py conv_diff_jvp_plain: the forward-mode
// derivative of conv_diff_plain, the function K12 computes): with u and its
// tangent du, nu and its tangent dnu,
//   dr = J_conv(u) du + nu Lap(du) + dnu Lap(u)
// written as the tangent of each face flux
//   dphi_ij = duadv v + uadv dv - (dnu (u_i[p] - u_i[p-e_j])
//                                  + nu (du_i[p] - du_i[p-e_j]))
// with v the scheme value of the upwind stencil and dv its tangent, and
// dr_i[p] = sum_j dphi_ij[p] - dphi_ij[p+e_j] at every cell, ghosts
// included, with the roll-wrap reads, the one-sided phiL/phiR slabs and, in
// the directions whose bit is set in `per`, the periodic phiuP fluxes of
// K12 (convdiff_tile.cuh states them).  The JAX package differentiates its
// conv-diff (waterlily_tpu/ops/pallas3d.py:274 conv_diff3d_generic and the
// jnp slabs around it) with jax.jvp through the same formula; this kernel
// is the port of that derivative.
//
// Selections are the plain version's: the upwind branch by uadv > 0 (the
// phiR slab by !(uadv < 0)), van Leer's revert test, and the scheme's
// median3 as torch.minimum/maximum, whose forward derivative is
// other_t + w (self_t - other_t) with w = 1/2 at a tie (PyTorch's rule, as
// JAX's).  A uniform stream makes median3's arguments equal almost
// everywhere, so the tie weight sets the derivative there: every primal
// value that meets a comparison is rounded as PyTorch rounds it on the
// card, one operation at a time (the __f*_rn intrinsics, never contracted
// into a fused multiply-add; a division by a scalar as the product with its
// float reciprocal), so that the kernel takes the plain version's branches
// and ties on the same inputs.  One rounding apart, near-ties of median3
// flip on 258^3 random fields, each a jump of the tangent at its cell
// (7e-3 of max with a correctly rounded /6, measured on an NVIDIA H100
// 80GB HBM3 at 700 W).
//
// What bounds it on an H100: the function must move 36 B/cell (u and du in,
// dr out), 0.184 ms at 258^3 at 3.35 TB/s.  This first form is simple: one
// thread per (cell, component), no shared memory, each of the 6 face fluxes
// it needs evaluated from cached global reads (every flux twice over the
// grid, as K12 was before its tiles), so it is bound by instruction issue,
// not memory: 3.29 ms at 258^3 for quick on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 3).  Tiling it as K12 is later work.

#include "stencil_common.cuh"

namespace {

struct Dual {
  float v, t;  // a value and its tangent
};

// torch.minimum / torch.maximum and their forward derivative
__device__ __forceinline__ Dual dmin(Dual a, Dual b) {
  const float w = a.v == b.v ? 0.5f : (a.v < b.v ? 1.f : 0.f);
  return {fminf(a.v, b.v), b.t + w * (a.t - b.t)};
}

__device__ __forceinline__ Dual dmax(Dual a, Dual b) {
  const float w = a.v == b.v ? 0.5f : (a.v > b.v ? 1.f : 0.f);
  return {fmaxf(a.v, b.v), b.t + w * (a.t - b.t)};
}

__device__ __forceinline__ Dual dmedian3(Dual a, Dual b, Dual c) {
  return dmax(dmin(a, b), dmin(dmax(a, b), c));
}

// u = upstream, c = centre, d = downstream (stencil3d.py quick, vanleer, cds)
template <int SCHEME>
__device__ __forceinline__ Dual dscheme(Dual u, Dual c, Dual d) {
  if (SCHEME == 0) {  // median-limited QUICK
    // (5c + 2d - u) / 6 as PyTorch rounds it on the card: its division by a
    // scalar multiplies by the scalar's float reciprocal
    constexpr float inv6 = 1.f / 6.f;
    const float a = __fmul_rn(
        __fsub_rn(__fadd_rn(__fmul_rn(5.f, c.v), __fmul_rn(2.f, d.v)), u.v), inv6);
    const float b = __fsub_rn(__fmul_rn(10.f, c.v), __fmul_rn(9.f, u.v));
    const Dual da = {a, (5.f * c.t + 2.f * d.t - u.t) * inv6};
    const Dual db = {b, 10.f * c.t - 9.f * u.t};
    return dmedian3(da, c, dmedian3(db, c, d));
  } else if (SCHEME == 1) {  // van Leer with the divide-safe guard
    const float denom = __fsub_rn(d.v, u.v);
    const bool zero = denom == 0.f;
    const float safe = zero ? 1.f : denom;
    const float dsafe = zero ? 0.f : d.t - u.t;
    const float p = (d.v - c.v) * (c.v - u.v);
    const float dp = (d.t - c.t) * (c.v - u.v) + (d.v - c.v) * (c.t - u.t);
    const float q = p / safe;
    const bool revert = (c.v <= fminf(u.v, d.v)) || (c.v >= fmaxf(u.v, d.v));
    return revert ? c : Dual{c.v + q, c.t + (dp - q * dsafe) / safe};
  } else {  // central difference
    return {(c.v + d.v) / 2.f, (c.t + d.t) / 2.f};
  }
}

__device__ __forceinline__ int wrap(int k, int n) {
  return k < 0 ? k + n : (k >= n ? k - n : k);
}

// The tangent of the flux of component i through the lower j-face of the
// cell q, which lies in the field (0 <= q[d] < extent).  A periodic
// direction's slabs j-index 1 and n-1 carry the first-slab phiuP flux: the
// stencil at j-index 1, its second-upwind value from the partner n-3.
template <int SCHEME>
__device__ __forceinline__ float tflux(const float* __restrict__ u,
                                       const float* __restrict__ du,
                                       const Grid3& g, float nu, float dnu,
                                       int i, int j, int qx, int qy, int qz,
                                       int per) {
  int q[3] = {qx, qy, qz};
  const int dims[3] = {g.nx, g.ny, g.nz};
  const int n = dims[j];
  const bool periodic = (per >> j) & 1;
  int k0 = q[j], km2;
  if (periodic && (k0 == 1 || k0 == n - 1)) {
    k0 = 1;
    km2 = n - 3;
  } else {
    km2 = wrap(k0 - 2, n);
  }
  const int km1 = wrap(k0 - 1, n), kp1 = wrap(k0 + 1, n);
  q[j] = k0;
  const int64_t sj = stride(g, j);
  const int64_t c = at(g, q[0], q[1], q[2]);
  const int64_t base = c - (int64_t)k0 * sj;  // the cell at j-index 0
  // uadv = (u_j[q] + u_j[q - e_i]) / 2, the i index wrapped
  const int64_t cb =
      c + (int64_t)(wrap(q[i] - 1, dims[i]) - q[i]) * stride(g, i);
  const float* uj = u + (int64_t)j * g.n;
  const float* duj = du + (int64_t)j * g.n;
  const float ua = __fmul_rn(0.5f, __fadd_rn(uj[c], uj[cb]));
  const float dua = 0.5f * (duj[c] + duj[cb]);
  const float* f = u + (int64_t)i * g.n;
  const float* df = du + (int64_t)i * g.n;
  const int64_t o2 = base + (int64_t)km2 * sj, o1 = base + (int64_t)km1 * sj,
                op = base + (int64_t)kp1 * sj;
  const Dual fm2 = {f[o2], df[o2]}, fm1 = {f[o1], df[o1]}, fc = {f[c], df[c]},
             fp1 = {f[op], df[op]};
  const bool lo = !periodic && k0 == 1, hi = !periodic && k0 == n - 1;
  const bool up = hi ? !(ua < 0.f) : (ua > 0.f);
  Dual v;
  if ((lo && ua > 0.f) || (hi && ua < 0.f)) {
    v = {0.5f * (fc.v + fm1.v), 0.5f * (fc.t + fm1.t)};
  } else {
    v = dscheme<SCHEME>(up ? fm2 : fp1, up ? fm1 : fc, up ? fc : fm1);
  }
  return dua * v.v + ua * v.t - (dnu * (fc.v - fm1.v) + nu * (fc.t - fm1.t));
}

template <int SCHEME>
__global__ void conv_diff_jvp_kernel(const float* __restrict__ u,
                                     const float* __restrict__ du,
                                     const float* __restrict__ nu_p,
                                     const float* __restrict__ dnu_p,
                                     float* __restrict__ dr, int per,
                                     Grid3 g) {
  const int z = blockIdx.x * BZ + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int i = blockIdx.z / g.nx;
  const int x = blockIdx.z - i * g.nx;
  if (z >= g.nz || y >= g.ny) return;
  const float nu = *nu_p, dnu = *dnu_p;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int xp = j == 0 ? wrap(x + 1, g.nx) : x;
    const int yp = j == 1 ? wrap(y + 1, g.ny) : y;
    const int zp = j == 2 ? wrap(z + 1, g.nz) : z;
    const float lo = tflux<SCHEME>(u, du, g, nu, dnu, i, j, x, y, z, per);
    const float hi = tflux<SCHEME>(u, du, g, nu, dnu, i, j, xp, yp, zp, per);
    s = s + (lo - hi);
  }
  dr[(int64_t)i * g.n + at(g, x, y, z)] = s;
}

template <int SCHEME>
cudaError_t launch_conv_diff_jvp(const float* u, const float* du,
                                 const float* nu, const float* dnu, float* dr,
                                 int per, const Grid3& g, cudaStream_t s) {
  conv_diff_jvp_kernel<SCHEME><<<grid_of(g, 3), dim3(BZ, BY), 0, s>>>(
      u, du, nu, dnu, dr, per, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// per: bit j set = direction j periodic; nu, dnu: device scalars
int wlt_conv_diff_jvp(const float* u, const float* du, const float* nu,
                      const float* dnu, float* dr, int64_t nx, int64_t ny,
                      int64_t nz, int scheme_id, int per, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  cudaStream_t s = (cudaStream_t)stream;
  if (per < 0 || per > 7) return (int)cudaErrorInvalidValue;
  switch (scheme_id) {
    case 0: return (int)launch_conv_diff_jvp<0>(u, du, nu, dnu, dr, per, g, s);
    case 1: return (int)launch_conv_diff_jvp<1>(u, du, nu, dnu, dr, per, g, s);
    case 2: return (int)launch_conv_diff_jvp<2>(u, du, nu, dnu, dr, per, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
