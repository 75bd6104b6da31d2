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
// the directions whose bit is set in PER, the periodic phiuP fluxes of
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
// 80GB HBM3 at 700 W).  Tangent arithmetic meets no comparison and may
// contract; van Leer's quotient and its tangent share one reciprocal.
//
// What bounds it on an H100: the function must move 36 B/cell (u and du in,
// dr out), 0.184 ms at 258^3 at 3.35 TB/s, but a cell needs 9 dual face
// fluxes, each about twice the instructions of K12's, so, as K12, it is
// bound by instruction issue.  The design is K12's tile (convdiff_tile.cuh)
// carried over to duals:
//
// * One thread per cell computes the three components; a block owns a
//   CT_TY x CT_TZ column of cells and marches over a chunk of x rows,
//   chosen by K12's rule (conv_diff_tile_grid).
// * A rolling window of 5 x planes of the 3 components of u and of du, each
//   with a +-2 halo, value and tangent interleaved as float2: a stencil read
//   is one 64-bit shared load, and the 4-byte cp.async copies write the two
//   halves from the two arrays.  Plane x+3 is fetched into the free slot
//   while plane x is computed; one barrier a step serves the window and the
//   flux exchange.  The window (51,840 B) and the double-buffered y-flux
//   array (6,912 B) exceed the 48 KB of static shared memory: dynamic shared
//   memory, its limit raised once per instantiation.
// * Each lower-face dual flux once: the upper x-face flux carried in
//   registers, the upper z-face flux from the next lane by a shuffle, the
//   upper y-face flux from the next warp through shared memory, the tile's
//   y and z edge fluxes on lanes that would idle (K12's schedule).  Only
//   tangent fluxes are exchanged: the primal RHS is K12's output, not this
//   kernel's; the primal values are formed only to choose the branches and
//   to form uadv' v + uadv v'.
// * The periodic first-slab fluxes need values far outside the tile: the
//   threads on those planes read them from global memory (tflux_per1, the
//   dual form of K12's flux_per1) in one loop over a bit mask of their
//   special faces, one copy of the code for every special flux.
// * No thread returns early: the threads of a ragged tile beyond the field
//   hold the wrapped cells, whose fluxes the last cells need; only the
//   stores are masked.
//
// SCHEME and PER are template parameters (3 x 8 instantiations).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/convdiff_bench.py):
// quick at 258^3 0.87 ms against 3.27 for one thread per (cell, component);
// its x-march loop is ~1,456 instructions a cell (K12's: 761), an issue
// bound of 0.75 ms at 1,980 MHz, the rest the ragged z tile (258 = 8 x 32
// + 2) and each chunk's lead-in.  Below ~34^3 the few blocks of the tile
// leave it no faster than the one-thread form (18^3: ~18 us, 9 blocks).
// The registers are ptxas's own choice: a minimum of 3 blocks an SM sped
// the periodic instantiations by 3-8 % and slowed the walled quick by 2 %,
// and an explicit minimum of 1 let it take 124 registers (2 blocks an SM).

#include "convdiff_tile.cuh"

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
    const float rs = __frcp_rn(zero ? 1.f : denom);
    const float dsafe = zero ? 0.f : d.t - u.t;
    const float p = (d.v - c.v) * (c.v - u.v);
    const float dp = (d.t - c.t) * (c.v - u.v) + (d.v - c.v) * (c.t - u.t);
    const float q = p * rs;
    const bool revert = (c.v <= fminf(u.v, d.v)) || (c.v >= fmaxf(u.v, d.v));
    return revert ? c : Dual{c.v + q, c.t + (dp - q * dsafe) * rs};
  } else {  // central difference
    return {(c.v + d.v) / 2.f, (c.t + d.t) / 2.f};
  }
}

// The tangent of a face flux from its dual stencil values at j-index pj of
// a direction with n cells (fm2 .. fp1: u_i at pj-2 .. pj+1) and the dual
// advecting velocity (ua, dua).  `walled`: phiL at pj = 1 and phiR at
// pj = n-1, as K12's face_flux.
template <int SCHEME>
__device__ __forceinline__ float face_tflux(float ua, float dua, Dual fm2,
                                            Dual fm1, Dual fc, Dual fp1, int pj,
                                            int n, bool walled, float nu,
                                            float dnu) {
  const bool lo = walled && pj == 1, hi = walled && pj == n - 1;
  const bool up = hi ? !(ua < 0.f) : (ua > 0.f);
  Dual v = dscheme<SCHEME>(up ? fm2 : fp1, up ? fm1 : fc, up ? fc : fm1);
  if ((lo && ua > 0.f) || (hi && ua < 0.f))
    v = {0.5f * (fc.v + fm1.v), 0.5f * (fc.t + fm1.t)};
  return dua * v.v + ua * v.t - (dnu * (fc.v - fm1.v) + nu * (fc.t - fm1.t));
}

// uadv = (u_j[q] + u_j[q - e_i]) / 2 as PyTorch rounds it, and its tangent
__device__ __forceinline__ void dual_uadv(float a, float da, float b, float db,
                                          float& ua, float& dua) {
  ua = __fmul_rn(0.5f, __fadd_rn(a, b));
  dua = 0.5f * (da + db);
}

// The tangent fluxes of direction j's periodic first slab (phiuP) of the
// three components, read from global memory: at the cell (x, y, z) with its
// j coordinate set to 1, the second-upwind value from the partner n-3
// (K12's flux_per1 on duals; j is a run-time value, one copy of the code).
template <int SCHEME>
__device__ __forceinline__ void tflux_per1(const float* __restrict__ u,
                                           const float* __restrict__ du,
                                           const Grid3& g, float nu, float dnu,
                                           int j, int x, int y, int z,
                                           float (&v)[3]) {
  x = j == 0 ? 1 : x;
  y = j == 1 ? 1 : y;
  z = j == 2 ? 1 : z;
  const int nj = extent(g, j);
  const int64_t sj = stride(g, j);
  const int64_t c = at(g, x, y, z);
  const int64_t cj = (int64_t)j * g.n + c;
  const float ujc = u[cj], dujc = du[cj];
  Dual ub[3], fm2[3], fm1[3], fc[3], fp1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int ci = i == 0 ? x : (i == 1 ? y : z);
    const int64_t si = stride(g, i);
    const int64_t back = ci > 0 ? -si : (int64_t)(extent(g, i) - 1) * si;
    const int64_t ci0 = (int64_t)i * g.n + c;
    ub[i] = {u[cj + back], du[cj + back]};
    fc[i] = {u[ci0], du[ci0]};
    fm1[i] = {u[ci0 - sj], du[ci0 - sj]};
    fp1[i] = {u[ci0 + sj], du[ci0 + sj]};
    const int64_t o2 = ci0 + (int64_t)(nj - 4) * sj;
    fm2[i] = {u[o2], du[o2]};
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float ua, dua;
    dual_uadv(ujc, dujc, ub[i].v, ub[i].t, ua, dua);
    v[i] = face_tflux<SCHEME>(ua, dua, fm2[i], fm1[i], fc[i], fp1[i], 1, nj,
                              false, nu, dnu);
  }
}

__device__ __forceinline__ Dual dual(float2 a) { return {a.x, a.y}; }

// Tangent flux of component i through the lower J-face of the cell at tile
// offset o of the window plane at offset s0 (sm2, sm1, sp1: the planes two
// and one before and one after it), in float2 units of the dual window (K12's
// tile_flux on duals).
template <int SCHEME, int J, bool WALLED>
__device__ __forceinline__ float tile_tflux(const float2* win, float nu,
                                            float dnu, int i, int sm2, int sm1,
                                            int s0, int sp1, int o, int pj,
                                            int nj) {
  const float2* f = win + i * CT_PLANE;
  const float2* uj = win + J * CT_PLANE;
  const int back = i == 0 ? sm1 + o : s0 + o - (i == 1 ? CT_PZ : 1);
  const float2 a = uj[s0 + o], b = uj[back];
  float ua, dua;
  dual_uadv(a.x, a.y, b.x, b.y, ua, dua);
  float2 fm2, fm1, fc = f[s0 + o], fp1;
  if (J == 0) {
    fm2 = f[sm2 + o];
    fm1 = f[sm1 + o];
    fp1 = f[sp1 + o];
  } else {
    constexpr int d = J == 1 ? CT_PZ : 1;
    fm2 = f[s0 + o - 2 * d];
    fm1 = f[s0 + o - d];
    fp1 = f[s0 + o + d];
  }
  return face_tflux<SCHEME>(ua, dua, dual(fm2), dual(fm1), dual(fc), dual(fp1),
                            pj, nj, WALLED, nu, dnu);
}

// ------------------------------------------------------------ window
constexpr int JV_SLOT = 3 * CT_PLANE;  // float2 of one window slot
constexpr int JV_SMEM_BYTES =
    5 * JV_SLOT * (int)sizeof(float2) + 2 * CT_FBUF * (int)sizeof(float);

// This thread's share of a plane load: for each of its CT_NLD tile elements
// the in-plane source offset (wrapped in y and z) and the shared address of
// its float2 in slot 0, both fixed over the march.
struct DualLoads {
  int src[CT_NLD];
  unsigned dst[CT_NLD];
  bool on[CT_NLD];
};

// Start the copy of plane P (-2 <= P <= nx + 1, wrapped into the field) of
// the three components of u and du into the window slot at float2 offset
// `slot`: the value into the low half of each float2, the tangent into the
// high half.
__device__ __forceinline__ void load_dual_plane(const DualLoads& h,
                                                const float* __restrict__ u,
                                                const float* __restrict__ du,
                                                const Grid3& g, int P, int slot) {
  const int xw = P < 0 ? P + g.nx : (P >= g.nx ? P - g.nx : P);
  const int64_t xoff = (int64_t)xw * g.sx;
#pragma unroll
  for (int k = 0; k < CT_NLD; ++k) {
    if (h.on[k]) {
      const int64_t s = xoff + h.src[k];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const unsigned d = h.dst[k] + (unsigned)(slot + c * CT_PLANE) * 8u;
        cp_async4(d, u + s + (int64_t)c * g.n);
        cp_async4(d + 4u, du + s + (int64_t)c * g.n);
      }
    }
  }
}

// ------------------------------------------------------------ the kernel
template <int SCHEME, int PER>
__global__ void __launch_bounds__(CT_NT)
    conv_diff_jvp_tile_kernel(const float* __restrict__ u,
                              const float* __restrict__ du,
                              const float* __restrict__ nu_ptr,
                              const float* __restrict__ dnu_ptr,
                              float* __restrict__ dr, Grid3 g, int xc) {
  extern __shared__ __align__(16) float2 jv_smem[];
  float2* win = jv_smem;
  float* fbuf = reinterpret_cast<float*>(jv_smem + 5 * JV_SLOT);
  const int tz = threadIdx.x, ty = threadIdx.y, tid = ty * CT_TZ + tz;
  const int z0 = blockIdx.x * CT_TZ, y0 = blockIdx.y * CT_TY;
  const int xa = blockIdx.z * xc;
  const int xb = min(g.nx, xa + xc);
  const float nu = *nu_ptr, dnu = *dnu_ptr;
  constexpr bool WX = !(PER & 1), WY = !(PER & 2), WZ = !(PER & 4);

  DualLoads h;
  const unsigned win_s = (unsigned)__cvta_generic_to_shared(win);
#pragma unroll
  for (int k = 0; k < CT_NLD; ++k) {
    int e = tid + k * CT_NT;
    int row = e / CT_PZ, col = e - row * CT_PZ;
    h.on[k] = e < CT_PLANE;
    h.dst[k] = win_s + 8u * e;
    h.src[k] = pmod(y0 - 2 + row, g.ny) * g.nz + pmod(z0 - 2 + col, g.nz);
  }
  // wrapped coordinates of this thread's cell and of the two edge positions
  const int ly = pmod(y0 + ty, g.ny), lz = pmod(z0 + tz, g.nz);
  const int lye = pmod(y0 + CT_TY, g.ny), lze = pmod(z0 + CT_TZ, g.nz);
  const int o = (ty + 2) * CT_PZ + tz + 2;
  const int oye = (CT_TY + 2) * CT_PZ + tz + 2;
  const int oze = (ty + 2) * CT_PZ + CT_TZ + 2;
  const bool valid = y0 + ty < g.ny && z0 + tz < g.nz;
  // which of this thread's y and z fluxes are periodic first-slab fluxes:
  // bit 1 fy, 2 fz, 3 the z-edge flux, 4 the y-edge flux (bit 0: fx)
  unsigned spec_yz = 0;
  if (PER != 0) {
    if (!WY && (ly == 1 || ly == g.ny - 1)) spec_yz |= 2u;
    if (!WZ && (lz == 1 || lz == g.nz - 1)) spec_yz |= 4u;
    if (!WZ && tz < 3 && (lze == 1 || lze == g.nz - 1)) spec_yz |= 8u;
    if (!WY && ty < 3 && (lye == 1 || lye == g.ny - 1)) spec_yz |= 16u;
  }

  // window slots of planes t-1, t, t+1, t+2 and the free one
  int sa = 0, sb = JV_SLOT, sc = 2 * JV_SLOT, sd = 3 * JV_SLOT, se = 4 * JV_SLOT;
  load_dual_plane(h, u, du, g, xa - 2, sa);
  load_dual_plane(h, u, du, g, xa - 1, sb);
  load_dual_plane(h, u, du, g, xa, sc);
  load_dual_plane(h, u, du, g, xa + 1, sd);
  cp_async_wait_all();
  __syncthreads();

  float fx_lo[3] = {0.f, 0.f, 0.f};
  // step t: the x-face tangent fluxes at plane t+1; from t = xa on also the
  // y and z fluxes of plane t and its result
  for (int t = xa - 1; t < xb; ++t) {
    if (t + 2 <= xb) load_dual_plane(h, u, du, g, t + 3, se);
    const int lxp = t + 1 == g.nx ? 0 : t + 1;
    const bool out = t >= xa;
    float* fb = fbuf + ((t - xa + 1) & 1) * CT_FBUF;
    float fx_up[3], fy[3], fz[3], ez = 0.f, ey = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      fx_up[i] = tile_tflux<SCHEME, 0, WX>(win, nu, dnu, i, sa, sb, sc, sd, o,
                                           lxp, g.nx);
    if (out) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        fy[i] = tile_tflux<SCHEME, 1, WY>(win, nu, dnu, i, 0, sa, sb, 0, o, ly,
                                          g.ny);
        fz[i] = tile_tflux<SCHEME, 2, WZ>(win, nu, dnu, i, 0, sa, sb, 0, o, lz,
                                          g.nz);
      }
      ez = tile_tflux<SCHEME, 2, WZ>(win, nu, dnu, tz % 3, 0, sa, sb, 0, oze,
                                     lze, g.nz);
      if (ty < 3)
        ey = tile_tflux<SCHEME, 1, WY>(win, nu, dnu, ty, 0, sa, sb, 0, oye, lye,
                                       g.ny);
    }
    if (PER != 0) {
      // the periodic first-slab fluxes replace what the tile gave
      unsigned spec = out ? spec_yz : 0u;
      if (!WX && (lxp == 1 || lxp == g.nx - 1)) spec |= 1u;
#pragma unroll 1
      while (spec) {
        const int k = __ffs(spec) - 1;
        spec &= spec - 1;
        float v[3];
        tflux_per1<SCHEME>(u, du, g, nu, dnu, k < 3 ? k : 5 - k, t,
                           k == 4 ? lye : ly, k == 3 ? lze : lz, v);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (k == 0) fx_up[q] = v[q];
          if (k == 1) fy[q] = v[q];
          if (k == 2) fz[q] = v[q];
          if (k == 3 && tz == q) ez = v[q];
          if (k == 4 && ty == q) ey = v[q];
        }
      }
    }
    if (out) {
      if (ty < 3) fb[(ty * (CT_TY + 1) + CT_TY) * CT_TZ + tz] = ey;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        fb[(i * (CT_TY + 1) + ty) * CT_TZ + tz] = fy[i];
    }
    cp_async_wait_all();
    __syncthreads();
    if (out) {
      const int64_t c = at(g, t, y0 + ty, z0 + tz);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float zn = __shfl_down_sync(0xffffffffu, fz[i], 1);
        float ze = __shfl_sync(0xffffffffu, ez, i);
        float up_z = tz == CT_TZ - 1 ? ze : zn;
        float up_y = fb[(i * (CT_TY + 1) + ty + 1) * CT_TZ + tz];
        float r = 0.f;
        r = r + (fx_lo[i] - fx_up[i]);
        r = r + (fy[i] - up_y);
        r = r + (fz[i] - up_z);
        if (valid) dr[(int64_t)i * g.n + c] = r;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) fx_lo[i] = fx_up[i];
    int s = sa;
    sa = sb;
    sb = sc;
    sc = sd;
    sd = se;
    se = s;
  }
}

template <int SCHEME, int PER>
cudaError_t launch_conv_diff_jvp(const float* u, const float* du,
                                 const float* nu, const float* dnu, float* dr,
                                 const Grid3& g, cudaStream_t s) {
  // the window needs more than the 48 KB a block gets by default: raise the
  // limit once per instantiation (a function-local static, no cost a call)
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_diff_jvp_tile_kernel<SCHEME, PER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, JV_SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  int xc;
  const dim3 grid = conv_diff_tile_grid(g, xc);
  conv_diff_jvp_tile_kernel<SCHEME, PER>
      <<<grid, dim3(CT_TZ, CT_TY), JV_SMEM_BYTES, s>>>(u, du, nu, dnu, dr, g, xc);
  return cudaGetLastError();
}

template <int SCHEME>
cudaError_t launch_conv_diff_jvp(const float* u, const float* du,
                                 const float* nu, const float* dnu, float* dr,
                                 int per, const Grid3& g, cudaStream_t s) {
  switch (per) {
#define WLT_CONV_DIFF_JVP_CASE(P) \
  case P:                         \
    return launch_conv_diff_jvp<SCHEME, P>(u, du, nu, dnu, dr, g, s);
    WLT_CONV_DIFF_JVP_CASE(0)
    WLT_CONV_DIFF_JVP_CASE(1)
    WLT_CONV_DIFF_JVP_CASE(2)
    WLT_CONV_DIFF_JVP_CASE(3)
    WLT_CONV_DIFF_JVP_CASE(4)
    WLT_CONV_DIFF_JVP_CASE(5)
    WLT_CONV_DIFF_JVP_CASE(6)
    WLT_CONV_DIFF_JVP_CASE(7)
#undef WLT_CONV_DIFF_JVP_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// per: bit j set = direction j periodic; nu, dnu: device scalars
int wlt_conv_diff_jvp(const float* u, const float* du, const float* nu,
                      const float* dnu, float* dr, int64_t nx, int64_t ny,
                      int64_t nz, int scheme_id, int per, void* stream) {
  Grid3 g = make_grid(nx, ny, nz);
  cudaStream_t s = (cudaStream_t)stream;
  switch (scheme_id) {
    case 0: return (int)launch_conv_diff_jvp<0>(u, du, nu, dnu, dr, per, g, s);
    case 1: return (int)launch_conv_diff_jvp<1>(u, du, nu, dnu, dr, per, g, s);
    case 2: return (int)launch_conv_diff_jvp<2>(u, du, nu, dnu, dr, per, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
