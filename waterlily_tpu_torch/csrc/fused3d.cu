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
// tiles of convdiff_tile.cuh.  Reductions are deterministic: per-block
// partials in a fixed tree order, then one block that folds them (a float
// atomicAdd would change the L1 norm, and with it the iteration count, from
// run to run); the CFL max is an integer atomicMax on the bits of a
// non-negative float, which is order-free.

#include "convdiff_tile.cuh"

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
// Routes, chosen by the arguments: float32 with 1 to IG_MAX_IT colours is
// one launch of the tiled cascade below (incr_gs_tile_kernel) and the fold
// of its norm partials; no colours (K6) is one pass of incr_tail_kernel,
// 32 B/cell, 0.16 ms at 258^3; more than IG_MAX_IT colours, and the bf16
// instantiation, take a head pass (r1 into r_out, e), K15's colour sweep per
// colour, a tail pass (x', r', the norm partials) and the fold: ~180 B/cell
// with 4 colours, which is what the cascade replaces.
//
// ------------------------------------------------------------ K7 cascade
// What bounds it on an H100: the call must move x, r, eps, L (3), D, iD in
// and x', r' out, 40 B/cell, 0.205 ms at 258^3 at 3.35 TB/s, for ~13 flops
// a cell and a sweep.  The design keeps the colour sweeps off device memory
// (the TPU kernel's communication-avoiding cascade, pallas_flat.py:896-1000,
// with halo it+1), needs one barrier per x plane, and reads device memory
// only at the head and the tail of its wavefront:
//
// * Tiles cover the interior: a block owns IG_TY x IG_TZ interior (y, z)
//   cells (the first and last tiles of a row of tiles also own the ghost
//   cells beside them) and marches over a chunk of xc interior x rows (the
//   first and last chunks also own the ghost planes).  Its region is the
//   tile grown by H = IT+1 cells in y and z.  Each thread owns a pair of
//   z-adjacent cells (z, z+1) of the region for the whole march: on any
//   plane one of them has the colour of a sweep.
// * At march step t the thread runs, in this order: stage k = 1..IT, the
//   sweep of the k-th colour on plane t-k (at the cell of its pair that has
//   the colour); the tail on plane q = t-IT-1 (x', r' and the norms at the
//   cells of its pair that the block owns); stage 0 on plane t+1 (r1 and
//   e0 = r1 iD at both cells, and its cells' L and iD into shared rings).
//   e, r1, L and iD live in shared rings of planes.  A stage reads its own
//   cells' x-neighbours, written by this thread earlier, and in-plane
//   neighbours (e, L) on its plane, written by other threads in an earlier
//   step: one barrier a step orders them.  A sweep on plane p leaves the
//   other colour of p alone, so its in-plane reads see the values of the
//   sequential sweeps, for any colour list (tests/
//   test_torch_incr_gs_cascade.py emulates this schedule on the CPU).
// * Each stage runs on its dependency cone in x (stage k: the chunk grown
//   by H-k planes; a chunk takes xc + 2 IT + 3 steps) and in y (the tile
//   grown by H-k rows: the warps of the outer rows skip the sweep), and on
//   every column of the region.  A value outside the cone may be wrong or
//   stale and is never read by a value inside it (so the region's last
//   column may read the rings' zero border for L2(+z)).
// * Cells outside the field are masked, never wrapped: an interior cell
//   reads one cell into the ghosts at most.  Colour parity and the
//   interior mask are global.  No thread returns early.
// * Device memory: eps arrives by cp.async in a ring of 4 planes (the
//   region grown by one cell), three planes ahead of stage 0; stage 0
//   starts its loads (r, D, iD, L and L(+e_d)) at the start of the step and
//   uses them at its end; the tail starts x, r, eps, D at the start of the
//   step.  The sweeps read shared memory only.
// * A ring plane stores each row's odd columns, then its even ones, so
//   the threads of a warp read consecutive words (no bank conflicts: the
//   cells of a pair are two columns apart in neither half).
// * Norms: per-thread sums and maxima over the march, the block's fixed
//   tree, per-block partials, fold_partials_kernel: equal from call to call.
// * Chunks: the fewest steps per resident block slot of the card, from
//   the shape, the card's SM count and the kernel's occupancy.
//
// On an H100 it runs at ~4.6x the byte floor: one block of 18 warps an SM,
// held in step by the barrier, waits on each step's dependent chain (the
// sweeps through shared memory, then the tail) far longer than it moves
// bytes (PERF.md section 6 has the timings).
//
// IT (1..IG_MAX_IT) and NORMS are template parameters; the rings are
// dynamic shared memory, 212 KB a block of 576 threads at IT = 4.
constexpr int IG_TY = 16;
constexpr int IG_TZ = 32;
constexpr int IG_MAX_IT = 4;

template <int IT>
struct IgShape {
  static constexpr int H = IT + 1;                   // the region's halo
  static constexpr int HR = IG_TY + 2 * H;           // region rows (y)
  static constexpr int WR = IG_TZ + 2 * H;           // region columns (z)
  static constexpr int WP = WR / 2;                  // cell pairs a row
  static constexpr int NPAIR = HR * WP;
  static constexpr int NT = (NPAIR + 31) / 32 * 32;  // threads of a block
  static constexpr int W2 = WR + 2;                  // ring planes: region
  static constexpr int PP = (HR + 2) * W2;           // grown by one cell
  static constexpr int HW = W2 / 2;                  // columns of a half
  // ring planes: e, L0, L1, L2 NE (planes t+1 .. t-IT-1 in step t); r1 and
  // iD NR (t+1 .. t-IT); eps 4 (t .. t+3)
  static constexpr int NE = IT + 3, NR = IT + 2;
  static constexpr int O_L0 = NE * PP, O_L1 = 2 * NE * PP,
                       O_L2 = 3 * NE * PP, O_R1 = 4 * NE * PP,
                       O_ID = O_R1 + NR * PP, O_EPS = O_ID + NR * PP;
  static constexpr int SMEM = (O_EPS + 4 * PP) * 4;
  static constexpr int NLD = (PP + NT - 1) / NT;     // eps loads a thread
};
static_assert(IgShape<IG_MAX_IT>::NT <= 1024, "a block holds every pair");
static_assert(IgShape<IG_MAX_IT>::SMEM <= 227 * 1024,
              "the cascade's rings exceed a block's shared memory");

__device__ __forceinline__ void cp_async4_zfill(unsigned dst, const float* src,
                                                int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// colour k of the list is bit k-1 of cmask
template <int IT, bool NORMS>
__global__ void __launch_bounds__(IgShape<IT>::NT, 1)
    incr_gs_tile_kernel(const float* __restrict__ x,
                        const float* __restrict__ r,
                        const float* __restrict__ eps,
                        const float* __restrict__ L,
                        const float* __restrict__ D,
                        const float* __restrict__ iD, float omega,
                        unsigned cmask, int xc, float* __restrict__ x_out,
                        float* __restrict__ r_out,
                        float* __restrict__ partials, Grid3 g) {
  using S = IgShape<IT>;
  constexpr int H = S::H, W2 = S::W2, PP = S::PP, NE = S::NE, NR = S::NR;
  constexpr int NT = S::NT, NLD = S::NLD;
  extern __shared__ __align__(16) float ig_smem[];
  float* const E = ig_smem;
  float* const A0 = ig_smem + S::O_L0;
  float* const A1 = ig_smem + S::O_L1;
  float* const A2 = ig_smem + S::O_L2;
  float* const R1 = ig_smem + S::O_R1;
  float* const AI = ig_smem + S::O_ID;
  const float* const EP = ig_smem + S::O_EPS;
  const float* const L0 = L;
  const float* const L1 = L + g.n;
  const float* const L2 = L + 2 * g.n;
  const int64_t sx = g.sx, sy = g.sy;
  const int tid = threadIdx.x;
  const int y0 = 1 + blockIdx.y * IG_TY, z0 = 1 + blockIdx.x * IG_TZ;
  const int ia = 1 + blockIdx.z * xc;
  // the planes, rows and columns of the cells whose x' and r' it writes
  const int xa = blockIdx.z == 0 ? 0 : ia;
  const int xb = blockIdx.z == gridDim.z - 1 ? g.nx : ia + xc;
  const int ya = blockIdx.y == 0 ? 0 : y0;
  const int yb = blockIdx.y == gridDim.y - 1 ? g.ny : y0 + IG_TY;
  const int za = blockIdx.x == 0 ? 0 : z0;
  const int zb = blockIdx.x == gridDim.x - 1 ? g.nz : z0 + IG_TZ;

  // this thread's pair: cells (y, zc) and (y, zc + 1)
  const int prow = tid / S::WP, pcol = 2 * (tid - prow * S::WP);
  const int y = y0 - H + prow, zc = z0 - H + pcol;
  // ring offsets (row * W2 + (col odd ? 0 : HW) + col / 2) of cell 0 (ring
  // column pcol + 1, odd) and cell 1 (pcol + 2, even)
  const int m = pcol >> 1;
  // rows from the region's edge: stage k's cone leaves out the outer k
  const int ydepth = min(prow, S::HR - 1 - prow);
  const int o0 = (prow + 1) * W2 + m, o1 = o0 + S::HW + 1;
  // their z-1 and z+1 neighbours: cell j is at oc[j], its z-1 at om[j],
  // its z+1 at op[j]
  const int oc[2] = {o0, o1}, om[2] = {o1 - 1, o0}, op[2] = {o1, o0 + 1};
  const int64_t goff = (int64_t)y * sy + zc;
  // bit j: cell j interior in (y, z); bit 2+j: cell j written by this
  // block; bit 4: parity of y + zc; bit 5+j: cell j in the field
  unsigned fl = ((y + zc) & 1) ? 16u : 0u;
  if (tid < S::NPAIR) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int z = zc + j;
      if (y >= 1 && y <= g.ny - 2 && z >= 1 && z <= g.nz - 2) fl |= 1u << j;
      if (y >= ya && y < yb && z >= za && z < zb) fl |= 4u << j;
      if (y >= 0 && y < g.ny && z >= 0 && z < g.nz) fl |= 32u << j;
    }
  }
  // this thread's eps ring elements: offset in a plane, -1 off the field
  // (zero fill), -2 past the ring plane
  int eo[NLD], ed[NLD];
#pragma unroll
  for (int k = 0; k < NLD; ++k) {
    const int e = tid + k * NT;
    const int row = e / W2, col = e - row * W2;
    ed[k] = row * W2 + (col & 1 ? 0 : S::HW) + (col >> 1);
    const int yy = y0 - H - 1 + row, zz = z0 - H - 1 + col;
    eo[k] = e >= PP ? -2
                    : (yy >= 0 && yy < g.ny && zz >= 0 && zz < g.nz
                           ? yy * g.nz + zz
                           : -1);
  }
  const unsigned eps_s =
      (unsigned)__cvta_generic_to_shared(ig_smem + S::O_EPS);
  const auto load_eps = [&](int p, int slot) {
    const bool pin = p >= 0 && p < g.nx;
    const float* base = eps + (int64_t)(pin ? p : 0) * sx;
#pragma unroll
    for (int k = 0; k < NLD; ++k)
      if (eo[k] != -2)
        cp_async4_zfill(eps_s + (slot * PP + ed[k]) * 4,
                        base + (eo[k] < 0 ? 0 : eo[k]),
                        pin && eo[k] >= 0 ? 4 : 0);
  };

  // step s works on plane t = t0 + s; plane p sits in slot (p - t0) % NE
  // of e, L0, L1, L2, (p - t0) % NR of r1 and iD, (p - t0) % 4 of eps.
  // eb[j] and rb[j] are the float offsets of plane t+1-j's slots (j = NE
  // and NR: the slot of t+1, read before stage 0 writes it), rotated at
  // the end of each step.
  const int t0 = xa - H - 1;
  int eb[NE], rb[NR];
#pragma unroll
  for (int j = 0; j < NE; ++j) eb[j] = ((NE + 1 - j) % NE) * PP;
#pragma unroll
  for (int j = 0; j < NR; ++j) rb[j] = ((NR + 1 - j) % NR) * PP;
  for (int i = tid; i < S::O_EPS; i += NT) ig_smem[i] = 0.f;
  load_eps(t0, 0);
  load_eps(t0 + 1, 1);
  load_eps(t0 + 2, 2);
  cp_async_wait_all();
  __syncthreads();

  float acc_s = 0.f, acc_m = 0.f;
  const int nsteps = (xb - xa) + 2 * IT + 3;
  for (int s = 0; s < nsteps; ++s) {
    const int t = t0 + s;
    load_eps(t + 3, (s + 3) & 3);
    // ---- stage 0's global reads (plane t+1), used at the end of the step:
    // L0, L1, L2 at every cell of the field (the rings' in-plane and next
    // plane reads), r, D, iD and L(+e_d) at interior cells
    const int p0 = t + 1;
    const bool s0 = p0 >= 0 && p0 < g.nx && p0 <= xb + IT;
    const bool s0in = p0 >= 1 && p0 <= g.nx - 2;
    float q_r[2], q_d[2], q_id[2], q_l0[2], q_l0p[2], q_l1[2], q_l1p[2],
        q_l2[3];
    {
      const int64_t c = (int64_t)(s0 ? p0 : 0) * sx + goff;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool in = s0in && (fl >> j & 1u);
        const bool f = s0 && (fl >> (5 + j) & 1u);
        q_r[j] = in ? r[c + j] : 0.f;
        q_d[j] = in ? D[c + j] : 0.f;
        q_id[j] = in ? iD[c + j] : 0.f;
        q_l0[j] = f ? L0[c + j] : 0.f;
        q_l0p[j] = in ? L0[c + j + sx] : 0.f;
        q_l1[j] = f ? L1[c + j] : 0.f;
        q_l1p[j] = in ? L1[c + j + sy] : 0.f;
        q_l2[j] = f ? L2[c + j] : 0.f;
      }
      q_l2[2] = s0in && (fl & 2u) ? L2[c + 2] : 0.f;
    }
    // ---- the tail's global reads (plane q)
    const int q = t - IT - 1;
    const bool tail = q >= xa && q < xb;
    const bool qin = q >= 1 && q <= g.nx - 2;
    const int64_t cq = (int64_t)(tail ? q : 0) * sx + goff;
    float t_x[2], t_r[2], t_e[2], t_d[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool w = tail && (fl >> (2 + j) & 1u);
      const bool in = w && qin && (fl >> j & 1u);
      t_x[j] = w ? x[cq + j] : 0.f;
      t_r[j] = w ? r[cq + j] : 0.f;
      t_e[j] = in ? eps[cq + j] : 0.f;
      t_d[j] = in ? D[cq + j] : 0.f;
    }
    // ---- stages 1..IT: the k-th colour on plane t-k, in place
#pragma unroll
    for (int k = 1; k <= IT; ++k) {
      const int p = t - k;
      if (p >= max(1, xa - H + k) && p <= min(g.nx - 2, xb + H - k - 1) &&
          ydepth >= k) {
        const int off = ((p + (int)(fl >> 4)) & 1) ^ ((cmask >> (k - 1)) & 1);
        if (fl >> off & 1u) {
          const int o = off ? o1 : o0;
          const int b = eb[k + 1];                       // plane p
          const int sc = b + o;
          const int sm = eb[(k + 2) % NE] + o;
          const int sn = eb[k] + o;
          const int sr = rb[(k + 1) % NR] + o;
          const int zm = b + (off ? o0 : o1 - 1), zp = b + (off ? o0 + 1 : o1);
          float v = R1[sr];
          v = v - (E[sm] * A0[sc] + E[sn] * A0[sn]);
          v = v - (E[sc - W2] * A1[sc] + E[sc + W2] * A1[sc + W2]);
          v = v - (E[zm] * A2[sc] + E[zp] * A2[zp]);
          E[sc] = v * AI[sr];
        }
      }
    }
    // ---- the tail: x', r' and the norms on plane q
    if (tail) {
      const int bc = eb[IT + 2], bm = eb[0], bn = eb[IT + 1];  // q, q-+1
      const int br = rb[0];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (fl >> (2 + j) & 1u) {
          const int sc = bc + oc[j];
          float xv = t_x[j], rq = t_r[j];
          if (qin && (fl >> j & 1u)) {
            const float e = E[sc];
            float a = e * t_d[j];
            a = a + E[bm + oc[j]] * A0[sc];
            a = a + E[bn + oc[j]] * A0[bn + oc[j]];
            a = a + E[sc - W2] * A1[sc];
            a = a + E[sc + W2] * A1[sc + W2];
            a = a + E[bc + om[j]] * A2[sc];
            a = a + E[bc + op[j]] * A2[bc + op[j]];
            xv = xv + omega * (t_e[j] + e);
            rq = R1[br + oc[j]] - omega * a;
          }
          x_out[cq + j] = xv;
          r_out[cq + j] = rq;
          acc_s += fabsf(rq);
          acc_m = fmaxf(acc_m, fabsf(rq));
        }
      }
    }
    // ---- stage 0: r1 and e0 on plane t+1 at both cells; L and iD into
    // the rings
    if (s0 && tid < S::NPAIR) {
      const float* pm = EP + (s & 3) * PP;        // plane t
      const float* pc = EP + ((s + 1) & 3) * PP;  // plane t+1
      const float* pp = EP + ((s + 2) & 3) * PP;  // plane t+2
      const int bc = eb[0], br = rb[0];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = oc[j];
        float rv = q_r[j], v = 0.f;
        if (s0in && (fl >> j & 1u)) {
          float a = pc[o] * q_d[j];
          a = a + pm[o] * q_l0[j];
          a = a + pp[o] * q_l0p[j];
          a = a + pc[o - W2] * q_l1[j];
          a = a + pc[o + W2] * q_l1p[j];
          a = a + pc[om[j]] * q_l2[j];
          a = a + pc[op[j]] * q_l2[j + 1];
          rv = rv - omega * a;
          v = rv * q_id[j];
        }
        E[bc + o] = v;
        A0[bc + o] = q_l0[j];
        A1[bc + o] = q_l1[j];
        A2[bc + o] = q_l2[j];
        R1[br + o] = rv;
        AI[br + o] = q_id[j];
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const int e_new = eb[NE - 1], r_new = rb[NR - 1];
#pragma unroll
    for (int j = NE - 1; j > 0; --j) eb[j] = eb[j - 1];
#pragma unroll
    for (int j = NR - 1; j > 0; --j) rb[j] = rb[j - 1];
    eb[0] = e_new;
    rb[0] = r_new;
  }
  if (NORMS) {
    block_sum_max(acc_s, acc_m, NT);
    if (tid == 0) {
      const int64_t b = block_linear();
      const int64_t nb = (int64_t)gridDim.x * gridDim.y * gridDim.z;
      partials[b] = acc_s;
      partials[nb + b] = acc_m;
    }
  }
}

// The cascade's grid: tiles over the (y, z) interior and chunks of xc
// interior x rows, the chunk length that gives the fewest steps per
// resident block slot (the card's SMs times the blocks an SM holds).
template <int IT, bool NORMS>
cudaError_t incr_gs_tile_grid(const Grid3& g, dim3& grid, int& xc) {
  using S = IgShape<IT>;
  static int slots = 0;
  if (slots == 0) {
    auto kernel = incr_gs_tile_kernel<IT, NORMS>;
    int dev = 0, sms = 0, bps = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, kernel, S::NT,
                                                          S::SMEM);
    if (err != cudaSuccess) return err;
    slots = sms * (bps > 0 ? bps : 1);
  }
  grid.x = g.nz > 2 ? (unsigned)((g.nz - 2 + IG_TZ - 1) / IG_TZ) : 1u;
  grid.y = g.ny > 2 ? (unsigned)((g.ny - 2 + IG_TY - 1) / IG_TY) : 1u;
  const int ni = g.nx > 2 ? g.nx - 2 : 1;
  const int64_t cols = (int64_t)grid.x * grid.y;
  int64_t best = -1;
  xc = ni;
  for (int n = 1; n <= ni; ++n) {
    const int c = (ni + n - 1) / n;
    if ((ni + c - 1) / c != n) continue;
    const int64_t cost = (cols * n + slots - 1) / slots * (c + 2 * IT + 3);
    if (best < 0 || cost < best) {
      best = cost;
      xc = c;
    }
  }
  grid.z = (unsigned)((ni + xc - 1) / xc);
  return cudaSuccess;
}

template <int IT, bool NORMS>
cudaError_t launch_incr_gs_it(const float* x, const float* r,
                              const float* eps, const float* L,
                              const float* D, const float* iD, float omega,
                              unsigned cmask, float* x_out, float* r_out,
                              float* partials, float* norms, const Grid3& g,
                              cudaStream_t s) {
  using S = IgShape<IT>;
  dim3 grid;
  int xc;
  cudaError_t err = incr_gs_tile_grid<IT, NORMS>(g, grid, xc);
  if (err != cudaSuccess) return err;
  incr_gs_tile_kernel<IT, NORMS><<<grid, S::NT, S::SMEM, s>>>(
      x, r, eps, L, D, iD, omega, cmask, xc, x_out, r_out, partials, g);
  if ((err = cudaGetLastError()) != cudaSuccess || !NORMS) return err;
  int64_t nb = (int64_t)grid.x * grid.y * grid.z;
  fold_partials_kernel<<<1, RT, 0, s>>>(partials, nb, norms);
  return cudaGetLastError();
}

template <bool NORMS>
cudaError_t launch_incr_gs_tile(const float* x, const float* r,
                                const float* eps, const float* L,
                                const float* D, const float* iD, float omega,
                                const int* colors, int ncolors, float* x_out,
                                float* r_out, float* partials, float* norms,
                                const Grid3& g, cudaStream_t s) {
  unsigned cmask = 0;
  for (int k = 0; k < ncolors; ++k) cmask |= (unsigned)(colors[k] & 1) << k;
#define WLT_IG_CASE(IT)                                                     \
  case IT:                                                                  \
    return launch_incr_gs_it<IT, NORMS>(x, r, eps, L, D, iD, omega, cmask, \
                                        x_out, r_out, partials, norms, g, s)
  switch (ncolors) {
    WLT_IG_CASE(1);
    WLT_IG_CASE(2);
    WLT_IG_CASE(3);
    WLT_IG_CASE(4);
    default: return cudaErrorInvalidValue;
  }
#undef WLT_IG_CASE
}

// the blocks of the cascade's grid with norms, or -1 on an error
int64_t incr_gs_tile_blocks(const Grid3& g, int ncolors) {
  dim3 grid;
  int xc;
  cudaError_t err;
  switch (ncolors) {
    case 1: err = incr_gs_tile_grid<1, true>(g, grid, xc); break;
    case 2: err = incr_gs_tile_grid<2, true>(g, grid, xc); break;
    case 3: err = incr_gs_tile_grid<3, true>(g, grid, xc); break;
    case 4: err = incr_gs_tile_grid<4, true>(g, grid, xc); break;
    default: return -1;
  }
  return err == cudaSuccess ? (int64_t)grid.x * grid.y * grid.z : -1;
}

// ------------------------------------------------------------ K6, K7 per colour
// The per-colour route (bf16, or more than IG_MAX_IT colours) and K6.
// MP instantiation (pallas_flat.py:896 incr_gs with mp=True; the arithmetic
// is in stencil_common.cuh): L, D, iD and the e scratch are bf16.  r1 is
// formed in float32 from the float32 eps and the bf16 coefficients and kept
// in float32; the cascade reads its bf16 rounding; A e is accumulated in
// bf16; x', r' and the norms are float32.  The call must move x, r, eps in,
// x', r' out (20 B) and five bf16 coefficients (10 B): 30 B/cell against 40,
// 0.15 ms at 258^3.  It needs at least one colour: the increment alone (K6)
// has no mixed-precision form.
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

// the tiled cascade takes float32 with 1 to IG_MAX_IT colours
__host__ bool incr_gs_tiled(int ncolors, bool mp) {
  return !mp && ncolors >= 1 && ncolors <= IG_MAX_IT;
}

// e: scratch field (used by the per-colour route only); partials: 2 x
// wlt_incr_gs_partials floats and norms: 2 floats, both nullptr without
// norms.  r must not alias r_out: the cascade reads r at other blocks' cells.
template <bool MP>
cudaError_t launch_incr_gs(const float* x, const float* r, const float* eps,
                           const coef_t<MP>* L, const coef_t<MP>* D,
                           const coef_t<MP>* iD, coef_t<MP>* e, float* x_out,
                           float* r_out, const int* colors, int ncolors,
                           float omega, float* partials, float* norms,
                           const Grid3& g, cudaStream_t s) {
  if constexpr (!MP) {
    if (incr_gs_tiled(ncolors, MP)) {
      return norms == nullptr
                 ? launch_incr_gs_tile<false>(x, r, eps, L, D, iD, omega,
                                              colors, ncolors, x_out, r_out,
                                              nullptr, nullptr, g, s)
                 : launch_incr_gs_tile<true>(x, r, eps, L, D, iD, omega,
                                             colors, ncolors, x_out, r_out,
                                             partials, norms, g, s);
    }
  }
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

// the length of each half of the norm partials buffer of wlt_incr_gs (mp
// = 0) or wlt_incr_gs_mp (mp = 1) with ncolors colours: the blocks of the
// grid that the call's route launches, or -1 on an error
int64_t wlt_incr_gs_partials(int64_t nx, int64_t ny, int64_t nz, int ncolors,
                             int mp) {
  Grid3 g = make_grid(nx, ny, nz);
  if (incr_gs_tiled(ncolors, mp != 0)) return incr_gs_tile_blocks(g, ncolors);
  dim3 gr = grid_of(g, 1);
  return (int64_t)gr.x * gr.y * gr.z;
}

// 1 if wlt_incr_gs (mp = 0) or wlt_incr_gs_mp (mp = 1) with ncolors
// colours takes the per-colour route, which needs the e scratch field
int wlt_incr_gs_scratch(int ncolors, int mp) {
  return ncolors > 0 && !incr_gs_tiled(ncolors, mp != 0);
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

int wlt_incr_gs(const float* x, const float* r, const float* eps,
                const float* L, const float* D, const float* iD, float* e,
                float* x_out, float* r_out, const int* colors, int ncolors,
                float omega, float* partials, float* norms, int64_t nx,
                int64_t ny, int64_t nz, void* stream) {
  return (int)launch_incr_gs<false>(x, r, eps, L, D, iD, e, x_out, r_out,
                                    colors, ncolors, omega, partials, norms,
                                    make_grid(nx, ny, nz),
                                    (cudaStream_t)stream);
}

// the mixed-precision instantiation: L, D, iD and the e scratch are bf16;
// ncolors >= 1
int wlt_incr_gs_mp(const float* x, const float* r, const float* eps,
                   const bf16* L, const bf16* D, const bf16* iD, bf16* e,
                   float* x_out, float* r_out, const int* colors, int ncolors,
                   float omega, float* partials, float* norms, int64_t nx,
                   int64_t ny, int64_t nz, void* stream) {
  return (int)launch_incr_gs<true>(x, r, eps, L, D, iD, e, x_out, r_out,
                                   colors, ncolors, omega, partials, norms,
                                   make_grid(nx, ny, nz),
                                   (cudaStream_t)stream);
}

}  // extern "C"
