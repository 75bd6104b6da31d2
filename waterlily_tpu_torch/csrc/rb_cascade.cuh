// The tiled red-black cascade shared by the smoothers: K7 incr_gs_k
// (fused3d.cu), K15 gs_incr_k and K13 gauss_sweeps_k (stencil3d.cu), each a
// head and a tail around the same colour sweeps, chosen by a template
// parameter (RbForm):
//
//   form              stage 0 (e0 and the r ring)      tail (plane q)
//   RB_INCR_GS (K7)   r1 = r - w A eps, e0 = r1 iD      x' = x + w (eps + e),
//                     (eps by cp.async, see below)      r' = r1 - w A e
//                                                       (+ norms of r')
//   RB_GS_INCR (K15)  e0 = r iD, the ring holds r       x' = x + w e,
//                                                       r' = r - w A e
//   RB_SWEEPS (K13)   e0 = eps (every cell of the       eps' = e
//                     field), the ring holds r
//
// on interior cells; the ghosts of x' and r' keep x and r.  K13 sweeps with
// periodic images (below).  The colour sweeps, the schedule and the rings
// are the same for every form.
//
// MP (a template parameter; K7 and K15 only, the smoothers' bf16 forms,
// pallas_flat.py:805-860, 935-1005): L, D and iD are bf16 and every
// operation of e is a bf16 operation, rounded where the plain versions
// (stencil3d._mp_sweeps, _mp_mult) round.  They round a float32 result to
// bf16; the card's bf16 instructions round the exact result once, which is
// the same number for bf16 operands: a product of two bf16 values is exact
// in float32, and for a sum float32 carries more than 2 x 8 + 1 bits, so
// its rounding before the one to bf16 changes nothing (double rounding is
// innocuous).  So the sweeps and A e use the bf16 instructions (the _rn
// forms, never contracted into a fused multiply-add), one instruction an
// operation.  K7's r1 = r - w A eps is float32 from the float32 eps and the
// bf16 coefficients, each operation rounded on its own; the sweeps read a
// bf16 rounding of r1 (K15: of r); x', r' and the norms are float32.  The
// e, L and iD rings are bf16 (133 KB a block for K7 at IT = 4, 113 for K15,
// against 212 and 193), r (K7: r1) and eps stay float32.  The loads are the
// float32 form's, one a cell (PERF.md section 6: a float32 operation and a
// conversion for each bf16 one made the form 1.7x slower; loading each pair
// of cells as one float2 / bf16x2 made it slower too).  The float32
// instantiations keep their code.
//
// What bounds it on an H100: K7 must move 40 B/cell (x, r, eps, L (3), D, iD
// in, x', r' out; 0.205 ms at 258^3 at 3.35 TB/s), K15 36 B (0.185 ms), K13
// 28 B (eps, r, L (3), iD in, eps' out; 0.144 ms), for ~13 flops a cell and
// a sweep.  The design keeps the colour sweeps off device memory (the TPU
// kernel's communication-avoiding cascade, pallas_flat.py:896-1000,
// pallas3d.py:416, with halo it+1), needs one barrier per x plane, and reads
// device memory only at the head and the tail of its wavefront:
//
// * Tiles cover the interior: a block owns RB_TY x RB_TZ interior (y, z)
//   cells (the first and last tiles of a row of tiles also own the ghost
//   cells beside them) and marches over a chunk of xc interior x rows (the
//   first and last chunks also own the ghost planes).  Its region is the
//   tile grown by H = IT+1 cells in y and z.  Each thread owns a pair of
//   z-adjacent cells (z, z+1) of the region for the whole march: on any
//   plane one of them has the colour of a sweep.
// * At march step t the thread runs, in this order: stage k = 1..IT, the
//   sweep of the k-th colour on plane t-k (at the cell of its pair that has
//   the colour); the tail on plane q = t-IT-1 (at the cells of its pair
//   that the block owns); stage 0 on plane t+1 (e0 and the r ring at both
//   cells, and its cells' L and iD into shared rings).  e, r (K7: r1), L
//   and iD live in shared rings of planes.  A stage reads its own cells'
//   x-neighbours, written by this thread earlier, and in-plane neighbours
//   (e, L) on its plane, written by other threads in an earlier step: one
//   barrier a step orders them.  A sweep on plane p leaves the other colour
//   of p alone, so its in-plane reads see the values of the sequential
//   sweeps, for any colour list (tests/test_torch_incr_gs_cascade.py
//   emulates this schedule on the CPU for every form).
// * Each stage runs on its dependency cone in x (stage k: the chunk grown
//   by H-k planes; a chunk takes xc + 2 IT + 3 steps) and in y (the tile
//   grown by H-k rows: the warps of the outer rows skip the sweep), and on
//   every column of the region.  A value outside the cone may be wrong or
//   stale and is never read by a value inside it (so the region's last
//   column may read the rings' zero border for L2(+z)).
// * Cells outside the field are masked, never wrapped, in a direction that
//   is not periodic: an interior cell reads one cell into the ghosts at
//   most.  Colour parity and the interior mask are global.  No thread
//   returns early.
// * Periodic directions (K13, bit j of `per`): the region is the field's
//   periodic extension.  A cell maps to its source, its image in the
//   interior (1 + (p - 1) mod (n - 2)), computed once per thread in y and z
//   and once per step in x, so the chunk lead-ins at either end of the
//   march and the halo rows and columns wrap; every ring value is its
//   source's.  The source's interior mask decides which cells stages
//   1..IT-1 sweep; the last stage sweeps the real interior only, so a
//   periodic ghost of the output keeps its partner's value from before the
//   last colour, as the per-colour reference (a ghost refresh before each
//   colour, none after the last) leaves it.  Needs, in each periodic
//   direction, an even interior extent (the partner of a face cell then has
//   the other colour, and parity is that of the source; an odd extent takes
//   the per-colour launches) and L's ghost planes equal to their partners'
//   (bc_vector with perdir leaves them so): a ring cell stores one L, read
//   both as a ghost's and as its source's.  Corner and edge ghosts map to
//   the same source in any order of the directions.
// * Device memory: K7's eps arrives by cp.async in a ring of 4 planes (the
//   region grown by one cell), three planes ahead of stage 0 (its A eps
//   reads neighbours); stage 0 starts its loads at the start of the step
//   and uses them at its end (K13's eps among them: it needs its own cells
//   only); the tail starts its loads (K7: x, r, eps, D; K15: x, D and r at
//   the ghosts) at the start of the step.  The sweeps read shared memory
//   only.
// * A ring plane stores each row's odd columns, then its even ones, so
//   the threads of a warp read consecutive words (no bank conflicts: the
//   cells of a pair are two columns apart in neither half).
// * K7's norms: per-thread sums and maxima over the march, returned to the
//   kernel, which reduces them in the block's fixed tree into per-block
//   partials: equal from call to call.
// * Chunks: the fewest steps per resident block slot of the card, from
//   the shape, the card's SM count and the kernel's occupancy.
//
// On an H100 it runs at several times the byte floor: one block of 18 warps
// an SM, held in step by the barrier, waits on each step's dependent chain
// (stage 0's loads, the sweeps through shared memory, then the tail) far
// longer than it moves bytes (PERF.md section 6 has the timings).  On small
// levels the march's fixed cost per step loses to per-colour launches: the
// launchers keep those below a measured size.
//
// IT (1..RB_MAX_IT) and the form are template parameters; the rings are
// dynamic shared memory, 212 KB a block of 576 threads at IT = 4 (193 KB
// without K7's eps ring).
#pragma once

#include "convdiff_tile.cuh"

namespace {

constexpr int RB_TY = 16;
constexpr int RB_TZ = 32;
constexpr int RB_MAX_IT = 4;

enum RbForm : int { RB_INCR_GS, RB_INCR_GS_NORMS, RB_GS_INCR, RB_SWEEPS };

template <int IT>
struct RbShape {
  static constexpr int H = IT + 1;                   // the region's halo
  static constexpr int HR = RB_TY + 2 * H;           // region rows (y)
  static constexpr int WR = RB_TZ + 2 * H;           // region columns (z)
  static constexpr int WP = WR / 2;                  // cell pairs a row
  static constexpr int NPAIR = HR * WP;
  static constexpr int NT = (NPAIR + 31) / 32 * 32;  // threads of a block
  static constexpr int W2 = WR + 2;                  // ring planes: region
  static constexpr int PP = (HR + 2) * W2;           // grown by one cell
  static constexpr int HW = W2 / 2;                  // columns of a half
  // ring planes: e, L0, L1, L2 NE (planes t+1 .. t-IT-1 in step t); r (K7:
  // r1) and iD NR (t+1 .. t-IT); K7's eps 4 (t .. t+3)
  static constexpr int NE = IT + 3, NR = IT + 2;
  static constexpr int O_L0 = NE * PP, O_L1 = 2 * NE * PP,
                       O_L2 = 3 * NE * PP, O_R1 = 4 * NE * PP,
                       O_ID = O_R1 + NR * PP, O_EPS = O_ID + NR * PP;
  static constexpr int NLD = (PP + NT - 1) / NT;     // eps loads a thread
  // MP: r1 (float, NR planes at float 0), the bf16 rings from float M_B (e,
  // L0, L1, L2 as above, iD at bf16 M_ID), K7's eps (float, from M_EPS)
  static constexpr int M_B = NR * PP, M_ID = 4 * NE * PP;
  static constexpr int M_EPS = M_B + (M_ID + NR * PP) / 2;
  static_assert(PP % 2 == 0, "a bf16 ring plane fills whole words");
};
static_assert(RbShape<RB_MAX_IT>::NT <= 1024, "a block holds every pair");

// dynamic shared memory of a form: the rings, and K7's eps ring
template <int IT, int FORM, bool MP = false>
constexpr int rb_smem() {
  using S = RbShape<IT>;
  return ((MP ? S::M_EPS : S::O_EPS) +
          (FORM == RB_INCR_GS || FORM == RB_INCR_GS_NORMS ? 4 * S::PP : 0)) *
         4;
}
static_assert(rb_smem<RB_MAX_IT, RB_INCR_GS>() <= 227 * 1024,
              "the cascade's rings exceed a block's shared memory");

// zero of a ring element
template <bool MP>
__device__ __forceinline__ coef_t<MP> rzero() {
  if constexpr (MP) {
    return __ushort_as_bfloat16((unsigned short)0);
  } else {
    return 0.f;
  }
}

__device__ __forceinline__ void cp_async4_zfill(unsigned dst, const float* src,
                                                int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// the periodic source of coordinate p in a direction of n cells: its image
// in the interior 1 .. n-2
__device__ __forceinline__ int rb_wrap(int p, int n) {
  const int m = n - 2;
  const int q = (p - 1) % m;
  return 1 + (q < 0 ? q + m : q);
}

// The cascade's body, run by every thread of a block of RbShape<IT>::NT.
// Colour k of the list is bit k-1 of cmask; per: the periodic directions
// (RB_SWEEPS only).  K13 writes eps' into x_out.  acc_s, acc_m: this
// thread's sum and max of |r'| (RB_INCR_GS_NORMS).  MP: the bf16 form.
template <int IT, int FORM, bool MP = false>
__device__ __forceinline__ void rb_cascade(
    const float* __restrict__ x, const float* __restrict__ r,
    const float* __restrict__ eps, const coef_t<MP>* __restrict__ L,
    const coef_t<MP>* __restrict__ D, const coef_t<MP>* __restrict__ iD,
    float omega, unsigned cmask, unsigned per, int xc,
    float* __restrict__ x_out, float* __restrict__ r_out, float& acc_s,
    float& acc_m, const Grid3& g) {
  using S = RbShape<IT>;
  constexpr bool K7 = FORM == RB_INCR_GS || FORM == RB_INCR_GS_NORMS;
  constexpr bool SW = FORM == RB_SWEEPS;
  static_assert(!(MP && SW), "K13 has no bf16 form");
  constexpr int H = S::H, W2 = S::W2, PP = S::PP, NE = S::NE, NR = S::NR;
  constexpr int NT = S::NT, NLD = S::NLD;
  using RT = coef_t<MP>;          // e, L and iD in the rings
  extern __shared__ __align__(16) float rb_smem_[];
  RT* const E = reinterpret_cast<RT*>(rb_smem_ + (MP ? S::M_B : 0));
  RT* const A0 = E + S::O_L0;
  RT* const A1 = E + S::O_L1;
  RT* const A2 = E + S::O_L2;
  float* const R1 = rb_smem_ + (MP ? 0 : S::O_R1);
  RT* const AI =
      MP ? E + S::M_ID : reinterpret_cast<RT*>(rb_smem_ + S::O_ID);
  const float* const EP = rb_smem_ + (MP ? S::M_EPS : S::O_EPS);
  const coef_t<MP>* const L0 = L;
  const coef_t<MP>* const L1 = L + g.n;
  const coef_t<MP>* const L2 = L + 2 * g.n;
  const int64_t sx = g.sx, sy = g.sy;
  const int tid = threadIdx.x;
  const int y0 = 1 + blockIdx.y * RB_TY, z0 = 1 + blockIdx.x * RB_TZ;
  const int ia = 1 + blockIdx.z * xc;
  // the planes, rows and columns of the cells whose outputs it writes
  const int xa = blockIdx.z == 0 ? 0 : ia;
  const int xb = blockIdx.z == gridDim.z - 1 ? g.nx : ia + xc;
  const int ya = blockIdx.y == 0 ? 0 : y0;
  const int yb = blockIdx.y == gridDim.y - 1 ? g.ny : y0 + RB_TY;
  const int za = blockIdx.x == 0 ? 0 : z0;
  const int zb = blockIdx.x == gridDim.x - 1 ? g.nz : z0 + RB_TZ;

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
  // the periodic directions and the sources of the pair's cells in y, z
  const bool px = SW && (per & 1u), pyd = SW && (per & 2u),
             pzd = SW && (per & 4u);
  const int ys = pyd ? rb_wrap(y, g.ny) : y;
  int zs[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) zs[j] = pzd ? rb_wrap(zc + j, g.nz) : zc + j;
  const int64_t so[2] = {SW ? (int64_t)ys * sy + zs[0] : goff,
                         SW ? (int64_t)ys * sy + zs[1] : goff + 1};
  // bit j: cell j's source interior in (y, z); bit 2+j: cell j written by
  // this block; bit 4: parity of y + zc; bit 5+j: cell j's source in the
  // field; bit 7+j (K13): cell j itself interior in (y, z)
  unsigned fl = ((y + zc) & 1) ? 16u : 0u;
  if (tid < S::NPAIR) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int z = zc + j, zq = zs[j];
      if (ys >= 1 && ys <= g.ny - 2 && zq >= 1 && zq <= g.nz - 2) fl |= 1u << j;
      if (y >= ya && y < yb && z >= za && z < zb) fl |= 4u << j;
      if (ys >= 0 && ys < g.ny && zq >= 0 && zq < g.nz) fl |= 32u << j;
      if (SW && y >= 1 && y <= g.ny - 2 && z >= 1 && z <= g.nz - 2)
        fl |= 128u << j;
    }
  }
  // K7: this thread's eps ring elements: offset in a plane, -1 off the
  // field (zero fill), -2 past the ring plane
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
  const unsigned eps_s = (unsigned)__cvta_generic_to_shared(EP);
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
  // of e, L0, L1, L2, (p - t0) % NR of r and iD, (p - t0) % 4 of eps.
  // eb[j] and rb[j] are the float offsets of plane t+1-j's slots (j = NE
  // and NR: the slot of t+1, read before stage 0 writes it), rotated at
  // the end of each step.
  const int t0 = xa - H - 1;
  int eb[NE], rb[NR];
#pragma unroll
  for (int j = 0; j < NE; ++j) eb[j] = ((NE + 1 - j) % NE) * PP;
#pragma unroll
  for (int j = 0; j < NR; ++j) rb[j] = ((NR + 1 - j) % NR) * PP;
  for (int i = tid; i < (MP ? S::M_EPS : S::O_EPS); i += NT)
    rb_smem_[i] = 0.f;
  if (K7) {
    load_eps(t0, 0);
    load_eps(t0 + 1, 1);
    load_eps(t0 + 2, 2);
    cp_async_wait_all();
  }
  __syncthreads();

  const int nsteps = (xb - xa) + 2 * IT + 3;
  for (int s = 0; s < nsteps; ++s) {
    const int t = t0 + s;
    if (K7) load_eps(t + 3, (s + 3) & 3);
    // ---- stage 0's global reads (plane t+1, at its source x0), used at the
    // end of the step: L0, L1, L2 (K13: and eps) at every cell of the field
    // (the rings' in-plane and next plane reads), r, iD (K7: D and L(+e_d))
    // at interior cells
    const int p0 = t + 1;
    const int x0 = px ? rb_wrap(p0, g.nx) : p0;
    const bool s0 = x0 >= 0 && x0 < g.nx && p0 <= xb + IT;
    const bool s0in = x0 >= 1 && x0 <= g.nx - 2;
    float q_r[2], q_e[2];
    RT q_d[2], q_id[2], q_l0[2], q_l0p[2], q_l1[2], q_l1p[2], q_l2[3];
    {
      const RT z = rzero<MP>();
      const int64_t c = (int64_t)(s0 ? x0 : 0) * sx;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool in = s0in && (fl >> j & 1u);
        const bool f = s0 && (fl >> (5 + j) & 1u);
        const int64_t cj = c + so[j];
        q_r[j] = in ? r[cj] : 0.f;
        if (K7) q_d[j] = in ? D[cj] : z;
        q_id[j] = in ? iD[cj] : z;
        q_l0[j] = f ? L0[cj] : z;
        if (K7) q_l0p[j] = in ? L0[cj + sx] : z;
        q_l1[j] = f ? L1[cj] : z;
        if (K7) q_l1p[j] = in ? L1[cj + sy] : z;
        q_l2[j] = f ? L2[cj] : z;
        if (SW) q_e[j] = f ? eps[cj] : 0.f;
      }
      if (K7) q_l2[2] = s0in && (fl & 2u) ? L2[c + so[1] + 1] : z;
    }
    // ---- the tail's global reads (plane q)
    const int q = t - IT - 1;
    const bool tail = q >= xa && q < xb;
    const bool qin = q >= 1 && q <= g.nx - 2;
    const int64_t cq = (int64_t)(tail ? q : 0) * sx + goff;
    float t_x[2], t_r[2], t_e[2];
    RT t_d[2];
    if (!SW) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool w = tail && (fl >> (2 + j) & 1u);
        const bool in = w && qin && (fl >> j & 1u);
        t_x[j] = w ? x[cq + j] : 0.f;
        // K15 and the bf16 K7 read r at the interior from its ring
        t_r[j] = (K7 && !MP ? w : w && !in) ? r[cq + j] : 0.f;
        if (K7) t_e[j] = in ? eps[cq + j] : 0.f;
        t_d[j] = in ? D[cq + j] : rzero<MP>();
      }
    }
    // ---- stages 1..IT: the k-th colour on plane t-k, in place (K13 with x
    // periodic: planes whose source is interior, the last stage the real
    // interior)
#pragma unroll
    for (int k = 1; k <= IT; ++k) {
      const int p = t - k;
      const bool xin = (px && k < IT) || (p >= 1 && p <= g.nx - 2);
      if (p >= xa - H + k && p <= xb + H - k - 1 && xin && ydepth >= k) {
        const int off = ((p + (int)(fl >> 4)) & 1) ^ ((cmask >> (k - 1)) & 1);
        const unsigned im = SW && k == IT ? fl >> 7 : fl;
        if (im >> off & 1u) {
          const int o = off ? o1 : o0;
          const int b = eb[k + 1];                       // plane p
          const int sc = b + o;
          const int sm = eb[(k + 2) % NE] + o;
          const int sn = eb[k] + o;
          const int sr = rb[(k + 1) % NR] + o;
          const int zm = b + (off ? o0 : o1 - 1), zp = b + (off ? o0 + 1 : o1);
          if constexpr (MP) {
            bf16 v = __float2bfloat16_rn(R1[sr]);
            v = __hsub_rn(v, __hadd_rn(__hmul_rn(E[sm], A0[sc]),
                                       __hmul_rn(E[sn], A0[sn])));
            v = __hsub_rn(v, __hadd_rn(__hmul_rn(E[sc - W2], A1[sc]),
                                       __hmul_rn(E[sc + W2], A1[sc + W2])));
            v = __hsub_rn(v, __hadd_rn(__hmul_rn(E[zm], A2[sc]),
                                       __hmul_rn(E[zp], A2[zp])));
            E[sc] = __hmul_rn(v, AI[sr]);
          } else {
            float v = R1[sr];
            v = v - (E[sm] * A0[sc] + E[sn] * A0[sn]);
            v = v - (E[sc - W2] * A1[sc] + E[sc + W2] * A1[sc + W2]);
            v = v - (E[zm] * A2[sc] + E[zp] * A2[zp]);
            E[sc] = v * AI[sr];
          }
        }
      }
    }
    // ---- the tail on plane q: x', r' (K7: and the norms), or eps'
    if (tail) {
      const int bc = eb[IT + 2], bm = eb[0], bn = eb[IT + 1];  // q, q-+1
      const int br = rb[0];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (fl >> (2 + j) & 1u) {
          const int sc = bc + oc[j];
          if constexpr (SW) {
            x_out[cq + j] = E[sc];
            continue;
          }
          float xv = t_x[j], rq = t_r[j];
          if (qin && (fl >> j & 1u)) {
            if constexpr (MP) {
              const bf16 e = E[sc];
              const int sm = bm + oc[j], sn = bn + oc[j];
              const int zm = bc + om[j], zp = bc + op[j];
              bf16 a = __hmul_rn(e, t_d[j]);
              a = __hadd_rn(__hadd_rn(a, __hmul_rn(E[sm], A0[sc])),
                            __hmul_rn(E[sn], A0[sn]));
              a = __hadd_rn(__hadd_rn(a, __hmul_rn(E[sc - W2], A1[sc])),
                            __hmul_rn(E[sc + W2], A1[sc + W2]));
              a = __hadd_rn(__hadd_rn(a, __hmul_rn(E[zm], A2[sc])),
                            __hmul_rn(E[zp], A2[zp]));
              const float ef = fb(e);
              const float ex = K7 ? __fadd_rn(t_e[j], ef) : ef;
              xv = __fadd_rn(xv, __fmul_rn(omega, ex));
              rq = __fsub_rn(R1[br + oc[j]], __fmul_rn(omega, fb(a)));
            } else {
              const float e = E[sc];
              float a = e * t_d[j];
              a = a + E[bm + oc[j]] * A0[sc];
              a = a + E[bn + oc[j]] * A0[bn + oc[j]];
              a = a + E[sc - W2] * A1[sc];
              a = a + E[sc + W2] * A1[sc + W2];
              a = a + E[bc + om[j]] * A2[sc];
              a = a + E[bc + op[j]] * A2[bc + op[j]];
              xv = xv + omega * (K7 ? t_e[j] + e : e);
              rq = R1[br + oc[j]] - omega * a;
            }
          }
          x_out[cq + j] = xv;
          r_out[cq + j] = rq;
          acc_s += fabsf(rq);
          acc_m = fmaxf(acc_m, fabsf(rq));
        }
      }
    }
    // ---- stage 0: e0 and the r ring on plane t+1 at both cells; L and iD
    // into the rings
    if (s0 && tid < S::NPAIR) {
      const float* pm = EP + (s & 3) * PP;        // plane t
      const float* pc = EP + ((s + 1) & 3) * PP;  // plane t+1
      const float* pp = EP + ((s + 2) & 3) * PP;  // plane t+2
      const int bc = eb[0], br = rb[0];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = oc[j];
        float rv = q_r[j];
        RT v = rzero<MP>();
        if constexpr (SW) {
          v = q_e[j];
        } else if constexpr (!K7) {
          // 0 off the interior
          if constexpr (MP) {
            v = __hmul_rn(__float2bfloat16_rn(rv), q_id[j]);
          } else {
            v = rv * q_id[j];
          }
        } else if (s0in && (fl >> j & 1u)) {
          if constexpr (MP) {
            float a = __fmul_rn(pc[o], fb(q_d[j]));
            a = __fadd_rn(a, __fmul_rn(pm[o], fb(q_l0[j])));
            a = __fadd_rn(a, __fmul_rn(pp[o], fb(q_l0p[j])));
            a = __fadd_rn(a, __fmul_rn(pc[o - W2], fb(q_l1[j])));
            a = __fadd_rn(a, __fmul_rn(pc[o + W2], fb(q_l1p[j])));
            a = __fadd_rn(a, __fmul_rn(pc[om[j]], fb(q_l2[j])));
            a = __fadd_rn(a, __fmul_rn(pc[op[j]], fb(q_l2[j + 1])));
            rv = __fsub_rn(rv, __fmul_rn(omega, a));
            v = __hmul_rn(__float2bfloat16_rn(rv), q_id[j]);
          } else {
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
        }
        E[bc + o] = v;
        A0[bc + o] = q_l0[j];
        A1[bc + o] = q_l1[j];
        A2[bc + o] = q_l2[j];
        R1[br + o] = rv;
        AI[br + o] = q_id[j];
      }
    }
    if (K7) cp_async_wait_all();
    __syncthreads();
    const int e_new = eb[NE - 1], r_new = rb[NR - 1];
#pragma unroll
    for (int j = NE - 1; j > 0; --j) eb[j] = eb[j - 1];
#pragma unroll
    for (int j = NR - 1; j > 0; --j) rb[j] = rb[j - 1];
    eb[0] = e_new;
    rb[0] = r_new;
  }
}

// The cascade's grid: tiles over the (y, z) interior and chunks of xc
// interior x rows, the chunk length that gives the fewest steps per
// resident block slot (the card's SMs times the blocks an SM holds).
// `slots` is 0 until the first call, which sets the kernel's shared memory
// and finds its slots.
template <int IT, typename Kernel>
cudaError_t rb_cascade_grid(Kernel kernel, int smem, int& slots,
                            const Grid3& g, dim3& grid, int& xc) {
  using S = RbShape<IT>;
  if (slots == 0) {
    int dev = 0, sms = 0, bps = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, kernel, S::NT,
                                                          smem);
    if (err != cudaSuccess) return err;
    slots = sms * (bps > 0 ? bps : 1);
  }
  grid.x = g.nz > 2 ? (unsigned)((g.nz - 2 + RB_TZ - 1) / RB_TZ) : 1u;
  grid.y = g.ny > 2 ? (unsigned)((g.ny - 2 + RB_TY - 1) / RB_TY) : 1u;
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

}  // namespace
