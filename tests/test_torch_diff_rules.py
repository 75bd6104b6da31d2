"""The port's forward-mode rules on the CPU, float64, with the plain versions.

* K12's tangent kernel (`csrc/convdiff_jvp.cu`), emulated here formula for
  formula (`emulate_conv_diff_jvp`: the same face-flux tangents, slabs,
  selections and min/max tie weights), against `conv_diff_jvp_plain`, the
  forward-mode derivative of `conv_diff_plain` (`torch.func.jvp`), for every
  scheme and periodic mask, on random fields and on fields whose values are
  few, so that upwind tests meet 0 and `median3` meets ties;
* the rules of K12 and K14 (`stencil3d._ConvDiffRule`, `_BdimRule`: the
  `torch.autograd.Function` classes the card takes under AD, here on their
  plain versions) under `torch.func.jvp` (K14 also under
  `torch.autograd.forward_ad`; K12's plain tangent is itself a
  `torch.func.jvp`, which cannot run inside a `forward_ad` level, so K12's
  rule meets `forward_ad` on the card, `tests/test_torch_cuda.py`), against
  the derivative of the plain op, 1e-12 of max;
* the implicit rule of `multigrid.solve_mg_implicit` against the derivative
  of a dense pseudo-inverse solve;
* the tangent gate of the kernel wrappers (`stencil3d._no_tangent`);
* `mom_step_impl` with a float ``dt`` gives the bits it gave before the
  rules (the plain `solve_mg` and the clamp CFL), and a 0-d tensor ``dt``
  the same bits.

Every test here runs in a few seconds or less."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from waterlily_tpu_torch import AutoBody
from waterlily_tpu_torch.models import flow as fl
from waterlily_tpu_torch.models.body import measure_fill
from waterlily_tpu_torch.ops import fused3d as fz
from waterlily_tpu_torch.ops import multigrid as mg
from waterlily_tpu_torch.ops import poisson as ps
from waterlily_tpu_torch.ops import stencil3d as st
from waterlily_tpu_torch.ops.bc import bc_vector
from waterlily_tpu_torch.ops.grid import interior, shift

F64 = torch.float64
SHAPE = (18, 18, 18)           # 16³ interior
ODD = (12, 10, 9)              # a non-cubic field: an axis mixed up shows
PERS = [tuple(j for j in range(3) if m >> j & 1) for m in range(8)]


def close(a, b, rel=1e-12):
    a, b = a.detach(), b.detach()
    scale = max(b.abs().max().item(), 1e-300)
    err = (a - b).abs().max().item()
    assert err <= rel * scale, f"max|d| {err:.3e} > {rel:.0e} * {scale:.3e}"


def fields(shape, seed, coarse=False):
    """u and du ``(3, *shape)`` from a seed; ``coarse``: u takes the values
    {−1, −½, 0, ½, 1} only (ties and zero upwind velocities everywhere)."""
    rng = np.random.default_rng(seed)
    if coarse:
        u = 0.5 * rng.integers(-2, 3, (3,) + shape)
    else:
        u = rng.standard_normal((3,) + shape)
    du = rng.standard_normal((3,) + shape)
    return torch.as_tensor(u, dtype=F64), torch.as_tensor(du, dtype=F64)


# ---------------------------------------------------------------- K12's tangent
def _dmin(a, at, b, bt):
    w = torch.where(a == b, 0.5, (a < b).to(a.dtype))
    return torch.minimum(a, b), bt + w * (at - bt)


def _dmax(a, at, b, bt):
    w = torch.where(a == b, 0.5, (a > b).to(a.dtype))
    return torch.maximum(a, b), bt + w * (at - bt)


def _dmedian3(a, at, b, bt, c, ct):
    m1, m1t = _dmin(a, at, b, bt)
    x, xt = _dmax(a, at, b, bt)
    m2, m2t = _dmin(x, xt, c, ct)
    return _dmax(m1, m1t, m2, m2t)


def _dscheme(sid, u, ut, c, ct, d, dt):
    """`dscheme<SCHEME>` of `csrc/convdiff_jvp.cu` (van Leer's quotient as
    the kernel's product with one reciprocal differs from this division by
    a rounding, within the card's 2e-5)."""
    if sid == 0:
        a, at = (5 * c + 2 * d - u) / 6, (5 * ct + 2 * dt - ut) / 6
        b, bt = 10 * c - 9 * u, 10 * ct - 9 * ut
        m, mt = _dmedian3(b, bt, c, ct, d, dt)
        return _dmedian3(a, at, c, ct, m, mt)
    if sid == 1:
        denom = d - u
        zero = denom == 0
        safe = torch.where(zero, 1.0, denom)
        dsafe = torch.where(zero, 0.0, dt - ut)
        p = (d - c) * (c - u)
        dp = (dt - ct) * (c - u) + (d - c) * (ct - ut)
        q = p / safe
        revert = (c <= torch.minimum(u, d)) | (c >= torch.maximum(u, d))
        return (torch.where(revert, c, c + q),
                torch.where(revert, ct, ct + (dp - q * dsafe) / safe))
    return (c + d) / 2, (ct + dt) / 2


def _tflux(u, du, nu, dnu, i, j, sid, per):
    """`face_tflux` of `csrc/convdiff_jvp.cu` at every cell, on the stencil
    `tile_tflux` reads (or, at a periodic first slab, `tflux_per1`): the
    tangent of the flux of component i through each cell's lower j-face."""
    n = u.shape[1 + j]
    k = torch.arange(n)
    periodic = j in per
    special = periodic & ((k == 1) | (k == n - 1)) if periodic else torch.zeros(n, dtype=torch.bool)
    k0 = torch.where(special, 1, k)
    km2 = torch.where(special, n - 3, (k0 - 2) % n)
    km1, kp1 = (k0 - 1) % n, (k0 + 1) % n

    def at(a, idx):
        return a.index_select(j, idx)

    ujc, dujc = at(u[j], k0), at(du[j], k0)
    if i == j:
        ujb, dujb = at(u[j], km1), at(du[j], km1)
    else:
        ujb, dujb = torch.roll(ujc, 1, i), torch.roll(dujc, 1, i)
    ua, dua = 0.5 * (ujc + ujb), 0.5 * (dujc + dujb)
    f, df = u[i], du[i]
    fm2, fm1, fc, fp1 = (at(f, km2), at(f, km1), at(f, k0), at(f, kp1))
    dfm2, dfm1, dfc, dfp1 = (at(df, km2), at(df, km1), at(df, k0), at(df, kp1))
    view = [1, 1, 1]
    view[j] = n
    lo = (~torch.tensor(periodic) & (k0 == 1)).reshape(view)
    hi = (~torch.tensor(periodic) & (k0 == n - 1)).reshape(view)
    up = torch.where(hi, ~(ua < 0), ua > 0)
    v, vt = _dscheme(sid, torch.where(up, fm2, fp1), torch.where(up, dfm2, dfp1),
                     torch.where(up, fm1, fc), torch.where(up, dfm1, dfc),
                     torch.where(up, fc, fm1), torch.where(up, dfc, dfm1))
    central = (lo & (ua > 0)) | (hi & (ua < 0))
    v = torch.where(central, 0.5 * (fc + fm1), v)
    vt = torch.where(central, 0.5 * (dfc + dfm1), vt)
    return dua * v + ua * vt - (dnu * (fc - fm1) + nu * (dfc - dfm1))


def emulate_conv_diff_jvp(u, du, nu, dnu, sid, per):
    """`conv_diff_jvp_tile_kernel<SCHEME, PER>` of `csrc/convdiff_jvp.cu` on
    the whole grid: per component, the sum over j of the tangent flux
    through the lower j-face minus that through the upper one (the next
    cell's lower, wrapped: the kernel's carried x flux, shuffled z flux and
    exchanged y flux)."""
    out = []
    for i in range(3):
        s = torch.zeros_like(u[i])
        for j in range(3):
            phi = _tflux(u, du, nu, dnu, i, j, sid, per)
            s = s + (phi - torch.roll(phi, -1, j))
        out.append(s)
    return torch.stack(out)


@pytest.mark.parametrize("per", PERS, ids=lambda p: "per" + "".join(map(str, p)))
@pytest.mark.parametrize("sid", [0, 1, 2], ids=["quick", "vanleer", "cds"])
@pytest.mark.parametrize("coarse", [False, True], ids=["random", "ties"])
def test_conv_diff_jvp_formula(sid, per, coarse):
    u, du = fields(SHAPE, 3 * sid + len(per), coarse)
    nu, dnu = 0.03, -0.7
    want = st.conv_diff_jvp_plain(u, du, nu, dnu, st.SCHEMES[sid], per)
    close(emulate_conv_diff_jvp(u, du, nu, dnu, sid, per), want)


@pytest.mark.parametrize("sid", [0, 1, 2], ids=["quick", "vanleer", "cds"])
def test_conv_diff_jvp_formula_odd_shape(sid):
    for per in ((), (0, 1, 2), (1,)):
        u, du = fields(ODD, 11 + sid, coarse=True)
        close(emulate_conv_diff_jvp(u, du, 0.01, 0.5, sid, per),
              st.conv_diff_jvp_plain(u, du, 0.01, 0.5, st.SCHEMES[sid], per))


def test_conv_diff_jvp_ties_split_half():
    """At a uniform stream every median3 is a tie: the tangent takes ½ of
    each side, as `torch.minimum`/`maximum` (and JAX's) do; a clamp would
    take all of one."""
    u = torch.zeros((3,) + SHAPE, dtype=F64)
    u[0] = 1.0
    du = torch.as_tensor(np.random.default_rng(2).standard_normal((3,) + SHAPE))
    want = st.conv_diff_jvp_plain(u, du, 0.0, 0.0, st.quick)
    close(emulate_conv_diff_jvp(u, du, 0.0, 0.0, 0, ()), want)
    # quick's median of (5c+2d−u)/6, c, median(10c−9u, c, d) at u = c = d:
    # the tangent is not the upwind-only one
    assert (want - st.conv_diff_jvp_plain(u, du, 0.0, 0.0, st.cds)).abs().max() > 1e-3


# ---------------------------------------------------------------- K12 / K14 rules
@pytest.mark.parametrize("per", [(), (0, 1, 2), (2,)], ids=["walls", "per012", "per2"])
@pytest.mark.parametrize("what", ["u", "nu", "both"])
def test_conv_diff_rule_func_jvp(what, per):
    """Tangents in u alone (nu's is None in the rule), in nu alone (u's is
    None) and in both."""
    u, du = fields(SHAPE, 7)
    nu, dnu = torch.tensor(0.02, dtype=F64), torch.tensor(0.3, dtype=F64)
    for sid, scheme in enumerate(st.SCHEMES):
        def rule(a, b):
            return st._ConvDiffRule.apply(a, b, sid, per)

        def plain(a, b):
            return st.conv_diff_plain(a, b, scheme, per)
        for fn in (rule, plain):
            if what == "u":
                out = torch.func.jvp(lambda a: fn(a, nu), (u,), (du,))
            elif what == "nu":
                out = torch.func.jvp(lambda b: fn(u, b), (nu,), (dnu,))
            else:
                out = torch.func.jvp(fn, (u, nu), (du, dnu))
            if fn is rule:
                got = out
        close(got[0], out[0])
        close(got[1], out[1])


def test_conv_diff_rule_jacfwd():
    """`torch.func.jacfwd` through K12's rule (a batch of two directions in
    (u, nu): the rule and its tangent run once per batch entry,
    `stencil3d._loop_vmap`) against `torch.func.jvp` along each."""
    u, du = fields((7, 6, 5), 13)
    du2 = torch.roll(du, 1, 1)
    nu, dnu = torch.tensor(0.02, dtype=F64), torch.tensor(0.3, dtype=F64)
    for sid, per in ((0, ()), (1, (0, 1, 2)), (2, (1,))):
        def f(p):
            return st._ConvDiffRule.apply(u + p[0] * du + p[1] * du2,
                                          nu + p[0] * dnu, sid, per)

        p0 = torch.zeros(2, dtype=F64)
        jac = torch.func.jacfwd(f)(p0)
        for k in range(2):
            e = torch.zeros(2, dtype=F64)
            e[k] = 1.0
            close(jac[..., k], torch.func.jvp(f, (p0,), (e,))[1])


def bdim_inputs(seed):
    rng = np.random.default_rng(seed)

    def g(*s):
        return torch.as_tensor(rng.standard_normal(s + SHAPE), dtype=F64)
    prim = (g(3), g(3), g(3), 0.1 * g(3), g(3).abs(), 0.3 * g(3, 3),
            torch.tensor(0.3, dtype=F64))
    tans = (g(3), g(3), g(3), g(3), g(3), g(3, 3), torch.tensor(0.7, dtype=F64))
    return prim, tans


@pytest.mark.parametrize("keep", [
    (0, 1, 2, 3, 4, 5, 6),      # every argument
    (0, 1, 2, 3, 6),            # the fields and dt: one tangent launch
    (4, 5),                     # the moments alone
    (6,),                       # dt alone
    (3,),                       # V alone (f* and the +V term)
], ids=["all", "no-mu", "mu", "dt", "V"])
def test_bdim_rule_func_jvp(keep):
    """The two K14 launches of `_BdimTangent` against the derivative of
    `bdim_plain`: ghosts, the V counted in f* and in the +V term, and a
    tangent of dt."""
    prim, tans = bdim_inputs(len(keep))
    tans = tuple(t if k in keep else torch.zeros_like(t) for k, t in enumerate(tans))
    got = torch.func.jvp(st._BdimRule.apply, prim, tans)
    want = torch.func.jvp(st.bdim_plain, prim, tans)
    close(got[0], want[0])
    close(got[1], want[1])


def test_bdim_rule_jacfwd():
    """`torch.func.jacfwd` through K14's rule, a batch of two directions in
    every argument (the moments' launch and dt's tangent included), against
    `torch.func.jvp` along each."""
    prim, tans = bdim_inputs(5)
    _, tans2 = bdim_inputs(6)

    def f(p):
        return st._BdimRule.apply(*(a + p[0] * t + p[1] * t2
                                    for a, t, t2 in zip(prim, tans, tans2)))

    p0 = torch.zeros(2, dtype=F64)
    jac = torch.func.jacfwd(f)(p0)
    for k in range(2):
        e = torch.zeros(2, dtype=F64)
        e[k] = 1.0
        close(jac[..., k], torch.func.jvp(f, (p0,), (e,))[1])


def test_rules_skip_the_launches_of_absent_tangents(monkeypatch):
    """An input without a tangent reaches a rule as None, not as zeros: K14's
    moment launch and the tangent solve's Ȧ·x are skipped when the moments
    and the coefficients carry none (the derivative in ν of a static
    body's run)."""
    calls = {"k14": 0, "dAx": 0}
    k14, mult = st._k14, mg._mult_raw

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(st, "_k14", count("k14", k14))
    monkeypatch.setattr(mg, "_mult_raw", count("dAx", mult))
    prim, tans = bdim_inputs(3)
    torch.func.jvp(lambda u, f: st._BdimRule.apply(u, prim[1], f, *prim[3:]),
                   (prim[0], prim[2]), (tans[0], tans[2]))
    assert calls["k14"] == 2                  # the primal and one tangent launch
    L, z = _operator(torch.tensor(0.4, dtype=F64)), _z()
    levels, masks = mg.make_mg(L)
    torch.func.jvp(lambda zz: mg.solve_mg_implicit(levels, masks, torch.zeros_like(zz),
                                                   zz).x, (z,), (z,))
    assert calls["dAx"] == 0


def test_bdim_rule_forward_ad():
    prim, tans = bdim_inputs(9)
    with fwAD.dual_level():
        duals = [fwAD.make_dual(p, t) for p, t in zip(prim, tans)]
        got = fwAD.unpack_dual(st._BdimRule.apply(*duals)).tangent
    close(got, torch.func.jvp(st.bdim_plain, prim, tans)[1])


# ---------------------------------------------------------------- implicit solve
def _operator(theta):
    """A 3-D level from face coefficients that move with ``theta``."""
    shape = (10, 10, 10)
    rng = np.random.default_rng(4)
    L0 = torch.as_tensor(0.5 + rng.random((3,) + shape), dtype=F64)
    L1 = torch.as_tensor(rng.standard_normal((3,) + shape), dtype=F64)
    return bc_vector(L0 + 0.2 * torch.sin(theta) * L1, (0.0, 0.0, 0.0))


def _dense_solve(L, z):
    """The canonical-gauge (zero-mean) solution of A x = z by a dense
    pseudo-inverse: the exact solution whose derivative the rule gives."""
    lev = ps.dense_pinv(ps.make_level(L))
    zi = interior(z)
    x = (lev.Ainv @ zi.reshape(-1)).reshape(zi.shape)
    return torch.nn.functional.pad(x - x.mean(), (1, 1) * 3)


def _z():
    """A zero-mean right-hand side on the 8³ interior."""
    zi = np.random.default_rng(6).standard_normal((8, 8, 8))
    return torch.nn.functional.pad(torch.as_tensor(zi - zi.mean()), (1, 1) * 3)


@pytest.mark.parametrize("with_z", [False, True], ids=["operator", "operator+rhs"])
def test_implicit_rule_exact(with_z):
    """d/dθ of the converged MG solve equals d/dθ of the dense solve: the
    tangent solve carries Ȧ·x (and ż), not the lagged loop tangent."""
    z0 = _z()
    zt = torch.roll(z0, 1, 0) if with_z else torch.zeros_like(z0)

    def mg_solve(th):
        L = _operator(th)
        levels, masks = mg.make_mg(L)
        z = z0 + th * zt
        return mg.solve_mg_implicit(levels, masks, torch.zeros_like(z), z,
                                    tol=1e-11, itmx=200).x

    def dense(th):
        return _dense_solve(_operator(th), z0 + th * zt)

    th, one = torch.tensor(0.4, dtype=F64), torch.tensor(1.0, dtype=F64)
    with mg.iteration_log() as log:
        got = torch.func.jvp(mg_solve, (th,), (one,))
    want = torch.func.jvp(dense, (th,), (one,))
    assert len(log) == 2 and log[0] > 1 and log[1] > 1     # primal, tangent
    close(interior(got[0]), interior(want[0]), 1e-8)
    close(interior(got[1]), interior(want[1]), 1e-8)


def test_implicit_rule_jacfwd_and_forward_ad():
    """`torch.func.jacfwd` (vmapped tangent solves) and `forward_ad` duals
    give `torch.func.jvp`'s derivative."""
    z = _z()

    def f(th):
        levels, masks = mg.make_mg(_operator(th))
        return mg.solve_mg_implicit(levels, masks, torch.zeros_like(z), z,
                                    tol=1e-10, itmx=200).x.sum(dim=(1, 2))

    th, one = torch.tensor(0.4, dtype=F64), torch.tensor(1.0, dtype=F64)
    want = torch.func.jvp(f, (th,), (one,))[1]
    close(torch.func.jacfwd(f)(th), want)
    with fwAD.dual_level():
        got = fwAD.unpack_dual(f(fwAD.make_dual(th, one))).tangent
    close(got, want)


def test_implicit_solve_without_ad_is_solve_mg():
    L = _operator(torch.tensor(0.4, dtype=F64))
    levels, masks = mg.make_mg(L)
    z = _z()
    a = mg.solve_mg_implicit(levels, masks, torch.zeros_like(z), z)
    b = mg.solve_mg(levels, masks, torch.zeros_like(z), z)
    assert torch.equal(a.x, b.x) and torch.equal(a.r, b.r)
    assert a.iters == b.iters and a.stats == b.stats


# ---------------------------------------------------------------- tangent gate
def test_no_tangent_gate():
    x = torch.ones(4, dtype=F64)
    assert not st.ad_active()
    st._no_tangent("k", x)                    # nothing active: never raises

    def wrapped(a):
        assert st.ad_active()
        st._no_tangent("k", x)                # a tensor outside the transform
        with pytest.raises(RuntimeError, match=r"k: .*tangent.*\[ad\]"):
            st._no_tangent("k", a)
        return a

    torch.func.jvp(wrapped, (x,), (x,))
    with fwAD.dual_level():
        assert st.ad_active()
        st._no_tangent("k", x)
        with pytest.raises(RuntimeError, match=r"\[ad\]"):
            st._no_tangent("k", fwAD.make_dual(x, x))

    class Inner(torch.autograd.Function):
        """A rule's forward sees plain tensors: the gate lets them through."""
        @staticmethod
        def forward(a):
            st._no_tangent("k", a)
            return a * 2

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def jvp(ctx, da):
            return da * 2

    assert torch.equal(torch.func.jvp(Inner.apply, (x,), (x,))[1], 2 * x)
    with fwAD.dual_level():
        out = Inner.apply(fwAD.make_dual(x, x))
        assert torch.equal(fwAD.unpack_dual(out).tangent, 2 * x)
    assert not st.ad_active()


# ---------------------------------------------------------------- float dt: same bits
def _sphere(dtype):
    ctr = torch.tensor([6.0, 8.0, 8.0], dtype=dtype)
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - 3.0)
    flow = fl.Flow((16, 16, 16), (1.0, 0.1, 0.0), nu=0.02, dtype=dtype, device="cpu")
    V, mu0, mu1, _ = measure_fill(body, flow.cfg.shape, 0.0, 1.0, dtype, device="cpu")
    return flow, dataclasses.replace(flow.state, V=V, mu0=mu0, mu1=mu1)


def _old_solve(levels, masks, x, z, tol, itmx, perdir):
    return mg.solve_mg(levels, masks, x, z, tol=tol, itmx=itmx, perdir=perdir)


def _old_cfl(u, nu):
    s = torch.zeros(u.shape[1:], dtype=u.dtype)
    for i in range(u.shape[0]):
        s = s + torch.clamp(shift(u[i], i, 1), min=0.0) + torch.clamp(-u[i], min=0.0)
    return torch.clamp(1.0 / (torch.max(interior(s)) + 5 * nu), max=10.0)


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_float_dt_step_same_bits(dtype):
    """Three steps of `mom_step_impl` with host-float dt (the default
    implicit solve, `torch.minimum`/`maximum` CFL) equal the same steps
    with the plain `solve_mg` injected and the clamp CFL bit for bit, and
    a 0-d tensor dt gives the same bits again."""
    flow, s_new = _sphere(dtype)
    s_old, s_ten = s_new, s_new
    levels, masks = mg.make_mg(s_new.mu0)
    dt = t = 0.25
    for _ in range(3):
        s_new, dn_new, n_new, _ = fl.mom_step_impl(flow.cfg, s_new, levels, masks, dt, t)
        s_old, _, n_old, _ = fl.mom_step_impl(flow.cfg, s_old, levels, masks, dt, t,
                                              solve_fn=_old_solve)
        s_ten, dn_ten, n_ten, _ = fl.mom_step_impl(
            flow.cfg, s_ten, levels, masks, torch.tensor(dt, dtype=dtype),
            torch.tensor(t, dtype=dtype))
        assert n_new == n_old == n_ten
        for a in (s_old, s_ten):
            assert torch.equal(s_new.u, a.u) and torch.equal(s_new.p, a.p)
        assert torch.equal(dn_new, _old_cfl(s_new.u, s_new.nu))
        assert torch.equal(dn_new, dn_ten)
        t, dt = t + dt, float(dn_new)
    assert torch.equal(fz.cfl_max(s_new.u), torch.max(interior(sum(
        torch.clamp(shift(s_new.u[i], i, 1), min=0.0) + torch.clamp(-s_new.u[i], min=0.0)
        for i in range(3)))))
