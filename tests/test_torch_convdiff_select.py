"""The identities the tiled conv–diff kernels (`csrc/convdiff_tile.cuh`) rest
on, checked on the CPU with the port's plain schemes:

1. selecting the scheme's *arguments* by the upwind direction and evaluating
   the scheme once gives, bit for bit, what evaluating both branches and
   selecting the *result* gives;
2. the RHS built from one array of lower-face fluxes per (component,
   direction) — the boundary slabs chosen by an integer compare on the face
   index, the periodic first-slab flux reused at the top ghost face — and
   differenced with a shift equals `conv_diff_plain` (1e-6 of max: the same
   operations, a different association of the select);
3. ``x / 6`` as a product with the rounded reciprocal and one residual
   correction (the kernels' ``div6``) is the correctly rounded quotient;
4. identity 1 on duals (K12's tangent kernel selects the dual arguments
   and evaluates the dual scheme once): the forward derivative of the
   scheme at the selected arguments along the selected tangents is, bit for
   bit, the selected derivative of the two branches.

Inputs are random with ties and zeros mixed in, float32 and float64.
"""
import numpy as np
import pytest
import torch

from waterlily_tpu_torch.ops import stencil3d as st
from waterlily_tpu_torch.ops.grid import shift

DTYPES = [torch.float32, torch.float64]
MASKS = [(), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2)]


def ties_and_zeros(rng, shape, dtype):
    """Random values of which a third are small integers (ties between the
    arguments, exact zeros)."""
    a = rng.standard_normal(shape)
    pick = rng.random(shape) < 1 / 3
    a[pick] = rng.integers(-2, 3, size=shape)[pick]
    return torch.as_tensor(a, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("scheme", st.SCHEMES, ids=lambda s: s.__name__)
def test_scheme_of_selected_arguments_is_the_selected_scheme(scheme, dtype):
    rng = np.random.default_rng(0)
    fm2, fm1, fc, fp1, uadv = (ties_and_zeros(rng, (200_000,), dtype)
                               for _ in range(5))
    up = uadv > 0
    want = torch.where(up, scheme(fm2, fm1, fc), scheme(fp1, fc, fm1))
    got = scheme(torch.where(up, fm2, fp1), torch.where(up, fm1, fc),
                 torch.where(up, fc, fm1))
    assert up.any() and (~up).any() and (uadv == 0).any()
    assert torch.equal(got, want)
    # the top slab's rule: upwind unless the flow comes from above
    up_hi = ~(uadv < 0)
    want = torch.where(uadv < 0, 0.5 * (fc + fm1), scheme(fm2, fm1, fc))
    got = scheme(torch.where(up_hi, fm2, fp1), torch.where(up_hi, fm1, fc),
                 torch.where(up_hi, fc, fm1))
    got = torch.where(uadv < 0, 0.5 * (fc + fm1), got)
    assert torch.equal(got, want)


def at_index(f, j, idx):
    """The slab of ``f`` at index ``idx`` of direction ``j``, broadcast over
    that direction."""
    return f.narrow(j, idx, 1).expand_as(f)


def lower_face_flux(u, nu, scheme, i, j, perdir):
    """Φ_ij at every cell the way the kernels evaluate it: one formula with
    selected arguments; in a walled direction the central value at face
    index 1 (inflow from the wall) and n−1 (inflow from above); in a periodic
    one the second-upwind value of face 1 from the partner n−3, and face n−1
    a copy of face 1."""
    f, n = u[i], u.shape[1 + j]
    idx_shape = [1] * f.dim()
    idx_shape[j] = n
    pj = torch.arange(n).reshape(idx_shape)
    uadv = 0.5 * (u[j] + shift(u[j], i, -1))
    fm2, fm1, fp1 = shift(f, j, -2), shift(f, j, -1), shift(f, j, 1)
    per = j in perdir
    if per:
        fm2 = torch.where(pj == 1, at_index(f, j, n - 3), fm2)
    hi = (pj == n - 1) & (not per)
    lo = (pj == 1) & (not per)
    up = torch.where(hi, ~(uadv < 0), uadv > 0)
    v = scheme(torch.where(up, fm2, fp1), torch.where(up, fm1, f),
               torch.where(up, f, fm1))
    v = torch.where((lo & (uadv > 0)) | (hi & (uadv < 0)), 0.5 * (f + fm1), v)
    phi = uadv * v - nu * (f - fm1)
    if per:
        phi = torch.where(pj == n - 1, at_index(phi, j, 1), phi)
    return phi


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("perdir", MASKS, ids=lambda m: "".join(map(str, m)) or "walls")
@pytest.mark.parametrize("scheme", st.SCHEMES, ids=lambda s: s.__name__)
def test_rhs_from_one_flux_per_face_equals_conv_diff_plain(scheme, perdir, dtype):
    rng = np.random.default_rng(1)
    u = ties_and_zeros(rng, (3, 9, 8, 7), dtype)
    nu = 0.03
    r = []
    for i in range(3):
        ri = torch.zeros_like(u[i])
        for j in range(3):
            phi = lower_face_flux(u, nu, scheme, i, j, perdir)
            ri = ri + (phi - shift(phi, j, 1))
        r.append(ri)
    got, want = torch.stack(r), st.conv_diff_plain(u, nu, scheme, perdir)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_div6_is_the_correctly_rounded_quotient():
    """The float32 sequence q = x·r, q + (x − 6q)·r with r = fl(1/6), carried
    out in float64 where each product is exact, against float32 division."""
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.standard_normal(400_000) * 10.0 ** rng.integers(-6, 7, 400_000),
        np.arange(-3000, 3001) / 2.0]).astype(np.float32)
    r = np.float32(1.0) / np.float32(6.0)
    q = (x.astype(np.float64) * np.float64(r)).astype(np.float32)
    e = (x.astype(np.float64) - 6.0 * q.astype(np.float64)).astype(np.float32)
    assert np.array_equal(e.astype(np.float64),
                          x.astype(np.float64) - 6.0 * q.astype(np.float64))
    got = (q.astype(np.float64) + e.astype(np.float64) * np.float64(r)).astype(np.float32)
    assert np.array_equal(got, x / np.float32(6.0))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("scheme", st.SCHEMES, ids=lambda s: s.__name__)
def test_dual_scheme_of_selected_arguments_is_the_selected_dual_scheme(scheme, dtype):
    rng = np.random.default_rng(3)
    n = 100_000
    fm2, fm1, fc, fp1, uadv = (ties_and_zeros(rng, (n,), dtype) for _ in range(5))
    tm2, tm1, tc, tp1 = (torch.as_tensor(rng.standard_normal(n), dtype=dtype)
                         for _ in range(4))

    def dual(u, ut, c, ct, d, dt):
        return torch.func.jvp(scheme, (u, c, d), (ut, ct, dt))

    up_v, up_t = dual(fm2, tm2, fm1, tm1, fc, tc)
    dn_v, dn_t = dual(fp1, tp1, fc, tc, fm1, tm1)
    # the generic rule (upwind where uadv > 0) and the top slab's (upwind
    # unless the flow comes from above)
    for up in (uadv > 0, ~(uadv < 0)):
        def w(a, b):
            return torch.where(up, a, b)
        got_v, got_t = dual(w(fm2, fp1), w(tm2, tp1), w(fm1, fc), w(tm1, tc),
                            w(fc, fm1), w(tc, tm1))
        assert torch.equal(got_v, w(up_v, dn_v))
        assert torch.equal(got_t, w(up_t, dn_t))
    # ties reach the min/max of every scheme but cds
    assert (fm1 == fc).any() and (fm2 == fm1).any()
