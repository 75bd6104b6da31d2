"""The kernel binding of the port on the CPU, no card and no `nvcc`:

(a) every ``extern "C"`` entry of `csrc/*.cu` has its ctypes declaration in
    `ops/_build.py` with the same number of arguments and a pointer,
    ``int64_t``, ``int`` or ``float`` in the same places (a drifted
    signature would otherwise pass a 32-bit pointer on the card);
(b) the one-pass validation of the wrappers (`stencil3d._fits`, the message
    from `stencil3d._invalid`) refuses exactly what the per-check
    validation of the wrappers refused before it, with the same exception
    type and message (the earlier `_check` and `_lead` are kept here as the
    reference);
(c) the cached C rules (routes, norm-partial counts) and the colour and
    direction arrays are keyed on every argument the C rule reads: the
    shape, the number of colours, ``mp`` and the periodic directions."""
import ctypes
import re
from pathlib import Path

import pytest
import torch

from waterlily_tpu_torch.ops import _build
from waterlily_tpu_torch.ops import fused3d as fz
from waterlily_tpu_torch.ops import stencil3d as st

CSRC = Path(_build.__file__).resolve().parents[1] / "csrc"
_FN = re.compile(r"^(int|int64_t|const char\*)\s+(wlt_\w+)\(([^)]*)\)\s*\{", re.M)


def c_entries() -> dict[str, tuple[str, list[str]]]:
    """name -> (return kind, argument kinds) of each ``extern "C"`` entry."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        start = text.index('extern "C" {')
        block = text[start:text.index('}  // extern "C"', start)]
        for ret, name, params in _FN.findall(block):
            kinds = []
            for p in params.split(","):
                ctype = re.sub(r"\w+$", "", p.strip())      # drop the name
                kinds.append("pointer" if "*" in ctype else ctype.strip())
            out[name] = ({"int": "int", "int64_t": "int64_t",
                          "const char*": "string"}[ret], kinds)
    return out


def ctypes_kind(t) -> str:
    if t is ctypes.c_void_p or (isinstance(t, type) and issubclass(t, ctypes._Pointer)):
        return "pointer"
    if t is ctypes.c_char_p:
        return "string"
    return {ctypes.c_int64: "int64_t", ctypes.c_int: "int",
            ctypes.c_float: "float"}[t]


ENTRIES = c_entries()


def test_every_entry_is_declared():
    assert set(ENTRIES) == set(_build._SIGNATURES)
    assert len(ENTRIES) >= 20


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_argtypes_match_the_source(name):
    ret, kinds = ENTRIES[name]
    restype, argtypes = _build._SIGNATURES[name]
    assert ctypes_kind(restype) == ret
    assert [ctypes_kind(t) for t in argtypes] == kinds


# ---------------------------------------------------------------- (b)
def old_check(name, shape, device, dtype=torch.float32, /, **tensors):
    """The per-argument check of the wrappers before the one-pass form."""
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if tuple(t.shape[-3:]) != shape or t.dim() < 3:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected trailing {shape}")


def old_lead(name, arg, t, lead):
    if tuple(t.shape[:-3]) != lead:
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected leading {lead}")


SHAPE = (6, 6, 6)
BF = torch.bfloat16


def tensors(kind):
    """The arguments of one wrapper family, valid, by name."""
    g = torch.Generator().manual_seed(0)

    def f(*lead, dtype=torch.float32):
        return torch.rand(lead + SHAPE, generator=g).to(dtype)
    if kind in ("gs_incr", "gs_incr_mp", "incr_gs"):
        cdt = BF if kind == "gs_incr_mp" else torch.float32
        d = dict(x=f(), r=f(), L=f(3, dtype=cdt), D=f(dtype=cdt), iD=f(dtype=cdt))
        return d | (dict(eps=f()) if kind == "incr_gs" else {})
    if kind == "bdim":
        return dict(u=f(3), u0=f(3), f=f(3), V=f(3), mu0=f(3), mu1=f(3, 3))
    return dict(u=f(3), x=f(), L=f(3))            # projbc


def old_way(kind, a):
    """What the wrappers of ``kind`` did before: their `_check`s, then their
    `_lead`s, in their order."""
    if kind in ("gs_incr", "gs_incr_mp", "incr_gs"):
        name = {"gs_incr": "gs_incr_k", "gs_incr_mp": "gs_incr_mp_k",
                "incr_gs": "incr_gs_k"}[kind]
        cdt = BF if kind == "gs_incr_mp" else torch.float32
        x = a["x"]
        f32 = dict(x=x, r=a["r"]) | ({"eps": a["eps"]} if "eps" in a else {})
        old_check(name, tuple(x.shape), x.device, **f32)
        old_check(name, tuple(x.shape), x.device, cdt, L=a["L"], D=a["D"], iD=a["iD"])
        for arg in (*f32, "D", "iD"):
            old_lead(name, arg, a[arg], ())
        old_lead(name, "L", a["L"], (3,))
    elif kind == "bdim":
        u = a["u"]
        old_check("bdim_k", tuple(u.shape[1:]), u.device, **a)
        for arg in ("u", "u0", "f", "V", "mu0"):
            old_lead("bdim_k", arg, a[arg], (3,))
        old_lead("bdim_k", "mu1", a["mu1"], (3, 3))
    else:
        u = a["u"]
        old_check("projbc_k", tuple(u.shape[1:]), u.device, **a)
        old_lead("projbc_k", "u", u, (3,))
        old_lead("projbc_k", "x", a["x"], ())
        old_lead("projbc_k", "L", a["L"], (3,))


def new_way(kind, a):
    if kind in ("gs_incr", "gs_incr_mp", "incr_gs"):
        name = {"gs_incr": "gs_incr_k", "gs_incr_mp": "gs_incr_mp_k",
                "incr_gs": "incr_gs_k"}[kind]
        st._smoother_args(name, BF if kind == "gs_incr_mp" else torch.float32,
                          a["x"], a["r"], a["L"], a["D"], a["iD"], a.get("eps"))
    elif kind == "bdim":
        st._bdim_args("bdim_k", *a.values())
    else:
        fz._field_args("projbc_k", a["u"], x=a["x"], L=a["L"])


def spoil(t, defect):
    if defect == "device":
        return t.to("meta")
    if defect == "dtype":
        return t.double()
    if defect == "noncontiguous":
        return t.transpose(-1, -2)
    if defect == "trailing":
        return t[..., :-1].contiguous()
    if defect == "leading":
        return t[None].contiguous() if t.dim() == 3 else t[:2].contiguous()
    return t


def outcome(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e), str(e)
    return None


CASES = [(kind, arg, defect)
         for kind in ("gs_incr", "gs_incr_mp", "incr_gs", "bdim", "projbc")
         for arg in tensors(kind)
         for defect in ("device", "dtype", "noncontiguous", "trailing", "leading")]


@pytest.mark.parametrize("kind", ["gs_incr", "gs_incr_mp", "incr_gs", "bdim", "projbc"])
def test_validation_passes_what_it_passed(kind):
    a = tensors(kind)
    assert outcome(lambda: old_way(kind, a)) is None
    assert outcome(lambda: new_way(kind, a)) is None


@pytest.mark.parametrize("kind,arg,defect", CASES,
                         ids=[f"{k}-{a}-{d}" for k, a, d in CASES])
def test_validation_refuses_as_before(kind, arg, defect):
    a = tensors(kind)
    a[arg] = spoil(a[arg], defect)
    want = outcome(lambda: old_way(kind, a))
    assert want is not None
    assert outcome(lambda: new_way(kind, a)) == want


def test_fits_refuses_each_condition():
    x = torch.zeros(SHAPE)
    assert st._fits(x.device, torch.float32, SHAPE, x, x.clone())
    # dtype, device, contiguity (a transposed cube keeps its shape), shape
    for bad in (x.double(), x.to("meta"), x.transpose(0, 2), torch.zeros((3,) + SHAPE)):
        assert not st._fits(x.device, torch.float32, SHAPE, x, bad)


# ---------------------------------------------------------------- (c)
class FakeLib:
    """Stands in for the kernel library: each rule returns a value unique to
    its arguments and records the call."""

    def __init__(self):
        self.calls = []

    def _rule(self, entry):
        def fn(*args):
            self.calls.append((entry, args))
            return len(self.calls)
        return fn

    def __getattr__(self, name):
        if name.startswith("wlt_"):
            return self._rule(name)
        raise AttributeError(name)


@pytest.fixture
def fake(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(st, "_RULES", {})
    return lib


# (entry, arguments as the wrappers pass them): shape, colours, mp or the
# periodic mask, and the route for the partials
RULES = [("wlt_gs_incr_route", (18, 18, 18, 4, 0)),
         ("wlt_incr_gs_route", (18, 18, 18, 4, 1)),
         ("wlt_gauss_sweeps_route", (18, 18, 18, 2, 0b101)),
         ("wlt_incr_gs_partials", (18, 18, 18, 4, 0, 1))]


@pytest.mark.parametrize("entry,args", RULES, ids=[e for e, _ in RULES])
def test_rule_cache_keys_on_every_argument(fake, entry, args):
    first = st._rule(entry, *args)
    assert st._rule(entry, *args) == first and len(fake.calls) == 1
    # a change of any one argument is asked anew and gets its own value
    for k in range(len(args)):
        other = args[:k] + (args[k] + 1,) + args[k + 1:]
        v = st._rule(entry, *other)
        assert fake.calls[-1] == (entry, other) and v == len(fake.calls)
        assert st._rule(entry, *other) == v
    assert len(fake.calls) == 1 + len(args)
    assert st._rule(entry, *args) == first


def test_rule_cache_keeps_no_error(monkeypatch):
    class Failing:
        def __init__(self):
            self.n = 0

        def wlt_incr_gs_partials(self, *args):
            self.n += 1
            return -1
    lib = Failing()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(st, "_RULES", {})
    assert st._rule("wlt_incr_gs_partials", 18, 18, 18, 4, 0, 1) == -1
    assert st._rule("wlt_incr_gs_partials", 18, 18, 18, 4, 0, 1) == -1
    assert lib.n == 2


def test_colour_and_direction_arrays(monkeypatch):
    monkeypatch.setattr(st, "_COLOURS", {})
    monkeypatch.setattr(st, "_PERDIRS", {})
    arr, n = st._colours("gs_incr_k", [0, 1, 0, 1])
    assert list(arr) == [0, 1, 0, 1] and n == 4
    assert st._colours("gs_incr_k", (0, 1, 0, 1))[0] is arr
    assert list(st._colours("gs_incr_k", [1, 0, 1, 0])[0]) == [1, 0, 1, 0]
    assert st._colours("gs_incr_k", [])[1] == 0
    with pytest.raises(ValueError, match=r"gs_incr_k: colours must be 0 or 1, got \[0, 2\]"):
        st._colours("gs_incr_k", [0, 2])
    mask, parr, npd = st._perdir("gauss_sweeps_k", (2, 0))
    assert (mask, list(parr)[:npd], npd) == (0b101, [2, 0], 2)
    assert st._perdir("gauss_sweeps_k", (0, 2))[0] == 0b101
    assert list(st._perdir("gauss_sweeps_k", (0, 2))[1]) == [0, 2]
    assert st._perdir("conv_diff_k", ())[::2] == (0, 0)
    for bad in ((3,), (1, 1)):
        with pytest.raises(ValueError, match="perdir must hold distinct directions 0-2"):
            st._perdir("conv_diff_k", bad)
    # lists of other than ints are made each time, never kept
    st._colours("gs_incr_k", [torch.tensor(1)])
    assert all(type(c) is int for key in st._COLOURS for c in key)
