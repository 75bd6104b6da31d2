"""The copy probes of `ops/probe.py` on the CPU: the plain version against
the probe kernels of the JAX benchmarks (`benchmarks/leanprobe.py:96-127`,
`benchmarks/bwprobe.py:108-130`, whose bodies are repeated here, in Pallas
interpret mode), exactly: one float32 multiply by 1.0000001 has one result.
`tools/bandwidth_probe.py` itself runs only on a card and says so here."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from waterlily_tpu.ops import flat as fo
from waterlily_tpu.ops import pallas_flat as plf
from waterlily_tpu_torch.ops import probe
from waterlily_tpu_torch.ops import stencil3d as st

SHAPE = (12, 10, 7)
GEOM = fo.geom_of(SHAPE)
TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / "bandwidth_probe.py"


def field(seed):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def test_scale_is_one_ulp_above_one():
    assert np.float32(probe.SCALE) == np.float32(1.0) + np.float32(2.0 ** -23)


@pytest.mark.parametrize("bx", [4, 8])
def test_copy_plain_vs_windowed_pallas_copy(monkeypatch, bx):
    monkeypatch.setattr(plf, "_INTERPRET", True)
    a = field(0)

    def body(win, aux, scalars, ox, cos, bx_):
        return [win[0][pl.ds(cos[0], bx_)] * 1.0000001]

    call = plf._halo_call(body, GEOM.Nx, GEOM.S, n_scalar=0, halos=[0], n_aux=0,
                          n_out=1, bx=bx, pipeline=True, cover_all=True)
    want = fo.from_flat(call([], [fo.to_flat(jnp.asarray(a), GEOM)], [])[0], GEOM)
    got = probe.copy_scale_plain([torch.as_tensor(a)])[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_copy_plain_vs_blockspec_pallas_copy():
    a = jnp.asarray(np.random.default_rng(1).standard_normal((8, 8, 128)),
                    jnp.float32)

    def bker(a_ref, o_ref):
        o_ref[:] = a_ref[:] * 1.0000001

    want = pl.pallas_call(
        bker, grid=(2,), in_specs=[pl.BlockSpec((4, 8, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((4, 8, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 8, 128), jnp.float32), interpret=True)(a)
    got = probe.copy_scale_plain([torch.as_tensor(np.array(a))])[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_copy6_plain_vs_pallas_and_cpu_wrapper(monkeypatch):
    monkeypatch.setattr(plf, "_INTERPRET", True)
    fields = [field(k) for k in range(6)]

    def body6(win, aux, scalars, ox, cos, bx_):
        return [win[k][pl.ds(cos[k], bx_)] * 1.0000001 for k in range(6)]

    call6 = plf._halo_call(body6, GEOM.Nx, GEOM.S, n_scalar=0, halos=[0] * 6,
                           n_aux=0, n_out=6, bx=8, pipeline=True, cover_all=True)
    want = call6([], [fo.to_flat(jnp.asarray(a), GEOM) for a in fields], [])
    before = st.launch_counts()
    # on the CPU the wrapper is the plain version and counts no launch
    got = probe.copy_scale_k([torch.as_tensor(a) for a in fields])
    assert st.launch_counts() == before
    assert before["copy_scale_k"] == before["copy_scale6_k"] == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(fo.from_flat(w, GEOM)))


def test_bandwidth_probe_needs_a_card(capsys):
    spec = importlib.util.spec_from_file_location("bandwidth_probe", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main([]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA device"):
        tool.run(8)
