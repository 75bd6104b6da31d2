"""Visualization helpers (matplotlib).

PyTorch counterpart of `waterlily_tpu/utils/viz.py` (the reference's
plotting extensions `flood`/`addbody`/`body_plot!`/`sim_gif!`/`plot_logger`,
`ext/WaterLilyPlotsExt.jl:1-104`, and the 2-D/3-D `viz!` viewer,
`ext/WaterLilyMakieExt.jl:153-297`): frames are rendered straight to PNG or
GIF files (2-D filled contours, 3-D mid-plane slices).

Every function takes tensors on any device or numpy arrays and draws host
numpy arrays: a device field is copied to the host once per frame.
Matplotlib is imported inside the functions, so the package imports and
runs without it.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["flood", "addbody", "body_plot", "sim_gif", "plot_logger", "viz",
           "get_body", "default_field"]


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _np(a) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _interior2d(a) -> np.ndarray:
    return _np(a)[1:-1, 1:-1]


def flood(f, *, shift=(0.0, 0.0), cfill: str = "RdBu_r", clims=None,
          levels: int = 10, kv: Optional[dict] = None, ax=None,
          filled: bool = True):
    """Filled contour of a 2D scalar field with ghosts stripped (`flood`,
    `ext/WaterLilyPlotsExt.jl:14-34`).  ``clims`` symmetrizes by default like
    the reference (±max|f|)."""
    plt = _plt()
    f = _interior2d(f)
    if clims is None:
        m = float(np.max(np.abs(f))) or 1.0
        clims = (-m, m)
    else:
        f = np.clip(f, clims[0], clims[1])
    nx, ny = f.shape
    x = np.arange(nx) + 0.5 + shift[0]
    y = np.arange(ny) + 0.5 + shift[1]
    if ax is None:
        _, ax = plt.subplots()
    fn = ax.contourf if filled else ax.contour
    cs = fn(x, y, f.T, levels=np.linspace(clims[0], clims[1], levels + 1),
            cmap=cfill, extend="both", **(kv or {}))
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])
    for spine in ax.spines.values():
        spine.set_visible(False)
    return ax, cs


def addbody(x, y, *, ax, c: str = "black"):
    """Fill a polygon outline onto the current plot (`addbody`,
    `ext/WaterLilyPlotsExt.jl:36`)."""
    ax.fill(_np(x), _np(y), c)
    return ax


def body_plot(sim, *, levels=(0.0,), lines=True, c: str = "black", ax=None):
    """Draw the body sdf zero contour (`body_plot!`,
    `ext/WaterLilyPlotsExt.jl:38-43`)."""
    plt = _plt()
    sigma = _interior2d(sim.sdf_field())
    nx, ny = sigma.shape
    x = np.arange(nx) + 0.5
    y = np.arange(ny) + 0.5
    if ax is None:
        _, ax = plt.subplots()
    if lines:
        ax.contour(x, y, sigma.T, levels=list(levels), colors=c)
    else:
        ax.contourf(x, y, sigma.T, levels=[-1e30, levels[0]], colors=c)
    ax.set_aspect("equal")
    return ax


def default_field(sim):
    """Vorticity normalized by U/L, the default frame field of `viz` and
    `sim_gif`, on the host."""
    from .metrics import vorticity

    return _np(vorticity(sim.flow.state.u)) * sim.L / sim.U


def _default_plot_body(sim, t, ax, plotbody, kv):
    om = default_field(sim)
    if om.ndim == 3:
        om = om[:, :, om.shape[2] // 2]
    ax.clear()
    flood(om, clims=kv.pop("clims", (-5, 5)), ax=ax, **kv)
    if plotbody:
        body_plot(sim, ax=ax)
    ax.set_title(f"tU/L = {t:.2f}")


def sim_gif(sim, *, duration: float = 1.0, step: float = 0.1, t0=None,
            verbose: bool = False, remeasure: bool = False,
            plotbody: bool = False, udf=None, fname: str = "flow.gif",
            fps: int = 10, plotter: Optional[Callable] = None, **kv):
    """Step the simulation and write an animated GIF (`sim_gif!`,
    `ext/WaterLilyPlotsExt.jl:45-53`).  The default frame is the vorticity
    flood of the reference; pass ``plotter(sim, t, ax)`` to customize."""
    plt = _plt()
    from matplotlib.animation import PillowWriter

    t0 = sim.sim_time if t0 is None else t0
    frames = np.arange(t0, t0 + duration + 1e-9, step)
    fig, ax = plt.subplots(figsize=(6, 4), dpi=100)
    writer = PillowWriter(fps=fps)
    with writer.saving(fig, fname, dpi=100):
        for t in frames:
            sim.sim_step(float(t), remeasure=remeasure, verbose=verbose,
                         udf=udf)
            if plotter is not None:
                plotter(sim, t, ax)
            else:
                _default_plot_body(sim, t, ax, plotbody, dict(kv))
            writer.grab_frame()
    plt.close(fig)
    return fname


def plot_logger(fname: str = "WaterLily.log", out: Optional[str] = None):
    """Plot the pressure-solver convergence log (`plot_logger`,
    `ext/WaterLilyPlotsExt.jl:55-104`): per-projection residual traces
    (first/middle/last highlighted) and the iteration-count histogram."""
    plt = _plt()
    from .log import parse_log

    counts, rinf, r1 = parse_log(fname)
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    nsolves = len(rinf)
    picks = sorted({0, nsolves // 2, nsolves - 1}) if nsolves else []
    for ax, series, name in ((axes[0], rinf, r"$r_\infty$"),
                             (axes[1], r1, r"$r_1$")):
        for k, tr in enumerate(series):
            tr = np.maximum(np.asarray(tr), 1e-16)
            if k in picks:
                ax.semilogy(tr, lw=2, label=f"solve {k}")
            else:
                ax.semilogy(tr, color="0.8", lw=0.5, zorder=0)
        ax.set_xlabel("iteration")
        ax.set_ylabel(name)
        if picks:
            ax.legend(fontsize=8)
    if counts:
        axes[2].hist(counts, bins=np.arange(max(counts) + 2) - 0.5)
    axes[2].set_xlabel("iterations per solve")
    axes[2].set_ylabel("count")
    fig.tight_layout()
    out = out or fname.replace(".log", "_residuals.png")
    fig.savefig(out)
    plt.close(fig)
    return out


def get_body(sim, t: Optional[float] = None):
    """Body geometry for plotting (`get_body`,
    `ext/WaterLilyMeshingExt.jl:13-17`): 3D → `(verts, faces)` triangle mesh
    of the sdf zero isosurface (marching tetrahedra, `utils.mesh`); 2D → the
    interior sdf grid for `body_plot`-style contouring."""
    s = _np(sim.sdf_field(t))
    if s.ndim == 3:
        from .mesh import body_mesh

        return body_mesh(sim, t)
    return s[1:-1, 1:-1]


def _frame_field(sim, d: Callable, cut: Optional[int]):
    f = _np(d(sim))
    if f.ndim == 3:
        k = f.shape[2] // 2 if cut is None else cut
        f = f[:, :, k]
    return f


def viz(sim, d: Optional[Callable] = None, *, t_end: Optional[float] = None,
        step: float = 0.1, cut: Optional[int] = None, clims=None,
        cmap: str = "RdBu_r", fname: str = "viz.gif", fps: int = 10,
        remeasure: bool = False, plotbody: bool = True, udf=None):
    """Unified 2D/3D field viewer (`viz!`, `ext/WaterLilyMakieExt.jl:153-284`).

    ``d(sim) -> field`` extracts the plotted scalar (default: vorticity
    magnitude normalized by U/L).  3D fields are shown as the mid-``z``
    (or ``cut``) plane — the headless analog of the reference's volume/slice
    view.  With ``t_end`` the simulation is stepped and a GIF written;
    without, a single PNG of the current state."""
    plt = _plt()

    if d is None:
        d = default_field

    if t_end is None:
        fig, ax = plt.subplots(figsize=(6, 4), dpi=100)
        f = _frame_field(sim, d, cut)
        flood(f, clims=clims, cfill=cmap, ax=ax)
        if plotbody and sim.flow.cfg.D == 2:
            body_plot(sim, ax=ax)
        out = fname if fname.endswith(".png") else fname.rsplit(".", 1)[0] + ".png"
        fig.savefig(out)
        plt.close(fig)
        return out

    def plotter(sim, t, ax):
        ax.clear()
        f = _frame_field(sim, d, cut)
        flood(f, clims=clims, cfill=cmap, ax=ax)
        if plotbody and sim.flow.cfg.D == 2:
            body_plot(sim, ax=ax)
        ax.set_title(f"tU/L = {t:.2f}")

    return sim_gif(sim, duration=t_end - sim.sim_time, step=step,
                   remeasure=remeasure, udf=udf, fname=fname, fps=fps,
                   plotter=plotter)
