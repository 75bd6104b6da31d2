"""Particle pathlines.

PyTorch counterpart of `waterlily_tpu/utils/pathlines.py` (the reference's
Pathlines extension, `ext/WaterLilyPathlinesExt.jl:19-58`): a swarm of
passive tracers advected through the flow on the simulation's device
(batched staggered interpolation, `utils.interp.interp_vector`), respawned
from a `torch.Generator` when they leave the domain or age out, and drawn
on the host as fading, speed-coloured segments.  Matplotlib is imported
only by the functions that draw.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .interp import interp_vector

__all__ = ["Particles", "update_particles", "pathlines_gif"]


@dataclasses.dataclass
class Particles:
    """Tracer swarm (`Pathlines.Particles`): positions ``(N, D)`` in grid
    units of the interior frame, ages ``(N,)`` in steps, the generator that
    respawns them, and their lifetime in steps."""
    pos: torch.Tensor
    age: torch.Tensor
    generator: torch.Generator
    life: int = 255

    @classmethod
    def init(cls, n: int, shape, *, life: int = 255, seed: int = 0,
             dtype=torch.float32, device="cuda"):
        """``n`` particles spread uniformly over the interior of a padded
        ``shape`` grid, with uniform ages in ``[0, life)``."""
        gen = torch.Generator(device=device).manual_seed(seed)
        hi = torch.tensor([s - 2 for s in shape], dtype=dtype, device=device)
        pos = torch.rand((n, len(shape)), generator=gen, dtype=dtype,
                         device=device) * hi
        age = torch.randint(0, life, (n,), generator=gen, device=device)
        return cls(pos=pos, age=age, generator=gen, life=life)


def _advect(p: Particles, u: torch.Tensor, dt, hi: torch.Tensor):
    """RK2 midpoint advection, then respawn of the particles that left
    ``[0, hi]`` or reached their lifetime (`Particles.update!`)."""
    v1 = interp_vector(p.pos + 1.0, u)        # interior -> padded frame
    v2 = interp_vector(p.pos + 0.5 * dt * v1 + 1.0, u)
    new = p.pos + dt * v2
    age = p.age + 1
    out = torch.any((new < 0) | (new > hi), dim=1) | (age >= p.life)
    fresh = torch.rand(p.pos.shape, generator=p.generator, dtype=p.pos.dtype,
                       device=p.pos.device) * hi
    new = torch.where(out[:, None], fresh, new)
    age = torch.where(out, 0, age)
    return new, age, v2


def update_particles(p: Particles, sim, dt: Optional[float] = None):
    """Advance the swarm one step through ``sim``'s velocity; returns
    ``(particles, old positions, velocities)`` for drawing.  ``dt`` defaults
    to the last step's."""
    u = sim.flow.state.u
    if dt is None:
        dt = sim.flow.dt[-2] if len(sim.flow.dt) > 1 else sim.flow.dt[-1]
    hi = torch.tensor([s - 2 for s in sim.flow.cfg.shape], dtype=u.dtype,
                      device=u.device)
    new, age, v = _advect(p, u, dt, hi)
    return dataclasses.replace(p, pos=new, age=age), p.pos, v


class _SegmentTrail:
    """Host-side fading segment buffer (the `PathlineCanvas`): recent
    segments with exponentially decaying alpha."""

    def __init__(self, fadetau: float = 0.2, alpha_min: float = 0.02):
        self.segs: list[np.ndarray] = []     # (M, 2, 2) per frame
        self.speed: list[np.ndarray] = []
        self.alpha: list[float] = []
        self.fadetau = fadetau
        self.alpha_min = alpha_min

    def fade(self, dt_scaled: float):
        decay = float(np.exp(-dt_scaled / self.fadetau))
        self.alpha = [a * decay for a in self.alpha]
        keep = [i for i, a in enumerate(self.alpha) if a > self.alpha_min]
        self.segs = [self.segs[i] for i in keep]
        self.speed = [self.speed[i] for i in keep]
        self.alpha = [self.alpha[i] for i in keep]

    def draw(self, p0: np.ndarray, p1: np.ndarray, speed: np.ndarray):
        ok = np.linalg.norm(p1 - p0, axis=1) < 5.0    # drop respawn jumps
        self.segs.append(np.stack([p0[ok], p1[ok]], axis=1))
        self.speed.append(speed[ok])
        self.alpha.append(1.0)

    def render(self, ax, colormap="plasma", colorrange=(0, 3)):
        import matplotlib
        from matplotlib.collections import LineCollection
        from matplotlib.colors import Normalize

        norm = Normalize(*colorrange)
        cmap = matplotlib.colormaps[colormap]
        for segs, spd, a in zip(self.segs, self.speed, self.alpha):
            colors = cmap(norm(spd))
            colors[:, 3] = a
            ax.add_collection(LineCollection(segs, colors=colors, lw=0.8))


def pathlines_gif(sim, *, n: int = 10_000, duration: float = 1.0,
                  step: float = 0.05, life: int = 255, fadetau: float = 0.2,
                  colormap: str = "plasma", colorrange=(0.0, 3.0),
                  bgcolor: str = "black", remeasure: bool = False,
                  fname: str = "pathlines.gif", fps: int = 20, seed: int = 0):
    """Step a 2-D simulation and write a fading-pathline animation (the
    `viz!` Pathlines mode, `WaterLilyPathlinesExt.jl:19-58`)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.animation import PillowWriter

    cfg = sim.flow.cfg
    if cfg.D != 2:
        raise ValueError("pathlines_gif draws 2D simulations")
    nx, ny = (s - 2 for s in cfg.shape)
    p = Particles.init(n, cfg.shape, life=life, seed=seed, dtype=cfg.dtype,
                       device=sim.device)
    trail = _SegmentTrail(fadetau=fadetau)
    fig, ax = plt.subplots(figsize=(6, 6 * ny / nx), dpi=110)
    writer = PillowWriter(fps=fps)
    t0 = sim.sim_time
    frames = np.arange(t0 + step, t0 + duration + 1e-9, step)
    with writer.saving(fig, fname, dpi=110):
        for t in frames:
            sim.sim_step(float(t), remeasure=remeasure)
            p, old, v = update_particles(p, sim)
            trail.fade(sim.flow.dt[-2] * sim.U / sim.L)
            trail.draw(old.cpu().numpy(), p.pos.cpu().numpy(),
                       torch.linalg.norm(v, dim=1).cpu().numpy() / sim.U)
            ax.clear()
            ax.set_facecolor(bgcolor)
            ax.set_xlim(0, nx)
            ax.set_ylim(0, ny)
            ax.set_xticks([])
            ax.set_yticks([])
            ax.set_aspect("equal")
            trail.render(ax, colormap, colorrange)
            writer.grab_frame()
    plt.close(fig)
    return fname
