"""Multi-device domain decomposition (`DistSimulation` on a shard mesh)."""
from . import dist  # noqa: F401
from .dist import (DistSimulation, Mesh, from_blocked, make_mesh,  # noqa: F401
                   to_blocked)
