from . import autobody, body, flow, flowflat, rigidmap  # noqa: F401
from .autobody import AutoBody, curvature
from .body import Body, NoBody, SetBody, measure_fill, measure_sdf
from .flow import Flow, FlowCfg, FlowState, cds, quick, vanleer
from .rigidmap import RigidMap, rotation, setmap
