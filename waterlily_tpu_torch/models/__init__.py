from . import autobody, body, flow, flowflat  # noqa: F401
from .autobody import AutoBody
from .body import Body, NoBody, measure_fill, measure_sdf
from .flow import Flow, FlowCfg, FlowState, cds, quick, vanleer
