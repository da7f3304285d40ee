"""Per-tenant fault policy vocabulary (``FaultPolicy``, ``Strategy``).

The verbs fabric of the reference's ``api`` package is not ported yet.
"""

from repro_torch.api.policy import DEFAULT_POLICY, FaultPolicy
from repro_torch.core.arbiter import ServiceClass
from repro_torch.core.resolver import Strategy

__all__ = ["DEFAULT_POLICY", "FaultPolicy", "ServiceClass", "Strategy"]
