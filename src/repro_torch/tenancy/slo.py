"""Per-tenant SLO classes for the tenancy control plane.

The thesis models per-domain QoS only implicitly (one protection domain
per SMMU context bank, §1.3.1.4); the multi-tenant reproduction already
splits DMA service into ``ServiceClass.LATENCY``/``BULK``.  The SLO
class is the *tenant-facing* knob that maps a business-level tier onto
the three datapath levers at once:

=============  ==============  ==========  ====================
SLO class      ServiceClass    arb weight  bank-steal immunity
=============  ==============  ==========  ====================
GOLD           LATENCY         4           yes (bank is sticky)
SILVER         BULK            2           no
BEST_EFFORT    BULK            1           no
=============  ==============  ==========  ====================

GOLD tenants keep their SMMU context bank once bound: the BankManager's
LRU steal skips them, so a GOLD tenant never pays the
shootdown-and-rebind penalty on its own faults (it may still queue
behind another tenant's shootdown on the shared driver CPU).
"""

from __future__ import annotations

import enum

from repro_torch.errors import ConfigError
from repro_torch.core.arbiter import ServiceClass

__all__ = ["SLOClass", "coerce_slo"]


class SLOClass(enum.Enum):
    """Tenant service tier; maps onto arbiter class/weight + bank policy."""

    GOLD = "gold"
    SILVER = "silver"
    BEST_EFFORT = "best_effort"

    @property
    def service_class(self) -> ServiceClass:
        return (ServiceClass.LATENCY if self is SLOClass.GOLD
                else ServiceClass.BULK)

    @property
    def arb_weight(self) -> int:
        return {SLOClass.GOLD: 4, SLOClass.SILVER: 2,
                SLOClass.BEST_EFFORT: 1}[self]

    @property
    def steal_immune(self) -> bool:
        """GOLD domains' context banks are never LRU-stolen."""
        return self is SLOClass.GOLD


def coerce_slo(value) -> "SLOClass | None":
    """Accept an ``SLOClass``, its name/value string, or ``None``."""
    if value is None or isinstance(value, SLOClass):
        return value
    if isinstance(value, str):
        key = value.strip().lower()
        for slo in SLOClass:
            if key in (slo.value, slo.name.lower()):
                return slo
    raise ConfigError(
        f"not an SLO class: {value!r} (expected one of "
        f"{', '.join(s.name for s in SLOClass)})")
