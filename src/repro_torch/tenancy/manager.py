"""Per-node tenancy control plane: banks + SRQ + QP mux + admission.

One ``TenancyManager`` per ``Node`` owns every virtualized resource the
tenancy layer multiplexes — the SMMU context-bank binding table
(``BankManager``), the shared receive queue (``SRQ``), the queue-pair
multiplexer (``QPMux``) and the per-node tenant admission counters.  The
manager never touches the event loop, the SMMU model or the cost model:
it *decides* (who is bound where, who is admitted, who is evicted) and
returns the decision; the node/fabric layers *execute* and charge time.
That split keeps the control plane deterministic and unit-testable
without a fabric.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core import addresses as A
from repro_torch.errors import AdmissionError
from repro_torch.tenancy.banks import BankManager, BankStats, Binding
from repro_torch.tenancy.qp import QPMux, SRQ
from repro_torch.tenancy.slo import SLOClass

__all__ = ["TenancyManager"]


class TenancyManager:
    """All per-node multi-tenant resource bookkeeping in one place."""

    def __init__(self,
                 bank_capacity: int = A.NUM_CONTEXT_BANKS,
                 srq_entries: Optional[int] = None,
                 srq_gold_reserve: int = 0,
                 tenants_per_node: Optional[int] = None,
                 phys_qps: int = 16) -> None:
        self.banks = BankManager(capacity=bank_capacity)
        self.srq = SRQ(entries=srq_entries, gold_reserve=srq_gold_reserve)
        self.qp = QPMux(phys_qps=phys_qps)
        self.tenants_per_node = tenants_per_node
        self.tenants = 0
        self.gold_tenants = 0
        self.admission_rejections = 0
        self._slo: Dict[int, Optional[SLOClass]] = {}

    # ------------------------------------------------------------------
    # admission + lifecycle
    # ------------------------------------------------------------------
    def admission_error(self, slo: Optional[SLOClass]) -> Optional[str]:
        """Reason this node cannot take one more tenant, else ``None``.

        GOLD tenants are capped one *below* bank capacity: every GOLD
        bank is steal-immune, so at least one bank must stay stealable
        or a 17th domain could deadlock on an all-immune node.
        """
        if (self.tenants_per_node is not None
                and self.tenants >= self.tenants_per_node):
            return (f"node at tenant capacity "
                    f"({self.tenants}/{self.tenants_per_node})")
        if (slo is SLOClass.GOLD
                and self.gold_tenants >= self.banks.capacity - 1):
            return (f"node at GOLD capacity ({self.gold_tenants}/"
                    f"{self.banks.capacity - 1}: one bank must stay "
                    f"stealable)")
        return None

    def register(self, pd: int, slo: Optional[SLOClass] = None) -> None:
        reason = self.admission_error(slo)
        if reason is not None:
            self.admission_rejections += 1
            raise AdmissionError(reason)
        self.banks.register(pd, steal_immune=bool(slo and slo.steal_immune))
        self.qp.attach(pd)
        self._slo[pd] = slo
        self.tenants += 1
        if slo is SLOClass.GOLD:
            self.gold_tenants += 1

    def release(self, pd: int) -> Optional[int]:
        """Drop every per-tenant resource; returns the bank held, if any."""
        if pd not in self._slo:
            return None
        slo = self._slo.pop(pd)
        self.qp.detach(pd)
        self.tenants -= 1
        if slo is SLOClass.GOLD:
            self.gold_tenants -= 1
        return self.banks.release(pd)

    def slo_of(self, pd: int) -> Optional[SLOClass]:
        return self._slo.get(pd)

    def is_gold(self, pd: int) -> bool:
        return self._slo.get(pd) is SLOClass.GOLD

    # ------------------------------------------------------------------
    # bank binding passthroughs (node executes the SMMU side)
    # ------------------------------------------------------------------
    def bind_bank(self, pd: int, fault_active) -> Binding:
        return self.banks.bind(pd, fault_active=fault_active)

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    @property
    def bank_stats(self) -> BankStats:
        return self.banks.stats

    def as_dict(self) -> Dict[str, object]:
        """Deterministic snapshot for soak stats / protocol_stats."""
        return {
            "tenants": self.tenants,
            "gold_tenants": self.gold_tenants,
            "admission_rejections": self.admission_rejections,
            "banks_bound": self.banks.bound_count(),
            "banks": self.banks.stats.as_dict(),
            "srq": dict(self.srq.stats.as_dict(), held=self.srq.held),
            "qp": self.qp.as_dict(),
        }
