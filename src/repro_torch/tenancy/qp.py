"""Shared receive queue (SRQ) + queue-pair multiplexing bookkeeping.

Real multi-tenant RDMA NICs do not give every tenant a private receive
queue: RDMAbox-style designs pool receive entries into a bounded shared
receive queue (SRQ) and multiplex many *virtual* queue pairs onto a few
*physical* ones.  The reproduction models both as admission-control
bookkeeping in front of the existing ``DMAArbiter`` quotas:

* ``SRQ`` — a bounded pool of per-node receive entries.  Every posted
  block consumes one entry on the destination node for the life of the
  transfer; when the pool is dry the posting verb raises
  ``TenantQuotaExceeded`` (typed backpressure, not silent queueing).  A
  ``gold_reserve`` slice is usable only by GOLD tenants so best-effort
  floods cannot starve the latency tier's receive path.
* ``QPMux`` — maps virtual per-domain queue pairs onto a bounded set of
  physical QP contexts (hash by pd).  Pure telemetry today: it proves
  the 10k-tenant soak runs with 16 physical QPs per node, and gives the
  invariants a place to check that multiplexing never loses a tenant.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.errors import ConfigError

__all__ = ["SRQ", "SRQStats", "QPMux"]


@dataclass
class SRQStats:
    admitted: int = 0        #: receive entries granted
    rejected: int = 0        #: acquire attempts bounced (backpressure)
    released: int = 0        #: entries returned on completion
    peak_held: int = 0       #: high-water mark of concurrently-held entries

    def as_dict(self) -> Dict[str, int]:
        return {"admitted": self.admitted, "rejected": self.rejected,
                "released": self.released, "peak_held": self.peak_held}


class SRQ:
    """Bounded shared receive-entry pool; ``entries=None`` = unbounded."""

    def __init__(self, entries: Optional[int] = None,
                 gold_reserve: int = 0) -> None:
        if entries is not None and gold_reserve > entries:
            raise ConfigError("gold_reserve exceeds SRQ entries")
        self.entries = entries
        self.gold_reserve = gold_reserve
        self.held = 0
        self.stats = SRQStats()

    def limit_for(self, gold: bool) -> Optional[int]:
        if self.entries is None:
            return None
        return self.entries if gold else self.entries - self.gold_reserve

    def try_acquire(self, n: int, gold: bool = False) -> bool:
        limit = self.limit_for(gold)
        if limit is not None and self.held + n > limit:
            self.stats.rejected += 1
            return False
        self.held += n
        self.stats.admitted += n
        self.stats.peak_held = max(self.stats.peak_held, self.held)
        return True

    def release(self, n: int) -> None:
        assert self.held >= n, "SRQ release underflow"
        self.held -= n
        self.stats.released += n


class QPMux:
    """Virtual-QP -> physical-QP multiplexer (deterministic hash by pd)."""

    def __init__(self, phys_qps: int = 16) -> None:
        self.phys_qps = int(phys_qps)
        self._virtual: Dict[int, int] = {}          # pd -> physical qp
        self._share: Dict[int, int] = {}            # physical qp -> count

    def attach(self, pd: int) -> int:
        if pd in self._virtual:
            return self._virtual[pd]
        qp = pd % self.phys_qps
        self._virtual[pd] = qp
        self._share[qp] = self._share.get(qp, 0) + 1
        return qp

    def detach(self, pd: int) -> None:
        qp = self._virtual.pop(pd, None)
        if qp is not None:
            self._share[qp] -= 1
            if not self._share[qp]:
                del self._share[qp]

    def qp_of(self, pd: int) -> Optional[int]:
        return self._virtual.get(pd)

    @property
    def virtual_qps(self) -> int:
        return len(self._virtual)

    @property
    def max_share(self) -> int:
        return max(self._share.values(), default=0)

    def as_dict(self) -> Dict[str, int]:
        return {"phys_qps": self.phys_qps, "virtual_qps": self.virtual_qps,
                "max_share": self.max_share}
