"""Per-tenant fault-handling policy (the verbs API's "QoS knob").

The seed engine wired ONE global :class:`~repro.core.resolver.Resolver`
into every node, so all tenants of a fabric shared one fault-resolution
strategy.  A :class:`FaultPolicy` is the declarative replacement: it names
a strategy, its lookahead, and the domain's pinnable-memory budget, and is
attached *per protection domain* (or per node, or fabric-wide as the
default) when the fabric is built.  ``Node.resolver_for(pd)`` selects the
right resolver at fault-handling time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.errors import ConfigError
from repro_torch.core.addresses import PAGES_PER_BLOCK
from repro_torch.core.arbiter import ServiceClass
from repro_torch.core.costmodel import CostModel
from repro_torch.core.resolver import Resolver, Strategy, coerce_strategy
from repro_torch.tenancy.slo import SLOClass, coerce_slo


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How one protection domain's page faults are resolved — and how its
    DMA traffic is scheduled while they are being resolved.

    * ``strategy`` — the fault-handling datapath: a thesis resolution
      strategy (Touch-A-Page, Touch-Ahead, ...) or ``NP_RDMA`` (the
      ``repro.npr`` no-pinning backend); see
      :class:`~repro.core.resolver.Strategy`.  A member, its name or its
      value is accepted; anything else raises ``ValueError`` naming the
      valid members.
    * ``lookahead`` — pages paged in per fault event for the
      ``TOUCH_AHEAD_N`` / ``STREAM`` strategies.
    * ``pin_limit_bytes`` — the domain's pinnable-memory budget M (the
      Firehose constraint); ``None`` = unlimited.
    * ``service_class`` — DMA-arbiter class of the domain's blocks:
      ``LATENCY`` (strict priority; serving-style small WRs) or ``BULK``
      (DRR bandwidth share; training/offload streams).  ``None`` means
      unspecified and schedules as BULK.
    * ``arb_weight`` — the domain's deficit-round-robin weight within its
      class ring (relative bandwidth share).
    * ``max_outstanding_blocks`` — per-node cap on the domain's launched,
      not-yet-completed blocks; the posting verbs raise
      :class:`~repro.api.completion.DomainQuotaExceeded` beyond it.
      ``None`` = no quota.
    * ``max_retries`` — retry budget for the R5 retransmission timer:
      a block may be retransmitted at most this many times before its
      transfer completes with
      :attr:`~repro.api.completion.WCStatus.RETRY_EXC_ERR`.  ``None``
      (the default) keeps the seed's unbounded retransmission — the
      thesis' 1 ms timer spins until the fault resolves.
    * ``retry_backoff`` — exponential-backoff multiplier applied to the
      R5 timeout per consecutive retransmission of the same block
      (``timeout_us * retry_backoff**retries``, capped).  ``1.0`` (the
      default) keeps the thesis' flat 1 ms timer bit-exact.
    * ``slo`` — the tenant's service tier
      (:class:`~repro.tenancy.SLOClass`: GOLD / SILVER / BEST_EFFORT, a
      member, name or value).  Setting it derives ``service_class`` and
      ``arb_weight`` when those are left at their defaults (GOLD →
      LATENCY weight 4, SILVER → BULK weight 2, BEST_EFFORT → BULK
      weight 1) and makes GOLD domains' SMMU context banks steal-immune
      under bank overcommit.  Explicit ``service_class``/``arb_weight``
      values always win over the derivation.
    """

    strategy: Strategy = Strategy.TOUCH_AHEAD
    lookahead: int = PAGES_PER_BLOCK
    pin_limit_bytes: Optional[int] = None
    service_class: Optional[ServiceClass] = None
    arb_weight: int = 1
    max_outstanding_blocks: Optional[int] = None
    max_retries: Optional[int] = None
    retry_backoff: float = 1.0
    slo: Optional[SLOClass] = None

    def __post_init__(self) -> None:
        # strict: an unknown strategy spelling used to slip through here
        # and surface later as an opaque error deep in resolver dispatch
        object.__setattr__(self, "strategy", coerce_strategy(self.strategy))
        object.__setattr__(self, "slo", coerce_slo(self.slo))
        if self.max_retries is not None and self.max_retries < 0:
            raise ConfigError(
                f"max_retries must be >= 0 (or None = unbounded), got "
                f"{self.max_retries}")
        if self.retry_backoff < 1.0:
            raise ConfigError(
                f"retry_backoff must be >= 1.0 (1.0 = the thesis' flat "
                f"timer), got {self.retry_backoff}")
        if self.slo is not None:
            # the SLO tier implies arbiter parameters unless the caller
            # pinned them explicitly (defaults: None / 1)
            if self.service_class is None:
                object.__setattr__(self, "service_class",
                                   self.slo.service_class)
            if self.arb_weight == 1:
                object.__setattr__(self, "arb_weight", self.slo.arb_weight)

    def make_resolver(self, cost: CostModel) -> Resolver:
        """Instantiate the resolver this policy describes."""
        return Resolver(strategy=self.strategy, cost=cost,
                        lookahead=self.lookahead)


DEFAULT_POLICY = FaultPolicy()
