"""Seeded multi-tenant traffic generation over a verbs fabric.

A :class:`TenantSpec` declares one protection domain's workload (service
class, arrival process, sizes, buffer preparation — i.e. whether its
destinations fault) and a :class:`FaultInjection` declares the background
churn (khugepaged collapses, reclaim/swap-out) the thesis identifies as
the reason even touched buffers keep faulting.  :class:`TenantRun` drives
one tenant entirely in virtual time: posts, CQ drains and retries are
event-loop callbacks, so a run is a pure function of ``(specs, seed)``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from repro_torch.api.completion import WorkQueueFull
from repro_torch.api.fabric import Fabric, NodeDown
from repro_torch.api.memory import BufferPrep
from repro_torch.api.policy import FaultPolicy
from repro_torch.core import addresses as A
from repro_torch.core.arbiter import ServiceClass
from repro_torch.core.resolver import Strategy
from repro_torch.tenancy import BankManager
from repro_torch.tenancy.slo import SLOClass

SRC_BASE = 0x10_0000_0000
DST_BASE = 0x20_0000_0000
TENANT_STRIDE = 0x1_0000_0000       # 4 GB of VA per tenant
REQUEST_STRIDE = 1 << 20            # 1 MB per request region

#: VA window slots per base: the architecture carries 39-bit virtual
#: addresses (``A.VA_BITS``), so only this many 4 GB tenant windows fit
#: above ``DST_BASE`` — tenants beyond the last slot wrap around and
#: reuse lower windows.  Aliasing across *protection domains* is safe
#: (each pd has its own page table and frames), and pds below the wrap
#: point keep their historical addresses byte-for-byte.  Without the
#: wrap, a faulting tenant with ``pd >= 224`` (va >= 1 TB) overflows
#: the fault FIFO's 28-bit IOVA field (Table 3.1): the driver then
#: resolves a *truncated* VPN forever while the real page stays
#: non-resident — a NACK/RAPF livelock the 1024-node soak tier caught.
VA_SLOTS = ((1 << A.VA_BITS) - DST_BASE) // TENANT_STRIDE       # 96


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's workload over the fabric."""

    pd: int
    name: str = ""
    service_class: Optional[ServiceClass] = None
    strategy: Strategy = Strategy.TOUCH_AHEAD
    arb_weight: int = 1
    max_outstanding_blocks: Optional[int] = None
    # tenant service tier (GOLD / SILVER / BEST_EFFORT): derives the
    # arbiter class/weight and GOLD bank-steal immunity (repro_torch.tenancy)
    slo: Optional[SLOClass] = None
    # arrival process
    mode: str = "closed"            # "closed" (fixed in-flight) | "open"
    inflight: int = 2               # closed-loop concurrency
    arrival_period_us: float = 100.0   # open-loop inter-arrival (uniform
    #                                    jitter of +-50% applied per post)
    n_requests: int = 16
    size_choices: tuple = (4096, 16384, 65536)
    # buffer preparation: FAULTING destinations take the thesis' fault
    # path on every cold page; fresh_dst=True makes EVERY request cold
    src_prep: BufferPrep = BufferPrep.TOUCHED
    dst_prep: BufferPrep = BufferPrep.FAULTING
    fresh_dst: bool = True
    src_node: int = 0
    dst_node: int = 1
    # open the domain only on these nodes (None = every node).  Scoping is
    # what lets a 64-node scale soak run 64+ tenants: SMMU context banks
    # (pd % 16) need only be unique per *node*, not fabric-wide.
    open_on: Optional[tuple] = None
    # cycle requests through this many memory-region slots instead of a
    # region per request (None = per-request regions).  Bounds page-table
    # and frame footprint on million-block soaks; after the first lap
    # every slot is warm, so reused regions stop faulting.
    region_slots: Optional[int] = None

    def label(self) -> str:
        return self.name or f"pd{self.pd}"


@dataclasses.dataclass(frozen=True)
class FaultInjection:
    """Seeded background churn applied while traffic runs.

    * ``khugepaged_period_us`` — every period, one khugepaged pass over a
      random registered region (transiently invalidates its resident,
      unpinned PTEs — §3.1.2.3);
    * ``reclaim_period_us`` — every period, swap out up to
      ``reclaim_pages`` LRU pages of a random domain (major faults on
      next access).

    A period of 0 disables that churn source.

    Crash-fault schedules (machine-failure model) are *deterministic*
    by construction — fixed virtual timestamps rather than sampled
    ones, so a chaos soak is still a pure function of ``(specs, seed)``:

    * ``crashes`` — ``(t_us, node_idx)`` pairs: at ``t_us`` the node
      fail-stops (:meth:`Fabric.crash_node`).  In-flight work toward it
      completes with error statuses, never silently disappears;
    * ``link_flaps`` — ``(t_down_us, t_up_us, u, v)`` tuples: the
      ``u<->v`` link fails at ``t_down_us`` and heals at ``t_up_us``
      (``<= 0`` = stays down), re-pathing routed traffic both ways.
    """

    khugepaged_period_us: float = 0.0
    reclaim_period_us: float = 0.0
    reclaim_pages: int = 8
    # crash-fault schedules: ((t_us, node_idx), ...) and
    # ((t_down_us, t_up_us, u, v), ...)
    crashes: tuple = ()
    link_flaps: tuple = ()


class TenantRun:
    """Drives one TenantSpec through a fabric, all in virtual time."""

    def __init__(self, fabric: Fabric, spec: TenantSpec,
                 rng: random.Random, poll_period_us: float = 200.0,
                 cq_depth: int = 256):
        self.fabric = fabric
        self.spec = spec
        self.rng = rng
        self.poll_period_us = poll_period_us
        self.domain = fabric.open_domain(
            spec.pd,
            policy=FaultPolicy(
                strategy=spec.strategy,
                service_class=spec.service_class,
                arb_weight=spec.arb_weight,
                max_outstanding_blocks=spec.max_outstanding_blocks,
                slo=spec.slo),
            nodes=(list(spec.open_on) if spec.open_on is not None else None))
        self.cq = fabric.create_cq(depth=cq_depth)
        self._mrs: dict[int, tuple] = {}      # request idx -> (src, dst)
        self.regions: list[tuple[int, int, int, int]] = []  # node, pd, vpn, n
        self.posted_ids: list[int] = []
        self.completions: list = []
        self.latencies: list[float] = []
        self.rejected = 0                     # quota/CQ backpressure events
        self.aborted = False                  # posting node crashed mid-run
        self.next_req = 0
        self._pump_scheduled = False

    # ----------------------------------------------------------- lifecycle
    @property
    def done(self) -> bool:
        # a crashed posting node can never reach n_requests; the run is
        # over once everything already posted has drained (with error
        # completions — nothing may hang or leak)
        if self.aborted:
            return self.in_flight == 0
        return len(self.completions) >= self.spec.n_requests

    @property
    def in_flight(self) -> int:
        return len(self.posted_ids) - len(self.completions)

    def start(self) -> None:
        spec = self.spec
        if spec.mode == "closed":
            for _ in range(min(spec.inflight, spec.n_requests)):
                self._try_post()        # rejects retried by the pump
        elif spec.mode == "open":
            t = 0.0
            for _ in range(spec.n_requests):
                jitter = self.rng.uniform(0.5, 1.5)
                t += spec.arrival_period_us * jitter
                self.fabric.loop.schedule(t, self._try_post, True)
        else:
            raise ValueError(f"unknown arrival mode {spec.mode!r}")
        self._schedule_pump()

    # -------------------------------------------------------------- posting
    def _regions_for(self, i: int):
        spec = self.spec
        # with region_slots set, request i reuses slot i % region_slots —
        # the MR pair (and its residency) persists across laps
        key = i if spec.region_slots is None else i % spec.region_slots
        if key in self._mrs:
            return self._mrs[key]
        size = self.rng.choice(spec.size_choices)
        window = (spec.pd % VA_SLOTS) * TENANT_STRIDE
        src_va = SRC_BASE + window + key * REQUEST_STRIDE
        # fresh_dst: a brand-new (cold, faulting) landing region per
        # request; otherwise all requests share one warm region
        slot = key if spec.fresh_dst else 0
        dst_va = DST_BASE + window + slot * REQUEST_STRIDE
        src = self.domain.register_memory(spec.src_node, src_va, size,
                                          prep=spec.src_prep)
        dst = (self._mrs[0][1] if not spec.fresh_dst and self._mrs
               else self.domain.register_memory(spec.dst_node, dst_va,
                                                size, prep=spec.dst_prep))
        self._mrs[key] = (src, dst)
        self.regions.append((spec.src_node, spec.pd, src_va >> 12,
                             A.num_pages(src_va, size)))
        self.regions.append((spec.dst_node, spec.pd, dst_va >> 12,
                             A.num_pages(dst_va, size)))
        return self._mrs[key]

    def _try_post(self, reschedule_on_reject: bool = False) -> None:
        if self.aborted or self.next_req >= self.spec.n_requests:
            return
        i = self.next_req
        src, dst = self._regions_for(i)
        try:
            wr = self.domain.post_write(
                src, dst, cq=self.cq,
                nbytes=min(src.length, dst.length))
        except NodeDown:
            # our posting node fail-stopped: a dead machine posts no new
            # work.  Already-posted WRs still drain (as errors) — the
            # pump keeps polling until in_flight hits zero.
            self.aborted = True
            return
        except WorkQueueFull:
            # quota / CQ backpressure; open-loop arrivals retry
            # themselves, closed-loop posts are retried by the pump
            self.rejected += 1
            if reschedule_on_reject:
                self.fabric.loop.schedule(self.poll_period_us,
                                          self._try_post, True)
            return
        self.next_req += 1
        self.posted_ids.append(wr.wr_id)

    # -------------------------------------------------------------- pumping
    def _schedule_pump(self) -> None:
        if self._pump_scheduled or self.done:
            return
        self._pump_scheduled = True
        self.fabric.loop.schedule(self.poll_period_us, self._pump)

    def _pump(self) -> None:
        self._pump_scheduled = False
        for wc in self.cq.poll(max_entries=self.cq.depth):
            self.completions.append(wc)
            self.latencies.append(wc.latency_us)
        if self.spec.mode == "closed":
            while (not self.done
                   and self.next_req < self.spec.n_requests
                   and self.in_flight < self.spec.inflight):
                before = self.next_req
                self._try_post()
                if self.next_req == before:     # backpressured: retry later
                    break
        self._schedule_pump()

    # ------------------------------------------------------------ reporting
    def stats_dict(self) -> dict:
        """Deterministic, JSON-able per-tenant summary."""
        lat = sorted(self.latencies)

        def pct(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        agg = {"timeouts": 0, "rapf_retransmits": 0, "retransmissions": 0,
               "src_faults": 0, "dst_faults": 0,
               # NP-RDMA backend (zero for thesis-datapath tenants)
               "mtt_hits": 0, "mtt_misses": 0, "mtt_stale": 0,
               "npr_aborts": 0, "pool_redirect_pages": 0}
        for wc in self.completions:
            for k in agg:
                agg[k] += getattr(wc.stats, k)
        return {
            "tenant": self.spec.label(),
            "pd": self.spec.pd,
            "service_class": (self.spec.service_class.value
                              if self.spec.service_class else "bulk"),
            "posted": len(self.posted_ids),
            "completed": len(self.completions),
            # crash-fault layer: completions that carry an error status
            # (still exactly one completion per posted WR) and whether
            # our posting node fail-stopped mid-run
            "errors": sum(1 for wc in self.completions if not wc.ok),
            "aborted": self.aborted,
            "rejected": self.rejected,
            "latency_mean_us": (round(sum(lat) / len(lat), 6)
                                if lat else 0.0),
            "latency_p50_us": round(pct(0.50), 6),
            "latency_p99_us": round(pct(0.99), 6),
            "latency_max_us": round(lat[-1], 6) if lat else 0.0,
            **agg,
        }


def scale_mix(n_nodes: int,
              total_blocks: int = 1_000_000,
              hot_node: int = 0,
              hot_blocks: int = 2 * A.TR_ID_SPACE + 4096,
              request_bytes: int = 256 * 1024,
              fault_requests: int = 256,
              inflight: int = 4) -> list[TenantSpec]:
    """The scale-soak tenant layout: ``n_nodes`` tenants driving
    ``total_blocks`` 16 KB blocks through the fabric, with ``hot_node``
    concentrated enough to wrap its 14-bit tr_ID space at least twice.

    * one *ring* tenant per node ``k`` (pd ``k``, nodes ``{k, k+1}``):
      closed-loop clean writes over ``region_slots`` reused regions —
      the bulk of the block count, spread across every link;
    * a *hot* clean tenant on ``hot_node`` sized to ``hot_blocks``
      launches (>= 2 wraps plus the ring share), and a *hot faulting*
      tenant (fresh cold destinations, ``fault_requests`` requests) so
      NACK/RAPF/FIFO recovery is exercised before, across and after the
      wrap boundary.

    Bank assignment is delegated to :class:`repro_torch.tenancy.BankManager` —
    the same allocator the SMMU driver uses under overcommit — instead
    of the old hand-rolled ``pd % 16`` juggling.  The layout is
    validated to admit an *eager* (steal-free) binding on every node, so
    the tier's timing baseline stays free of shootdown penalties.
    """
    if n_nodes < 2:
        raise ValueError(f"scale_mix needs >= 2 nodes, got {n_nodes}")
    blocks_per_request = request_bytes // A.BLOCK_SIZE
    specs: list[TenantSpec] = []
    # hot tenants: node hot_node -> hot_node + 8 (several routed hops on
    # a torus).  Ring tenants own pds 0..n_nodes-1; the hot pair simply
    # takes the next two — the BankManager finds them free banks, no
    # modular arithmetic needed.
    hot_pd = n_nodes
    hot_fault_pd = n_nodes + 1
    hot_dst = (hot_node + 8) % n_nodes
    if hot_dst == hot_node:                   # small fabrics: no loopback
        hot_dst = (hot_node + 1) % n_nodes
    fault_blocks = fault_requests * (65536 // A.BLOCK_SIZE)
    hot_clean_requests = max(1, (hot_blocks - fault_blocks)
                             // blocks_per_request)
    specs.append(TenantSpec(
        pd=hot_pd, name="hot-wrap", mode="closed", inflight=inflight,
        n_requests=hot_clean_requests, size_choices=(request_bytes,),
        src_prep=BufferPrep.TOUCHED, dst_prep=BufferPrep.TOUCHED,
        fresh_dst=False, region_slots=4,
        src_node=hot_node, dst_node=hot_dst,
        open_on=(hot_node, hot_dst)))
    specs.append(TenantSpec(
        pd=hot_fault_pd, name="hot-fault", mode="closed", inflight=2,
        n_requests=fault_requests, size_choices=(65536,),
        src_prep=BufferPrep.TOUCHED, dst_prep=BufferPrep.FAULTING,
        fresh_dst=True,
        src_node=hot_node, dst_node=hot_dst,
        open_on=(hot_node, hot_dst)))
    # ring tenants carry the remaining block budget evenly (rounded UP:
    # the tier's contract is ">= total_blocks", never a few short)
    ring_blocks = max(0, total_blocks - hot_blocks)
    ring_requests = -(-ring_blocks // (n_nodes * blocks_per_request))
    for k in range(n_nodes):
        if ring_requests <= 0:
            break
        specs.append(TenantSpec(
            pd=k, name=f"ring{k}", mode="closed", inflight=inflight,
            n_requests=ring_requests, size_choices=(request_bytes,),
            src_prep=BufferPrep.TOUCHED, dst_prep=BufferPrep.TOUCHED,
            fresh_dst=False, region_slots=4,
            src_node=k, dst_node=(k + 1) % n_nodes,
            open_on=(k, (k + 1) % n_nodes)))
    # prove the layout admits an eager, steal-free binding: run every
    # node's tenant set through a scratch BankManager (the allocator the
    # SMMU driver itself uses) — register() rejects duplicate pds and
    # try_bind() returns None once a node's 16 banks are exhausted
    managers: dict[int, BankManager] = {}
    for s in specs:
        for node in dict.fromkeys(s.open_on):
            mgr = managers.setdefault(node, BankManager())
            mgr.register(s.pd)
            if mgr.try_bind(s.pd) is None:
                raise ValueError(
                    f"scale_mix overcommits node {node}: pd {s.pd} is "
                    f"tenant #{mgr.bound_count() + 1} but the SMMU has "
                    f"only {mgr.capacity} context banks — the tier's "
                    f"steal-free baseline would not hold")
    return specs


def schedule_injection(fabric: Fabric, runs: list[TenantRun],
                       inj: FaultInjection, rng: random.Random) -> None:
    """Install the churn schedule as self-rescheduling loop events."""

    def all_done() -> bool:
        return all(r.done for r in runs)

    def regions():
        out = []
        for r in runs:
            out.extend(r.regions)
        return out

    def khugepaged_tick() -> None:
        if all_done():
            return
        regs = regions()
        if regs:
            node_idx, pd, vpn, n = rng.choice(regs)
            pt = fabric.nodes[node_idx].page_tables.get(pd)
            if pt is not None:
                pt.khugepaged_collapse(vpn + rng.randrange(max(1, n)))
        fabric.loop.schedule(inj.khugepaged_period_us, khugepaged_tick)

    def reclaim_tick() -> None:
        if all_done():
            return
        regs = regions()
        if regs:
            node_idx, pd, _, _ = rng.choice(regs)
            pt = fabric.nodes[node_idx].page_tables.get(pd)
            if pt is not None:
                pt.reclaim(inj.reclaim_pages)
        fabric.loop.schedule(inj.reclaim_period_us, reclaim_tick)

    if inj.khugepaged_period_us > 0:
        fabric.loop.schedule(inj.khugepaged_period_us, khugepaged_tick)
    if inj.reclaim_period_us > 0:
        fabric.loop.schedule(inj.reclaim_period_us, reclaim_tick)

    # crash-fault schedules: fixed timestamps, so the chaos run stays a
    # pure function of (specs, seed) — the rng never touches these
    for t_us, node_idx in inj.crashes:
        fabric.loop.schedule(t_us, fabric.crash_node, node_idx)
    for t_down, t_up, u, v in inj.link_flaps:
        fabric.loop.schedule(t_down, fabric.fail_link, u, v)
        if t_up > 0:
            fabric.loop.schedule(t_up, fabric.restore_link, u, v)
