"""The fabric builder and protection-domain verbs.

``Fabric.build(FabricConfig(...))`` replaces the 9-kwarg ``RDMAEngine``
constructor: it instantiates the event loop, the nodes (A53s + SMMU +
fault FIFO + R5 + PLDMA), and full-duplex links between every pair, then
hands out :class:`ProtectionDomain` handles.  Each domain carries its own
:class:`~repro_torch.api.policy.FaultPolicy`, so two tenants of one fabric can
resolve faults with different strategies — the multi-tenant scenario the
single global resolver of the seed engine could not express.

Data-path verbs live on the domain: ``register_memory`` returns
:class:`~repro_torch.api.memory.MemoryRegion` handles; ``post_write`` /
``post_read`` are asynchronous and deliver completions to a
:class:`~repro_torch.api.completion.CompletionQueue`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from repro_torch.core import addresses as A
from repro_torch.core.arbiter import ArbiterStats, ServiceClass
from repro_torch.core.node import (BankCollision, DomainClosed, DomainExists,
                             FabricError, Node, NodeDown, Transfer, TrIdStats)
from repro_torch.core.pagetable import FrameAllocator
from repro_torch.core.simulator import EventLoop, make_event_loop
from repro_torch.errors import ConfigError
from repro_torch.npr.stats import NPRStats
from repro_torch.net.interconnect import FabricStats, Interconnect
from repro_torch.net.router import NetworkPartitioned
from repro_torch.tenancy import SLOClass, TenancyManager, coerce_slo
from repro_torch.api.completion import (MAX_WAIT_EVENTS, CompletionQueue,
                                  DomainQuotaExceeded, TenantQuotaExceeded,
                                  TrIdExhausted, WCStatus, WorkCompletion,
                                  WorkQueueFull, WorkRequest, WROpcode,
                                  _advance_until)
from repro_torch.api.config import FabricConfig
from repro_torch.api.memory import BufferPrep, MemoryRegion, PrepCost, RegionError
from repro_torch.api.policy import FaultPolicy


@dataclasses.dataclass
class ProtocolStats:
    """One node's protocol telemetry, all datapaths side by side:
    the 14-bit tr_ID lifecycle (:class:`~repro_torch.core.node.TrIdStats`),
    the NP-RDMA backend (:class:`~repro_torch.npr.stats.NPRStats`) and the
    tenancy control plane (:class:`~repro_torch.tenancy.TenancyManager` —
    ``.tenancy.bank_stats`` is the node's
    :class:`~repro_torch.tenancy.BankStats`)."""

    tr_id: TrIdStats
    npr: NPRStats
    tenancy: TenancyManager

    def as_dict(self) -> dict:
        return {"tr_id": self.tr_id.as_dict(), "npr": self.npr.as_dict(),
                "tenancy": self.tenancy.as_dict()}


class ProtectionDomain:
    """One tenant: a PDID spanning its nodes, with its own fault policy."""

    def __init__(self, fabric: "Fabric", pd: int, policy: FaultPolicy,
                 node_policies: Optional[dict] = None,
                 slo: Optional[SLOClass] = None):
        self.fabric = fabric
        self.pd = pd
        self.policy = policy
        # tenant SLO tier (repro_torch.tenancy): GOLD rides the SRQ gold
        # reserve and its context banks are steal-immune
        self.slo = slo
        # default arbiter class of this domain's work requests (None ->
        # the class each node registered for the pd); consulted by the
        # posting verbs, so reassigning it retargets subsequent posts
        self.service_class: Optional[ServiceClass] = policy.service_class
        # node index -> the policy actually governing this domain there
        # (per-node FabricConfig overrides when no domain policy was given)
        self._node_policies = node_policies or {}
        # lifecycle: Fabric.close_domain flips this and every posting
        # verb / registration afterwards raises DomainClosed
        self.closed = False
        # regions handed out, so close_domain can deregister them
        self._regions: list[MemoryRegion] = []

    def policy_for(self, node_idx: int) -> FaultPolicy:
        """The effective fault policy of this domain on ``node_idx``."""
        return self._node_policies.get(node_idx, self.policy)

    @property
    def nodes(self) -> list[int]:
        """Node indices this domain is open on."""
        return sorted(self._node_policies)

    # ------------------------------------------------------------- memory
    def register_memory(self, node_idx: int, va: int, nbytes: int,
                        prep: BufferPrep = BufferPrep.FAULTING,
                        charge: bool = True) -> MemoryRegion:
        """mmap (+ touch/pin per ``prep``) a buffer on ``node_idx``.

        Returns a :class:`MemoryRegion` owning the prep state and the
        user-side cost accounting (``charge=False`` zeroes the accounting
        for warm-up registrations, as in the thesis' methodology).
        """
        fabric = self.fabric
        if self.closed:
            raise DomainClosed(f"domain pd={self.pd} is closed")
        if node_idx not in self._node_policies:
            raise RegionError(
                f"domain pd={self.pd} is not open on node {node_idx} "
                f"(open on {self.nodes}); pass it in open_domain(nodes=...)")
        node = fabric.nodes[node_idx]
        pt = node.pt(self.pd)
        pt.mmap(va, nbytes)
        cost = PrepCost(mmap_us=fabric.cost.mmap_us(nbytes))
        if prep is BufferPrep.TOUCHED:
            for vpn in A.pages_spanned(va, nbytes):
                pt.touch(vpn)
            cost.prep_us = fabric.cost.touch_us(nbytes)
        elif prep is BufferPrep.PINNED:
            pt.pin(va, nbytes)
            cost.prep_us = fabric.cost.pin_us(nbytes)
            cost.release_us = fabric.cost.unpin_us(nbytes)
        if not charge:
            cost = PrepCost()
        fabric._rkey_counter += 1
        mr = MemoryRegion(self, node_idx, va, nbytes, prep, cost,
                          rkey=fabric._rkey_counter)
        self._regions.append(mr)
        return mr

    # -------------------------------------------------------------- verbs
    def post_write(self, src: MemoryRegion, dst: MemoryRegion,
                   cq: CompletionQueue, nbytes: Optional[int] = None,
                   src_offset: int = 0, dst_offset: int = 0,
                   wr_id: Optional[int] = None,
                   service_class: Optional[ServiceClass] = None
                   ) -> WorkRequest:
        """Asynchronous remote write ``src -> dst``; completion on ``cq``.

        ``service_class`` overrides the domain's arbiter class for this
        work request only (e.g. a BULK tenant posting one urgent WR).

        Raises :class:`~repro_torch.core.node.NodeDown` when the *posting*
        (source) node has crashed; posting toward a crashed destination
        is accepted and completes with ``WCStatus.REMOTE_OP_ERR``."""
        if self.closed:
            raise DomainClosed(f"domain pd={self.pd} is closed")
        if self.fabric.nodes[src.node_id].crashed:
            raise NodeDown(
                f"cannot post from crashed node {src.node_id}")
        self._check_regions(src, dst)
        nbytes = nbytes if nbytes is not None else min(src.length, dst.length)
        src_va = src.addr + src_offset
        dst_va = dst.addr + dst_offset
        if not src.contains(src_va, nbytes) or not dst.contains(dst_va, nbytes):
            raise RegionError("work request outside its memory regions")
        assert (src_va % A.PAGE_SIZE) == (dst_va % A.PAGE_SIZE), \
            "fabric requires equally page-aligned src/dst (as in the thesis runs)"
        fabric = self.fabric
        self._check_quota(src.node_id)     # blocks launch on the src node
        # SRQ admission: each block consumes one shared receive entry on
        # the destination node for the transfer's lifetime
        n_blocks = len(A.split_blocks(src_va, nbytes))
        self._srq_acquire(dst.node_id, n_blocks)
        try:
            cq.on_post()
        except WorkQueueFull:
            fabric.nodes[dst.node_id].tenancy.srq.release(n_blocks)
            raise
        wr_id = wr_id if wr_id is not None else fabric._next_wr_id()
        t = fabric._start_write(self.pd, src.node_id, src_va,
                                dst.node_id, dst_va, nbytes,
                                service_class=service_class
                                or self.service_class)
        t.srq_held, t.srq_node = n_blocks, dst.node_id
        return fabric._track(wr_id, WROpcode.WRITE, cq, t)

    def post_read(self, target: MemoryRegion, local: MemoryRegion,
                  cq: CompletionQueue, nbytes: Optional[int] = None,
                  target_offset: int = 0, local_offset: int = 0,
                  wr_id: Optional[int] = None,
                  service_class: Optional[ServiceClass] = None
                  ) -> WorkRequest:
        """Asynchronous remote read: request forwarded to the target node,
        whose R5 turns it into a write back to the initiator (§1.3.2.2).

        ``service_class`` overrides the domain's arbiter class for this
        work request only (demand page-ins post LATENCY, prefetch BULK).

        Raises :class:`~repro_torch.core.node.NodeDown` when the *posting*
        (local) node has crashed; reading from a crashed target is
        accepted and completes with ``WCStatus.REMOTE_OP_ERR``."""
        if self.closed:
            raise DomainClosed(f"domain pd={self.pd} is closed")
        if self.fabric.nodes[local.node_id].crashed:
            raise NodeDown(
                f"cannot post from crashed node {local.node_id}")
        self._check_regions(target, local)
        nbytes = nbytes if nbytes is not None else min(target.length,
                                                      local.length)
        target_va = target.addr + target_offset
        local_va = local.addr + local_offset
        if not target.contains(target_va, nbytes) or \
                not local.contains(local_va, nbytes):
            raise RegionError("work request outside its memory regions")
        assert (target_va % A.PAGE_SIZE) == (local_va % A.PAGE_SIZE), \
            "fabric requires equally page-aligned target/local (as in the thesis runs)"
        fabric = self.fabric
        self._check_quota(target.node_id)  # blocks launch on the target node
        # the read's data lands on the LOCAL node: that is where the
        # shared receive entries are consumed
        n_blocks = len(A.split_blocks(target_va, nbytes))
        self._srq_acquire(local.node_id, n_blocks)
        try:
            cq.on_post()
        except WorkQueueFull:
            fabric.nodes[local.node_id].tenancy.srq.release(n_blocks)
            raise
        wr_id = wr_id if wr_id is not None else fabric._next_wr_id()
        t = fabric._start_read(self.pd, target.node_id, target_va,
                               local.node_id, local_va, nbytes,
                               service_class=service_class
                               or self.service_class)
        t.srq_held, t.srq_node = n_blocks, local.node_id
        return fabric._track(wr_id, WROpcode.READ, cq, t)

    def _check_quota(self, sending_node: int) -> None:
        """Per-domain outstanding-block quota backpressure (arbiter)."""
        arb = self.fabric.nodes[sending_node].arbiter
        if arb.over_quota(self.pd):
            arb.note_quota_rejection(self.pd)
            raise DomainQuotaExceeded(
                f"domain pd={self.pd} at its outstanding-block quota on "
                f"node {sending_node} ({arb.outstanding(self.pd)} blocks); "
                f"drain completions first")
        # node-wide protocol backpressure: refuse new work while every
        # 14-bit tr_ID is owned by a pending block (Table 3.2) — the
        # launching R5 would only defer the blocks internally anyway
        r5 = self.fabric.nodes[sending_node].r5
        if r5.tr_ids_free() == 0:
            r5.id_stats.exhausted_posts += 1
            raise TrIdExhausted(
                f"all {r5.tr_id_space} tr_IDs in flight on node "
                f"{sending_node}; drain completions first")

    def _srq_acquire(self, recv_node: int, n_blocks: int) -> None:
        """Claim shared receive entries on the landing node, or raise
        :class:`TenantQuotaExceeded` — GOLD tenants may dip into the
        ``srq_gold_reserve`` slice best-effort traffic cannot touch."""
        srq = self.fabric.nodes[recv_node].tenancy.srq
        if not srq.try_acquire(n_blocks, gold=self.slo is SLOClass.GOLD):
            raise TenantQuotaExceeded(
                f"domain pd={self.pd}: node {recv_node}'s shared receive "
                f"queue cannot grant {n_blocks} entries "
                f"({srq.held}/{srq.entries} held"
                + (f", {srq.gold_reserve} GOLD-reserved"
                   if srq.gold_reserve else "")
                + "); drain completions first")

    def arbiter_stats(self, node_idx: int) -> ArbiterStats:
        """This domain's DMA-arbiter telemetry on ``node_idx``."""
        arb = self.fabric.nodes[node_idx].arbiter
        return arb.domain_stats.setdefault(self.pd, ArbiterStats())

    def _check_regions(self, *regions: MemoryRegion) -> None:
        for mr in regions:
            if not mr.registered:
                raise RegionError(f"region rkey={mr.rkey} is deregistered")
            if mr.domain is not self:
                raise RegionError(
                    f"region rkey={mr.rkey} belongs to pd={mr.pd}, "
                    f"not pd={self.pd}")


class Fabric:
    """A built simulated fabric: nodes, links, domains, CQs."""

    def __init__(self, config: FabricConfig):
        self.config = config
        self.cost = config.cost
        if config.race_check or os.environ.get("REPRO_RACE_CHECK"):
            if config.shards > 1:
                raise ConfigError(
                    "shards > 1 is mutually exclusive with the race "
                    "sanitizer (REPRO_RACE_CHECK)")
            from repro_torch.lint.race import RaceCheckLoop
            self.loop: EventLoop = RaceCheckLoop()
        elif config.shards > 1:
            from repro_torch.core.shards import ShardedEventLoop
            # conservative lookahead = min routed link latency: every
            # cross-node (hence cross-shard) event crosses >= one hop
            self.loop = ShardedEventLoop(
                config.shards, lookahead_us=self.cost.hop_latency_us)
        else:
            self.loop = make_event_loop()
        node_loop = self.loop.handle_for if config.shards > 1 else None
        self.nodes: list[Node] = []
        for i in range(config.n_nodes):
            policy = config.policy_for_node(i)
            node = Node(node_loop(i) if node_loop else self.loop,
                        self.cost, i,
                        policy.make_resolver(self.cost),
                        allocator=FrameAllocator(config.frames_per_node),
                        hupcf=config.hupcf, fault_model=config.fault_model,
                        pldma_slots=config.pldma_slots,
                        arb_quantum_bytes=config.arb_quantum_bytes,
                        tr_id_space=config.tr_id_space,
                        mtt_entries=config.mtt_entries,
                        dma_pool_frames=config.dma_pool_frames,
                        speculation=config.speculation,
                        bank_overcommit=config.bank_overcommit,
                        srq_entries=config.srq_entries,
                        srq_gold_reserve=config.srq_gold_reserve,
                        tenants_per_node=config.tenants_per_node,
                        crash_detect_retries=config.crash_detect_retries,
                        lease_timeout_us=config.lease_timeout_us)
            self.nodes.append(node)
        # the routed interconnect: per-direction links along the physical
        # adjacencies of config.topology (ALL_TO_ALL keeps the seed's
        # dedicated pair links, with hops= as its distance alias), shared
        # by every transmit path — data pages and control packets alike
        self.interconnect = Interconnect(
            self.loop, self.cost, config.topology, n_nodes=config.n_nodes,
            dims=config.dims, qos=config.link_qos,
            legacy_hops=config.hops)
        for a in self.nodes:
            a.interconnect = self.interconnect
            for b in self.nodes:
                a.peer[b.node_id] = b
        self.domains: dict[int, ProtectionDomain] = {}
        self.cqs: list[CompletionQueue] = []
        self._tid = 0
        self._wr_counter = 0
        self._rkey_counter = 0

    @classmethod
    def build(cls, config: Optional[FabricConfig] = None, **overrides) -> "Fabric":
        """Builder entry point: ``Fabric.build(FabricConfig(...))`` or
        ``Fabric.build(n_nodes=4, default_policy=...)``."""
        if config is None:
            config = FabricConfig(**overrides)
        elif overrides:
            raise TypeError("pass either a FabricConfig or keyword "
                            "overrides, not both")
        return cls(config)

    # ------------------------------------------------------------- domains
    def open_domain(self, pd: int,
                    policy: Optional[FaultPolicy] = None,
                    nodes: Optional[list[int]] = None,
                    service_class: Optional[ServiceClass] = None,
                    arb_weight: Optional[int] = None,
                    max_outstanding_blocks: Optional[int] = None,
                    slo: Optional[SLOClass] = None
                    ) -> ProtectionDomain:
        """Create protection domain ``pd`` on ``nodes`` (default: all).

        ``policy`` overrides the per-node / fabric-default fault policy for
        THIS domain: its resolver is threaded into each node's fault
        handlers via ``Node.resolver_for(pd)``.

        ``service_class`` / ``arb_weight`` / ``max_outstanding_blocks``
        override the policy's DMA-arbiter parameters for this domain
        (class of its blocks, DRR bandwidth weight, outstanding-block
        quota enforced by the posting verbs).

        ``slo`` sets the tenant's service tier (GOLD / SILVER /
        BEST_EFFORT — a :class:`~repro_torch.tenancy.SLOClass`, its name or
        value), overriding the policy's ``slo``.  It derives the arbiter
        class/weight unless those are given explicitly, and GOLD makes
        the domain's context banks steal-immune under bank overcommit.

        Raises :class:`DomainExists` for a duplicate pd,
        :class:`BankCollision` for a ``pd % 16`` clash when
        ``FabricConfig(bank_overcommit=False)``, and
        :class:`~repro_torch.api.completion.TenantQuotaExceeded` when a node
        is at its admission cap.
        """
        if pd in self.domains:
            raise DomainExists(f"domain pd={pd} already open")
        slo = coerce_slo(slo)
        if slo is None and policy is not None:
            slo = policy.slo
        if slo is None:
            slo = self.config.default_policy.slo
        if slo is not None:
            if service_class is None and (policy is None
                                          or policy.service_class is None):
                service_class = slo.service_class
            if arb_weight is None and (policy is None
                                       or policy.arb_weight == 1):
                arb_weight = slo.arb_weight
        node_idxs = list(nodes) if nodes is not None \
            else list(range(len(self.nodes)))
        # With overcommit disabled, each domain owns its seed-style bank
        # (pd % NUM_CONTEXT_BANKS) forever: a second pd landing on an
        # in-use bank would overwrite the bank's page table — cross-
        # tenant corruption — so reject it here, across all its nodes,
        # before any node state is created.
        if not self.config.bank_overcommit:
            bank = pd % A.NUM_CONTEXT_BANKS
            for i in node_idxs:
                clash = [q for q in self.nodes[i].page_tables
                         if q % A.NUM_CONTEXT_BANKS == bank]
                if clash:
                    raise BankCollision(
                        f"pd={pd} maps to SMMU context bank {bank}, "
                        f"already claimed by domain pd={clash[0]} on node "
                        f"{i} (bank = pd % {A.NUM_CONTEXT_BANKS})")
        # tenancy admission: check every node before creating on any,
        # so a rejection cannot leave the domain half-open
        for i in node_idxs:
            reason = self.nodes[i].tenancy.admission_error(slo)
            if reason is not None:
                self.nodes[i].tenancy.admission_rejections += 1
                raise TenantQuotaExceeded(
                    f"open_domain(pd={pd}) refused: {reason} (node {i})")
        effective = {i: policy or self.config.policy_for_node(i)
                     for i in node_idxs}
        for i in node_idxs:
            resolver = (policy.make_resolver(self.cost)
                        if policy is not None else None)
            eff = effective[i]
            self.nodes[i].create_domain(
                pd, pin_limit_bytes=eff.pin_limit_bytes,
                resolver=resolver,
                service_class=service_class or eff.service_class,
                arb_weight=(arb_weight if arb_weight is not None
                            else eff.arb_weight),
                max_outstanding_blocks=(
                    max_outstanding_blocks if max_outstanding_blocks
                    is not None else eff.max_outstanding_blocks),
                slo=slo,
                max_retries=eff.max_retries,
                retry_backoff=eff.retry_backoff)
        dom = ProtectionDomain(self, pd,
                               policy or self.config.default_policy,
                               node_policies=effective, slo=slo)
        if service_class is not None:     # explicit override beats policy
            dom.service_class = service_class
        self.domains[pd] = dom
        return dom

    def close_domain(self, pd: int, deadline_us: float = 5e6,
                     max_events: int = MAX_WAIT_EVENTS) -> None:
        """Tear down protection domain ``pd`` (the lifecycle the seed
        never had: domains could only accumulate).

        Semantics, in order:

        1. the domain stops accepting work — posting verbs and
           ``register_memory`` raise :class:`DomainClosed`;
        2. in-flight work requests DRAIN (the loop advances until every
           node's arbiter reports zero outstanding blocks for the pd, up
           to ``deadline_us`` of virtual time — a ``FabricError`` if it
           expires);
        3. every node releases the domain: SMMU bank detached (full TLB
           shootdown), NP-RDMA MTT entries dropped, all frames returned
           to the shared pool, SRQ/QP/admission slots freed;
        4. the domain's memory regions are marked deregistered and the
           pd becomes reusable by a later ``open_domain``.
        """
        dom = self.domains.get(pd)
        if dom is None:
            raise FabricError(f"domain pd={pd} is not open")
        dom.closed = True
        node_idxs = dom.nodes
        # crash-fault flush: a transfer whose destination died (or became
        # permanently unreachable) would otherwise sit out the dead-round
        # detection — or, from a crashed posting node, spin the full
        # drain deadline.  Flush such work NOW with WR_FLUSH_ERR so
        # teardown is prompt.
        self._flush_stranded(pd, node_idxs)

        def drained() -> bool:
            return all(self.nodes[i].arbiter.outstanding(pd) == 0
                       for i in node_idxs)

        if not _advance_until(self.loop, drained, deadline_us, max_events):
            dom.closed = False        # give the caller a retry path
            pending = {i: self.nodes[i].arbiter.outstanding(pd)
                       for i in node_idxs
                       if self.nodes[i].arbiter.outstanding(pd)}
            raise FabricError(
                f"close_domain(pd={pd}): {sum(pending.values())} blocks "
                f"still in flight after {deadline_us} us (per node: "
                f"{pending}); raise deadline_us or drain completions")
        for i in node_idxs:
            self.nodes[i].release_domain(pd)
        for mr in dom._regions:
            # frames were already released wholesale by release_domain;
            # the handle just becomes invalid for future verbs
            mr.registered = False
        del self.domains[pd]

    def _flush_stranded(self, pd: int, node_idxs: list[int]) -> None:
        """Fail (WR_FLUSH_ERR) the domain's transfers that can never
        drain: executing node crashed (transfers already failed there at
        crash time — this catches stragglers submitted since), or the
        destination is crashed / unreachable behind a partition."""
        ic = self.interconnect
        for i in node_idxs:
            r5 = self.nodes[i].r5
            stranded = {b.transfer for b in r5.pending.values()
                        if b.transfer.pd == pd}
            stranded.update(t for t in r5._starved if t.pd == pd)
            for t in sorted(stranded, key=lambda t: t.tid):
                if t.failed_status is not None or t.complete:
                    continue
                peer = t.dst_node
                if (self.nodes[i].crashed or peer.crashed
                        or not ic.reachable(i, peer.node_id)):
                    r5.fail_transfer(t, "wr_flush_err")

    def domain(self, pd: int) -> Optional[ProtectionDomain]:
        return self.domains.get(pd)

    # ----------------------------------------------------------------- CQs
    def create_cq(self, depth: int = 256,
                  max_outstanding: Optional[int] = None) -> CompletionQueue:
        cq = CompletionQueue(self, depth=depth,
                             max_outstanding=max_outstanding)
        self.cqs.append(cq)
        return cq

    # ------------------------------------------------------------ failures
    def crash_node(self, node_idx: int) -> None:
        """Fail-stop crash of one node (idempotent; no un-crash).

        Every incident physical link goes down (surviving traffic
        detours or partitions), the node's datapaths fall silent, and
        all transfers its R5 was executing complete with error statuses
        — ``WR_FLUSH_ERR`` for work posted from the dead node,
        ``REMOTE_OP_ERR`` for remote reads posted against it.  Work
        posted by *survivors* toward the dead node fails after
        ``FabricConfig.crash_detect_retries`` timeout rounds with
        ``REMOTE_OP_ERR``.  tr_IDs orphaned on the dead node return to
        its free list after ``FabricConfig.lease_timeout_us``.
        """
        self.nodes[node_idx].crash()

    def fail_link(self, u: int, v: int) -> None:
        """Take the physical adjacency ``u <-> v`` down (both directions).

        Traffic re-routes deterministically around it; endpoints cut off
        entirely behave like crashed peers (``REMOTE_OP_ERR`` after the
        detection window).  Raises ``KeyError`` for non-adjacent pairs.
        """
        self.interconnect.fail_link(u, v)

    def restore_link(self, u: int, v: int) -> None:
        """Bring a failed physical adjacency back up; with no links left
        down, routes revert bit-exactly to the oblivious minimal paths."""
        self.interconnect.restore_link(u, v)

    # ------------------------------------------------------------- network
    def net_stats(self) -> FabricStats:
        """Interconnect telemetry: per-link utilization/queueing rollup."""
        return self.interconnect.stats()

    def protocol_stats(self) -> dict:
        """Per-node protocol telemetry: ``{node_id: ProtocolStats}``.

        ``.tr_id`` — the tr_ID lifecycle (allocation/recycle/wrap counts,
        exhaustion backpressure, stale-control drops): the surface the
        scale soak and the wraparound regression tests assert against.
        ``.npr`` — the NP-RDMA backend (MTT hit/miss/stale, aborts,
        redirects, pool occupancy), all-zero unless a domain selected
        ``Strategy.NP_RDMA``.  ``.tenancy`` — the tenancy control plane
        (bank binds/steals/shootdowns, SRQ admission, QP multiplexing,
        tenant counts).  All are real fields — no getattr fallbacks — so
        stats consumers fail loudly if a section moves.
        """
        return {n.node_id: ProtocolStats(tr_id=n.r5.id_stats,
                                         npr=n.npr.stats,
                                         tenancy=n.tenancy)
                for n in self.nodes}

    def link_stats(self, src_node: int, dst_node: int):
        """One directed physical link's :class:`~repro_torch.net.link.LinkStats`.

        Raises :class:`FabricError` for non-adjacent pairs — on routed
        topologies only physical neighbours (and loopbacks) have links;
        use :meth:`net_stats` for the fabric-wide rollup.
        """
        try:
            return self.interconnect.link(src_node, dst_node).stats
        except KeyError:
            adj = self.interconnect.topology.neighbors(src_node)
            raise FabricError(
                f"no physical link {src_node}->{dst_node} on topology "
                f"{self.interconnect.topology.kind.value}; node "
                f"{src_node}'s neighbours are {adj}") from None

    # ------------------------------------------------------------ progress
    @property
    def now(self) -> float:
        return self.loop.now

    def progress(self, until: Optional[float] = None) -> None:
        """Run the event loop (to ``until``, or until drained)."""
        self.loop.run(until=until)

    # --------------------------------------------------- transfer internals
    def _next_wr_id(self) -> int:
        self._wr_counter += 1
        return self._wr_counter

    def _start_write(self, pd: int, src_node: int, src_va: int,
                     dst_node: int, dst_va: int, nbytes: int,
                     service_class: Optional[ServiceClass] = None) -> Transfer:
        self._tid += 1
        t = Transfer(self._tid, pd, self.nodes[src_node],
                     self.nodes[dst_node], src_va, dst_va, nbytes,
                     service_class=service_class)
        t.origin_id = src_node
        # count against the domain quota NOW, so a burst of posts sees
        # its own backlog before any simulated delay elapses
        self.nodes[src_node].arbiter.note_submit(t)
        self.nodes[src_node].r5.submit(t)
        return t

    def _start_read(self, pd: int, target_node: int, target_va: int,
                    local_node: int, local_va: int, nbytes: int,
                    service_class: Optional[ServiceClass] = None) -> Transfer:
        self._tid += 1
        t = Transfer(self._tid, pd, self.nodes[target_node],
                     self.nodes[local_node], target_va, local_va, nbytes,
                     service_class=service_class)
        t.origin_id = local_node
        # blocks will launch on the TARGET node: count them against the
        # quota now (not after the request-packet delay), so a burst of
        # posted reads is backpressured like a burst of writes
        self.nodes[target_node].arbiter.note_submit(t)
        # request packet: initiator -> target mailbox over the routed
        # interconnect (the seed charged one hop however far the target)
        req_delay = self.cost.pckzer_to_mbox_us
        if target_node != local_node:
            try:
                req_delay += (self.nodes[local_node]
                              .path_to(target_node).send_ctrl(16))
            except NetworkPartitioned:
                # the request can never reach the target: complete with
                # REMOTE_OP_ERR.  Scheduled (not immediate) so _track
                # attaches the completion callback first.
                self.loop.schedule(req_delay,
                                   self.nodes[target_node].r5.fail_transfer,
                                   t, "remote_op_err")
                return t
        self.loop.schedule(req_delay, self.nodes[target_node].r5.submit, t)
        return t

    def _track(self, wr_id: int, opcode: WROpcode, cq: CompletionQueue,
               transfer: Transfer) -> WorkRequest:
        wr = WorkRequest(wr_id, opcode, cq, transfer, t_posted=self.loop.now)

        def _on_complete(t: Transfer) -> None:
            if t.srq_held:
                # the completion frees the destination's receive entries
                # (error completions too: no WR may leak SRQ capacity)
                self.nodes[t.srq_node].tenancy.srq.release(t.srq_held)
                t.srq_held = 0
            # core stores the terminal error as the WCStatus *value*
            # string (it cannot import repro_torch.api); map it back here
            status = (WCStatus(t.failed_status) if t.failed_status
                      else WCStatus.SUCCESS)
            wc = WorkCompletion(wr_id=wr.wr_id, opcode=wr.opcode,
                                status=status, pd=t.pd,
                                nbytes=t.nbytes, t_posted=wr.t_posted,
                                t_complete=t.stats.t_complete,
                                stats=t.stats)
            wr.completion = wc
            cq.deliver(wc)

        transfer.on_complete = _on_complete
        return wr
