"""Fault-aware multi-tenant DMA arbiter (the thesis' §3.2 "adjustments to
the DMA scheduling logic", grown into a QoS scheduler).

The thesis prototype required the DMA engine to *pause* a faulting
transfer without stalling the engine.  The seed's ``R5Scheduler`` kept the
pause but not the "without stalling" part for multi-tenant traffic: every
launched block went straight to the PLDMA, so one tenant's fault storm
(pause → 1 ms timeout → full retransmit) could book the engine and the
wire ahead of everyone else's traffic — head-of-line blocking across
protection domains.

:class:`DMAArbiter` sits between the R5 block launcher and the PLDMA:

* **per-(domain, class) send queues** — launched blocks queue per
  protection domain, in one of two service classes:
  :attr:`ServiceClass.LATENCY` (serving-style small work requests) and
  :attr:`ServiceClass.BULK` (training/offload streams).  LATENCY queues
  are served with strict priority over BULK queues;
* **deficit round-robin across domains** within a class: each domain's
  queue accrues ``quantum × weight`` bytes of service credit per turn and
  dispatches whole blocks against it, so bandwidth shares follow the
  configured weights regardless of block sizes;
* **bounded PLDMA occupancy** — ``slots`` blocks may occupy the engine at
  once (default 2, the hardware's outstanding-block window, now shared by
  all tenants instead of granted per transfer);
* **deschedule-on-fault** — a block entering ``PAUSED_SRC``/``PAUSED_DST``
  yields its PLDMA slot *immediately*; the RAPF / retransmission-timeout
  re-enqueues it at the back of its class queue, so a faulting tenant
  waits out its own page faults instead of holding the engine;
* **per-domain outstanding-block quotas** — ``Fabric``'s posting verbs
  consult :meth:`DMAArbiter.over_quota` and refuse work beyond a domain's
  budget (:class:`~repro.api.completion.DomainQuotaExceeded`), turning
  runaway tenants into backpressure instead of queue growth.

Everything is observable: one :class:`ArbiterStats` per domain plus a
node-level total, with the invariant (checked by ``repro.testing``) that
the per-domain records sum to the total.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import TYPE_CHECKING, Optional

from repro_torch.core import addresses as A

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.core.node import Block, Node


class ServiceClass(enum.Enum):
    """Arbiter service class of a work request / protection domain.

    The class governs two arbitration points: the PLDMA slot scheduler
    below, and — on shared-link topologies (:mod:`repro.net`) — the wire
    itself, where :attr:`wire_priority` traffic overtakes BULK backlogs
    on every congested hop of its route.
    """
    LATENCY = "latency"      # serving-style small WRs: strict priority
    BULK = "bulk"            # training/offload streams: bandwidth-shared

    def __lt__(self, other: "ServiceClass") -> bool:   # stable sort keys
        return self.value < other.value

    @property
    def wire_priority(self) -> bool:
        """Does this class jump BULK queues on contended links?"""
        return self is ServiceClass.LATENCY


#: scheduling order: LATENCY queues are always served before BULK queues
CLASS_PRIORITY = (ServiceClass.LATENCY, ServiceClass.BULK)

#: default PLDMA occupancy: the hardware's two outstanding blocks,
#: now a *shared* resource arbitrated across all tenants of the node
DEFAULT_PLDMA_SLOTS = A.OUTSTANDING_BLOCKS_PER_TRANSFER


@dataclasses.dataclass(slots=True)
class ArbiterStats:
    """Per-domain (or node-total) arbiter telemetry.

    All fields except ``max_queue_depth`` are additive: the node total is
    the field-wise sum of the per-domain records (a ``repro.testing``
    invariant).  ``max_queue_depth`` is a high-water mark — per domain of
    its own queues, for the total of the node-wide backlog.
    """
    enqueued: int = 0            # fresh blocks entering the send queues
    dispatched: int = 0          # blocks granted a PLDMA slot
    completed: int = 0           # blocks ACKed
    deschedules: int = 0         # PAUSED_* blocks yielding their slot
    requeues: int = 0            # timeout/RAPF re-entries (back of queue)
    bytes_served: int = 0        # payload bytes of dispatched blocks
    quota_rejections: int = 0    # posts refused by the domain quota
    max_queue_depth: int = 0     # high-water mark (not additive)

    ADDITIVE = ("enqueued", "dispatched", "completed", "deschedules",
                "requeues", "bytes_served", "quota_rejections")


class _DomainQueue:
    """One (protection domain, service class) send queue with its DRR state."""

    __slots__ = ("pd", "service_class", "weight", "blocks", "deficit",
                 "credited", "in_ring")

    def __init__(self, pd: int, service_class: ServiceClass, weight: int):
        self.pd = pd
        self.service_class = service_class
        self.weight = max(1, weight)
        self.blocks: deque = deque()
        self.deficit = 0.0       # bytes of service credit (DRR counter)
        self.credited = False    # already credited for the current turn
        self.in_ring = False     # member of its class's active ring


class DMAArbiter:
    """Deficit-round-robin block scheduler in front of one node's PLDMA."""

    def __init__(self, node: "Node", slots: int = DEFAULT_PLDMA_SLOTS,
                 quantum_bytes: int = A.BLOCK_SIZE):
        if slots < 1:
            raise ValueError(f"need at least one PLDMA slot, got {slots}")
        if quantum_bytes < 1:
            raise ValueError(f"DRR quantum must be >= 1 B, got {quantum_bytes}")
        self.node = node
        self.slots = slots
        self.quantum = quantum_bytes
        self.in_flight = 0                   # blocks occupying PLDMA slots
        # (pd, class) -> queue; active rings hold queues with blocks
        self.queues: dict[tuple[int, ServiceClass], _DomainQueue] = {}
        self._active: dict[ServiceClass, deque] = {
            cls: deque() for cls in CLASS_PRIORITY}
        # domain registration (class/weight/quota defaults per pd)
        self._dom_class: dict[int, ServiceClass] = {}
        self._dom_weight: dict[int, int] = {}
        self._dom_quota: dict[int, Optional[int]] = {}
        self._outstanding: dict[int, int] = {}   # launched, not-yet-done
        # O(1) queue-depth counters (node total + per domain): queue_depth
        # is consulted on EVERY enqueue for the high-water stats, and the
        # seed's sum-over-queues scan made intake O(domains) per block
        self._depth_total = 0
        self._depth_by_pd: dict[int, int] = {}
        self.stats = ArbiterStats()              # node-wide total
        self.domain_stats: dict[int, ArbiterStats] = {}
        # cached enum member: enqueue/_pump test it per block, and the
        # import is circular at module load (node.py imports arbiter) but
        # fine here — a DMAArbiter only exists once its Node does
        from repro_torch.core.node import BlockState
        self._done = BlockState.DONE
        # DRR rotation bound factor, hoisted out of _next_block (the
        # integer division showed up at million-block scale)
        self._rot_factor = A.BLOCK_SIZE // self.quantum + 2

    # ------------------------------------------------------------ domains
    def register_domain(self, pd: int,
                        service_class: Optional[ServiceClass] = None,
                        weight: int = 1,
                        max_outstanding_blocks: Optional[int] = None) -> None:
        """Declare a domain's arbitration parameters (idempotent)."""
        self._dom_class[pd] = service_class or ServiceClass.BULK
        self._dom_weight[pd] = max(1, weight)
        self._dom_quota[pd] = max_outstanding_blocks
        self.domain_stats.setdefault(pd, ArbiterStats())

    def class_of(self, pd: int) -> ServiceClass:
        return self._dom_class.get(pd, ServiceClass.BULK)

    def outstanding(self, pd: int) -> int:
        """Blocks of ``pd`` submitted and not yet completed (pending
        launch, queued, in a PLDMA slot, or paused awaiting RAPF/timeout)."""
        return self._outstanding.get(pd, 0)

    def note_submit(self, transfer) -> None:
        """Count a posted transfer's blocks against its domain quota
        (called synchronously from the fabric's posting verbs — for both
        writes and reads — so quota checks see work the moment it is
        posted, not when blocks launch on this node)."""
        pd = transfer.pd
        self._outstanding[pd] = (self._outstanding.get(pd, 0)
                                 + len(transfer.blocks))

    def over_quota(self, pd: int) -> bool:
        """Is the domain at (or beyond) its outstanding-block quota?

        Posts are refused while ``outstanding >= quota``; a single work
        request may overshoot the quota by its own block count (the quota
        is a backpressure threshold, not a hard block-count ceiling).
        """
        quota = self._dom_quota.get(pd)
        return quota is not None and self.outstanding(pd) >= quota

    def note_quota_rejection(self, pd: int) -> None:
        self._stats_for(pd).quota_rejections += 1
        self.stats.quota_rejections += 1

    def queue_depth(self, pd: Optional[int] = None) -> int:
        if pd is None:
            return self._depth_total
        return self._depth_by_pd.get(pd, 0)

    def _stats_for(self, pd: int) -> ArbiterStats:
        # hot path (every enqueue/dispatch/completion): probe the dict
        # once instead of allocating a throwaway default per setdefault
        st = self.domain_stats.get(pd)
        if st is None:
            st = self.domain_stats[pd] = ArbiterStats()
        return st

    def _queue_for(self, pd: int, cls: ServiceClass) -> _DomainQueue:
        q = self.queues.get((pd, cls))
        if q is None:
            if pd not in self._dom_class:
                self.register_domain(pd)
            q = _DomainQueue(pd, cls, self._dom_weight.get(pd, 1))
            self.queues[(pd, cls)] = q
        return q

    # ------------------------------------------------------------- intake
    def enqueue(self, block: "Block", *, retransmit: bool = False) -> None:
        """Queue a block for a PLDMA slot (fresh launch or re-entry).

        Re-entries go to the *back* of their class queue — a faulting
        block that lost its slot does not jump fresh traffic.
        """
        if block.queued or block.state is self._done:
            return
        pd = block.transfer.pd
        cls = (block.transfer.service_class or self.class_of(pd))
        block.service_class = cls
        block.is_retransmit = retransmit
        block.queued = True
        q = self._queue_for(pd, cls)
        q.blocks.append(block)
        total = self._depth_total + 1
        self._depth_total = total
        depth = self._depth_by_pd.get(pd, 0) + 1
        self._depth_by_pd[pd] = depth
        if not q.in_ring:
            q.in_ring = True
            self._active[cls].append(q)
        st = self.domain_stats.get(pd)       # _stats_for, inlined (hot)
        if st is None:
            st = self.domain_stats[pd] = ArbiterStats()
        tot_st = self.stats
        if retransmit:
            st.requeues += 1
            tot_st.requeues += 1
        else:
            st.enqueued += 1
            tot_st.enqueued += 1
        if depth > st.max_queue_depth:            # high-water marks
            st.max_queue_depth = depth
        if total > tot_st.max_queue_depth:
            tot_st.max_queue_depth = total
        self._pump()

    def requeue(self, block: "Block") -> None:
        """Timeout/RAPF re-entry: release the slot if held, back of queue.

        Idempotent against the timeout-then-late-RAPF race: a block that
        is already queued, or already granted a slot with its dispatch
        event in flight (``grant_pending``), is on its way to retransmit
        — a second requeue must not steal the slot or double-queue it.
        """
        if block.queued or block.grant_pending:
            return
        self._release_slot(block, descheduled=False)
        self.enqueue(block, retransmit=True)

    # ---------------------------------------------------------- slot events
    def on_block_paused(self, block: "Block") -> None:
        """Deschedule-on-fault: a PAUSED_* block yields its slot NOW."""
        if self._release_slot(block, descheduled=True):
            self._pump()

    def on_block_done(self, block: "Block") -> None:
        pd = block.transfer.pd
        st = self.domain_stats.get(pd)       # _stats_for, inlined (hot)
        if st is None:
            st = self.domain_stats[pd] = ArbiterStats()
        st.completed += 1
        self.stats.completed += 1
        left = self._outstanding.get(pd, 0) - 1
        self._outstanding[pd] = max(0, left)
        if self._release_slot(block, descheduled=False):
            self._pump()

    # ----------------------------------------------------------- crash fault
    def purge(self, block: "Block") -> None:
        """Remove a terminally-failed block from the scheduler entirely:
        drop it from its send queue (if queued) and release its PLDMA
        slot (if held).  No completion stats — the block did not finish;
        quota release happens per transfer in :meth:`on_transfer_failed`.
        """
        released = False
        if block.queued:
            pd = block.transfer.pd
            cls = block.service_class or self.class_of(pd)
            q = self.queues.get((pd, cls))
            if q is not None:
                try:
                    q.blocks.remove(block)
                except ValueError:          # pragma: no cover - defensive
                    pass
                else:
                    self._depth_total -= 1
                    self._depth_by_pd[pd] -= 1
            block.queued = False
        if self._release_slot(block, descheduled=False):
            released = True
        if released:
            self._pump()

    def on_transfer_failed(self, transfer) -> None:
        """Release the quota held by a failed transfer's unfinished blocks
        (its ACKed blocks already released theirs in :meth:`on_block_done`,
        so the drained-fabric invariant ``outstanding(pd) == 0`` survives
        crashes and retry exhaustion)."""
        pd = transfer.pd
        remaining = len(transfer.blocks) - transfer.done_blocks
        if remaining > 0:
            left = self._outstanding.get(pd, 0) - remaining
            self._outstanding[pd] = max(0, left)

    def _release_slot(self, block: "Block", descheduled: bool) -> bool:
        if not block.holds_slot:
            return False
        block.holds_slot = False
        self.in_flight -= 1
        if descheduled:
            st = self._stats_for(block.transfer.pd)
            st.deschedules += 1
            self.stats.deschedules += 1
        return True

    # ------------------------------------------------------------ scheduling
    def _pump(self) -> None:
        """Grant free PLDMA slots to queued blocks per class/DRR order."""
        while self.in_flight < self.slots:
            block = self._next_block()
            if block is None:
                return
            block.queued = False
            if block.state is self._done:      # completed while queued
                continue
            block.holds_slot = True
            block.grant_pending = True
            self.in_flight += 1
            pd = block.transfer.pd
            nbytes = block.nbytes
            st = self.domain_stats.get(pd)   # _stats_for, inlined (hot)
            if st is None:
                st = self.domain_stats[pd] = ArbiterStats()
            st.dispatched += 1
            st.bytes_served += nbytes
            tot_st = self.stats
            tot_st.dispatched += 1
            tot_st.bytes_served += nbytes
            node = self.node
            delay = (node.cost.retransmit_setup_us
                     if block.is_retransmit else node.cost.per_block_r5_us)
            node.loop.schedule(delay, node.r5._dispatch, block,
                               block.is_retransmit)

    def _next_block(self) -> Optional["Block"]:
        """Deficit round robin, LATENCY ring strictly before BULK."""
        for cls in CLASS_PRIORITY:
            active = self._active[cls]
            if not active:
                continue
            # a full rotation credits every queue by quantum × weight, so
            # some head fits within ceil(BLOCK_SIZE / quantum) + 1 rotations
            max_rot = (len(active) + 1) * self._rot_factor
            rotations = 0
            while active and rotations <= max_rot:
                q = active[0]
                if not q.blocks:
                    # drained queue leaves the ring; credit does not hoard
                    active.popleft()
                    q.in_ring = False
                    q.deficit = 0.0
                    q.credited = False
                    continue
                if not q.credited:
                    q.deficit += self.quantum * q.weight
                    q.credited = True
                head = q.blocks[0]
                if q.deficit >= head.nbytes:
                    q.deficit -= head.nbytes
                    block = q.blocks.popleft()
                    self._depth_total -= 1
                    self._depth_by_pd[q.pd] -= 1
                    if not q.blocks:
                        active.popleft()
                        q.in_ring = False
                        q.deficit = 0.0
                        q.credited = False
                    return block
                # credit did not cover the head block: turn passes
                q.credited = False
                active.rotate(-1)
                rotations += 1
        return None

    # ------------------------------------------------------------ invariants
    def depth_counter_violations(self) -> list[str]:
        """The O(1) depth counters must equal the actual queue contents."""
        out = []
        actual_total = sum(len(q.blocks) for q in self.queues.values())
        if actual_total != self._depth_total:
            out.append(f"node {self.node.node_id}: depth counter "
                       f"{self._depth_total} != actual backlog {actual_total}")
        # torch-lint: allow(det-dict-iter): diagnostic list order only
        for pd, n in self._depth_by_pd.items():
            actual = sum(len(q.blocks) for q in self.queues.values()
                         if q.pd == pd)
            if actual != n:
                out.append(f"node {self.node.node_id} pd={pd}: depth counter "
                           f"{n} != actual backlog {actual}")
        return out

    def deficit_bound_violations(self) -> list[str]:
        """DRR fairness bound: 0 <= deficit <= BLOCK_SIZE + quantum × weight.

        A queue is credited quantum × weight per turn and serves whole
        blocks (each ≤ BLOCK_SIZE) against the credit, so the counter can
        never exceed one un-served head (< BLOCK_SIZE) plus one fresh
        credit.  ``repro.testing`` asserts this after a soak.
        """
        out = []
        # torch-lint: allow(det-dict-iter): diagnostic list order only
        for (pd, cls), q in self.queues.items():
            hi = A.BLOCK_SIZE + self.quantum * q.weight
            if not (0.0 <= q.deficit <= hi):
                out.append(
                    f"node {self.node.node_id} pd={pd} {cls.value}: "
                    f"deficit {q.deficit} outside [0, {hi}]")
        return out
