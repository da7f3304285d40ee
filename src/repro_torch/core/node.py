"""One ExaNeSt computing node: A53s + SMMU + fault FIFO + R5 + PLDMA.

Event-driven model of the full thesis mechanism:

* **Send path** (§1.3.2.1, §3.2.2): the R5 segments transfers into 16 KB
  blocks (window of 2 outstanding per transfer); the PLDMA translates source
  pages through the local SMMU as it packetizes — a source fault *pauses*
  the block after streaming the pages already translated; recovery is by
  timeout only (the prototype has no explicit source-side resume).
* **Receive path** (§3.2.3): destination pages are translated as packets
  arrive; the first faulting page of a block NACKs the block (AXI slave
  error), every NACKed packet is logged in the 512×128 b fault FIFO (with
  the hardware consecutive-dedup), and the remaining packets of the failed
  block are dropped.  The sender R5 *pauses* the transaction instead of
  instantly retransmitting (the thesis' firmware change).
* **Driver** (§3.2.1, §3.2.3.2): the ``arm_smmu_context_fault`` handler reads
  FSR/FAR/FSYNR on the driver CPU, clears the fault, and schedules the
  ``pf_send_handler`` / ``pf_rcv_tasklet`` tasklet by the WNR bit.  The
  receive tasklet drains the FIFO, skips entries already handled (the
  last-two-transactions cache that absorbs interleaving duplicates) and
  resolves faults via the configured strategy; for destination faults it
  fires the RAPF retransmit request at the initiator's mailbox.
* **Retransmission** (§3.2.3.3): R5 retransmits on RAPF (validating seq_num
  and the packetizer-wired PDID) or on timeout (1 ms default).
* **tr_ID lifecycle** (Table 3.2): the wire carries 14-bit transaction IDs,
  so once a node has launched 2^14 blocks, ID reuse is a *protocol
  property*.  The R5 allocates tr_IDs from a free list tied to its
  ``pending`` set — fresh IDs first, then IDs recycled **only on block
  completion** — so a still-paused block can never be aliased by a later
  launch.  Each allocation bumps a host-side *generation* tag (never on the
  wire; the 128-bit FIFO entry and the RAPF mailbox words stay bit-exact):
  RAPF matching, driver dedup and fault attribution all compare generations,
  so stale control traffic for a previous incarnation of an ID is dropped
  instead of retransmitting (or skipping) the wrong block.  When all 16K IDs
  are in flight the launch is deferred (FIFO) until a completion frees one;
  the posting verbs surface the same condition as typed backpressure
  (``repro_torch.api.TrIdExhausted``).
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import TYPE_CHECKING, Callable, Optional

from repro_torch.core import addresses as A
from repro_torch.core.addresses import (NetlinkMessage, RAPFMessage, iova_field_pack,
                                  iova_field_unpack, split_blocks)
from repro_torch.core.arbiter import DEFAULT_PLDMA_SLOTS, DMAArbiter, ServiceClass
from repro_torch.core.costmodel import CostModel
from repro_torch.core.fault import (SCTLR_HUPCF, SMMU, Access, Disposition,
                              FaultModel)
from repro_torch.core.fault_fifo import FaultFIFO, FIFOEntry
from repro_torch.core.pagetable import FrameAllocator, PageTable
from repro_torch.core.resolver import DriverDedupCache, Resolver, Strategy
from repro_torch.core.simulator import EventLoop, Resource
# runtime import of the bottom layer is safe: repro_torch.net.router imports
# only repro_torch.net.topology, never repro_torch.core
from repro_torch.net.router import NetworkPartitioned
from repro_torch.tenancy import TenancyManager
from repro_torch.tenancy.slo import SLOClass

if TYPE_CHECKING:                                    # pragma: no cover
    # type-only: importing repro_torch.net at runtime here would make the two
    # packages circularly dependent (net is the lower layer)
    from repro_torch.net.interconnect import Interconnect
    from repro_torch.net.link import Path


# The typed error hierarchy lives in the dependency-free repro_torch.errors
# (so repro_torch.tenancy / repro_torch.api can raise it without importing this
# module); re-exported here because these names were born here and the
# API layer + tests import them from repro_torch.core.node.
from repro_torch.errors import (BankCollision, DomainClosed,  # noqa: F401
                          DomainExists, FabricError, NodeDown)


class BlockState(enum.Enum):
    PENDING = 0
    IN_FLIGHT = 1
    PAUSED_SRC = 2    # source translation fault: waiting for timeout
    PAUSED_DST = 3    # PF-NACK received: waiting for RAPF or timeout
    DONE = 4


@dataclasses.dataclass
class TrIdStats:
    """Host-side telemetry of one node's 14-bit tr_ID lifecycle.

    ``space`` is the ID-space size (2^14 on hardware; tests may shrink it
    via ``FabricConfig.tr_id_space`` to exercise wraps cheaply — the wire
    encoding is unaffected, every ID always fits the 14-bit field).
    """

    space: int = A.TR_ID_SPACE
    allocated: int = 0           # total allocations (fresh + recycled)
    fresh: int = 0               # allocations from the never-used range
    recycled: int = 0            # allocations from the completion free list
    stalls: int = 0              # launches deferred: every ID in flight
    exhausted_posts: int = 0     # posts refused with TrIdExhausted
    in_flight: int = 0           # IDs currently owned by pending blocks
    max_in_flight: int = 0       # high-water mark of the above
    stale_rapf_drops: int = 0    # RAPFs for a previous incarnation dropped
    stale_fifo_entries: int = 0  # FIFO entries outliving their incarnation
    stale_npr_aborts: int = 0    # NP-RDMA aborts for a dead incarnation/round
    lease_reclaims: int = 0      # crash-orphaned IDs reclaimed at lease expiry

    @property
    def wraps(self) -> int:
        """Times the ID space has been fully consumed (>=1 once recycled
        IDs are in play, the regime the scale soak must survive)."""
        return self.allocated // self.space

    def as_dict(self) -> dict:
        return {
            "allocated": self.allocated, "fresh": self.fresh,
            "recycled": self.recycled, "stalls": self.stalls,
            "exhausted_posts": self.exhausted_posts,
            "max_in_flight": self.max_in_flight, "wraps": self.wraps,
            "stale_rapf_drops": self.stale_rapf_drops,
            "stale_fifo_entries": self.stale_fifo_entries,
            "stale_npr_aborts": self.stale_npr_aborts,
            "lease_reclaims": self.lease_reclaims,
        }


@dataclasses.dataclass(slots=True)
class TransferStats:
    t_submit: float = 0.0
    t_complete: float = -1.0
    timeouts: int = 0
    phantom_timeouts: int = 0    # of those, rounds with zero bytes on wire
    rapf_retransmits: int = 0
    retransmissions: int = 0
    src_faults: int = 0
    dst_faults: int = 0
    netlink_msgs: int = 0
    driver_us: float = 0.0       # kernel time: interrupt handler + tasklets
    user_us: float = 0.0         # library-thread time
    fifo_entries_handled: int = 0
    fifo_entries_skipped: int = 0
    segfaults_recovered: int = 0
    major_faults: int = 0
    # NP-RDMA backend (repro_torch.npr) — zero for thesis-datapath transfers
    mtt_hits: int = 0
    mtt_misses: int = 0
    mtt_stale: int = 0
    npr_aborts: int = 0
    pool_redirect_pages: int = 0

    @property
    def latency_us(self) -> float:
        return self.t_complete - self.t_submit


class Block:
    __slots__ = ("transfer", "index", "src_va", "dst_va", "nbytes", "tr_id",
                 "gen", "seq_num", "state", "attempts", "round_id",
                 "delivered", "nacked_round", "timeout_event", "n_pages",
                 "wire_bytes", "service_class", "queued", "holds_slot",
                 "grant_pending", "is_retransmit", "npr_redirect",
                 "retries", "dead_rounds")

    def __init__(self, transfer: "Transfer", index: int, src_va: int,
                 dst_va: int, nbytes: int):
        self.transfer = transfer
        self.index = index
        self.src_va = src_va
        self.dst_va = dst_va
        self.nbytes = nbytes
        self.tr_id = -1
        self.gen = 0                 # host-side incarnation tag of tr_id
        self.seq_num = index & A.SEQ_NUM_MASK
        self.state = BlockState.PENDING
        self.attempts = 0
        self.round_id = 0
        self.delivered: set[int] = set()
        self.nacked_round = -1       # round for which a PF-NACK was sent
        self.timeout_event = None
        self.n_pages = A.num_pages(dst_va, nbytes)
        self.wire_bytes = 0          # bytes streamed in the current round
        # DMA-arbiter state (repro_torch.core.arbiter)
        self.service_class: Optional[ServiceClass] = None
        self.queued = False          # sitting in an arbiter send queue
        self.holds_slot = False      # occupying a PLDMA slot
        self.grant_pending = False   # slot granted, _dispatch not yet run
        self.is_retransmit = False
        # NP-RDMA: an abort redirected this block into the DMA pool
        self.npr_redirect = False
        # crash-fault layer: retransmissions charged against the domain's
        # retry budget, and consecutive timeout rounds against a peer
        # that looks dead (crashed or unreachable)
        self.retries = 0
        self.dead_rounds = 0


class Transfer:
    # hot state: every page arrival and every ACK chases attributes on
    # this object, so it is slotted like Block — no per-instance dict
    __slots__ = ("tid", "pd", "service_class", "src_node", "dst_node",
                 "src_va", "dst_va", "nbytes", "on_complete", "stats",
                 "failed_status", "origin_id", "srq_held", "srq_node",
                 "blocks", "next_block", "done_blocks", "live_blocks")

    def __init__(self, tid: int, pd: int, src_node: "Node", dst_node: "Node",
                 src_va: int, dst_va: int, nbytes: int,
                 on_complete: Optional[Callable[["Transfer"], None]] = None,
                 service_class: Optional[ServiceClass] = None):
        self.tid = tid
        self.pd = pd
        # per-transfer arbiter class override (None -> the domain's class)
        self.service_class = service_class
        self.src_node = src_node
        self.dst_node = dst_node
        self.src_va = src_va
        self.dst_va = dst_va
        self.nbytes = nbytes
        self.on_complete = on_complete
        self.stats = TransferStats()
        # crash-fault layer: the terminal error, as a WCStatus *value*
        # string ("retry_exc_err"/"wr_flush_err"/"remote_op_err") — core
        # must not import repro_torch.api, so the enum mapping happens in the
        # fabric's completion tracker.  None = not failed.
        self.failed_status: Optional[str] = None
        # node the WR was posted from (set by the posting verbs; None for
        # direct engine use, where src_node is the origin) — picks
        # WR_FLUSH_ERR vs REMOTE_OP_ERR when a node crashes mid-transfer
        self.origin_id: Optional[int] = None
        # SRQ receive entries held on the destination node (repro_torch.tenancy):
        # acquired at post time, released when the completion fires
        self.srq_held = 0
        self.srq_node = -1
        # R5 16 KB-aligned segmentation; src/dst assumed equally page-aligned.
        self.blocks = [Block(self, i, sva, dst_va + (sva - src_va), n)
                       for i, (sva, n) in enumerate(split_blocks(src_va, nbytes))]
        self.next_block = 0
        self.done_blocks = 0
        # blocks currently IN_FLIGHT or PAUSED_* — the O(1) form of the
        # per-page "is another block of this transfer live on the wire"
        # interleave check (previously an O(n_blocks) scan per page)
        self.live_blocks = 0

    @property
    def complete(self) -> bool:
        return self.done_blocks == len(self.blocks)


class Node:
    def __init__(self, loop: EventLoop, cost: CostModel, node_id: int,
                 resolver: Resolver, allocator: Optional[FrameAllocator] = None,
                 hupcf: bool = True,
                 fault_model: FaultModel = FaultModel.TERMINATE,
                 pldma_slots: int = DEFAULT_PLDMA_SLOTS,
                 arb_quantum_bytes: int = A.BLOCK_SIZE,
                 tr_id_space: Optional[int] = None,
                 mtt_entries: int = 4096,
                 dma_pool_frames: int = 64,
                 speculation: bool = True,
                 bank_overcommit: bool = True,
                 srq_entries: Optional[int] = None,
                 srq_gold_reserve: int = 0,
                 tenants_per_node: Optional[int] = None,
                 crash_detect_retries: int = 3,
                 lease_timeout_us: float = 10_000.0):
        self.loop = loop
        self.cost = cost
        self.node_id = node_id
        self.resolver = resolver                 # node-default policy
        self.domain_resolvers: dict[int, Resolver] = {}   # per-PDID override
        self.allocator = allocator or FrameAllocator()
        self.page_tables: dict[int, PageTable] = {}
        self.smmu = SMMU(node_id, interrupt_handler=self._on_smmu_interrupt)
        self.fifo = FaultFIFO()
        self.driver_cpu = Resource(loop, f"n{node_id}.cpu0")   # IRQs+tasklets
        self.user_cpu = Resource(loop, f"n{node_id}.cpu2")     # library thread
        self.hupcf = hupcf
        self.fault_model = fault_model
        self.r5 = R5Scheduler(self, tr_id_space=tr_id_space)
        self.arbiter = DMAArbiter(self, slots=pldma_slots,
                                  quantum_bytes=arb_quantum_bytes)
        # driver last-2-transactions dedup cache (§ Fig 4.2 discussion),
        # generation-aware so recycled tr_IDs can't alias fresh faults
        self._handled = DriverDedupCache()
        self._rcv_tasklet_pending = False
        # engine wiring: the routed interconnect every transmit path —
        # data pages AND control packets — travels through
        self.interconnect: Optional[Interconnect] = None
        self.peer: dict[int, "Node"] = {}
        # NP-RDMA backend (competing datapath; engages only for domains
        # whose FaultPolicy selects Strategy.NP_RDMA).  Function-level
        # import: repro_torch.npr.engine imports this module at its top level.
        from repro_torch.npr.engine import NPREngine
        self.npr = NPREngine(self, mtt_entries=mtt_entries,
                             dma_pool_frames=dma_pool_frames,
                             speculation=speculation)
        # tenancy control plane: context-bank virtualization + SRQ/QP
        # multiplexing + per-node tenant admission (repro_torch.tenancy)
        self.bank_overcommit = bank_overcommit
        self.tenancy = TenancyManager(
            srq_entries=srq_entries, srq_gold_reserve=srq_gold_reserve,
            tenants_per_node=tenants_per_node)
        # crash-fault layer (fail-stop machine-failure model)
        self.crashed = False
        self.crash_detect_retries = crash_detect_retries
        self.lease_timeout_us = lease_timeout_us
        # per-domain retry budgets: pd -> (max_retries, retry_backoff)
        self.retry_budgets: dict[int, tuple[Optional[int], float]] = {}
        # hot-path cache of the BankManager's per-domain handle: a bound
        # domain's bank is one dict probe away (see bank_of_pd); a steal
        # nulls the victim handle's bank, so entries self-invalidate
        self._bank_dom: dict[int, object] = {}
        # stable references to the per-page-hot containers (both dicts
        # are mutated in place, never rebound) — saves two attribute
        # chains per received page
        self._npr_domains = self.npr.domains
        self._banks = self.tenancy.banks
        # demo/bench hook: blocks by (pd, src vpn) for source-fault attribution
        self.netlink_log: list[NetlinkMessage] = []

    # ------------------------------------------------------------- domains
    def create_domain(self, pd: int, pin_limit_bytes: Optional[int] = None,
                      resolver: Optional[Resolver] = None,
                      service_class: Optional[ServiceClass] = None,
                      arb_weight: int = 1,
                      max_outstanding_blocks: Optional[int] = None,
                      slo: Optional[SLOClass] = None,
                      max_retries: Optional[int] = None,
                      retry_backoff: float = 1.0
                      ) -> PageTable:
        """Create protection domain ``pd``, optionally with its own fault
        resolver (per-domain :class:`~repro_torch.api.policy.FaultPolicy`),
        DMA-arbiter parameters (service class, DRR weight, block quota)
        and SLO class (GOLD banks are steal-immune).

        With bank overcommit (the default) the BankManager binds the
        domain to a free context bank eagerly when one exists — byte
        identical to the seed's ``pd % 16`` for workloads that fit —
        and otherwise defers binding to first SMMU use, where an LRU
        bank steal (shootdown + rebind, cost-modeled) makes room.
        With ``bank_overcommit=False`` the seed's hard ceiling applies:
        a ``pd % NUM_CONTEXT_BANKS`` clash raises :class:`BankCollision`.
        """
        if pd in self.page_tables:
            raise DomainExists(
                f"pd={pd} already live on node {self.node_id}")
        if not self.bank_overcommit:
            bank = pd % A.NUM_CONTEXT_BANKS
            owner = self.pd_for_bank(bank)
            if owner is not None and owner != pd:
                raise BankCollision(
                    f"pd={pd} maps to SMMU context bank {bank}, already "
                    f"live for domain pd={owner} on node {self.node_id} "
                    f"(bank = pd % {A.NUM_CONTEXT_BANKS}); only "
                    f"{A.NUM_CONTEXT_BANKS} concurrent domains fit one "
                    f"node with bank_overcommit=False")
        # admission control: per-node tenant cap + the GOLD-bank ceiling
        self.tenancy.register(pd, slo)
        pt = PageTable(pd, self.allocator, pin_limit_bytes=pin_limit_bytes)
        self.page_tables[pd] = pt
        if max_retries is not None or retry_backoff != 1.0:
            self.retry_budgets[pd] = (max_retries, retry_backoff)
        if resolver is not None:
            self.domain_resolvers[pd] = resolver
        if self.resolver_for(pd).strategy is Strategy.NP_RDMA:
            # the domain's traffic goes through the NP-RDMA datapath:
            # MTT-translated sends, verified receives, pool redirects
            self.npr.register_domain(pd, pt)
        self.arbiter.register_domain(
            pd, service_class=service_class, weight=arb_weight,
            max_outstanding_blocks=max_outstanding_blocks)
        bound = self.tenancy.banks.try_bind(pd)
        if bound is not None:
            self.smmu.attach_domain(bound, pt, hupcf=self.hupcf,
                                    fault_model=self.fault_model)
        return pt

    def release_domain(self, pd: int) -> int:
        """Tear down every per-domain resource (``Fabric.close_domain``):
        detach + shoot down the SMMU bank, drop NP-RDMA MTT entries,
        release all frames back to the shared pool, forget resolvers.
        Returns the number of frames released.
        """
        bank = self.tenancy.banks.bank_of(pd)
        if bank is not None:
            self.smmu.detach_domain(bank)
        self.tenancy.release(pd)
        self._bank_dom.pop(pd, None)
        self.npr.unregister_domain(pd)
        self.retry_budgets.pop(pd, None)
        self.domain_resolvers.pop(pd, None)
        pt = self.page_tables.pop(pd, None)
        return 0 if pt is None else pt.release_all()

    def bank_of_pd(self, pd: int) -> tuple[int, float]:
        """The physical context bank serving ``pd``, binding on demand.

        Returns ``(bank, penalty_us)``.  A hit costs nothing.  A lazy
        bind to a free bank charges the page-table rebind; a bank steal
        additionally charges the victim's full-TLB shootdown — both
        reserved on the driver CPU (they are SMMU driver work) and
        returned so the caller can delay the datapath by the same amount
        (the cost shows up in fault latency, not just CPU accounting).
        Stealing detaches the victim from the SMMU and invalidates the
        victim's NP-RDMA MTT entries: zero stale completions.
        """
        banks = self.tenancy.banks
        # fast path: a cached, still-bound domain handle costs one dict
        # probe plus the same LRU-touch + hit accounting bind() would do
        # — no lambda, no Binding allocation (this runs once per page)
        dom = self._bank_dom.get(pd)
        if dom is None:
            dom = banks.domain_handle(pd)
            if dom is not None:
                self._bank_dom[pd] = dom
        if dom is not None:
            bank = dom.bank
            if bank is not None:
                # BankManager.note_hit inlined (LRU touch + hit counter):
                # this is the once-per-page common case
                banks.stats.hits += 1
                tick = banks._tick + 1
                banks._tick = tick
                dom.last_use = tick
                return bank, 0.0
        tn = self.tenancy
        binding = tn.bind_bank(
            pd, fault_active=lambda b: self.smmu.banks[b].fault_active)
        if binding.hit:            # pragma: no cover - cache served above
            return binding.bank, 0.0
        penalty = self.cost.bank_rebind_us
        if binding.stolen:
            self.smmu.detach_domain(binding.bank)
            tn.banks.stats.shootdowns += 1
            penalty += self.cost.bank_shootdown_us
            if binding.victim_pd is not None:
                # the stolen domain's cached NIC translations must die
                # with the bank or a speculative NP-RDMA launch could
                # complete against a translation the SMMU no longer backs
                self.npr.invalidate_domain(binding.victim_pd)
        self.smmu.attach_domain(binding.bank, self.page_tables[pd],
                                hupcf=self.hupcf,
                                fault_model=self.fault_model)
        self.driver_cpu.reserve(penalty)
        return binding.bank, penalty

    def pt(self, pd: int) -> PageTable:
        return self.page_tables[pd]

    def resolver_for(self, pd: int) -> Resolver:
        """The fault resolver governing domain ``pd`` (policy > default)."""
        return self.domain_resolvers.get(pd, self.resolver)

    def max_retries_for(self, pd: int) -> Optional[int]:
        """Domain retry budget (``FaultPolicy.max_retries``; None = ∞)."""
        return self.retry_budgets.get(pd, (None, 1.0))[0]

    def retry_backoff_for(self, pd: int) -> float:
        """Domain timeout-backoff multiplier (1.0 = the flat 1 ms timer)."""
        return self.retry_budgets.get(pd, (None, 1.0))[1]

    # -------------------------------------------------------------- failure
    def crash(self) -> None:
        """Fail-stop machine failure, mid-whatever-was-happening.

        Takes every incident physical link down (peers' routes detour or
        partition), silences this node's receive/driver datapaths, and
        fails every transfer its R5 was executing: the initiating side
        gets error completions (``WR_FLUSH_ERR`` for work posted here,
        ``REMOTE_OP_ERR`` for remote reads posted against it) instead of
        eternal retransmission.  tr_IDs owned by the dead blocks stay
        leased until ``lease_timeout_us`` and only then rejoin the free
        list, so the PR-5 ID-lifecycle invariants survive the crash.
        Idempotent; there is no un-crash.
        """
        if self.crashed:
            return
        self.crashed = True
        if self.interconnect is not None:
            self.interconnect.fail_node(self.node_id)
        self.r5.on_local_crash()

    def pd_for_bank(self, bank_index: int) -> Optional[int]:
        """The PDID *currently bound to* an SMMU context bank.

        Fault records carry only the bank index; domain state (page
        tables, resolvers, pending blocks) is keyed by the full PDID, so
        the driver needs this reverse map.  O(1) via the BankManager's
        binding table — and under overcommit the answer changes over
        time, which is why the fault handler resolves the pd at
        fault-record-read time, not at tasklet time.
        """
        return self.tenancy.banks.pd_for_bank(bank_index)

    # ------------------------------------------------------------- network
    def path_to(self, node_id: int) -> Path:
        """The routed interconnect path from this node to ``node_id``."""
        return self.interconnect.path(self.node_id, node_id)

    # =================================================== SMMU driver (CPU0)
    def _on_smmu_interrupt(self, bank_index: int) -> None:
        """arm_smmu_context_fault — runs on the driver CPU."""
        c = self.cost
        _, end = self.driver_cpu.reserve(c.interrupt_us + c.handler_regs_us)
        self.loop.at(end, self._handler_body, bank_index)

    def _handler_body(self, bank_index: int) -> None:
        iova, wnr, is_tf = self.smmu.read_fault_record(bank_index)
        self.smmu.clear_fault(bank_index)
        if not is_tf:
            return  # permission faults: future work in the thesis
        vpn = iova >> 12
        c = self.cost
        if wnr:  # destination (write) fault -> pf_rcv_tasklet
            self._schedule_rcv_tasklet()
        else:    # source (read) fault -> pf_send_handler
            # resolve bank -> pd NOW: under bank overcommit the bank can
            # be stolen and rebound to another tenant during the tasklet
            # latency, and the tasklet must bill the *faulting* domain
            pd = self.pd_for_bank(bank_index)
            if pd is None:
                return  # bank stolen before the record was read
            _, end = self.driver_cpu.reserve(c.tasklet_latency_us)
            self.loop.at(end, self._pf_send_handler, pd, vpn)

    # ------------------------------------------------- source-fault tasklet
    def _pf_send_handler(self, pd: int, vpn: int) -> None:
        if self.crashed:
            return  # dead CPUs run no tasklets
        c = self.cost
        pt = self.page_tables.get(pd)
        if pt is None:
            return
        block = self.r5.find_block_by_src_page(pd, vpn)
        stats = block.transfer.stats if block else None
        remaining = A.PAGES_PER_BLOCK
        if block is not None:
            last_vpn = A.page_index(block.src_va + block.nbytes - 1)
            remaining = max(1, last_vpn - vpn + 1)
        res = self.resolver_for(pd).resolve(
            pt, vpn, is_dst=False, block_pages_remaining=remaining)
        _, kend = self.driver_cpu.reserve(res.kernel_us)
        if stats:
            stats.driver_us += c.tasklet_latency_us + res.kernel_us
            stats.netlink_msgs += 0 if res.rapf_from_kernel else 1
            stats.segfaults_recovered += res.segfault_recovered
            stats.major_faults += res.major
        if res.user_us > 0:
            # library thread touches the page; no RAPF for source faults
            self.loop.at(kend, self._user_thread_work, res.user_us, stats, None)
        # §3.2.2.1: also kick the receive tasklet, "just in case"
        self._schedule_rcv_tasklet()

    # ----------------------------------------------- destination tasklet
    def _schedule_rcv_tasklet(self) -> None:
        if self._rcv_tasklet_pending:
            return
        self._rcv_tasklet_pending = True
        _, end = self.driver_cpu.reserve(self.cost.tasklet_latency_us)
        self.loop.at(end, self._pf_rcv_tasklet)

    def _pf_rcv_tasklet(self) -> None:
        """Drain the fault FIFO; resolve + RAPF per new entry.

        The tasklet scans the FIFO to empty — with interleaved duplicate
        entries from the two outstanding blocks, "it takes more time to
        find a new page / set of pages to page-in during the handling"
        (Fig 4.2 discussion): every pop costs two 64-bit AXI-lite reads on
        the driver CPU before the entry can even be dedup-checked.
        """
        self._rcv_tasklet_pending = False
        if self.crashed:
            return  # dead CPUs run no tasklets
        c = self.cost
        backlog = len(self.fifo)
        if backlog:
            # the scan through the queued (mostly duplicate) entries is on
            # the critical path of every resolution in this invocation
            self.driver_cpu.reserve(2 * c.fifo_read64_us * backlog)
        while not self.fifo.empty:
            entry = self.fifo.pop_entry()
            if entry is None:
                break
            gen = self.fifo.last_popped_gen
            key = entry.vpage_key() + (gen,)
            src_node = self.peer.get(entry.src_id)
            stats = None
            if src_node is not None:
                # O(1) lookup; the generation tag rejects entries that
                # outlived their block (the tr_id has been recycled) so a
                # stale entry can't charge a new incarnation's stats
                blk = src_node.r5.pending.get(entry.tr_id)
                if blk is not None and (gen == 0 or blk.gen == gen):
                    stats = blk.transfer.stats
                elif gen:
                    src_node.r5.id_stats.stale_fifo_entries += 1
            _, vpn27 = iova_field_unpack(entry.iova_field)
            pt = self.page_tables.get(entry.pdid)
            if self._handled.seen(key) or (pt is not None
                                           and pt.is_resident(vpn27)):
                # last-2-transactions cache (absorbs interleaving dups) or a
                # page an earlier get_user_pages already brought in: skip.
                _, _ = self.driver_cpu.reserve(c.driver_bookkeep_us)
                if stats:
                    stats.fifo_entries_skipped += 1
                    stats.driver_us += 2 * c.fifo_read64_us + c.driver_bookkeep_us
                continue
            self._handled.note(key)
            if pt is None:
                continue
            res = self.resolver_for(entry.pdid).resolve(
                pt, vpn27, is_dst=True,
                block_pages_remaining=A.PAGES_PER_BLOCK)
            _, kend = self.driver_cpu.reserve(res.kernel_us + c.driver_bookkeep_us)
            if stats:
                stats.fifo_entries_handled += 1
                stats.driver_us += (2 * c.fifo_read64_us + c.driver_bookkeep_us
                                    + res.kernel_us)
                stats.netlink_msgs += 0 if res.rapf_from_kernel else 1
                stats.segfaults_recovered += res.segfault_recovered
                stats.major_faults += res.major
            rapf = RAPFMessage(wired_pdid=entry.pdid, rcved_pdid=entry.pdid,
                               tr_id=entry.tr_id, seq_num=entry.seq_num)
            if res.rapf_from_kernel:
                self.loop.at(kend, self._send_rapf, entry.src_id, rapf, stats,
                             gen)
            else:
                self.netlink_log.append(NetlinkMessage(
                    src_id=entry.src_id, tr_id=entry.tr_id,
                    seq_num=entry.seq_num, iova_field=entry.iova_field,
                    pdid=entry.pdid, rw=1))
                self.loop.at(kend, self._user_thread_work, res.user_us, stats,
                             (entry.src_id, rapf, gen))

    def _user_thread_work(self, duration: float, stats: Optional[TransferStats],
                          rapf: Optional[tuple[int, RAPFMessage, int]]) -> None:
        _, end = self.user_cpu.reserve(duration)
        if stats:
            stats.user_us += duration
        if rapf is not None:
            self.loop.at(end, self._send_rapf, rapf[0], rapf[1], stats,
                         rapf[2])

    def _send_rapf(self, src_node_id: int, msg: RAPFMessage,
                   stats: Optional[TransferStats], gen: int = 0) -> None:
        if self.crashed:
            return
        target = self.peer.get(src_node_id)
        if target is None:
            return
        delay = self.cost.pckzer_to_mbox_us
        if target is not self:
            # the RAPF retransmission request rides the interconnect to
            # the initiator's mailbox: charge (and, on shared-link
            # topologies, reserve) the full routed distance — the seed
            # charged one hop_latency_us however far the initiator was
            try:
                delay += self.path_to(src_node_id).send_ctrl(8)
            except NetworkPartitioned:
                return  # RAPF lost; the sender's timeout recovers
        self.loop.schedule(delay, target.r5.on_mailbox, msg, stats, gen)

    # ============================================================== receive
    def recv_page(self, block: Block, page_idx: int, round_id: int,
                  interleaved: bool, nbytes: int) -> None:
        """Arrival of one page worth of packets at the destination PLDMA.

        With HUPCF set (the thesis' experimental configuration) every page
        of an in-flight block is translated independently, so a multi-page
        block with a cold destination logs one FIFO entry *per faulty page*
        in the first round (plus packet-level duplicates when the two
        outstanding blocks interleave on the wire — the Fig 4.2 dampening
        effect).  Without HUPCF the SMMU terminates even resident pages
        while a fault is outstanding (collateral NACKs, §3.2.1).
        """
        if self.crashed:
            return  # packets delivered to a dead node vanish
        if block.state is BlockState.DONE or round_id != block.round_id:
            return  # stale packets from a superseded round
        transfer = block.transfer
        pd = transfer.pd
        if pd in self._npr_domains:         # inlined NPREngine.owns()
            # NP-RDMA domain: host-side verification instead of the SMMU
            # translate -> NACK -> fault-FIFO path
            self.npr.recv_page(block, page_idx, round_id, nbytes)
            return
        # two outstanding blocks streaming together -> their NACK packets
        # interleave and defeat the FIFO's consecutive-dedup (§ Fig 4.2).
        # live_blocks counts this transfer's IN_FLIGHT/PAUSED_* blocks —
        # including this one — so "any other live block" is a counter
        # compare instead of a per-page scan over every block.
        interleaved = interleaved or transfer.live_blocks > 1
        vpn = (block.dst_va >> 12) + page_idx   # A.page_index, inlined
        # bind-on-use: an overcommitted domain may have to steal a bank
        # here; the shootdown+rebind penalty delays this page's ACK/NACK
        # (it is SMMU driver work on the translation's critical path).
        # The bank_of_pd hit path is inlined — cached bound handle, LRU
        # touch, hit count, zero penalty — it runs once per page.
        dom = self._bank_dom.get(pd)
        if dom is not None and dom.bank is not None:
            bank = dom.bank
            banks = self._banks
            banks.stats.hits += 1
            tick = banks._tick + 1
            banks._tick = tick
            dom.last_use = tick
            penalty = 0.0
        else:
            bank, penalty = self.bank_of_pd(pd)
            if penalty:
                transfer.stats.driver_us += penalty
        # SMMU TLB-hit fast path inlined (once per received page):
        # resident, cached, and not gated by an outstanding fault —
        # stats identical to translate_disposition()'s hit branch
        smmu = self.smmu
        cbank = smmu.banks[bank]
        if ((not cbank.fsr or cbank.sctlr & SCTLR_HUPCF)
                and (bank << 32) | vpn in smmu._tlb):
            sst = smmu.stats
            sst.translations += 1
            sst.tlb_hits += 1
            ok = True
        else:
            ok = (smmu.translate_disposition(bank, vpn, Access.WRITE)
                  is Disposition.OK)
        if ok:
            delivered = block.delivered
            delivered.add(page_idx)
            if len(delivered) == block.n_pages:
                # the ACK travels back over the interconnect: charge the
                # routed distance (the seed charged one hop, flat)
                src_node = transfer.src_node
                try:
                    ctrl = self.path_to(src_node.node_id).send_ctrl(0)
                except NetworkPartitioned:
                    return  # ACK lost; the sender's timeout recovers
                delay = penalty + self.cost.ack_us + ctrl
                self.loop.schedule(delay, src_node.r5.on_ack,
                                   block, round_id)
            return
        # ---- destination fault: NACK + FIFO logging --------------------
        transfer.stats.dst_faults += 1
        entry = FIFOEntry(src_id=transfer.src_node.node_id,
                          tr_id=block.tr_id, seq_num=block.seq_num,
                          pdid=pd,
                          iova_field=iova_field_pack(0, vpn))
        # every NACKed packet logs; consecutive same-page packets collapse
        # in the FIFO's dedup, but wire interleaving between the two
        # outstanding blocks breaks the "same as last pushed" check.
        n_pushes = max(1, nbytes // A.MTU) if interleaved else 1
        for _ in range(n_pushes):
            pushed = self.fifo.push(entry, gen=block.gen)
            if not interleaved and not pushed:
                break
            if interleaved:
                # alternating streams: defeat the consecutive-dedup the way
                # real interleaved packets do
                self.fifo.break_dedup()
        if block.nacked_round != round_id:
            block.nacked_round = round_id
            # the PF-NACK (AXI slave error) propagates back per routed hop
            try:
                ctrl = (self.path_to(transfer.src_node.node_id)
                            .send_ctrl(0))
            except NetworkPartitioned:
                ctrl = None  # NACK lost; the sender's timeout recovers
            if ctrl is not None:
                delay = penalty + self.cost.nack_us + ctrl
                self.loop.schedule(delay,
                                   transfer.src_node.r5.on_nack,
                                   block, round_id)
        # the SMMU interrupt fired inside translate() if this was the first
        # outstanding fault; MULTI faults rely on the FIFO alone (§3.2.1) —
        # make sure a drain is queued either way.
        self._schedule_rcv_tasklet()


class R5Scheduler:
    """The Cortex-R5 firmware model (thesis §1.3.2 + §3.2.3.3).

    Owns the node's 14-bit tr_ID space: IDs are allocated fresh until the
    space has been fully issued once, then recycled from a free list fed
    **only by block completions** — a paused block keeps its ID until it
    is ACKed, so launching 2^14+ blocks can never alias ``pending``.
    Every allocation bumps the ID's host-side generation tag, the
    disambiguator RAPF matching and driver dedup use once IDs recycle.
    """

    def __init__(self, node: Node, tr_id_space: Optional[int] = None):
        self.node = node
        self.loop = node.loop
        self.cost = node.cost
        space = int(tr_id_space) if tr_id_space is not None else A.TR_ID_SPACE
        if not 1 <= space <= A.TR_ID_SPACE:
            raise ValueError(
                f"tr_id_space must be in [1, {A.TR_ID_SPACE}] (the 14-bit "
                f"wire field, Table 3.2), got {space}")
        self.tr_id_space = space
        self._fresh_next = 0                  # next never-issued ID
        self._free: deque[int] = deque()      # IDs recycled on completion
        self._gen: dict[int, int] = {}        # ID -> current generation
        self._starved: deque[Transfer] = deque()   # deferred launches
        self.pending: dict[int, Block] = {}   # tr_id -> block
        # per-(pd, src vpn) index over pending blocks, launch-ordered:
        # the O(1) replacement for the per-fault O(pending) scan in
        # find_block_by_src_page (maintained on launch/completion).
        # Keys are packed ints ``(pd << 32) | vpn`` — int hashing beats
        # tuple hashing on the per-block add/remove path, and vpns are
        # 27-bit (39-bit IOVA space), so the packing never collides.
        self._src_index: dict[int, list[Block]] = {}
        self.id_stats = TrIdStats(space=space)

    # ----------------------------------------------------------- tr_ID pool
    def tr_ids_free(self) -> int:
        """IDs available to new launches right now (fresh + recycled)."""
        return (self.tr_id_space - self._fresh_next) + len(self._free)

    def _alloc_tr_id(self) -> Optional[int]:
        """Allocate a tr_ID, or None when all are owned by pending blocks.

        Fresh IDs are issued in order first (bit-identical to the seed's
        counter below one wrap); after that, completions feed the FIFO
        free list.  The ID's generation is bumped on every allocation.
        """
        st = self.id_stats
        if self._fresh_next < self.tr_id_space:
            tid = self._fresh_next
            self._fresh_next += 1
            st.fresh += 1
        elif self._free:
            tid = self._free.popleft()
            st.recycled += 1
        else:
            return None
        self._gen[tid] = self._gen.get(tid, 0) + 1
        st.allocated += 1
        st.in_flight += 1
        if st.in_flight > st.max_in_flight:
            st.max_in_flight = st.in_flight
        return tid

    def _free_tr_id(self, tid: int) -> None:
        """Recycle a completed block's ID (the ONLY way IDs come back)."""
        self._free.append(tid)
        self.id_stats.in_flight -= 1

    # ------------------------------------------------------ src-fault index
    def _index_add(self, block: Block) -> None:
        base = block.transfer.pd << 32
        idx = self._src_index
        first = base | (block.src_va >> 12)
        last = base | ((block.src_va + block.nbytes - 1) >> 12)
        for key in range(first, last + 1):
            lst = idx.get(key)
            if lst is None:
                idx[key] = [block]
            else:
                lst.append(block)

    def _index_remove(self, block: Block) -> None:
        base = block.transfer.pd << 32
        idx = self._src_index
        first = base | (block.src_va >> 12)
        last = base | ((block.src_va + block.nbytes - 1) >> 12)
        for key in range(first, last + 1):
            lst = idx.get(key)
            if lst is not None:
                try:
                    lst.remove(block)
                except ValueError:          # pragma: no cover - defensive
                    pass
                if not lst:
                    del idx[key]

    # ---------------------------------------------------------------- user
    def submit(self, transfer: Transfer) -> None:
        # NOTE: quota accounting (arbiter.note_submit) happens at POST
        # time in repro_torch.api.fabric, not here — for remote reads this
        # method only runs after the request-packet delay, too late for
        # the posting verbs' backpressure check to see the work.
        transfer.stats.t_submit = self.loop.now
        if self.node.crashed:
            # work arriving at (or posted on) a dead executing node —
            # e.g. a remote read whose request packet was in flight when
            # the target died — flushes immediately
            self.fail_transfer(transfer, self._crash_status(transfer))
            return
        self.loop.schedule(self.cost.dma_setup_us, self._start, transfer)

    def _start(self, transfer: Transfer) -> None:
        if self.node.crashed:
            # crashed during DMA setup: the transfer had no pending
            # blocks yet, so on_local_crash could not have seen it
            self.fail_transfer(transfer, self._crash_status(transfer))
            return
        for _ in range(A.OUTSTANDING_BLOCKS_PER_TRANSFER):
            self._launch_next(transfer)

    def _launch_next(self, transfer: Transfer) -> None:
        if transfer.next_block >= len(transfer.blocks):
            return
        tid = self._alloc_tr_id()
        if tid is None:
            # every ID is owned by a pending block: defer this launch.
            # Each completion frees an ID and redeems one ticket (FIFO),
            # so deferred traffic drains in launch order.
            self.id_stats.stalls += 1
            self._starved.append(transfer)
            return
        block = transfer.blocks[transfer.next_block]
        transfer.next_block += 1
        block.tr_id = tid
        block.gen = self._gen[tid]
        self.pending[tid] = block
        self._index_add(block)
        # blocks no longer go straight to the PLDMA: the fault-aware
        # arbiter grants slots per service class / DRR across domains
        self.node.arbiter.enqueue(block)

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, block: Block, is_retransmit: bool) -> None:
        block.grant_pending = False
        if block.state is BlockState.DONE:
            return
        node = self.node
        transfer = block.transfer
        prev_wire_bytes = block.wire_bytes
        block.round_id += 1
        block.attempts += 1
        block.delivered.clear()
        block.wire_bytes = 0
        if block.state is BlockState.PENDING:
            transfer.live_blocks += 1
        block.state = BlockState.IN_FLIGHT
        if is_retransmit and prev_wire_bytes:
            # only rounds that put bytes on the wire are *re*-transmitted;
            # a re-dispatch after a PAUSED_SRC-at-first-page round (zero
            # bytes streamed) is this data's first transmission
            transfer.stats.retransmissions += 1

        pd = transfer.pd
        first_vpn = block.src_va >> 12
        src_pages = range(first_vpn,
                          ((block.src_va + block.nbytes - 1) >> 12) + 1)
        # PLDMA reads/packetizes pages in order; a source fault stops the
        # stream (pages already read remain in flight).
        try:
            path = node.path_to(transfer.dst_node.node_id)
        except NetworkPartitioned:
            # no live route this round: yield the slot and let the R5
            # timer run — the timeout path counts dead rounds toward
            # REMOTE_OP_ERR if the partition persists
            block.state = BlockState.PAUSED_SRC
            node.arbiter.on_block_paused(block)
            self._arm_timeout(block)
            return
        # the DMA arbiter's service class extends to link arbitration:
        # LATENCY blocks overtake BULK backlogs on congested shared hops
        latency_class = (block.service_class is not None
                         and block.service_class.wire_priority)
        if pd in node._npr_domains:         # inlined NPREngine.owns()
            # NP-RDMA domain: the engine translates through its MTT (and
            # fixes source misses up host-side) instead of the SMMU loop
            # below; the R5 timeout stays armed as the common backstop
            node.npr.dispatch(block, path, latency_class)
            self._arm_timeout(block)
            return
        # bind-on-use: an overcommitted domain claims (possibly steals) a
        # context bank before the PLDMA can translate its source pages —
        # the shootdown+rebind penalty offsets every page this round puts
        # on the wire, so the steal cost is visible end to end
        bank, bank_penalty = node.bank_of_pd(pd)
        if bank_penalty:
            transfer.stats.driver_us += bank_penalty
        # the per-page loop is the hottest code in the simulator: bind
        # every loop-invariant lookup once, accumulate wire_bytes locally
        src_va = block.src_va
        src_end = src_va + block.nbytes
        # stream key: (transfer, block-index) — unique among streams
        # that can coexist on a link, unlike id(block), which CPython
        # may reuse after a finished block is collected while its
        # link is still draining (aliasing the interleave detector)
        stream_key = (transfer.tid, block.index)
        recv = transfer.dst_node.recv_page
        schedule = self.loop.schedule
        round_id = block.round_id
        smmu = node.smmu
        cbank = smmu.banks[bank]
        sst = smmu.stats
        tlb = smmu._tlb
        bank_key = bank << 32
        translate = smmu.translate_disposition
        read = Access.READ
        ok = Disposition.OK
        stream = path.stream_page
        wire_bytes = 0
        for i, vpn in enumerate(src_pages):
            # SMMU TLB-hit fast path inlined (per source page): cached
            # and not gated by an outstanding fault — identical stats
            # to translate_disposition()'s hit branch
            if ((not cbank.fsr or cbank.sctlr & SCTLR_HUPCF)
                    and bank_key | vpn in tlb):
                sst.translations += 1
                sst.tlb_hits += 1
            elif translate(bank, vpn, read) is not ok:
                block.state = BlockState.PAUSED_SRC
                transfer.stats.src_faults += 1
                # deschedule-on-fault: the paused block yields its PLDMA
                # slot so other tenants' queued blocks keep streaming
                node.arbiter.on_block_paused(block)
                break
            pg_start = vpn << 12
            if src_va > pg_start:
                pg_start = src_va
            pg_end = (vpn + 1) << 12
            if src_end < pg_end:
                pg_end = src_end
            nbytes = pg_end - pg_start
            delay, interleaved = stream(nbytes, stream_key,
                                        latency_class=latency_class)
            wire_bytes += nbytes
            schedule(bank_penalty + delay, recv, block, i,
                     round_id, interleaved, nbytes)
        block.wire_bytes = wire_bytes
        self._arm_timeout(block)

    def _arm_timeout(self, block: Block) -> None:
        if block.timeout_event is not None:
            block.timeout_event.cancel()
        timeout = self.cost.timeout_us
        # hot path (every dispatch re-arms): probe the budget dict once
        # instead of building the (None, 1.0) default tuple per call
        budget = self.node.retry_budgets.get(block.transfer.pd)
        if budget is not None and budget[1] > 1.0 and block.retries:
            # exponential backoff per consecutive retransmission of this
            # block (FaultPolicy.retry_backoff; exponent capped so a long
            # retry tail cannot overflow the float timeline)
            timeout *= budget[1] ** min(block.retries, 16)
        block.timeout_event = self.loop.schedule(
            timeout, self._on_timeout, block, block.round_id)

    def _on_timeout(self, block: Block, round_id: int) -> None:
        if block.state is BlockState.DONE or round_id != block.round_id:
            return
        transfer = block.transfer
        stats = transfer.stats
        stats.timeouts += 1
        if block.wire_bytes == 0:
            # the round paused PAUSED_SRC before any packet left the node:
            # the R5 timer still fires (source-fault recovery is by timeout
            # only in the prototype) but nothing was on the wire to lose —
            # accounted separately so phantom rounds are subtractable
            stats.phantom_timeouts += 1
        node = self.node
        peer = transfer.dst_node
        if peer.crashed or (node.interconnect is not None
                            and node.interconnect.down
                            and not node.interconnect.reachable(
                                node.node_id, peer.node_id)):
            # the peer looks dead (fail-stop crash or persistent
            # partition): count the round instead of retransmitting into
            # the void; enough consecutive dead rounds fail the transfer
            block.dead_rounds += 1
            if block.dead_rounds >= node.crash_detect_retries:
                self.fail_transfer(transfer, "remote_op_err")
                return
            if block.state is BlockState.IN_FLIGHT:
                # don't retransmit into the void, and don't camp on a
                # PLDMA slot while waiting out the detection window
                block.state = BlockState.PAUSED_SRC
                node.arbiter.on_block_paused(block)
            self._arm_timeout(block)
            return
        block.dead_rounds = 0
        if not self._charge_retry(block):
            return  # budget exhausted: the transfer just failed
        # re-enter at the BACK of the block's class queue: a faulting
        # tenant's retransmits do not jump other tenants' fresh traffic
        self.node.arbiter.requeue(block)

    # -------------------------------------------------------- crash faults
    def _charge_retry(self, block: Block) -> bool:
        """Charge one retransmission against the domain's retry budget.

        Returns True if the retransmit may proceed; False when the budget
        is exhausted (the transfer just completed with RETRY_EXC_ERR).
        The budget counts every retransmission of a block — timeout- and
        RAPF-triggered alike — so a permanently-faulting peer page cannot
        spin the 1 ms timer forever when a budget is set.
        """
        block.retries += 1
        max_retries = self.node.max_retries_for(block.transfer.pd)
        if max_retries is not None and block.retries > max_retries:
            self.fail_transfer(block.transfer, "retry_exc_err")
            return False
        return True

    def _crash_status(self, transfer: Transfer) -> str:
        """WR_FLUSH_ERR for work posted *from* this (dead) node,
        REMOTE_OP_ERR for work another node posted against it."""
        origin = (transfer.origin_id if transfer.origin_id is not None
                  else transfer.src_node.node_id)
        return ("wr_flush_err" if origin == self.node.node_id
                else "remote_op_err")

    def fail_transfer(self, transfer: Transfer, status: str,
                      free_ids: bool = True) -> None:
        """Terminally fail a transfer's remaining blocks and deliver its
        (error) completion exactly once.

        Failed blocks go to ``DONE`` without ever counting toward
        ``done_blocks``, so ``transfer.complete`` stays False forever: a
        late ACK can neither double-complete the transfer nor resurrect
        it.  ``free_ids=False`` leaves the blocks' tr_IDs leased in
        ``pending`` (crash orphans, reclaimed by ``_reclaim_leases``).
        """
        if transfer.failed_status is not None or transfer.complete:
            return
        transfer.failed_status = status
        for block in transfer.blocks:
            if block.state is not BlockState.DONE:
                self._fail_block(block, free_ids=free_ids)
        transfer.next_block = len(transfer.blocks)
        if self._starved:
            self._starved = deque(t for t in self._starved
                                  if t is not transfer)
        self.node.arbiter.on_transfer_failed(transfer)
        transfer.stats.t_complete = (self.loop.now
                                     + self.cost.completion_poll_us)
        if transfer.on_complete is not None:
            self.loop.schedule(self.cost.completion_poll_us,
                               transfer.on_complete, transfer)

    def _fail_block(self, block: Block, free_ids: bool) -> None:
        if block.state is BlockState.DONE:
            # every caller filters DONE already; the explicit guard keeps
            # DONE terminal by construction (repro_torch.lint conformance)
            return
        if block.timeout_event is not None:
            block.timeout_event.cancel()
            block.timeout_event = None
        if block.state in (BlockState.IN_FLIGHT, BlockState.PAUSED_SRC,
                           BlockState.PAUSED_DST):
            block.transfer.live_blocks -= 1
        block.state = BlockState.DONE
        self.node.arbiter.purge(block)
        if block.tr_id >= 0 and free_ids \
                and self.pending.get(block.tr_id) is block:
            del self.pending[block.tr_id]
            self._index_remove(block)
            self._free_tr_id(block.tr_id)
        # free_ids=False: the ID stays leased in pending AND the source
        # index (the lifecycle invariant mirrors one from the other)
        # until _reclaim_leases retires both

    def on_local_crash(self) -> None:
        """Fail every live transfer this (now dead) R5 was executing.

        tr_IDs owned by the dead blocks are NOT recycled immediately: a
        late wire packet could still name them, so they stay leased in
        ``pending`` until ``lease_timeout_us`` elapses, then return to
        the free list (each next allocation bumping the generation tag,
        exactly as a completion-recycled ID would).
        """
        transfers = {b.transfer for b in self.pending.values()}
        transfers.update(self._starved)
        self._starved.clear()
        for t in sorted(transfers, key=lambda t: t.tid):
            self.fail_transfer(t, self._crash_status(t), free_ids=False)
        orphans = tuple(sorted(self.pending))
        if orphans:
            self.loop.schedule(self.node.lease_timeout_us,
                               self._reclaim_leases, orphans)

    def _reclaim_leases(self, orphans: tuple) -> None:
        """Lease expiry: orphaned tr_IDs rejoin the free list."""
        for tid in orphans:
            block = self.pending.pop(tid, None)
            if block is None:               # pragma: no cover - defensive
                continue
            self._index_remove(block)
            self._free_tr_id(tid)
            self.id_stats.lease_reclaims += 1

    # ------------------------------------------------------------- arrivals
    def on_ack(self, block: Block, round_id: int) -> None:
        if block.state is BlockState.DONE or round_id != block.round_id:
            return
        transfer = block.transfer
        block.state = BlockState.DONE
        transfer.live_blocks -= 1
        if block.timeout_event is not None:
            block.timeout_event.cancel()
        tid = block.tr_id
        if self.pending.pop(tid, None) is block:
            self._index_remove(block)
            self._free_tr_id(tid)           # recycle ONLY on completion
        self.node.arbiter.on_block_done(block)
        transfer.done_blocks += 1
        # the freed ID may unblock launches deferred at exhaustion; the
        # completing transfer's own next block takes its turn BEHIND any
        # already-deferred work, so deferral tickets really are redeemed
        # in launch order (no self-refill priority inversion)
        if self._starved:
            self._starved.append(transfer)
        else:
            self._launch_next(transfer)
        while self._starved and self.tr_ids_free() > 0:
            self._launch_next(self._starved.popleft())
        if transfer.done_blocks == len(transfer.blocks):   # == .complete
            transfer.stats.t_complete = (self.loop.now
                                         + self.cost.completion_poll_us)
            if transfer.on_complete is not None:
                # the user observes the completion when the PLDMA
                # status-register poll returns — fire the callback AT
                # t_complete, not completion_poll_us before it (which
                # handed callbacks a timestamp from the future)
                self.loop.schedule(self.cost.completion_poll_us,
                                   transfer.on_complete, transfer)

    def on_nack(self, block: Block, round_id: int) -> None:
        # thesis firmware change: pause instead of instant retransmit.
        # Only a block that streamed this round can be NACKed: IN_FLIGHT,
        # or PAUSED_SRC when a mid-block source fault trailed packets the
        # destination then faulted on.  The round check alone excludes
        # the other states dynamically (PENDING blocks are on round 0,
        # one NACK per nacked_round); stating it as a guard makes the
        # spec'd transitions explicit (repro_torch.lint conformance).
        if block.state not in (BlockState.IN_FLIGHT, BlockState.PAUSED_SRC) \
                or round_id != block.round_id:
            return
        block.dead_rounds = 0        # a NACK is proof the peer is alive
        block.state = BlockState.PAUSED_DST
        self.node.arbiter.on_block_paused(block)

    def on_mailbox(self, msg: RAPFMessage, stats: Optional[TransferStats],
                   gen: int = 0) -> None:
        if msg.opcode != A.OPCODE_RAPF:
            return
        self.loop.schedule(self.cost.mailbox_poll_us, self._rapf_body, msg,
                           stats, gen)

    def _rapf_body(self, msg: RAPFMessage, stats, gen: int = 0) -> None:
        block = self.pending.get(msg.tr_id)
        if block is None or block.state is BlockState.DONE:
            return
        if gen and block.gen != gen:
            # the tr_ID was recycled between the fault and this RAPF: the
            # request addresses a finished incarnation, not this block —
            # without the generation check a wrapped seq_num could force
            # a spurious retransmit of (or steal the timeout of) a
            # brand-new block that inherited the ID
            self.id_stats.stale_rapf_drops += 1
            return
        if msg.seq_num != (block.seq_num & 0xFFF):
            return  # stale/forged: dropped, as in the firmware listing
        if msg.wired_pdid != block.transfer.pd:
            return  # security check: wired PDID mismatch
        block.transfer.stats.rapf_retransmits += 1
        block.dead_rounds = 0        # an RAPF is proof the peer is alive
        if block.timeout_event is not None:
            block.timeout_event.cancel()
        if not self._charge_retry(block):
            return  # retry budget exhausted: RETRY_EXC_ERR just fired
        self.node.arbiter.requeue(block)

    def on_npr_abort(self, tr_id: int, gen: int, round_id: int) -> None:
        """NP-RDMA abort-and-redirect request from the destination host.

        Validated exactly like a RAPF: the (generation, round) pair must
        match the live incarnation of the tr_ID — an abort that raced a
        completion (or a recycled ID) is dropped, not acted on, so it can
        never redirect a block it was not issued against.
        """
        block = self.pending.get(tr_id)
        if block is None or block.state is BlockState.DONE:
            return
        if (gen and block.gen != gen) or round_id != block.round_id:
            self.id_stats.stale_npr_aborts += 1
            return
        block.npr_redirect = True
        if block.timeout_event is not None:
            block.timeout_event.cancel()
        self.node.arbiter.requeue(block)

    # ----------------------------------------------------------- utilities
    def find_block_by_src_page(self, pd: int, vpn: int) -> Optional[Block]:
        """Earliest-launched pending block covering source page ``vpn``.

        O(1) via the per-(pd, vpn) index — the seed scanned every pending
        block per source fault, O(pending) on the driver's critical path.
        """
        lst = self._src_index.get((pd << 32) | vpn)
        return lst[0] if lst else None
