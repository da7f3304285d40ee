"""Declarative fabric configuration (replaces the ``RDMAEngine`` kwargs blob).

A :class:`FabricConfig` fully describes a simulated ExaNeSt fabric:
interconnect topology (nodes, :class:`~repro_torch.net.topology.TopologyKind`,
dims), hardware behaviour (HUPCF, fault model, frame pool), the
calibrated cost model, and fault-handling policy at three scopes —
fabric-wide default, per node, and (via
:meth:`~repro_torch.api.fabric.Fabric.open_domain`) per protection domain.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.errors import ConfigError
from repro_torch.core.addresses import BLOCK_SIZE, PAGES_PER_BLOCK, TR_ID_SPACE
from repro_torch.core.arbiter import DEFAULT_PLDMA_SLOTS
from repro_torch.core.costmodel import CostModel, DEFAULT_COST_MODEL
from repro_torch.core.fault import FaultModel
from repro_torch.net.topology import TopologyKind, coerce_kind
from repro_torch.api.policy import FaultPolicy


@dataclasses.dataclass
class FabricConfig:
    """Everything needed to build a :class:`~repro_torch.api.fabric.Fabric`.

    * ``n_nodes`` / ``topology`` / ``dims`` — the interconnect: a
      :class:`~repro_torch.net.topology.TopologyKind` (or its string name:
      ``"all_to_all"``, ``"ring"``, ``"mesh_2d"``, ``"torus_2d"``,
      ``"dragonfly"``) plus its dimensions (rows × cols for grids,
      n_groups × group_size for dragonfly).  Routed topologies share
      physical links: traffic between different node pairs contends for
      wire time on every common hop of its deterministic dimension-order
      route (:mod:`repro_torch.net`).
    * ``hops`` — **back-compat alias for ALL_TO_ALL only**: the seed's
      flat distance scalar, scaling every dedicated direct link to
      ``hops`` network hops (loopback stays one hop).  Rejected on
      routed topologies, where distance comes from the route.
    * ``link_qos`` — extend the DMA arbiter's service classes to the
      wire: LATENCY-class packets overtake BULK backlogs on congested
      links.  ``None`` (default) = on for routed topologies, off for
      ALL_TO_ALL (preserving the seed's dedicated-link timing exactly).
    * ``cost`` — the calibrated :class:`~repro_torch.core.costmodel.CostModel`
      (``None`` = thesis defaults).
    * ``hupcf`` — SMMU Hit-Under-Previous-Context-Fault: translate
      resident pages while a fault is outstanding (§3.2.1).
    * ``fault_model`` — TERMINATE (the prototype) or STALL.
    * ``frames_per_node`` — physical frame pool per node.
    * ``default_policy`` — fabric-wide fault policy; per-node overrides in
      ``node_policies`` (node index -> policy); per-domain overrides are
      given to ``Fabric.open_domain``.
    * ``pldma_slots`` — PLDMA occupancy per node: blocks streaming (or
      awaiting their ACK) at once, shared by ALL tenants and arbitrated by
      the fault-aware :class:`~repro_torch.core.arbiter.DMAArbiter` (default 2,
      the hardware's outstanding-block window).
    * ``arb_quantum_bytes`` — deficit-round-robin quantum of that arbiter
      (default one 16 KB block).
    * ``tr_id_space`` — size of each node's transaction-ID pool (default
      ``None`` = the hardware's full 2^14, Table 3.2).  A *host-side*
      scale-model knob: shrinking it makes ID exhaustion and recycling
      reachable in seconds for tests, while the wire encoding stays
      bit-exact (every allocated ID still fits the 14-bit field).
    * ``mtt_entries`` / ``dma_pool_frames`` / ``speculation`` — the
      NP-RDMA backend (``repro_torch.npr``, selected per domain via
      ``FaultPolicy(strategy=Strategy.NP_RDMA)``): memory-translation-
      table capacity, pre-registered DMA-able pool frames per node, and
      whether transfers launch speculatively on cached translations
      (``False`` = bounce-buffer mode: every block lands in the pool).
    * ``bank_overcommit`` / ``srq_entries`` / ``srq_gold_reserve`` /
      ``tenants_per_node`` — the tenancy control plane
      (``repro_torch.tenancy``): virtualize the 16 SMMU context banks with
      LRU bank stealing (``False`` restores the seed's hard
      ``BankCollision`` ceiling), bound the per-node shared receive
      queue (``None`` = unbounded; ``srq_gold_reserve`` entries usable
      only by GOLD tenants), and cap tenants admitted per node
      (``Fabric.open_domain`` raises ``TenantQuotaExceeded`` beyond it).
    * ``crash_detect_retries`` — consecutive R5 timeout rounds against a
      dead/unreachable peer before the transfer is declared failed with
      ``WCStatus.REMOTE_OP_ERR`` (crash *detection* is distinct from the
      page-fault retry budget ``FaultPolicy.max_retries``: a live peer
      that keeps faulting exhausts the budget; a dead peer trips this).
    * ``lease_timeout_us`` — tr_id lease on a crashed node: transaction
      IDs orphaned by ``Node.crash()`` (blocks that were in flight *from*
      the dead node) are reclaimed into the free list this long after the
      crash, preserving the PR-5 free-list/generation invariants without
      ever aliasing an ID a late wire packet could still name.
    * ``race_check`` — run the event loop under the same-timestamp race
      sanitizer (:class:`repro_torch.lint.race.RaceCheckLoop`): events firing
      at one virtual timestamp with overlapping read/write footprints
      are reported (their tie order is load-bearing).  Observation only
      — stats stay byte-identical.  Also enabled by the
      ``REPRO_RACE_CHECK`` environment variable.
    * ``shards`` — partition the fabric's nodes into this many per-shard
      event wheels merged under conservative lookahead (= the minimum
      routed link latency); see :mod:`repro_torch.core.shards`.  ``1``
      (default) = the single global wheel.  Results are byte-identical
      either way; sharding bounds per-queue size on 1000+-node fabrics
      and is the scaffold for parallel execution.  Mutually exclusive
      with ``race_check`` (the sanitizer wraps the single-queue loop).
    """

    n_nodes: int = 2
    hops: int = 1
    topology: Union[TopologyKind, str] = TopologyKind.ALL_TO_ALL
    dims: Optional[tuple] = None
    link_qos: Optional[bool] = None
    cost: Optional[CostModel] = None
    hupcf: bool = True
    fault_model: FaultModel = FaultModel.TERMINATE
    frames_per_node: int = 1 << 20
    default_policy: FaultPolicy = dataclasses.field(default_factory=FaultPolicy)
    node_policies: dict = dataclasses.field(default_factory=dict)
    pldma_slots: int = DEFAULT_PLDMA_SLOTS
    arb_quantum_bytes: int = BLOCK_SIZE
    tr_id_space: Optional[int] = None
    mtt_entries: int = 4096
    dma_pool_frames: int = 64
    speculation: bool = True
    bank_overcommit: bool = True
    srq_entries: Optional[int] = None
    srq_gold_reserve: int = 0
    tenants_per_node: Optional[int] = None
    crash_detect_retries: int = 3
    lease_timeout_us: float = 10_000.0
    race_check: bool = False
    shards: int = 1

    def __post_init__(self) -> None:
        if self.n_nodes < 1:
            raise ConfigError(f"n_nodes must be >= 1, got {self.n_nodes}")
        if self.shards < 1:
            raise ConfigError(f"shards must be >= 1, got {self.shards}")
        if self.shards > self.n_nodes:
            raise ConfigError(
                f"shards={self.shards} exceeds n_nodes={self.n_nodes}: "
                f"every shard must own at least one node")
        if self.shards > 1 and self.race_check:
            raise ConfigError(
                "shards > 1 is mutually exclusive with race_check: the "
                "race sanitizer wraps the single-queue event loop")
        if self.pldma_slots < 1:
            raise ConfigError(
                f"pldma_slots must be >= 1, got {self.pldma_slots}")
        if self.tr_id_space is not None \
                and not 1 <= self.tr_id_space <= TR_ID_SPACE:
            raise ConfigError(
                f"tr_id_space must be in [1, {TR_ID_SPACE}] (the 14-bit "
                f"tr_ID wire field), got {self.tr_id_space}")
        if self.mtt_entries < 1:
            raise ConfigError(
                f"mtt_entries must be >= 1, got {self.mtt_entries}")
        if self.dma_pool_frames < PAGES_PER_BLOCK:
            raise ConfigError(
                f"dma_pool_frames must be >= {PAGES_PER_BLOCK} (one 16 KB "
                f"block of 4 KB pages, or a redirected block could never "
                f"reserve its landing frames), got {self.dma_pool_frames}")
        if self.srq_entries is not None and self.srq_entries < 1:
            raise ConfigError(
                f"srq_entries must be >= 1 (or None = unbounded), got "
                f"{self.srq_entries}")
        if self.srq_gold_reserve < 0:
            raise ConfigError(
                f"srq_gold_reserve must be >= 0, got "
                f"{self.srq_gold_reserve}")
        if (self.srq_entries is not None
                and self.srq_gold_reserve > self.srq_entries):
            raise ConfigError(
                f"srq_gold_reserve={self.srq_gold_reserve} exceeds "
                f"srq_entries={self.srq_entries}")
        if self.tenants_per_node is not None and self.tenants_per_node < 1:
            raise ConfigError(
                f"tenants_per_node must be >= 1 (or None = unbounded), "
                f"got {self.tenants_per_node}")
        if self.crash_detect_retries < 1:
            raise ConfigError(
                f"crash_detect_retries must be >= 1, got "
                f"{self.crash_detect_retries}")
        if self.lease_timeout_us <= 0:
            raise ConfigError(
                f"lease_timeout_us must be > 0, got {self.lease_timeout_us}")
        self.topology = coerce_kind(self.topology)
        if self.hops < 1:
            raise ConfigError(f"hops must be >= 1, got {self.hops}")
        if self.hops != 1 and self.topology is not TopologyKind.ALL_TO_ALL:
            raise ConfigError(
                f"hops={self.hops} is the ALL_TO_ALL back-compat alias; "
                f"on topology={self.topology.value} distance comes from "
                f"the routed hop path — drop hops= or choose dims")
        if self.dims is not None:
            self.dims = tuple(self.dims)
        if self.cost is None:
            self.cost = DEFAULT_COST_MODEL

    def policy_for_node(self, node_idx: int) -> FaultPolicy:
        return self.node_policies.get(node_idx, self.default_policy)
