"""Verbs-style asynchronous API for virtual-address RDMA with page faults.

This package is the public face of the reproduction: real-RDMA verbs
semantics (builder, memory registration, asynchronous work requests,
completion queues) over the simulated ExaNeSt fabric, with the thesis'
page-fault handling underneath instead of the usual pinning ceremony.

Thesis concept -> API name
==========================

===============================  ========================================
Thesis / prototype concept        API construct
===============================  ========================================
PDID (protection-domain ID,       ``ProtectionDomain`` — ``Fabric.
SMMU context bank, §1.3.1.4)      open_domain(pd)``; one tenant, one
                                  SMMU context bank per node.
Fault-resolution strategy         ``FaultPolicy`` — per-domain (or
(Touch-A-Page / Touch-Ahead /     per-node / fabric-default) strategy +
Kernel-RAPF, §3.2.1)              lookahead + pin budget; threaded into
                                  ``Node.resolver_for(pd)``.
mmap + touch/pin preparation      ``ProtectionDomain.register_memory()``
(the thesis' three comparisons)   -> ``MemoryRegion`` with ``BufferPrep``
                                  state and ``PrepCost`` accounting.
PLDMA descriptor submission       ``post_write()`` / ``post_read()`` ->
(§1.3.2.1)                        ``WorkRequest`` future.
PLDMA status register polling     ``CompletionQueue.poll(max_entries)``
(completion_poll_us)              and ``cq.wait(n, deadline_us)``.
RAPF (Retransmit After Page       internal: fault FIFO -> driver tasklet
Fault, §3.2.3.3) + fault FIFO     -> resolver -> mailbox; surfaced in
(§3.2.3.1)                        ``WorkCompletion.stats``
                                  (``rapf_retransmits``,
                                  ``fifo_entries_handled``, ...).
R5 retransmission timeout         ``FabricConfig.cost.timeout_us``.
One mechanism for every memory    ``repro_torch.vmem`` — ``AddressSpace`` +
consumer (the thesis' claim:      ``Pager`` (fault → resolve → map) over
faults handled, pinning           pluggable ``FramePool`` backends;
avoided, §2 motivation)           per-tenant ``FaultPolicy`` threading.
Remote paging over the fabric     ``repro_torch.vmem.RemoteFramePool`` — every
(virtual-address RDMA as a        page-in is a ``post_read`` completing
paging backend)                   on a CQ; ``PagingStats`` surfaces
                                  ``rapf_retransmits`` / fault counts.
Pinning limit M / Firehose        ``FaultPolicy.pin_limit_bytes``,
working-set cliff (§2.3)          enforced by ``Pager.pin`` and by
                                  pin-aware eviction
                                  (``repro_torch.vmem.PinAwareLRU``).
"Adjustments to the DMA           ``repro_torch.core.arbiter.DMAArbiter`` —
scheduling logic" so a faulting   per-(domain, class) send queues feeding
transfer pauses without           each node's PLDMA slots by deficit
stalling the engine (§3.2)        round-robin; a block entering
                                  ``PAUSED_SRC``/``PAUSED_DST`` yields
                                  its slot immediately and re-enters at
                                  the back of its queue on RAPF/timeout.
DMA service classes /             ``ServiceClass.LATENCY`` (strict
per-tenant QoS (beyond paper:     priority) vs ``ServiceClass.BULK``
multi-tenant RDMA service)        (weighted share) — per
                                  ``FaultPolicy.service_class`` /
                                  ``open_domain``, overridable per work
                                  request (``post_write(...,
                                  service_class=...)``).
Per-tenant admission control      ``FaultPolicy.max_outstanding_blocks``
(beyond paper)                    — the posting verbs raise
                                  ``DomainQuotaExceeded`` when a domain
                                  is at its outstanding-block quota;
                                  telemetry in ``ArbiterStats``.
ExaNeSt multi-hop fabric          ``repro_torch.net`` — ``TopologyKind``
(QFDB quads over HSS links,       (``FabricConfig(topology=, dims=)``):
§ experimental setup)             ALL_TO_ALL (n_nodes=4 = one fully
                                  connected QFDB quad) / RING / MESH_2D
                                  / TORUS_2D (quads tiled) / DRAGONFLY
                                  (quad-like cliques + global links);
                                  ``hops=`` stays as the ALL_TO_ALL
                                  back-compat distance alias.
Routed RAPF/NACK/ACK delivery     deterministic dimension-order
(control packets cross the real   ``Router``; every control packet
interconnect, §3.2.3.3)           charges — and on shared-link
                                  topologies reserves — wire time per
                                  routed hop (the seed charged one
                                  ``hop_latency_us`` flat).
Shared-link contention /          per-direction ``Link`` resources with
congested fabric QoS (beyond      LATENCY-over-BULK wire arbitration
paper: multi-tenant fabrics)      (``FabricConfig.link_qos``); per-link
                                  utilization/queueing telemetry rolls
                                  up into ``Fabric.net_stats()`` →
                                  ``FabricStats``.
14-bit tr_ID wire field           R5 free-list allocator: fresh IDs
(Table 3.2) — the hardware        first, recycle **only on block
wraps, state must not             completion**, so a paused block is
(ID-lifecycle correctness)        never aliased past 2^14 launches;
                                  ``FabricConfig.tr_id_space`` shrinks
                                  the pool for tests, wire format
                                  bit-exact; telemetry in ``TrIdStats``
                                  (``Fabric.protocol_stats()``).
seq_num / RAPF matching under     host-side *generation* tags (never
ID reuse (§3.2.3.3 firmware       serialized): RAPF matching, FIFO
checks, wrap-robust)              dedup and driver last-2 cache compare
                                  generations, dropping control traffic
                                  addressed to a previous incarnation
                                  (``TrIdStats.stale_rapf_drops``).
R5 descriptor-pool exhaustion     ``TrIdExhausted`` (a
(beyond paper: admission          ``WorkQueueFull``) from the posting
control at protocol limits)       verbs when every tr_ID is in flight;
                                  internal launches defer FIFO until
                                  completions free IDs
                                  (``TrIdStats.stalls``).
NP-RDMA MTT cache (competing      ``repro_torch.npr.MTTCache`` — per-domain
design: NIC-cached VA→PA vs the   VA→PA entries filled host-side and
SMMU's page-table walks +         invalidated by the same munmap /
fault FIFO)                       reclaim / khugepaged hooks that feed
                                  the SMMU path; ``Strategy.NP_RDMA``
                                  + ``FabricConfig.mtt_entries``.
NP-RDMA DMA-able pool             ``repro_torch.npr.DMAPool`` — bounded
(competing design: pre-           pre-registered landing frames
registered landing frames vs      (``FabricConfig.dma_pool_frames``)
RAPF's retransmit-into-the-       with watermark-driven re-registration;
real-buffer)                      sizing is the crossover lever vs RAPF
                                  (pool dry → 1 ms timeout fallback).
NP-RDMA speculate / abort /       ``repro_torch.npr.NPREngine`` — launches on
redirect (competing design: the   cached translations, verifies at the
thesis instead pauses in the      destination, aborts stale rounds and
fault FIFO and RAPF-retransmits)  re-issues through the pool; counters
                                  in ``WorkCompletion.stats`` (``mtt_*``,
                                  ``npr_aborts``) and
                                  ``Fabric.protocol_stats()`` →
                                  ``ProtocolStats.npr``.
SMMU context bank as a            ``repro_torch.tenancy.BankManager`` — the 16
*virtualized* resource (beyond    banks (§1.3.1.4) are overcommitted:
paper: RDMAvisor-style NIC/MMU    domains bind on demand,
virtualization, the "beyond 16    ``Fabric.close_domain`` releases, and
domains" north star)              10k+ tenants/node admit behind
                                  ``tenants_per_node`` /
                                  ``TenantQuotaExceeded``.
Bank steal = TLB shootdown cost   LRU bank stealing evicts a cold
(an SMMU driver rebinding a       domain's bank: ``tlb_invalidate_all``
context bank must shoot down      + page-table rebind, charged as
its cached walks)                 ``CostModel.bank_shootdown_us`` +
                                  ``bank_rebind_us`` on the fault path;
                                  telemetry in ``BankStats``
                                  (``Fabric.protocol_stats()`` →
                                  ``ProtocolStats.tenancy``).
SLO class mapping (beyond         ``repro_torch.tenancy.SLOClass`` — GOLD /
paper: tenant tiers over one      SILVER / BEST_EFFORT maps onto
fault-handling datapath)          ``ServiceClass`` + DRR weight + bank
                                  steal immunity (GOLD) + the SRQ's
                                  ``srq_gold_reserve``; threaded through
                                  ``FaultPolicy.slo`` /
                                  ``open_domain(slo=...)``.
Machine-failure model (beyond     ``Fabric.crash_node`` (fail-stop) /
paper: the thesis assumes live    ``fail_link`` / ``restore_link``;
endpoints — real deployments      in-flight work toward a dead peer
crash mid-transfer)               completes with ``WCStatus.
                                  REMOTE_OP_ERR`` / ``WR_FLUSH_ERR``
                                  instead of retransmitting forever;
                                  posting from a dead node raises
                                  ``NodeDown``; routed traffic re-paths
                                  around down links or fails typed
                                  (``NetworkPartitioned``).
Retry budgets (beyond paper:      ``FaultPolicy.max_retries`` caps a
the R5's unconditional requeue    block's retransmissions (timeout AND
is a livelock against a dead      RAPF paths) — exhaustion completes
or wedged peer)                   the WR with ``WCStatus.
                                  RETRY_EXC_ERR``;
                                  ``FaultPolicy.retry_backoff``
                                  stretches the R5 timeout
                                  exponentially per retry.
tr_ID lease reclamation (crash    a crashed node's in-flight tr_IDs
orphans must not alias the        stay *leased* (unrecyclable) for
free list — PR-5 lifecycle        ``FabricConfig.lease_timeout_us``,
invariants under failures)        then return to the free list;
                                  ``TrIdStats.lease_reclaims``.
Remote-pager failover (beyond     ``RemoteFramePool.build(replica_node
paper: paging over a fabric       =...)`` mirrors write-backs
whose backing node can die)       (``page_out``) to a replica; a
                                  failed page-in re-serves from it
                                  with read-your-writes verification
                                  (``ryw_verified`` /
                                  ``ryw_violations``;
                                  ``PagingStats.failovers``).
===============================  ========================================

**When to use which backend** (``benchmarks/npr_compare.py`` measures
the crossovers): the thesis path (``TOUCH_AHEAD``/``KERNEL_RAPF``) wins
when destination faults dominate and memory is too tight to dedicate a
DMA pool — RAPF retransmits need no reserved frames.  ``NP_RDMA`` wins
when *source* faults occur (host fixup in microseconds vs the thesis'
1 ms timeout-only recovery) and under warm-cache/THP-churn destination
regimes with an adequately-provisioned pool (abort+redirect beats the
retransmit round-trip).  Pinning (``BufferPrep.PINNED``) still wins raw
transfer latency if you can afford the pin cost and the working set.

Quick tour::

    from repro_torch.api import (BufferPrep, Fabric, FabricConfig, FaultPolicy,
                           Strategy)

    fabric = Fabric.build(FabricConfig(n_nodes=2))
    tenant_a = fabric.open_domain(1, policy=FaultPolicy(Strategy.TOUCH_AHEAD))
    tenant_b = fabric.open_domain(2, policy=FaultPolicy(Strategy.KERNEL_RAPF))

    src = tenant_a.register_memory(0, 0x10_0000_0000, 65536,
                                   prep=BufferPrep.TOUCHED)
    dst = tenant_a.register_memory(1, 0x20_0000_0000, 65536)  # faulting!

    cq = fabric.create_cq(depth=64)
    wr = tenant_a.post_write(src, dst, cq=cq)       # returns immediately
    for wc in cq.wait(1):
        print(wc.latency_us, wc.stats.dst_faults, wc.stats.rapf_retransmits)
"""

from repro_torch.api.completion import (CompletionQueue, CQStats,
                                  DomainQuotaExceeded, TenantQuotaExceeded,
                                  TrIdExhausted, WCStatus, WorkCompletion,
                                  WorkQueueFull, WorkRequest, WROpcode)
from repro_torch.api.config import FabricConfig
from repro_torch.api.fabric import Fabric, ProtectionDomain, ProtocolStats
from repro_torch.api.memory import BufferPrep, MemoryRegion, PrepCost, RegionError
from repro_torch.api.policy import DEFAULT_POLICY, FaultPolicy
from repro_torch.core.arbiter import ArbiterStats, DMAArbiter, ServiceClass
from repro_torch.core.node import (BankCollision, DomainClosed, DomainExists,
                             FabricError, NodeDown, TrIdStats)
from repro_torch.errors import AdmissionError, ConfigError, LivelockError
from repro_torch.core.resolver import Strategy, coerce_strategy
from repro_torch.npr.stats import NPRStats
from repro_torch.tenancy import (BankManager, BankStats, SLOClass, TenancyManager,
                           coerce_slo)
from repro_torch.net import (FabricStats, LinkStats, NetworkPartitioned, Router,
                       Topology, TopologyError, TopologyKind, build_topology)

__all__ = [
    "AdmissionError", "ArbiterStats", "BankCollision", "BankManager",
    "BankStats", "BufferPrep", "CompletionQueue", "ConfigError", "CQStats",
    "DEFAULT_POLICY", "DMAArbiter", "DomainClosed", "DomainExists",
    "DomainQuotaExceeded", "Fabric", "FabricConfig", "FabricError",
    "FabricStats", "FaultPolicy", "LinkStats", "LivelockError",
    "MemoryRegion", "NPRStats", "NetworkPartitioned",
    "NodeDown", "PrepCost", "ProtectionDomain", "ProtocolStats",
    "RegionError", "Router", "SLOClass", "ServiceClass", "Strategy",
    "TenancyManager", "TenantQuotaExceeded", "Topology", "TopologyError",
    "TopologyKind", "TrIdExhausted", "TrIdStats", "WCStatus",
    "WorkCompletion", "WorkQueueFull", "WorkRequest", "WROpcode",
    "build_topology", "coerce_slo", "coerce_strategy",
]
