"""Unified paging telemetry: one dataclass for every memory consumer.

The seed grew four parallel stats records (``StoreStats``, ``KVStats``,
``OffloadStats`` and the fault fields of ``EngineStats``), each with its
own reset logic and half-overlapping field names.  :class:`PagingStats`
replaces all of them: every :class:`~repro.vmem.pager.AddressSpace` and
every :class:`~repro.vmem.pager.Pager` owns one, and the legacy names are
kept as aliases/properties so existing callers keep working.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PagingStats:
    """Telemetry of one pager (aggregate) or one address space (tenant)."""

    # ---- fault path ------------------------------------------------------
    faults: int = 0              # fault-resolution events
    pages_in: int = 0            # pages paged in at fault/pin time
    pages_out: int = 0           # pages written back / dropped on eviction
    evictions: int = 0
    prefetch_hits: int = 0       # accesses that found a prefetched page
    pin_violations: int = 0      # pool exhausted with everything pinned,
    #                              or a FaultPolicy pin budget exceeded
    # ---- multi-tenant ----------------------------------------------------
    allocs: int = 0              # address spaces created on this pager
    spills: int = 0              # cross-tenant evictions (another space's
    #                              page evicted to satisfy this tenant)
    # ---- remote (fabric-backed) page-ins ---------------------------------
    remote_reads: int = 0        # verbs post_read page-in operations
    remote_bytes_in: int = 0
    remote_dst_faults: int = 0   # destination faults of those reads
    rapf_retransmits: int = 0    # RAPF-triggered retransmits of those reads
    failovers: int = 0           # page-ins re-served by the replica pager
    #                              after the primary backing node crashed
    # ---- NP-RDMA backend (reads through a Strategy.NP_RDMA domain) -------
    mtt_hits: int = 0            # translations served by a fresh MTT entry
    mtt_misses: int = 0          # uncached translations (filled host-side)
    mtt_stale: int = 0           # stale entries caught by verification
    pool_redirects: int = 0      # pages redirected through the DMA pool
    # ---- streaming consumers (block-wise optimizer offload) --------------
    blocks_streamed: int = 0
    prefetch_overlapped: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    # ---- time ------------------------------------------------------------
    simulated_us: float = 0.0    # calibrated cost-model time

    # legacy aliases (KVStats / OffloadStats vocabulary) -------------------
    @property
    def fault_events(self) -> int:
        return self.faults

    @property
    def fault_page_ins(self) -> int:
        return self.pages_in

    def reset(self) -> None:
        """Zero every counter (all fields default to their zero)."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)

    def merge(self, other: "PagingStats") -> None:
        """Accumulate another record into this one (fleet roll-ups)."""
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
