"""Per-node telemetry of the NP-RDMA backend (one record per node).

One dataclass covers all three moving parts — the
:class:`~repro_torch.npr.mtt.MTTCache`, the :class:`~repro_torch.npr.pool.DMAPool`
and the speculative-issue engine — so ``Fabric.protocol_stats()`` can
surface them uniformly next to :class:`~repro_torch.core.node.TrIdStats`
without per-field ``getattr`` fallbacks.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class NPRStats:
    """Telemetry of one node's NP-RDMA engine.

    ``stale_completions`` is the backend's central safety counter: a
    page delivered through a translation that an invalidation had
    already flagged stale.  The verification step makes this
    structurally impossible, and ``repro_torch.testing`` asserts it stays 0.
    """

    # ---- MTT (memory translation table) ---------------------------------
    mtt_capacity: int = 0
    mtt_hits: int = 0            # verifications served by a fresh entry
    mtt_misses: int = 0          # lookups with no entry at all
    mtt_fills: int = 0           # entries installed (miss fills + fixups)
    mtt_stale_hits: int = 0      # verifications that caught a stale entry
    mtt_invalidations: int = 0   # entries flagged by page-table hooks
    mtt_evictions: int = 0       # LRU evictions at capacity
    # ---- speculative issue ----------------------------------------------
    aborts_sent: int = 0         # abort-and-redirect control messages
    redirected_blocks: int = 0   # blocks that completed through the pool
    redirect_pages: int = 0      # pages landed in pool frames
    src_fixups: int = 0          # source misses fixed host-side (no 1 ms)
    stale_completions: int = 0   # MUST stay zero (repro_torch.testing invariant)
    # ---- DMA-able pool ---------------------------------------------------
    pool_frames: int = 0
    pool_reserve_failures: int = 0   # reservations refused: pool exhausted
    pool_refills: int = 0            # watermark-driven re-registrations
    pool_reserved_peak: int = 0      # high-water mark of frames held
    pool_stalls: int = 0             # dispatches deferred awaiting frames

    @property
    def active(self) -> bool:
        """Did the engine do any work (beyond configuration echo)?"""
        return any(getattr(self, f.name) for f in dataclasses.fields(self)
                   if f.name not in ("mtt_capacity", "pool_frames"))

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}
