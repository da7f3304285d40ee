"""Paged KV-cache manager for serving: allocation, spill, fault handling.

Each sequence is one :class:`~repro_torch.vmem.pager.AddressSpace` tenant over
a shared control-plane :class:`~repro_torch.vmem.frames.FrameIdPool` — the
multi-tenant scenario of the ``repro_torch.vmem`` pager.  The device pools
handed to the compiled decode step are fixed-size frame pools; this
manager owns the *page tables* mapping (sequence, page-slot) → frame.
When the pool is exhausted, cold pages of preempted/idle sequences spill
(cross-tenant eviction); re-activating a sequence faults its pages back
in at the granularity of the tenant's
:class:`~repro_torch.api.policy.FaultPolicy` (Touch-Ahead blocks by default).

The compiled step never sees a fault: like the thesis' driver, residency
is resolved on the control plane before dispatch, and the step's page
table only ever names resident frames (unmapped tail slots are -1 and
masked inside the kernel).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.api.policy import FaultPolicy
from repro_torch.core.costmodel import CostModel, DEFAULT_COST_MODEL
from repro_torch.core.resolver import Strategy
from repro_torch.vmem import (FrameIdPool, FramePool, NON_RESIDENT, Pager,
                        PagingStats, coerce_policy)

FREE = -1

# unified telemetry: the old name stays importable
KVStats = PagingStats


class PagedKVManager:
    """Frame allocator + per-sequence page tables (one per layer-group)."""

    def __init__(self, n_frames: int, page_tokens: int, max_pages_per_seq: int,
                 strategy: Optional[Strategy] = None,
                 lookahead: Optional[int] = None,
                 cost: CostModel = DEFAULT_COST_MODEL,
                 policy: Optional[FaultPolicy] = None,
                 pool: Optional[FramePool] = None,
                 pager: Optional[Pager] = None):
        self.n_frames = n_frames
        self.page_tokens = page_tokens
        self.max_pages = max_pages_per_seq
        # only pin a per-sequence policy when the caller asked for one;
        # otherwise an injected pager's own policy must govern
        explicit = (policy is not None or strategy is not None
                    or lookahead is not None)
        coerced = coerce_policy("PagedKVManager", policy, strategy,
                                lookahead)
        self.cost = cost
        if pager is None:
            pager = Pager(pool or FrameIdPool(n_frames), policy=coerced,
                          cost=cost)
        self.pager = pager
        self._space_policy = coerced if explicit else None
        self.policy = coerced if explicit else pager.policy
        self.strategy = self.policy.strategy
        self.lookahead = self.policy.lookahead
        self.stats = self.pager.stats
        # seq_id -> its address space (one tenant per sequence)
        self.seq_spaces: dict[int, "object"] = {}
        self.lengths: dict[int, int] = {}

    # ---------------------------------------------------- compat views
    @property
    def tables(self) -> dict[int, np.ndarray]:
        """seq_id -> np.array(max_pages) of frame ids / FREE."""
        return {s: sp.page_table for s, sp in self.seq_spaces.items()}

    @property
    def spilled(self) -> dict[int, set[int]]:
        """seq_id -> slots evicted to host, awaiting fault-back-in."""
        return {s: set(map(int, np.where(sp.swapped)[0]))
                for s, sp in self.seq_spaces.items()}

    def _victims(self, for_seq: int,
                 spill_candidates: Optional[list[int]]) -> list:
        """Candidate spaces to spill from (never the requesting seq)."""
        if spill_candidates:
            return [self.seq_spaces[s] for s in spill_candidates
                    if s in self.seq_spaces]
        return [sp for s, sp in self.seq_spaces.items() if s != for_seq]

    # ------------------------------------------------------------ sequences
    def add_sequence(self, seq_id: int) -> None:
        self.seq_spaces[seq_id] = self.pager.create_space(
            self.max_pages, name=f"seq{seq_id}", policy=self._space_policy)
        self.lengths[seq_id] = 0

    def free_sequence(self, seq_id: int) -> None:
        space = self.seq_spaces.pop(seq_id, None)
        if space is not None:
            self.pager.destroy_space(space)
        self.lengths.pop(seq_id, None)

    # ------------------------------------------------------------- growing
    def append_tokens(self, seq_id: int, n: int,
                      spill_candidates: Optional[list[int]] = None) -> None:
        """Extend a sequence by n tokens, allocating pages on demand."""
        new_len = self.lengths[seq_id] + n
        needed = -(-new_len // self.page_tokens)
        space = self.seq_spaces[seq_id]
        victims = self._victims(seq_id, spill_candidates)
        for slot in range(needed):
            if space.page_table[slot] == NON_RESIDENT \
                    and not space.swapped[slot]:
                self.pager.map_fresh(space, slot, victims=victims)
        self.lengths[seq_id] = new_len

    # --------------------------------------------------------------- faults
    def ensure_resident(self, seq_id: int,
                        spill_candidates: Optional[list[int]] = None) -> int:
        """Resolve all spilled pages of a sequence before dispatch.

        Returns the number of pages faulted back in.  Touch-Ahead pages in
        ``lookahead``-page blocks (one fault event per block — the 16 KB
        block of the thesis); Touch-A-Page pays one event per page.
        """
        space = self.seq_spaces[seq_id]
        spilled = np.where(space.swapped)[0]
        if not len(spilled):
            return 0
        return self.pager.resolve_batch(
            space, spilled, victims=self._victims(seq_id, spill_candidates))

    # ---------------------------------------------------------------- views
    def device_table(self, seq_ids: list[int]) -> np.ndarray:
        """(B, max_pages) int32 page table for the compiled step."""
        out = np.full((len(seq_ids), self.max_pages), FREE, np.int32)
        for i, s in enumerate(seq_ids):
            out[i] = self.seq_spaces[s].page_table
        return out

    def batch_lengths(self, seq_ids: list[int]) -> np.ndarray:
        return np.asarray([self.lengths[s] for s in seq_ids], np.int32)

    @property
    def frames_used(self) -> int:
        return self.pager.pool.frames_used

    @property
    def free(self) -> list[int]:
        return self.pager.pool.free
