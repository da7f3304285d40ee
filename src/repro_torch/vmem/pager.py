"""The unified demand pager: fault → resolve → map.

One :class:`Pager` owns one :class:`~repro_torch.vmem.frames.FramePool` and
serves any number of :class:`AddressSpace` tenants over it — the thesis'
"handle the fault instead of pinning" mechanism as a reusable subsystem.
``PagedTensorStore``, ``PagedKVManager``, ``PagedAdamW`` and the serving
engine's KV spill path are all thin wrappers over this one fault loop:

* an access (or pre-dispatch residency check) hits a non-resident page;
* the tenant's :class:`~repro_torch.api.policy.FaultPolicy` picks the
  resolution strategy — Touch-A-Page pays one event per page, the
  block strategies resolve a ``get_user_pages`` block per event, STREAM
  additionally warms the next block (``repro_torch.vmem.prefetch``);
* frames come from the shared pool, evicting per the pluggable policy
  (``repro_torch.vmem.eviction``) when exhausted — never a pinned page;
* the pool backend moves the payload: device/host copies locally, or a
  verbs ``post_read`` over the fabric for
  :class:`~repro_torch.vmem.remote.RemoteFramePool`, whose completions land on
  a real :class:`~repro_torch.api.completion.CompletionQueue`.

Timing is accounted with the calibrated :class:`CostModel` in
``PagingStats.simulated_us`` while the data movement itself is real,
exactly as in the seed pagers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.policy import DEFAULT_POLICY, FaultPolicy
from repro_torch.compat import canonicalize_dtype
from repro_torch.core import addresses as A
from repro_torch.core.costmodel import CostModel, DEFAULT_COST_MODEL
from repro_torch.core.resolver import Strategy
from repro_torch.vmem.eviction import EvictionPolicy, LRUEviction
from repro_torch.vmem.frames import FramePool
from repro_torch.vmem.prefetch import predictor_for
from repro_torch.vmem.stats import PagingStats

NON_RESIDENT = -1


class AddressSpace:
    """One tenant's virtual page range over a (possibly shared) pool.

    Owns the page table, pin/prefetch/reference bits, the host backing
    image (where non-resident pages live, absent for id-only pools) and a
    per-tenant :class:`PagingStats`.  An optional per-space
    :class:`FaultPolicy` overrides the pager default — two tenants of one
    pool can resolve faults with different strategies, mirroring the
    per-domain policies of ``repro_torch.api``.
    """

    def __init__(self, pager: "Pager", n_pages: int, name: str = "",
                 policy: Optional[FaultPolicy] = None):
        self.pager = pager
        self.n_pages = n_pages
        self.name = name
        self.policy = policy
        self.page_table = np.full((n_pages,), NON_RESIDENT, np.int64)
        self.pinned = np.zeros((n_pages,), bool)
        self.prefetched = np.zeros((n_pages,), bool)
        self.referenced = np.zeros((n_pages,), bool)
        self.swapped = np.zeros((n_pages,), bool)   # evicted, awaiting fault
        self.last_used = np.zeros((n_pages,), np.int64)
        pool = pager.pool
        if pool.page_elems:
            dtype = canonicalize_dtype(
                getattr(pool, "dtype", np.float32))
            self.backing = np.zeros((n_pages, pool.page_elems), dtype)
        else:
            self.backing = None
        self.stats = PagingStats()

    # ------------------------------------------------------------ queries
    def is_resident(self, vpage: int) -> bool:
        return self.page_table[vpage] != NON_RESIDENT

    def resident_pages(self) -> int:
        return int((self.page_table != NON_RESIDENT).sum())

    def frame_ids(self, vpages) -> np.ndarray:
        """Frame ids for compiled-kernel page tables (resolve first)."""
        return self.page_table[np.atleast_1d(vpages)]

    # -------------------------------------------------- delegated verbs
    def access(self, vpages) -> torch.Tensor:
        return self.pager.access(self, vpages)

    def ensure_resident(self, vpages, victims=None) -> int:
        return self.pager.ensure_resident(self, vpages, victims=victims)

    def pin(self, vpages) -> None:
        self.pager.pin(self, vpages)

    def unpin(self, vpages) -> None:
        self.pager.unpin(self, vpages)

    def write(self, vpage: int, data, allow_partial: bool = False) -> None:
        """Populate a page's backing image (device copy kept coherent).

        ``data`` must fill the page exactly unless ``allow_partial`` —
        streaming consumers whose final page is short (e.g. the last
        optimizer block) opt in; everyone else gets a loud error rather
        than a silently stale page tail.
        """
        flat = np.asarray(data, self.backing.dtype).reshape(-1)
        width = self.backing.shape[1]
        if flat.size != width and not (allow_partial
                                       and flat.size < width):
            raise ValueError(
                f"page payload of {flat.size} elems does not fill a "
                f"{width}-elem page (pass allow_partial=True to write a "
                f"short final page)")
        self.backing[vpage, :flat.size] = flat
        f = self.page_table[vpage]
        if f != NON_RESIDENT:
            self.pager.pool.load(int(f), self.backing[vpage])

    def write_back(self, vpage: int) -> None:
        """Frame -> backing writeback for a resident page."""
        f = self.page_table[vpage]
        if f != NON_RESIDENT and self.backing is not None:
            data = self.pager.pool.store(int(f))
            if data is not None:
                self.backing[vpage] = data


class Pager:
    """Fault resolver + frame allocator over one pool, many spaces."""

    def __init__(self, pool: FramePool, *,
                 policy: FaultPolicy = DEFAULT_POLICY,
                 cost: CostModel = DEFAULT_COST_MODEL,
                 eviction: Optional[EvictionPolicy] = None,
                 page_bytes: int = A.PAGE_SIZE):
        self.pool = pool
        self.policy = policy
        self.cost = cost
        self.eviction = eviction or LRUEviction()
        self.page_bytes = page_bytes
        self.spaces: list[AddressSpace] = []
        self.stats = PagingStats()
        self._clock = 0

    # ------------------------------------------------------------- spaces
    def create_space(self, n_pages: int, name: str = "",
                     policy: Optional[FaultPolicy] = None) -> AddressSpace:
        sp = AddressSpace(self, n_pages, name=name, policy=policy)
        self.spaces.append(sp)
        self.pool.spaces.append(sp)
        self.stats.allocs += 1
        sp.stats.allocs += 1
        return sp

    def destroy_space(self, space: AddressSpace) -> None:
        for v in np.where(space.page_table != NON_RESIDENT)[0]:
            self.pool.release(int(space.page_table[v]))
            self.eviction.note_unmap(space, int(v))
        space.page_table[:] = NON_RESIDENT
        self.spaces.remove(space)
        self.pool.spaces.remove(space)

    def policy_of(self, space: AddressSpace) -> FaultPolicy:
        return space.policy or self.policy

    # ------------------------------------------------------------ plumbing
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _acct(self, space: AddressSpace, **deltas) -> None:
        # torch-lint: allow(det-dict-iter): commutative setattr accumulation
        for name, d in deltas.items():
            setattr(space.stats, name, getattr(space.stats, name) + d)
            setattr(self.stats, name, getattr(self.stats, name) + d)

    @property
    def _os_pages_per_page(self) -> int:
        """4 KB OS pages one pager page represents (cost granularity)."""
        return max(1, self.page_bytes // A.PAGE_SIZE)

    # ----------------------------------------------------------- eviction
    def _evict_page(self, space: AddressSpace, vpage: int) -> None:
        frame = int(space.page_table[vpage])
        space.write_back(vpage)
        space.page_table[vpage] = NON_RESIDENT
        space.swapped[vpage] = True
        space.prefetched[vpage] = False
        self.pool.release(frame)
        self.eviction.note_unmap(space, vpage)
        self._acct(space, evictions=1, pages_out=1)

    def _evict_for(self, requester: AddressSpace,
                   victims: Optional[Sequence[AddressSpace]]) -> int:
        # default candidates: every space over the POOL (not just this
        # pager's), so consumers sharing a pool contend with each other
        cands = list(victims) if victims is not None else self.pool.spaces
        pick = self.eviction.select_victim(cands)
        if pick is None:
            self._acct(requester, pin_violations=1)
            raise MemoryError(
                "frame pool exhausted and every candidate page is pinned "
                "or absent (the thesis' pinning-limit failure mode)")
        vspace, vpage = pick
        self._evict_page(vspace, vpage)
        if vspace is not requester:
            # cross-tenant spill: touching the victim's cold page out is
            # on the requester's critical path (seed KV-spill accounting)
            self._acct(requester, spills=1,
                       simulated_us=self.cost.touch_page_us)
        frame = self.pool.alloc()
        assert frame is not None
        return frame

    def _map_page(self, space: AddressSpace, vpage: int,
                  victims: Optional[Sequence[AddressSpace]],
                  fresh: bool = False) -> int:
        if space.page_table[vpage] != NON_RESIDENT:
            return int(space.page_table[vpage])
        frame = self.pool.alloc()
        if frame is None:
            frame = self._evict_for(space, victims)
        if not fresh and space.backing is not None:
            self.pool.load(frame, space.backing[vpage])
        space.page_table[vpage] = frame
        space.swapped[vpage] = False
        space.last_used[vpage] = self._clock
        self.eviction.note_map(space, vpage)
        if not fresh:
            self._acct(space, pages_in=1)
        return frame

    # -------------------------------------------------------- fault events
    def _fault_event(self, space: AddressSpace, pages: Sequence[int],
                     victims: Optional[Sequence[AddressSpace]],
                     stream: Sequence[int] = ()) -> int:
        """One resolution event: page in ``pages`` (+``stream``), charge
        the strategy's cost and the pool backend's transport cost."""
        pol = self.policy_of(space)
        paged = [v for v in pages
                 if space.page_table[v] == NON_RESIDENT]
        for v in paged:
            self._map_page(space, v, victims)
        streamed = [v for v in stream
                    if space.page_table[v] == NON_RESIDENT]
        for v in streamed:
            self._map_page(space, v, victims)
            space.prefetched[v] = True
        # all block pages beyond the faulted one rode along: prefetched
        for v in paged[1:]:
            space.prefetched[v] = True
        c = self.cost
        osp = self._os_pages_per_page
        if pol.strategy is Strategy.TOUCH_A_PAGE:
            events = osp * max(1, len(paged))
            self._acct(space, faults=events, simulated_us=events * (
                c.netlink_send_us + c.wakeup_us + c.touch_page_us))
        else:
            cap = max(1, pol.lookahead)
            us = c.gup_us(max(1, min(len(paged) * osp, cap)))
            us += min(len(streamed) * osp, cap) * c.gup_per_page_us
            self._acct(space, faults=1, simulated_us=us)
        # transport: contiguous runs, one backend page-in per run.  Demand
        # pages (the faulted block) go first as LATENCY traffic; predictive
        # stream warm-ups ride behind them as BULK (fabric-backed pools
        # thread the class into the DMA arbiter via post_read).
        for pages, is_prefetch in ((paged, False), (streamed, True)):
            for start, n in _runs(sorted(pages)):
                r = self.pool.page_in(space, start, n, prefetch=is_prefetch)
                self._acct(space, simulated_us=r.us,
                           remote_reads=r.remote_reads,
                           rapf_retransmits=r.rapf_retransmits,
                           remote_dst_faults=r.dst_faults,
                           remote_bytes_in=r.bytes_in,
                           failovers=r.failovers,
                           mtt_hits=r.mtt_hits,
                           mtt_misses=r.mtt_misses,
                           mtt_stale=r.mtt_stale,
                           pool_redirects=r.pool_redirects)
        return len(paged) + len(streamed)

    def fault_in(self, space: AddressSpace, vpage: int,
                 victims: Optional[Sequence[AddressSpace]] = None) -> int:
        """Resolve a fault at ``vpage`` with the policy's prefetch."""
        block, stream = predictor_for(self.policy_of(space)).predict(
            space, vpage)
        return self._fault_event(space, [vpage] + block, victims,
                                 stream=stream)

    def resolve_batch(self, space: AddressSpace, vpages,
                      victims: Optional[Sequence[AddressSpace]] = None
                      ) -> int:
        """Resolve a known set of non-resident pages (pre-dispatch
        residency, KV fault-back-in): block strategies take one event per
        ``lookahead`` pages of the sorted set, Touch-A-Page one each."""
        self._tick()
        pol = self.policy_of(space)
        todo = sorted(int(v) for v in np.atleast_1d(vpages)
                      if space.page_table[int(v)] == NON_RESIDENT)
        n = 0
        if pol.strategy is Strategy.TOUCH_A_PAGE:
            for v in todo:
                n += self._fault_event(space, [v], victims)
        else:
            la = max(1, pol.lookahead)
            for i in range(0, len(todo), la):
                n += self._fault_event(space, todo[i:i + la], victims)
        return n

    # ------------------------------------------------------------- verbs
    def map_fresh(self, space: AddressSpace, vpage: int,
                  victims: Optional[Sequence[AddressSpace]] = None) -> int:
        """Allocate+map a brand-new page (no backing page-in): the KV
        append path, where the payload is produced on device."""
        self._tick()
        return self._map_page(space, vpage, victims, fresh=True)

    def access(self, space: AddressSpace, vpages) -> torch.Tensor:
        """Read pages, faulting in non-resident ones; (n, page_elems)."""
        vpages = np.atleast_1d(np.asarray(vpages, np.int64))
        self._tick()
        for v in map(int, vpages):
            if space.page_table[v] == NON_RESIDENT:
                self.fault_in(space, v)
            elif space.prefetched[v]:
                self._acct(space, prefetch_hits=1)
                space.prefetched[v] = False
            space.last_used[v] = self._clock
            self.eviction.note_access(space, v)
        return self.pool.gather(space.page_table[vpages])

    def ensure_resident(self, space: AddressSpace, vpages,
                        victims: Optional[Sequence[AddressSpace]] = None
                        ) -> int:
        """Fault in any non-resident ``vpages`` (with prefetch), without
        reading them back; returns pages paged in."""
        self._tick()
        n = 0
        for v in map(int, np.atleast_1d(vpages)):
            if space.page_table[v] == NON_RESIDENT:
                n += self.fault_in(space, v, victims)
            space.last_used[v] = self._clock
        return n

    def pin(self, space: AddressSpace, vpages,
            victims: Optional[Sequence[AddressSpace]] = None) -> None:
        """Page in and pin; enforces the FaultPolicy pin budget.

        Duplicate vpages pin (and charge ``pin_us`` for) one page, not
        one per occurrence: the budget check counts *distinct* new pins,
        so ``pin([v, v])`` with one page of headroom succeeds.
        """
        vp = np.atleast_1d(vpages)
        uniq = list(dict.fromkeys(map(int, vp)))   # dedup, order-preserving
        pol = self.policy_of(space)
        if pol.pin_limit_bytes is not None:
            would = (int(space.pinned.sum())
                     + sum(1 for v in uniq if not space.pinned[v]))
            if would * self.page_bytes > pol.pin_limit_bytes:
                self._acct(space, pin_violations=1)
                raise MemoryError(
                    f"pin budget exceeded: {would} pages x "
                    f"{self.page_bytes} B > pin_limit_bytes="
                    f"{pol.pin_limit_bytes} (tenant {space.name!r})")
        self._tick()
        for v in uniq:
            self._map_page(space, v, victims)
            space.pinned[v] = True
        self._acct(space,
                   simulated_us=self.cost.pin_us(len(uniq) * self.page_bytes))

    def unpin(self, space: AddressSpace, vpages) -> None:
        vp = np.atleast_1d(vpages)
        uniq = list(dict.fromkeys(map(int, vp)))
        for v in uniq:
            space.pinned[v] = False
        self._acct(space, simulated_us=self.cost.unpin_us(
            len(uniq) * self.page_bytes))


def _runs(pages: Sequence[int]) -> list[tuple[int, int]]:
    """Collapse a sorted page list into (start, length) contiguous runs."""
    out: list[tuple[int, int]] = []
    for v in pages:
        if out and out[-1][0] + out[-1][1] == v:
            out[-1] = (out[-1][0], out[-1][1] + 1)
        else:
            out.append((v, 1))
    return out
