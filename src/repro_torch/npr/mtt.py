"""Host-managed memory translation table (MTT) cache.

NP-RDMA (arXiv 2310.11062) keeps VA→PA translations in a host-side MTT
the NIC consults to issue DMA *speculatively* — no page pinning, no
IOMMU fault path.  RDMAbox (arXiv 2104.12197) showed the same
translation-cache fast path pays off whenever the working set re-uses
pages.  This module is the cache itself; the speculation/verification
protocol around it lives in :mod:`repro_torch.npr.engine`.

Design points mirrored from the papers:

* **per-domain keys** — entries are ``(pd, vpn) -> frame`` so one node's
  cache serves all its protection domains without aliasing;
* **stale marking, not eviction, on invalidation** — reclaim/khugepaged
  hooks *flag* the entry instead of dropping it.  A flagged entry is the
  detection window: a speculative DMA that raced the invalidation is
  caught by the host-side verification step comparing against the flag
  (dropping the entry would make the race look like a plain miss and
  lose the "this translation was used while dying" signal);
* **bounded LRU** — ``mtt_entries`` caps host memory; eviction is
  least-recently-verified.

The cache mirrors how :class:`~repro_torch.core.fault.SMMU` subscribes its TLB
shoot-down to :attr:`~repro_torch.core.pagetable.PageTable.invalidation_hooks`:
:meth:`~repro_torch.npr.engine.NPREngine.register_domain` registers
:meth:`MTTCache.invalidate` on the same hook list, so the *same*
``FaultInjection`` churn (reclaim, khugepaged collapse, munmap) that
faults the thesis datapath stales this one.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from repro_torch.npr.stats import NPRStats


class MTTEntry:
    """One cached translation: the frame plus its staleness flag."""

    __slots__ = ("frame", "stale")

    def __init__(self, frame: int):
        self.frame = frame
        self.stale = False


class MTTCache:
    """Bounded per-node VA→PA translation cache with stale marking."""

    def __init__(self, capacity: int, stats: NPRStats):
        if capacity < 1:
            raise ValueError(f"MTT capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.stats = stats
        self._entries: "OrderedDict[tuple[int, int], MTTEntry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, pd: int, vpn: int) -> Optional[MTTEntry]:
        """The entry for ``(pd, vpn)``, stale or not; None on a miss.

        A hit refreshes LRU order (stale entries included — they are
        about to be either refreshed by a fill or consulted by the
        verification step, both recency signals).  Hit/miss/stale
        *counters* are the caller's job: only the engine knows whether a
        lookup was a speculative verify or a plain probe.
        """
        e = self._entries.get((pd, vpn))
        if e is not None:
            self._entries.move_to_end((pd, vpn))
        return e

    def install(self, pd: int, vpn: int, frame: int) -> MTTEntry:
        """Install/refresh the translation for ``(pd, vpn)`` (a *fill*)."""
        key = (pd, vpn)
        e = self._entries.get(key)
        if e is None:
            e = MTTEntry(frame)
            self._entries[key] = e
            if len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.mtt_evictions += 1
        else:
            e.frame = frame
            e.stale = False
        self._entries.move_to_end(key)
        self.stats.mtt_fills += 1
        return e

    def invalidate(self, pd: int, vpn: int) -> None:
        """Page-table hook: the mapping changed under the cache."""
        e = self._entries.get((pd, vpn))
        if e is not None and not e.stale:
            e.stale = True
            self.stats.mtt_invalidations += 1

    def invalidate_domain(self, pd: int) -> int:
        """Stale-mark every entry of ``pd`` (its SMMU bank was stolen).

        Same detection-window semantics as per-page :meth:`invalidate`:
        a speculative DMA racing the bank steal is caught by the
        verification step instead of completing against a translation
        the SMMU no longer backs.  Returns entries newly staled.
        """
        staled = 0
        # torch-lint: allow(det-dict-iter): per-entry idempotent staling, order-free
        for (epd, _), e in self._entries.items():
            if epd == pd and not e.stale:
                e.stale = True
                staled += 1
        self.stats.mtt_invalidations += staled
        return staled

    def drop_domain(self, pd: int) -> int:
        """Remove every entry of ``pd`` outright (``close_domain`` —
        nothing can race a closed domain, so no detection window is
        needed).  Returns entries dropped."""
        keys = [k for k in self._entries if k[0] == pd]
        for k in keys:
            del self._entries[k]
        return len(keys)

    def entries(self):
        """Iterate ``((pd, vpn), entry)`` — for invariant checkers."""
        return self._entries.items()
