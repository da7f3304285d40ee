"""Pluggable eviction policies for the shared frame pool.

A policy selects a ``(space, vpage)`` victim among candidate address
spaces; it must never pick a pinned page (the pager raises the thesis'
pinning-limit ``MemoryError`` when nothing unpinned is left).

* :class:`LRUEviction` — least-recently-used across every candidate
  space (the seed ``PagedTensorStore`` behaviour).
* :class:`ClockEviction` — second-chance: a hand sweeps the resident
  pages, clearing reference bits and evicting the first cold page.
* :class:`PinAwareLRU` — multi-tenant fairness: the victim comes from
  the candidate space holding the most *unpinned resident* frames (the
  tenant hogging the pool pays), LRU within it.  Tenants that pin their
  working set cannot starve the others below their own footprint.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

NON_RESIDENT = -1


def _resident_unpinned(space) -> np.ndarray:
    return np.where((space.page_table != NON_RESIDENT) & ~space.pinned)[0]


class EvictionPolicy:
    """Interface: bookkeeping hooks + victim selection."""

    def note_map(self, space, vpage: int) -> None:
        pass

    def note_access(self, space, vpage: int) -> None:
        pass

    def note_unmap(self, space, vpage: int) -> None:
        pass

    def select_victim(self, spaces) -> Optional[tuple]:
        """Pick ``(space, vpage)`` to evict, or None if all pinned/empty."""
        raise NotImplementedError


class LRUEviction(EvictionPolicy):
    def select_victim(self, spaces) -> Optional[tuple]:
        best = None
        best_used = None
        for sp in spaces:
            cands = _resident_unpinned(sp)
            if not len(cands):
                continue
            v = int(cands[np.argmin(sp.last_used[cands])])
            used = int(sp.last_used[v])
            if best is None or used < best_used:
                best, best_used = (sp, v), used
        return best


class ClockEviction(EvictionPolicy):
    """Second-chance clock over the candidates' resident pages."""

    def __init__(self):
        self._hand = 0

    def note_access(self, space, vpage: int) -> None:
        space.referenced[vpage] = True

    def note_map(self, space, vpage: int) -> None:
        space.referenced[vpage] = True

    def select_victim(self, spaces) -> Optional[tuple]:
        ring = [(sp, int(v)) for sp in spaces
                for v in _resident_unpinned(sp)]
        if not ring:
            return None
        start = self._hand % len(ring)
        for i in range(len(ring)):
            sp, v = ring[(start + i) % len(ring)]
            if not sp.referenced[v]:
                self._hand = start + i + 1
                return sp, v
            sp.referenced[v] = False       # second chance granted
        # every page was referenced: the sweep cleared all bits, so the
        # page under the hand is now the (cold) victim
        sp, v = ring[start]
        self._hand = start + 1
        return sp, v


class PinAwareLRU(EvictionPolicy):
    """Fairness under pinning: evict from the biggest unpinned holder."""

    def select_victim(self, spaces) -> Optional[tuple]:
        best_space = None
        best_cands = None
        for sp in spaces:
            cands = _resident_unpinned(sp)
            if not len(cands):
                continue
            if best_cands is None or len(cands) > len(best_cands):
                best_space, best_cands = sp, cands
        if best_space is None:
            return None
        v = int(best_cands[np.argmin(best_space.last_used[best_cands])])
        return best_space, v
