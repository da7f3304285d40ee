"""Per-protection-domain page tables with demand paging, COW, pinning & THP.

Models the OS-side state the thesis' mechanism manipulates:

* **Demand paging** (§3.1.2.1): ``mmap`` creates *valid but non-resident*
  mappings; the first touch allocates a frame (minor fault).
* **Copy-on-write** (§3.1.2.2): shared read-only frames duplicated on write.
* **Transparent Huge Pages** (§3.1.2.3): a ``khugepaged`` model that
  transiently *invalidates* mappings of huge-page-aligned regions while
  collapsing them — the thesis' motivation for why even touched/pinned
  buffers still fault during RDMA.
* **Pinning** (§2.2): pinned pages are exempt from reclaim/THP, subject to a
  pinnable-memory limit M (the Firehose constraint).

Each page table corresponds to one SMMU context bank (§1.3.1.4): the SMMU
walks *these* tables, so invalidating a PTE here makes the next RDMA
translation fault.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Iterable, Optional

from repro_torch.core.addresses import PAGE_SIZE, page_index

HUGE_PAGE_PAGES = 512  # 2 MB huge page = 512 x 4 KB


class PageState(enum.Enum):
    NOT_MAPPED = 0        # no VMA: access is a segmentation fault
    MAPPED_NOT_RESIDENT = 1   # valid mapping, no frame: minor fault on access
    RESIDENT = 2          # frame assigned, translation succeeds
    SWAPPED = 3           # frame reclaimed to swap: major fault on access


@dataclasses.dataclass
class PTE:
    state: PageState = PageState.NOT_MAPPED
    frame: int = -1
    pinned: bool = False
    cow: bool = False          # shared read-only; write triggers duplication
    writable: bool = True
    touched_epoch: int = -1    # LRU bookkeeping for reclaim


class OutOfFramesError(RuntimeError):
    pass


class SegmentationFault(RuntimeError):
    def __init__(self, pd: int, vpn: int):
        super().__init__(f"segfault pd={pd} vpn={vpn:#x}")
        self.pd = pd
        self.vpn = vpn


class PinLimitExceeded(RuntimeError):
    pass


class FrameAllocator:
    """Finite pool of physical frames shared by all protection domains.

    Eviction of unpinned frames backs the SWAPPED state (major faults) and
    the Firehose-style working-set experiments.
    """

    def __init__(self, total_frames: int = 1 << 22):  # 16 GB default
        self.total_frames = total_frames
        # lazy free pool: frames >= _next_fresh have never been handed
        # out, released frames recycle LIFO — allocation order is
        # identical to the seed's materialized descending list, without
        # building (total_frames) ints per node at fabric construction
        # (64-node fabrics paid seconds of setup for untouched frames)
        self._next_fresh = 0
        self._released: list[int] = []
        self.owner: dict[int, tuple[int, int]] = {}   # frame -> (pd, vpn)
        self.refcount: dict[int, int] = {}

    @property
    def used(self) -> int:
        return len(self.owner)

    @property
    def free_frames(self) -> int:
        return self.total_frames - self._next_fresh + len(self._released)

    def alloc(self, pd: int, vpn: int) -> int:
        if self._released:
            f = self._released.pop()
        elif self._next_fresh < self.total_frames:
            f = self._next_fresh
            self._next_fresh += 1
        else:
            raise OutOfFramesError("frame pool exhausted")
        self.owner[f] = (pd, vpn)
        self.refcount[f] = 1
        return f

    def share(self, frame: int) -> None:
        self.refcount[frame] += 1

    def release(self, frame: int) -> None:
        rc = self.refcount.get(frame, 0)
        if rc <= 1:
            self.owner.pop(frame, None)
            self.refcount.pop(frame, None)
            self._released.append(frame)
        else:
            self.refcount[frame] = rc - 1


@dataclasses.dataclass
class PageTableStats:
    minor_faults: int = 0
    major_faults: int = 0
    cow_breaks: int = 0
    thp_invalidations: int = 0
    pins: int = 0
    unpins: int = 0
    touches: int = 0


class PageTable:
    """One protection domain's page table (== one SMMU context bank)."""

    def __init__(self, pd: int, allocator: FrameAllocator,
                 pin_limit_bytes: Optional[int] = None):
        self.pd = pd
        self.allocator = allocator
        self.entries: dict[int, PTE] = {}
        self.pin_limit_pages = (
            None if pin_limit_bytes is None else pin_limit_bytes // PAGE_SIZE)
        self.pinned_pages = 0
        self.stats = PageTableStats()
        self.epoch = 0
        # Hooks: the SMMU driver registers here to shoot down its TLB when a
        # mapping is invalidated (the paper's invalidation flow, §2.1.1).
        self.invalidation_hooks: list[Callable[[int], None]] = []

    # ----------------------------------------------------------------- VMA
    def mmap(self, va: int, nbytes: int) -> None:
        """Create valid, *non-resident* mappings (demand paging)."""
        for vpn in range(page_index(va), page_index(va + nbytes - 1) + 1):
            if vpn not in self.entries or self.entries[vpn].state == PageState.NOT_MAPPED:
                self.entries[vpn] = PTE(state=PageState.MAPPED_NOT_RESIDENT)

    def munmap(self, va: int, nbytes: int) -> None:
        for vpn in range(page_index(va), page_index(va + nbytes - 1) + 1):
            pte = self.entries.get(vpn)
            if pte is None:
                continue
            if pte.state in (PageState.RESIDENT, PageState.SWAPPED) and pte.frame >= 0:
                self.allocator.release(pte.frame)
            if pte.pinned:
                self.pinned_pages -= 1
            del self.entries[vpn]
            self._notify_invalidation(vpn)

    def release_all(self) -> int:
        """Release every frame this domain holds (domain teardown).

        Bulk form of ``munmap`` over the whole table: frames return to
        the shared allocator, pins drop, PTEs clear.  Per-page
        invalidation hooks are *not* fired — on ``close_domain`` the SMMU
        bank is detached (full TLB shootdown) and the NP-RDMA MTT domain
        dropped wholesale, so per-page notification would only inflate
        shootdown counters O(pages).  Returns the frames released.
        """
        released = 0
        # torch-lint: allow(det-dict-iter): frame reuse tracks PT insertion order
        for pte in self.entries.values():
            if (pte.state in (PageState.RESIDENT, PageState.SWAPPED)
                    and pte.frame >= 0):
                self.allocator.release(pte.frame)
                released += 1
        self.entries.clear()
        self.pinned_pages = 0
        return released

    # --------------------------------------------------------------- lookup
    def lookup(self, vpn: int) -> PTE:
        pte = self.entries.get(vpn)
        if pte is None:
            return PTE(state=PageState.NOT_MAPPED)
        return pte

    def is_resident(self, vpn: int) -> bool:
        return self.lookup(vpn).state == PageState.RESIDENT

    def resident_fraction(self, va: int, nbytes: int) -> float:
        vpns = range(page_index(va), page_index(va + nbytes - 1) + 1)
        n = len(vpns)
        return sum(self.is_resident(v) for v in vpns) / max(1, n)

    # --------------------------------------------------------------- faults
    def touch(self, vpn: int, write: bool = True) -> tuple[bool, PTE]:
        """CPU access to a page: resolve the fault like the MMU would.

        Returns ``(was_major, pte)``.  Raises SegmentationFault for unmapped
        pages (the library's ``sig_handler`` scenario, Fig 3.2).
        """
        pte = self.entries.get(vpn)
        if pte is None or pte.state == PageState.NOT_MAPPED:
            raise SegmentationFault(self.pd, vpn)
        self.stats.touches += 1
        self.epoch += 1
        major = False
        if pte.state == PageState.MAPPED_NOT_RESIDENT:
            pte.frame = self.allocator.alloc(self.pd, vpn)
            pte.state = PageState.RESIDENT
            self.stats.minor_faults += 1
        elif pte.state == PageState.SWAPPED:
            pte.frame = self.allocator.alloc(self.pd, vpn)
            pte.state = PageState.RESIDENT
            self.stats.major_faults += 1
            major = True
        if write and pte.cow:
            self._break_cow(vpn, pte)
        pte.touched_epoch = self.epoch
        return major, pte

    def get_user_pages(self, start_vpn: int, max_pages: int,
                       write: bool = True) -> int:
        """Kernel-space page-in of up to ``max_pages`` consecutive pages.

        Faithful to §3.2.2.1: stops at the first page that does not belong
        to the application's address space and returns the number of pages
        actually brought in.
        """
        n = 0
        for vpn in range(start_vpn, start_vpn + max_pages):
            pte = self.entries.get(vpn)
            if pte is None or pte.state == PageState.NOT_MAPPED:
                break
            self.touch(vpn, write=write)
            n += 1
        return n

    # ------------------------------------------------------------------ COW
    def fork_share(self, vpns: Iterable[int]) -> None:
        """Mark resident pages COW (shared read-only), as after fork()."""
        for vpn in vpns:
            pte = self.entries.get(vpn)
            if pte is not None and pte.state == PageState.RESIDENT:
                pte.cow = True
                self.allocator.share(pte.frame)

    def _break_cow(self, vpn: int, pte: PTE) -> None:
        old = pte.frame
        pte.frame = self.allocator.alloc(self.pd, vpn)
        self.allocator.release(old)
        pte.cow = False
        self.stats.cow_breaks += 1

    # -------------------------------------------------------------- pinning
    def pin(self, va: int, nbytes: int) -> None:
        vpns = list(range(page_index(va), page_index(va + nbytes - 1) + 1))
        new_pins = sum(1 for v in vpns if not self.lookup(v).pinned)
        if (self.pin_limit_pages is not None
                and self.pinned_pages + new_pins > self.pin_limit_pages):
            raise PinLimitExceeded(
                f"pin limit {self.pin_limit_pages} pages exceeded")
        for vpn in vpns:
            self.touch(vpn)  # pinning implies residency
            pte = self.entries[vpn]
            if not pte.pinned:
                pte.pinned = True
                self.pinned_pages += 1
        self.stats.pins += 1

    def unpin(self, va: int, nbytes: int) -> None:
        for vpn in range(page_index(va), page_index(va + nbytes - 1) + 1):
            pte = self.entries.get(vpn)
            if pte is not None and pte.pinned:
                pte.pinned = False
                self.pinned_pages -= 1
        self.stats.unpins += 1

    # -------------------------------------------------------------- reclaim
    def reclaim(self, n_pages: int) -> int:
        """Swap out up to n unpinned resident pages (LRU). Returns count."""
        candidates = sorted(
            ((pte.touched_epoch, vpn) for vpn, pte in self.entries.items()
             if pte.state == PageState.RESIDENT and not pte.pinned),
        )
        done = 0
        for _, vpn in candidates[:n_pages]:
            pte = self.entries[vpn]
            self.allocator.release(pte.frame)
            pte.frame = -1
            pte.state = PageState.SWAPPED
            self._notify_invalidation(vpn)
            done += 1
        return done

    # ------------------------------------------------------------------ THP
    def khugepaged_collapse(self, region_vpn: int) -> int:
        """Model one khugepaged pass over a 2 MB-aligned region (§3.1.2.3).

        While the kernel migrates small pages into a huge page, the old PTEs
        are transiently invalid — an RDMA translating through the SMMU in
        that window faults *even though the pages were touched*.  We model
        the observable effect: resident, unpinned PTEs in the region revert
        to MAPPED_NOT_RESIDENT (minor fault on next access) and SMMU TLBs
        are shot down.  Pinned pages are skipped (but note the thesis:
        pinning does not stop khugepaged scanning cost).
        """
        base = region_vpn - (region_vpn % HUGE_PAGE_PAGES)
        inv = 0
        for vpn in range(base, base + HUGE_PAGE_PAGES):
            pte = self.entries.get(vpn)
            if pte is not None and pte.state == PageState.RESIDENT and not pte.pinned:
                self.allocator.release(pte.frame)
                pte.frame = -1
                pte.state = PageState.MAPPED_NOT_RESIDENT
                self._notify_invalidation(vpn)
                inv += 1
        if inv:
            self.stats.thp_invalidations += inv
        return inv

    # ---------------------------------------------------------------- hooks
    def _notify_invalidation(self, vpn: int) -> None:
        for hook in self.invalidation_hooks:
            hook(vpn)
