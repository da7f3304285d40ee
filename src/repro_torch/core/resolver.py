"""Page-fault resolution strategies (thesis §3.2.1) + beyond-paper variants.

* **TOUCH_A_PAGE** — the Netlink path: the driver sends one
  :class:`~repro.core.addresses.NetlinkMessage` per fault; a user-space
  library thread wakes, touches the *one* faulty page (CPU-MMU minor fault
  does the paging-in), and — for destination faults — fires the RAPF
  retransmit request through the packetizer.
* **TOUCH_AHEAD** — the ``get_user_pages()`` path: the driver pages in up to
  **4 pages** (the faulty one + the rest of its 16 KB block) entirely in
  kernel space.  Per the thesis, the RAPF *still* needs the user-space hop
  (the packetizer is only reachable from user space in the prototype).
* **TOUCH_AHEAD_N** *(beyond paper)* — generalized lookahead.
* **KERNEL_RAPF** *(beyond paper — the thesis' future-work item #1)* —
  Touch-Ahead plus a kernel-space packetizer: no user-space hop at all.
* **STREAM** *(beyond paper)* — sequential-stream prediction: on a fault at
  page *p* of a transfer, also page in the first page of the *next* block so
  the following block's fault never happens on the critical path.
* **NP_RDMA** *(beyond paper — NP-RDMA, arXiv 2310.11062)* — selects the
  ``repro.npr`` no-pinning backend: speculative VA→PA translation through a
  host-managed :class:`~repro.npr.mtt.MTTCache` with abort-and-redirect
  through a :class:`~repro.npr.pool.DMAPool` of pre-registered frames.  The
  datapath bypasses the SMMU fault FIFO entirely; this resolver is only the
  defensive fallback for stray SMMU faults in an NP_RDMA domain (it behaves
  like KERNEL_RAPF so such a fault still resolves).
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque

from repro_torch.core.addresses import PAGES_PER_BLOCK
from repro_torch.core.costmodel import CostModel
from repro_torch.core.pagetable import PageTable, SegmentationFault


class DriverDedupCache:
    """The driver's last-two-transactions cache (§3.2.3.2 / Fig 4.2).

    The ``pf_rcv_tasklet`` skips FIFO entries it has just handled — the
    window that absorbs the interleaving duplicates the hardware's
    consecutive-dedup lets through.  Keys are the wire identity
    ``(src_ID, tr_ID, seq_num, vpage)`` *plus* the host-side generation
    tag of the tr_ID: once a node has launched 2^14 blocks and tr_IDs
    recycle, the wire identity alone aliases across incarnations, and an
    un-tagged cache would skip a *fresh* fault because a previous life of
    the same tr_ID faulted on the same page.  Membership tests are O(1)
    in the (constant, =2) depth — this cache is on the critical path of
    every FIFO entry drained.
    """

    __slots__ = ("_entries",)

    def __init__(self, depth: int = 2):
        self._entries: deque[tuple] = deque(maxlen=depth)

    def seen(self, key: tuple) -> bool:
        return key in self._entries

    def note(self, key: tuple) -> None:
        self._entries.append(key)


class Strategy(enum.Enum):
    TOUCH_A_PAGE = "touch_a_page"
    TOUCH_AHEAD = "touch_ahead"
    TOUCH_AHEAD_N = "touch_ahead_n"
    KERNEL_RAPF = "kernel_rapf"
    STREAM = "stream"
    NP_RDMA = "np_rdma"


def coerce_strategy(value) -> Strategy:
    """Resolve ``value`` into a :class:`Strategy` member, strictly.

    Accepts a member, its name (``"NP_RDMA"``) or its value
    (``"np_rdma"``), case-insensitively.  Anything else raises a typed
    ``ValueError`` naming every valid member — the seed accepted
    arbitrary spellings loosely and failed later with an opaque
    ``raise ValueError(s)`` deep in the resolver dispatch.
    """
    if isinstance(value, Strategy):
        return value
    if isinstance(value, str):
        try:
            return Strategy[value.upper()]
        except KeyError:
            try:
                return Strategy(value.lower())
            except ValueError:
                pass
    valid = ", ".join(f"{m.name} ({m.value!r})" for m in Strategy)
    raise ValueError(
        f"unknown fault-handling strategy {value!r}; valid Strategy "
        f"members: {valid}")


@dataclasses.dataclass
class Resolution:
    """Outcome + cost split of resolving one fault entry."""
    pages_resolved: int
    kernel_us: float          # time on the driver CPU (tasklet)
    user_us: float            # time on the user CPU (library thread)
    rapf_from_kernel: bool    # RAPF sent without the user-space hop
    segfault_recovered: bool = False
    major: bool = False


@dataclasses.dataclass
class Resolver:
    strategy: Strategy
    cost: CostModel
    lookahead: int = PAGES_PER_BLOCK     # for TOUCH_AHEAD_N / STREAM

    def resolve(self, pt: PageTable, vpn: int, *, is_dst: bool,
                block_pages_remaining: int) -> Resolution:
        """Resolve the fault at ``vpn``; page in per the strategy.

        ``block_pages_remaining`` bounds Touch-Ahead to the faulty page's
        block (the thesis touches "the one that was faulty and the next
        three after it", i.e. to the end of the 16 KB block).
        """
        s = self.strategy
        if s is Strategy.TOUCH_A_PAGE:
            return self._touch_a_page(pt, vpn, is_dst)
        if s is Strategy.TOUCH_AHEAD:
            return self._touch_ahead(pt, vpn, is_dst,
                                     min(PAGES_PER_BLOCK, block_pages_remaining),
                                     kernel_rapf=False, stream=False)
        if s is Strategy.TOUCH_AHEAD_N:
            return self._touch_ahead(pt, vpn, is_dst, self.lookahead,
                                     kernel_rapf=False, stream=False)
        if s is Strategy.KERNEL_RAPF:
            return self._touch_ahead(pt, vpn, is_dst,
                                     min(PAGES_PER_BLOCK, block_pages_remaining),
                                     kernel_rapf=True, stream=False)
        if s is Strategy.STREAM:
            return self._touch_ahead(pt, vpn, is_dst, self.lookahead,
                                     kernel_rapf=True, stream=True)
        if s is Strategy.NP_RDMA:
            # NP_RDMA traffic normally never reaches the SMMU fault path
            # (repro.npr verifies translations host-side); a stray fault
            # resolves like KERNEL_RAPF so the domain cannot wedge
            return self._touch_ahead(pt, vpn, is_dst,
                                     min(PAGES_PER_BLOCK, block_pages_remaining),
                                     kernel_rapf=True, stream=False)
        raise ValueError(s)

    # ------------------------------------------------------------------
    def _touch_a_page(self, pt: PageTable, vpn: int, is_dst: bool) -> Resolution:
        c = self.cost
        kernel = c.netlink_send_us
        user = c.wakeup_us
        seg = False
        major = False
        try:
            major, _ = pt.touch(vpn)
            user += c.touch_page_us + (c.major_fault_extra_us if major else 0.0)
        except SegmentationFault:
            # The Fig-3.2 scenario: the page left the address space between
            # the fault and the touch; the library's sig_handler absorbs it.
            user += c.sigsegv_recover_us
            seg = True
        if is_dst:
            user += c.pckzer_to_mbox_us
        return Resolution(pages_resolved=0 if seg else 1, kernel_us=kernel,
                          user_us=user, rapf_from_kernel=False,
                          segfault_recovered=seg, major=major)

    def _touch_ahead(self, pt: PageTable, vpn: int, is_dst: bool,
                     lookahead: int, *, kernel_rapf: bool,
                     stream: bool) -> Resolution:
        c = self.cost
        n = pt.get_user_pages(vpn, max(1, lookahead), write=True)
        kernel = c.gup_us(max(1, n))
        user = 0.0
        if stream and n:
            # predictively warm the first page of the next block
            extra = pt.get_user_pages(vpn + n, 1, write=True)
            if extra:
                kernel += c.gup_per_page_us
                n += extra
        if is_dst:
            if kernel_rapf:
                kernel += c.pckzer_to_mbox_us
            else:
                # prototype constraint: packetizer reachable from user space
                kernel += c.netlink_send_us
                user += c.wakeup_us + c.pckzer_to_mbox_us
        return Resolution(pages_resolved=n, kernel_us=kernel, user_us=user,
                          rapf_from_kernel=kernel_rapf)
