"""Pre-registered DMA-able frame pool (the NP-RDMA redirect target).

When speculation mis-translates (stale MTT entry) or finds no resident
page at all, NP-RDMA aborts the block and *redirects* it into a small
pool of frames that were registered (pinned, IOVA-mapped) once at
startup — DMA into them can never fault.  The host then fixes the real
mapping up and copies the data out.

The pool is the backend's bounded resource, and its sizing is the
crossover lever against the thesis mechanism: a redirect can only be
offered while ``block.n_pages`` frames are free, so under heavy churn a
small pool runs dry, aborts stop being sent, and recovery degrades to
the R5's 1 ms retransmission timeout — exactly the regime where RAPF
wins (see ``benchmarks/npr_compare.py``).

Frame lifecycle (conservation checked by ``repro_torch.testing``)::

    free --reserve--> reserved --retire--> retired --refill--> free
                          \\------cancel (unused, clean)------/

* **reserve** is idempotent per block (an abort re-sent for the same
  round must not double-book) and all-or-nothing (``n_pages`` frames);
* **cancel** returns *clean* frames straight to free — the reservation
  was superseded (e.g. a later speculative round completed because the
  pages came back) and nothing was DMA'd into them;
* **retire** parks *dirty* frames after the fix-up copies data out;
  a watermark-driven batch refill re-registers them (one
  ``pool_refill_us`` charge per batch, modelling the amortized
  re-registration NP-RDMA does off the critical path).

Frames come from the node's :class:`~repro_torch.core.pagetable.FrameAllocator`
— the same physical pool backing page tables and the ``repro_torch.vmem``
frame pools — so pool sizing really competes with application memory.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.costmodel import CostModel
from repro_torch.core.pagetable import FrameAllocator
from repro_torch.core.simulator import EventLoop
from repro_torch.npr.stats import NPRStats

#: pool pages are owned by the NIC, not any protection domain
POOL_PD = -1


class DMAPool:
    """Bounded pool of pre-registered DMA-able frames on one node."""

    def __init__(self, loop: EventLoop, cost: CostModel, n_frames: int,
                 stats: NPRStats, allocator: Optional[FrameAllocator] = None,
                 on_frames_available: Optional[Callable] = None):
        if n_frames < 1:
            raise ValueError(f"DMA pool needs >= 1 frame, got {n_frames}")
        self.loop = loop
        self.cost = cost
        self.capacity = n_frames
        self.stats = stats
        self.allocator = allocator
        self._materialized = False
        self.free: list[int] = []
        self.reserved: dict = {}          # Block -> [frame, ...]
        self.retired: list[int] = []      # dirty, awaiting re-registration
        self.low_watermark = max(1, n_frames // 4)
        self._refill_pending = False
        self._waiters: list = []          # Blocks stalled on reserve()
        self._on_frames_available = on_frames_available

    # --------------------------------------------------------- registration
    def materialize(self) -> None:
        """Register the pool's frames (once, when the backend first gets a
        domain).  Lazy so nodes that never serve an NP_RDMA domain do not
        steal frames from the shared physical pool."""
        if self._materialized:
            return
        self._materialized = True
        if self.allocator is not None:
            # registered once out of the same physical pool backing the
            # page tables — pool sizing competes with application memory
            self.free = [self.allocator.alloc(POOL_PD, -1 - i)
                         for i in range(self.capacity)]
        else:
            self.free = list(range(self.capacity))

    # ------------------------------------------------------------- reserve
    def reserve(self, block) -> bool:
        """Book ``block.n_pages`` landing frames; all-or-nothing,
        idempotent per block.  Failure is counted but schedules nothing —
        callers fall back to the R5 timeout (and may :meth:`add_waiter`)."""
        if block in self.reserved:
            return True
        need = block.n_pages
        if len(self.free) < need:
            self.stats.pool_reserve_failures += 1
            return False
        frames = [self.free.pop() for _ in range(need)]
        self.reserved[block] = frames
        held = sum(len(f) for f in self.reserved.values())
        if held > self.stats.pool_reserved_peak:
            self.stats.pool_reserved_peak = held
        return True

    def cancel(self, block) -> None:
        """Release an unused (clean) reservation back to the free list."""
        frames = self.reserved.pop(block, None)
        if frames:
            self.free.extend(frames)
            self._wake_waiters()

    def retire(self, block) -> None:
        """Park a consumed (dirty) reservation for batched re-registration."""
        frames = self.reserved.pop(block, None)
        if frames:
            self.retired.extend(frames)
        if (len(self.free) < self.low_watermark and self.retired
                and not self._refill_pending):
            self._refill_pending = True
            self.loop.schedule(self.cost.pool_refill_us, self._do_refill)

    def _do_refill(self) -> None:
        self._refill_pending = False
        self.free.extend(self.retired)
        self.retired.clear()
        self.stats.pool_refills += 1
        self._wake_waiters()

    # ------------------------------------------------------------- waiters
    def add_waiter(self, block) -> None:
        """Re-notify ``block`` (FIFO) when frames return to the free list."""
        if block not in self._waiters:
            self._waiters.append(block)

    def _wake_waiters(self) -> None:
        if not self._waiters or self._on_frames_available is None:
            return
        waiters, self._waiters = self._waiters, []
        for block in waiters:
            self._on_frames_available(block)

    # ----------------------------------------------------------- observers
    def frames_accounted(self) -> int:
        """free + reserved + retired — must always equal ``capacity``."""
        return (len(self.free) + sum(len(f) for f in self.reserved.values())
                + len(self.retired))

    @property
    def outstanding_reservations(self) -> int:
        return len(self.reserved)
