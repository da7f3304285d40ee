"""Demand-paged tensor storage: one tenant of the ``repro_torch.vmem`` pager.

A :class:`PagedTensorStore` is a thin compatibility wrapper over one
:class:`~repro_torch.vmem.pager.AddressSpace` on a
:class:`~repro_torch.vmem.frames.DeviceFramePool` (a torch tensor of
frames on the chosen device, numpy backing).  Accessing a non-resident
page is a **page fault**, resolved by the tenant's
:class:`~repro_torch.api.policy.FaultPolicy` — Touch-A-Page, Touch-Ahead
(the ``get_user_pages`` block, default lookahead 4), or the beyond-paper
STREAM predictor — with eviction, prefetch, pinning and telemetry all
provided by the shared subsystem.

Timing is accounted with the calibrated :class:`CostModel` (simulated
microseconds) while the data movement itself is real (host numpy ↔ device
tensor copies through the page gather / scatter kernels).  Pass ``pool=``
to share frames with other tenants.

One difference of form from the reference: ``frames`` is the pool's one
tensor, updated **in place** (``st.frames[f] = ...``); the reference's
setter takes a new array instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api.policy import FaultPolicy
from repro_torch.compat import DeviceLike
from repro_torch.core.costmodel import CostModel, DEFAULT_COST_MODEL
from repro_torch.core.resolver import Strategy
from repro_torch.vmem import (DeviceFramePool, FramePool, Pager, PagingStats,
                              coerce_policy)

# unified telemetry: the old name stays importable
StoreStats = PagingStats


class PagedTensorStore:
    """One tenant's paged storage over a (shareable) device frame pool.

    ``device=None`` means the GPU (an error without one); it places the
    frame pool this store makes, and is not used with ``pool=`` or
    ``pager=``.
    """

    def __init__(self, page_elems: int, n_device_frames: int,
                 n_host_pages: int, dtype=np.float32,
                 strategy: Optional[Strategy] = None,
                 lookahead: Optional[int] = None,
                 cost: CostModel = DEFAULT_COST_MODEL,
                 policy: Optional[FaultPolicy] = None,
                 pool: Optional[FramePool] = None,
                 pager: Optional[Pager] = None,
                 device: DeviceLike = None):
        self.page_elems = page_elems
        self.dtype = dtype
        # only pin a per-space policy when the caller actually asked for
        # one; otherwise an injected pager's own policy must govern
        explicit = (policy is not None or strategy is not None
                    or lookahead is not None)
        policy = coerce_policy("PagedTensorStore", policy, strategy,
                               lookahead)
        self.cost = cost
        if pager is None:
            pool = pool or DeviceFramePool(n_device_frames, page_elems,
                                           dtype, device=device)
            pager = Pager(pool, policy=policy, cost=cost)
        self.pager = pager
        self.pool = pager.pool
        self.space = self.pager.create_space(
            n_host_pages, name="store",
            policy=policy if explicit else None)
        self.policy = self.pager.policy_of(self.space)
        self.strategy = self.policy.strategy
        self.lookahead = max(1, self.policy.lookahead)
        self.stats = self.space.stats

    # ---------------------------------------------------- compat views
    @property
    def page_table(self) -> np.ndarray:
        return self.space.page_table

    @property
    def pinned(self) -> np.ndarray:
        return self.space.pinned

    @property
    def prefetched(self) -> np.ndarray:
        return self.space.prefetched

    @property
    def host(self) -> np.ndarray:
        return self.space.backing

    @property
    def frames(self) -> torch.Tensor:
        """The pool's ``(n_frames, page_elems)`` tensor; write rows in
        place."""
        return self.pool.data

    @property
    def free_frames(self) -> list[int]:
        return self.pool.free

    # ------------------------------------------------------------- writes
    def write_host(self, vpage: int, data: np.ndarray) -> None:
        """Populate a page's backing store (host)."""
        self.space.write(vpage, data)

    def write_back(self, vpage: int) -> None:
        """Device -> host writeback for a resident page."""
        self.space.write_back(vpage)

    # ----------------------------------------------------------- residency
    def is_resident(self, vpage: int) -> bool:
        return self.space.is_resident(vpage)

    def resident_pages(self) -> int:
        return self.space.resident_pages()

    def pin(self, vpages) -> None:
        self.space.pin(vpages)

    def unpin(self, vpages) -> None:
        self.space.unpin(vpages)

    # --------------------------------------------------------------- reads
    def access(self, vpages) -> torch.Tensor:
        """Read pages (faulting in non-resident ones). Returns (n, elems)."""
        return self.space.access(vpages)

    def frame_ids(self, vpages) -> np.ndarray:
        """Resident frame ids for kernel page tables (must be resolved
        first — the engine calls access() or ensure_resident())."""
        return self.space.frame_ids(vpages)

    def ensure_resident(self, vpages) -> None:
        self.space.ensure_resident(vpages)
