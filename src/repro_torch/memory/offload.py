"""Optimizer-state offload with Touch-Ahead prefetch (the thesis' technique
applied to training memory).

Adam moments live host-side as **pages** of one block each; the ``mu``
and ``nu`` buffers are two :class:`~repro_torch.vmem.pager.AddressSpace`
tenants over one shared :class:`~repro_torch.vmem.frames.DeviceFramePool`
of four block-frames (two per buffer — the double buffer).  Each update
iterates the parameter leaves block-wise: while block *i* updates, block
*i+1* is already paged in by the pager's block prefetch, so the device
working set is two blocks instead of 2× the model size.

Page-ins are ``page_scatter`` launches into the device frame pool and
accesses ``page_gather`` launches out of it (on the GPU, the hand-written
kernels); a block's new moments are written through to the host backing.
The update arithmetic is the reference's, in f32 on the parameters'
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api.policy import FaultPolicy
from repro_torch.compat import DeviceLike, resolve_device, torch_to_numpy
from repro_torch.core.costmodel import CostModel, DEFAULT_COST_MODEL
from repro_torch.core.resolver import Strategy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.vmem import (DeviceFramePool, Pager, PagingStats,
                              coerce_policy)

# unified telemetry: the old name stays importable
OffloadStats = PagingStats

_DEFAULT = FaultPolicy(strategy=Strategy.TOUCH_AHEAD)


class PagedAdamW:
    """AdamW whose moments are host-paged and streamed block-wise.

    ``device=None`` is the GPU (and raises without one): the frame pool and
    the update live there; the parameters and gradients passed to
    :meth:`update` must too.
    """

    def __init__(self, cfg: AdamWConfig, params, *,
                 block_elems: int = 1 << 20,
                 strategy: Optional[Strategy] = None,
                 cost: CostModel = DEFAULT_COST_MODEL,
                 policy: Optional[FaultPolicy] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.block_elems = block_elems
        self.policy = coerce_policy("PagedAdamW", policy, strategy,
                                    default=_DEFAULT)
        self.strategy = self.policy.strategy
        self.cost = cost
        self.device = resolve_device(device)
        self.step = 0
        leaves = tree_leaves(params)
        self.shapes = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.sizes = [int(np.prod(s)) for s in self.shapes]
        total = sum(self.sizes)
        self.total = total
        self.offsets = np.cumsum([0] + self.sizes)
        n_blocks = max(1, -(-total // block_elems))
        # the vmem pager: one page per block, double-buffered per moment
        # buffer (fault brings the block + the next one, pool holds 4)
        stream = (self.policy.strategy is not Strategy.TOUCH_A_PAGE)
        inner = FaultPolicy(
            strategy=Strategy.TOUCH_AHEAD_N if stream
            else Strategy.TOUCH_A_PAGE,
            lookahead=2 if stream else 1)
        self.pager = Pager(DeviceFramePool(4, block_elems, np.float32,
                                           device=self.device),
                           policy=inner, cost=cost,
                           page_bytes=max(1, block_elems * 4))
        self.mu_space = self.pager.create_space(n_blocks, name="mu")
        self.nu_space = self.pager.create_space(n_blocks, name="nu")
        self.stats = self.pager.stats
        # host-resident moment pages, exposed flat (views of the backing)
        self.mu_host = self.mu_space.backing.reshape(-1)[:total]
        self.nu_host = self.nu_space.backing.reshape(-1)[:total]

    # ---------------------------------------------------------------- core
    def _blocks(self):
        for start in range(0, self.total, self.block_elems):
            yield start, min(self.total, start + self.block_elems)

    def _page(self, space, bi: int, width: int) -> torch.Tensor:
        hits = self.pager.stats.prefetch_hits
        page = self.pager.access(space, [bi])[0][:width]
        if self.pager.stats.prefetch_hits > hits:
            # the block was already in flight while its predecessor
            # computed: the double-buffered overlap
            self.stats.prefetch_overlapped += 1
        return page

    @torch.no_grad()
    def update(self, params, grads):
        """Block-streamed AdamW; returns new params (the inputs are not
        modified)."""
        self.step += 1
        cfg = self.cfg
        flat_p = torch.cat([l.float().reshape(-1)
                            for l in tree_leaves(params)])
        flat_g = torch.cat([l.float().reshape(-1)
                            for l in tree_leaves(grads)])
        step = self.step
        b1c = 1.0 - cfg.b1 ** step
        b2c = 1.0 - cfg.b2 ** step
        lr = cfg.schedule(torch.tensor(step, device=flat_p.device)) \
            if cfg.schedule else cfg.lr

        out = flat_p.clone()
        for bi, (a, b) in enumerate(self._blocks()):
            mu = self._page(self.mu_space, bi, b - a)   # page-in (real copy)
            nu = self._page(self.nu_space, bi, b - a)
            self.stats.bytes_in += (b - a) * 8

            g = flat_g[a:b]
            p = flat_p[a:b]
            mu_new = cfg.b1 * mu + (1 - cfg.b1) * g
            nu_new = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
            m_hat = mu_new / b1c
            v_hat = nu_new / b2c
            delta = m_hat / (torch.sqrt(v_hat) + cfg.eps) \
                + cfg.weight_decay * p
            out[a:b] = p - lr * delta
            self.mu_space.write(bi, torch_to_numpy(mu_new),  # write-through
                                allow_partial=True)
            self.nu_space.write(bi, torch_to_numpy(nu_new),
                                allow_partial=True)
            self.stats.bytes_out += (b - a) * 8
            self.stats.blocks_streamed += 1

        news = [out[self.offsets[i]:self.offsets[i] + sz].reshape(shape)
                .to(dtype) for i, (sz, shape, dtype) in
                enumerate(zip(self.sizes, self.shapes, self.dtypes))]
        return tree_unflatten(params, news)

    def device_bytes_resident(self) -> int:
        """Peak device bytes for moments: two blocks per buffer (the
        shared 4-frame f32 pool = 2 × block_elems × 8)."""
        return 2 * self.block_elems * 8
