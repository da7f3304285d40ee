"""Speculative-issue engine: the NP-RDMA datapath proper.

The thesis handles RDMA page faults *reactively in hardware*: the SMMU
terminates the access, a fault FIFO + driver tasklet resolve it, and a
RAPF message (or the 1 ms R5 timeout) retransmits.  NP-RDMA
(arXiv 2310.11062) reaches the same no-pinning goal *proactively in the
host*: transfers launch immediately on cached
:class:`~repro_torch.npr.mtt.MTTCache` translations, a host-side verification
step audits every landed page, and mis-speculation triggers
**abort-and-redirect** through the :class:`~repro_torch.npr.pool.DMAPool`
instead of an IOMMU fault.

Per-block protocol (all timings from :class:`~repro_torch.core.costmodel`):

* **source side** (``dispatch``) — pages are translated through the MTT
  as the PLDMA streams.  A resident page with a fresh entry streams at
  full speed (``mtt_hits``); a missing/stale entry costs one host
  ``mtt_fill_us`` (``mtt_misses``/``mtt_stale``).  A *non-resident* page
  pauses the block and fixes up **in microseconds on the host**
  (``npr_fixup_base_us + gup_us``) — where the thesis prototype can only
  wait out the 1 ms retransmission timeout (its single biggest
  source-fault cost, Fig 4.5/4.6);
* **destination side** (``recv_page``) — each landed page is verified
  against the MTT + page table.  Fresh hit → delivered; resident but
  uncached → host installs the entry (fill) and delivers; stale entry or
  non-resident page → the page is *lost* and, once per round, the
  destination reserves pool frames and sends an **abort** to the source
  R5 (``on_npr_abort``).  The abort reuses PR 5's generation-tagged
  tr_ID lifecycle, so an abort that outlives its block's incarnation is
  dropped (``stale_npr_aborts``) instead of redirecting a fresh block;
* **redirect round** — the aborted block re-issues with
  ``block.npr_redirect`` set and lands in the reserved pool frames
  (which cannot fault).  On full delivery the host fix-up pages the real
  destination in, copies the data out
  (``npr_fixup_base_us + gup_us + n × pool_copy_page_us``), installs
  fresh MTT entries (warming the next transfer) and ACKs;
* **pool exhaustion** — no frames, no abort: the destination stays
  silent and the source recovers by the plain 1 ms timeout.  This is the
  deliberate degradation mode that lets the thesis' RAPF datapath win
  under heavy churn with a small pool.

The engine deliberately reuses the surrounding machinery unchanged: the
DMA arbiter (slots, DRR, deschedule-on-fault), the routed interconnect,
tr_ID allocation/recycling, timeouts and ACK bookkeeping all behave
identically for both backends — only the fault handling differs, which
is what makes ``benchmarks/npr_compare.py`` a controlled comparison.
"""

from __future__ import annotations

from repro_torch.core import addresses as A
from repro_torch.core.node import Block, BlockState, Node
from repro_torch.npr.mtt import MTTCache
from repro_torch.npr.pool import DMAPool
from repro_torch.npr.stats import NPRStats


class NPREngine:
    """Per-node NP-RDMA backend: MTT + DMA pool + speculation protocol."""

    def __init__(self, node: Node, mtt_entries: int = 4096,
                 dma_pool_frames: int = 64, speculation: bool = True):
        self.node = node
        self.loop = node.loop
        self.cost = node.cost
        self.speculation = speculation
        self.stats = NPRStats(mtt_capacity=mtt_entries,
                              pool_frames=dma_pool_frames)
        self.mtt = MTTCache(mtt_entries, self.stats)
        self.pool = DMAPool(node.loop, node.cost, dma_pool_frames, self.stats,
                            allocator=node.allocator,
                            on_frames_available=self._pool_wakeup)
        self.domains: dict[int, object] = {}     # pd -> PageTable
        self._hooks: dict[int, object] = {}      # pd -> invalidation hook

    # ------------------------------------------------------------- domains
    def register_domain(self, pd: int, page_table) -> None:
        """Adopt domain ``pd``: translations for it go through the MTT,
        and the page table's invalidation hooks stale the cache exactly
        as they shoot down the SMMU TLB for the thesis datapath."""
        if pd in self.domains:
            return
        self.pool.materialize()
        self.domains[pd] = page_table
        hook = lambda vpn: self.mtt.invalidate(pd, vpn)
        page_table.invalidation_hooks.append(hook)
        self._hooks[pd] = hook

    def unregister_domain(self, pd: int) -> None:
        """Drop domain ``pd`` (``close_domain``): unhook the page table,
        forget its MTT entries wholesale.  No-op for non-NPR domains."""
        pt = self.domains.pop(pd, None)
        if pt is None:
            return
        hook = self._hooks.pop(pd, None)
        if hook is not None:
            try:
                pt.invalidation_hooks.remove(hook)
            except ValueError:
                pass
        self.mtt.drop_domain(pd)

    def invalidate_domain(self, pd: int) -> int:
        """Stale-mark every MTT entry of ``pd`` (its SMMU context bank
        was stolen by the tenancy layer).  No-op for non-NPR domains."""
        if pd not in self.domains:
            return 0
        return self.mtt.invalidate_domain(pd)

    def owns(self, block: Block) -> bool:
        """Is this block's domain served by the NP-RDMA backend?"""
        return block.transfer.pd in self.domains

    # ====================================================== source (send)
    def dispatch(self, block: Block, path, latency_class: bool) -> None:
        """Stream one block, translating source pages through the MTT.

        Called from ``R5Scheduler._dispatch`` in place of the SMMU
        per-page translate loop; the caller has already advanced
        ``round_id`` and arms the timeout after we return.
        """
        # the R5 moved the block to IN_FLIGHT just before delegating here
        # (the assert doubles as the from-state fact for repro_torch.lint)
        assert block.state is BlockState.IN_FLIGHT
        node, cost, loop = self.node, self.cost, self.loop
        transfer = block.transfer
        pd = transfer.pd
        pt = self.domains[pd]
        if block.npr_redirect or not self.speculation:
            # redirect round (or bounce-buffer mode): the block must land
            # in pre-reserved pool frames on the destination
            dst_pool = transfer.dst_node.npr.pool
            if not dst_pool.reserve(block):
                self.stats.pool_stalls += 1
                block.state = BlockState.PAUSED_DST
                node.arbiter.on_block_paused(block)
                dst_pool.add_waiter(block)
                return
            block.npr_redirect = True
        first_vpn = block.src_va >> 12
        last_vpn = (block.src_va + block.nbytes - 1) >> 12
        fill_offset = 0.0
        for i, vpn in enumerate(range(first_vpn, last_vpn + 1)):
            pte = pt.lookup(vpn)
            if not pt.is_resident(vpn):
                self._src_fixup(block, vpn, last_vpn - vpn + 1)
                return
            entry = self.mtt.lookup(pd, vpn)
            if entry is not None and not entry.stale \
                    and entry.frame == pte.frame:
                self.stats.mtt_hits += 1
                transfer.stats.mtt_hits += 1
            else:
                if entry is None:
                    self.stats.mtt_misses += 1
                    transfer.stats.mtt_misses += 1
                else:
                    self.stats.mtt_stale_hits += 1
                    transfer.stats.mtt_stale += 1
                self.mtt.install(pd, vpn, pte.frame)
                node.driver_cpu.reserve(cost.mtt_fill_us)
                transfer.stats.driver_us += cost.mtt_fill_us
                fill_offset += cost.mtt_fill_us
            pg_start = max(block.src_va, vpn << 12)
            pg_end = min(block.src_va + block.nbytes, (vpn + 1) << 12)
            nbytes = pg_end - pg_start
            # same deterministic stream key as R5Scheduler._dispatch:
            # id(block) can alias a collected block's reused address
            delay, interleaved = path.stream_page(
                nbytes, (transfer.tid, block.index),
                latency_class=latency_class)
            block.wire_bytes += nbytes
            loop.schedule(fill_offset + delay, transfer.dst_node.recv_page,
                          block, i, block.round_id, interleaved, nbytes)

    def _src_fixup(self, block: Block, vpn: int, remaining: int) -> None:
        """Source page not resident: pause and fix up host-side, in µs.

        The thesis prototype has no source-side resume at all — recovery
        is by the 1 ms timeout only (§3.2.2).  NP-RDMA's host issues the
        DMA itself, so it can ``get_user_pages`` the block's remaining
        pages, install their translations and requeue immediately.
        """
        assert block.state is BlockState.IN_FLIGHT   # see dispatch()
        node, cost = self.node, self.cost
        transfer = block.transfer
        transfer.stats.src_faults += 1
        self.stats.src_fixups += 1
        block.state = BlockState.PAUSED_SRC
        node.arbiter.on_block_paused(block)
        busy = cost.npr_fixup_base_us + cost.gup_us(remaining)
        transfer.stats.driver_us += busy
        _, end = node.driver_cpu.reserve(busy)
        self.loop.at(end, self._finish_src_fixup, block, vpn, remaining,
                     block.round_id)

    def _finish_src_fixup(self, block: Block, vpn: int, n: int,
                          round_id: int) -> None:
        if block.state is BlockState.DONE or round_id != block.round_id:
            return
        pd = block.transfer.pd
        pt = self.domains[pd]
        got = pt.get_user_pages(vpn, n, write=True)
        if not got:
            # page left the address space entirely: only the timeout can
            # retry this round (mirrors the thesis' SIGSEGV scenario)
            return
        for v in range(vpn, vpn + got):
            self.mtt.install(pd, v, pt.lookup(v).frame)
        if block.timeout_event is not None:
            block.timeout_event.cancel()
        self.node.arbiter.requeue(block)

    # ================================================= destination (recv)
    def recv_page(self, block: Block, page_idx: int, round_id: int,
                  nbytes: int) -> None:
        """Verify one landed page (speculative round) or accept it into
        the pool (redirect round).  Runs on the destination node; the
        caller has already rejected stale rounds."""
        transfer = block.transfer
        if block.npr_redirect:
            # pool frames are pre-registered: this DMA cannot fault
            self.stats.redirect_pages += 1
            transfer.stats.pool_redirect_pages += 1
            block.delivered.add(page_idx)
            if len(block.delivered) == block.n_pages:
                n = block.n_pages
                busy = (self.cost.npr_fixup_base_us + self.cost.gup_us(n)
                        + self.cost.pool_copy_page_us * n)
                transfer.stats.driver_us += busy
                _, end = self.node.driver_cpu.reserve(busy)
                self.loop.at(end, self._finish_redirect, block, round_id)
            return
        pd = transfer.pd
        pt = self.domains[pd]
        vpn = A.page_index(block.dst_va) + page_idx
        entry = self.mtt.lookup(pd, vpn)
        ok = False
        if pt.is_resident(vpn):
            frame = pt.lookup(vpn).frame
            if entry is not None and not entry.stale and entry.frame == frame:
                self.stats.mtt_hits += 1
                transfer.stats.mtt_hits += 1
                ok = True
            elif entry is None:
                # resident but uncached: verification installs the entry
                # and accepts the page (one host fill, RDMAbox-style)
                self.stats.mtt_misses += 1
                transfer.stats.mtt_misses += 1
                self.mtt.install(pd, vpn, frame)
                self.node.driver_cpu.reserve(self.cost.mtt_fill_us)
                transfer.stats.driver_us += self.cost.mtt_fill_us
                ok = True
            else:
                # stale/mismatched entry: the DMA hit a dead frame
                self.stats.mtt_stale_hits += 1
                transfer.stats.mtt_stale += 1
        elif entry is not None:
            # entry for a page that is gone: caught before completion
            self.stats.mtt_stale_hits += 1
            transfer.stats.mtt_stale += 1
        else:
            self.stats.mtt_misses += 1
            transfer.stats.mtt_misses += 1
        if ok:
            block.delivered.add(page_idx)
            if len(block.delivered) == block.n_pages:
                self._complete_speculative(block, round_id)
            return
        # ---- mis-speculation: abort-and-redirect (once per round) ------
        transfer.stats.dst_faults += 1
        if block.nacked_round == round_id:
            return
        block.nacked_round = round_id
        if not self.pool.reserve(block):
            # pool dry: no abort; the source's 1 ms timeout recovers.
            # (reserve() counted the failure — this is the degradation
            # regime where the thesis' RAPF datapath wins.)
            return
        self.stats.aborts_sent += 1
        transfer.stats.npr_aborts += 1
        delay = (self.cost.npr_abort_ctrl_us
                 + self.node.path_to(transfer.src_node.node_id).send_ctrl(8))
        self.loop.schedule(delay, transfer.src_node.r5.on_npr_abort,
                           block.tr_id, block.gen, round_id)

    def _complete_speculative(self, block: Block, round_id: int) -> None:
        # a reservation from an earlier aborted round may be outstanding
        # (the abort was lost/stale and plain retry succeeded): release it
        self.pool.cancel(block)
        delay = (self.cost.ack_us
                 + self.node.path_to(block.transfer.src_node.node_id)
                       .send_ctrl(0))
        self.loop.schedule(delay, block.transfer.src_node.r5.on_ack,
                           block, round_id)

    def _finish_redirect(self, block: Block, round_id: int) -> None:
        """Host fix-up after a redirect round fully landed in the pool:
        page the real destination in, copy out, warm the MTT, ACK."""
        transfer = block.transfer
        if block.state is BlockState.DONE or round_id != block.round_id:
            self.pool.retire(block)      # dirty frames of a dead round
            return
        pd = transfer.pd
        pt = self.domains[pd]
        vpn = A.page_index(block.dst_va)
        got = pt.get_user_pages(vpn, block.n_pages, write=True)
        if got < block.n_pages:
            # destination range (partially) unmapped: give the frames
            # back and let the timeout retry the redirect
            self.pool.retire(block)
            return
        for v in range(vpn, vpn + block.n_pages):
            self.mtt.install(pd, v, pt.lookup(v).frame)
        self.stats.redirected_blocks += 1
        self.pool.retire(block)
        delay = (self.cost.ack_us
                 + self.node.path_to(transfer.src_node.node_id).send_ctrl(0))
        self.loop.schedule(delay, transfer.src_node.r5.on_ack,
                           block, round_id)

    # ------------------------------------------------------------ plumbing
    def _pool_wakeup(self, block: Block) -> None:
        """Frames returned to the destination pool: retry a stalled block
        (on its *source* node's arbiter; requeue is idempotent and skips
        blocks that completed meanwhile)."""
        block.transfer.src_node.arbiter.requeue(block)
