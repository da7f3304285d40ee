"""Invariant checkers for the stress harness (and the property tests).

Each checker returns a list of human-readable violation strings — empty
means the invariant holds.  They are pure observers: no checker mutates
fabric, pager or page-table state, so they can run mid-soak as well as
at the end.
"""

from __future__ import annotations

from typing import Iterable, List

from repro_torch.core.arbiter import ArbiterStats
from repro_torch.net.link import LinkStats

NON_RESIDENT = -1


# ---------------------------------------------------------------- fabric
def check_completion_conservation(posted_ids: Iterable[int],
                                  completed_ids: Iterable[int],
                                  label: str = "") -> List[str]:
    """Every posted work request completes exactly once (no lost or
    duplicated completions) — the block-conservation invariant at WR
    granularity."""
    posted = list(posted_ids)
    completed = list(completed_ids)
    out = []
    tag = f" [{label}]" if label else ""
    if len(set(posted)) != len(posted):
        out.append(f"duplicate wr_ids posted{tag}")
    dupes = {w for w in completed if completed.count(w) > 1}
    if dupes:
        out.append(f"wr_ids completed more than once{tag}: {sorted(dupes)}")
    lost = set(posted) - set(completed)
    if lost:
        out.append(f"posted but never completed{tag}: {sorted(lost)}")
    phantom = set(completed) - set(posted)
    if phantom:
        out.append(f"completed but never posted{tag}: {sorted(phantom)}")
    return out


def check_pinned_resident(fabric) -> List[str]:
    """Pinned pages are exempt from reclaim/THP: every pinned PTE must
    still be RESIDENT, whatever churn the injection schedule applied."""
    out = []
    for node in fabric.nodes:
        for pd, pt in node.page_tables.items():
            for vpn, pte in pt.entries.items():
                if pte.pinned and pte.state.name != "RESIDENT":
                    out.append(
                        f"node {node.node_id} pd={pd} vpn={vpn:#x}: pinned "
                        f"page in state {pte.state.name}")
    return out


def check_link_conservation(fabric) -> List[str]:
    """Per-link packet conservation over the routed interconnect: every
    directed link carried exactly the data/ctrl packets of the routes
    that cross it (ledger recomputed from the deterministic router) —
    nothing lost, duplicated, or smuggled around the topology."""
    return fabric.interconnect.conservation_violations()


def check_route_sanity(fabric) -> List[str]:
    """Static route invariants for every (src, dst) pair: consecutive
    hops are physical adjacencies, no node repeats, and hop counts are
    symmetric (|route(a, b)| == |route(b, a)| for minimal routing)."""
    out = []
    ic = fabric.interconnect
    n = ic.topology.n_nodes
    for a in range(n):
        for b in range(n):
            try:
                fwd = ic.router.route(a, b)      # router verifies adjacency
                rev = ic.router.route(b, a)
            except Exception as e:               # RoutingError et al.
                out.append(f"route {a}->{b}: {e}")
                continue
            if len(fwd) != len(rev):
                out.append(
                    f"asymmetric hop count: |{a}->{b}|={len(fwd) - 1} "
                    f"but |{b}->{a}|={len(rev) - 1}")
    return out


def check_tr_id_lifecycle(fabric) -> List[str]:
    """The tr_ID free-list/index invariants on every node's R5:

    * no ID is simultaneously free and owned by a pending block;
    * the free list holds no duplicates;
    * the accounting identity ``fresh_issued == pending + free`` holds
      (every issued ID is either owned or recyclable);
    * the per-(pd, vpn) source-fault index contains exactly the pending
      blocks, in launch order — the O(1) lookup must answer precisely
      what the seed's O(pending) scan would have;
    * once the fabric drained: nothing pending, no deferred launches.
    """
    out = []
    for node in fabric.nodes:
        r5 = node.r5
        tag = f"node {node.node_id}"
        free = list(r5._free)
        if len(set(free)) != len(free):
            out.append(f"{tag}: duplicate tr_ids on the free list")
        overlap = set(free) & set(r5.pending)
        if overlap:
            out.append(f"{tag}: tr_ids both free and pending: "
                       f"{sorted(overlap)[:8]}")
        issued = r5._fresh_next
        if len(r5.pending) + len(free) != issued:
            out.append(
                f"{tag}: {len(r5.pending)} pending + {len(free)} free != "
                f"{issued} ids issued (leaked or double-freed)")
        for tid, block in r5.pending.items():
            if block.tr_id != tid:
                out.append(f"{tag}: pending[{tid}] holds block with "
                           f"tr_id={block.tr_id}")
        # rebuild the src index from pending (launch order == dict order);
        # keys are the scheduler's packed ``(pd << 32) | vpn`` ints
        expect: dict = {}
        for block in r5.pending.values():
            base = block.transfer.pd << 32
            first = block.src_va >> 12
            last = (block.src_va + block.nbytes - 1) >> 12
            for vpn in range(first, last + 1):
                expect.setdefault(base | vpn, []).append(block)
        if expect != r5._src_index:
            missing = set(expect) ^ set(r5._src_index)
            out.append(f"{tag}: src-fault index diverged from pending "
                       f"({len(missing)} keys differ)")
        if fabric.loop.idle:
            if r5.pending:
                out.append(f"{tag}: {len(r5.pending)} blocks still pending "
                           f"after drain")
            if r5._starved:
                out.append(f"{tag}: {len(r5._starved)} deferred launches "
                           f"left after drain")
    return out


def check_npr_consistency(fabric) -> List[str]:
    """NP-RDMA backend invariants, on every node serving NP_RDMA domains:

    * a *fresh* (non-stale) MTT entry never maps a reclaimed or moved
      frame: its page must be RESIDENT with exactly that frame — i.e.
      the page-table invalidation hooks staled every dying translation;
    * no page ever completed through a stale translation
      (``stats.stale_completions == 0`` — the backend's safety property);
    * DMA-pool frame conservation: ``free + reserved + retired`` equals
      the registered capacity and no frame sits in two lifecycle sets;
    * once the fabric drained: no pool reservation outstanding (every
      redirect retired its frames, every superseded one was cancelled).
    """
    out = []
    for node in fabric.nodes:
        eng = node.npr
        if not eng.domains:
            continue
        tag = f"node {node.node_id}"
        for (pd, vpn), e in eng.mtt.entries():
            if e.stale:
                continue
            pt = eng.domains.get(pd)
            if pt is None:
                out.append(f"{tag}: MTT entry for unregistered pd={pd}")
                continue
            pte = pt.lookup(vpn)
            if pte.state.name != "RESIDENT":
                out.append(
                    f"{tag} pd={pd} vpn={vpn:#x}: fresh MTT entry maps a "
                    f"{pte.state.name} page (missed invalidation)")
            elif pte.frame != e.frame:
                out.append(
                    f"{tag} pd={pd} vpn={vpn:#x}: fresh MTT entry frame "
                    f"{e.frame} != page-table frame {pte.frame}")
        if eng.stats.stale_completions:
            out.append(f"{tag}: {eng.stats.stale_completions} pages "
                       f"completed through a stale translation")
        pool = eng.pool
        frames = list(pool.free) + list(pool.retired)
        for held in pool.reserved.values():
            frames.extend(held)
        if len(frames) != pool.capacity:
            out.append(f"{tag}: DMA pool accounts {len(frames)} frames, "
                       f"capacity {pool.capacity}")
        if len(set(frames)) != len(frames):
            out.append(f"{tag}: DMA-pool frame in two lifecycle sets")
        if fabric.loop.idle and pool.reserved:
            out.append(f"{tag}: {len(pool.reserved)} DMA-pool reservations "
                       f"outstanding after drain")
    return out


#: the WCStatus values a failed transfer may carry (kept as strings to
#: match ``Transfer.failed_status`` — the core layer never imports api)
FAILED_STATUSES = {"retry_exc_err", "wr_flush_err", "remote_op_err"}


def check_crash_consistency(fabric) -> List[str]:
    """Crash-fault invariants, safe to run mid-soak or after drain:

    * a crashed node's datapath is *silent*: its arbiter holds no PLDMA
      slot and queues no block, and every tr_id it still leases belongs
      to a DONE (failed) block awaiting lease expiry — a dead machine
      neither launches nor retransmits;
    * a crashed node is fenced off the interconnect: every incident
      directed link is marked down (``fail_node`` left no back door);
    * every failed transfer fail-stopped *cleanly*: its status is one of
      the three crash-fault WC statuses, every block reached DONE and
      left the arbiter queue, and the transfer never also reports
      ``complete`` — i.e. its work request completes exactly once, with
      a non-SUCCESS status, never both ways.
    """
    out = []
    ic = fabric.interconnect
    for node in fabric.nodes:
        tag = f"node {node.node_id}"
        r5 = node.r5
        if node.crashed:
            arb = node.arbiter
            if arb.in_flight:
                out.append(f"{tag}: crashed but {arb.in_flight} blocks "
                           f"still hold PLDMA slots")
            depth = arb.queue_depth()
            if depth:
                out.append(f"{tag}: crashed but {depth} blocks still "
                           f"queued in the arbiter")
            for tid, block in r5.pending.items():
                if block.state.name != "DONE":
                    out.append(f"{tag}: crashed but leased tr_id {tid} "
                               f"holds a {block.state.name} block")
            for nbr in ic.topology.neighbors(node.node_id):
                if (node.node_id, nbr) not in ic.down \
                        or (nbr, node.node_id) not in ic.down:
                    out.append(f"{tag}: crashed but link to {nbr} is "
                               f"not marked down")
        # failed transfers (any node — retry exhaustion and flush happen
        # on live nodes too) must have fail-stopped cleanly
        seen: set = set()
        for block in r5.pending.values():
            t = block.transfer
            if id(t) in seen:
                continue
            seen.add(id(t))
            if t.failed_status is None:
                continue
            if t.failed_status not in FAILED_STATUSES:
                out.append(f"{tag} tid={t.tid}: unknown failed_status "
                           f"{t.failed_status!r}")
            if t.complete:
                out.append(f"{tag} tid={t.tid}: transfer both failed "
                           f"({t.failed_status}) and complete — its WR "
                           f"would complete twice")
            for b in t.blocks:
                if b.state.name != "DONE":
                    out.append(f"{tag} tid={t.tid}: failed transfer "
                               f"holds a {b.state.name} block")
                if b.queued:
                    out.append(f"{tag} tid={t.tid}: failed transfer's "
                               f"block still queued in the arbiter")
    return out


def check_arbiter_consistency(fabric) -> List[str]:
    """Arbiter telemetry and end-state sanity:

    * per-domain :class:`ArbiterStats` sum to the node total on every
      additive field;
    * DRR deficit counters sit inside the fairness bound;
    * once the fabric drained, no block is queued, slotted, or counted
      outstanding (nothing leaked a PLDMA slot).
    """
    out = []
    for node in fabric.nodes:
        arb = node.arbiter
        for field in ArbiterStats.ADDITIVE:
            total = getattr(arb.stats, field)
            per_dom = sum(getattr(s, field)
                          for s in arb.domain_stats.values())
            if total != per_dom:
                out.append(
                    f"node {node.node_id}: arbiter stats field {field!r} "
                    f"total {total} != per-domain sum {per_dom}")
        out.extend(arb.deficit_bound_violations())
        out.extend(arb.depth_counter_violations())
        if fabric.loop.idle:
            if arb.in_flight != 0:
                out.append(f"node {node.node_id}: {arb.in_flight} blocks "
                           f"still hold PLDMA slots after drain")
            depth = arb.queue_depth()
            if depth != 0:
                out.append(f"node {node.node_id}: {depth} blocks still "
                           f"queued after drain")
            for pd in arb.domain_stats:
                n = arb.outstanding(pd)
                if n != 0:
                    out.append(f"node {node.node_id} pd={pd}: {n} blocks "
                               f"still outstanding after drain")
    return out


def check_bank_conservation(fabric) -> List[str]:
    """Tenancy control-plane invariants on every node's BankManager/SMMU:

    * the pd <-> bank binding is a bijection: no two domains share a
      bank, no domain holds two banks, and at most ``capacity`` (16)
      banks are ever bound;
    * the SMMU agrees with the manager: a bound bank's attached page
      table IS the bound domain's page table, and an unbound bank is
      detached;
    * TLB entries exist only for bound banks (a steal's
      ``tlb_invalidate_all`` left nothing behind);
    * the counters obey their accounting identities:
      ``shootdowns == steals`` (every steal shoots down the victim) and
      ``binds >= steals`` (a steal is one kind of bind).
    """
    out = []
    for node in fabric.nodes:
        tag = f"node {node.node_id}"
        mgr = node.tenancy.banks
        bindings = mgr.bindings()               # bank -> pd snapshot
        if len(bindings) > mgr.capacity:
            out.append(f"{tag}: {len(bindings)} banks bound, capacity "
                       f"{mgr.capacity}")
        pds = list(bindings.values())
        if len(set(pds)) != len(pds):
            out.append(f"{tag}: one pd bound to multiple banks")
        for bank, pd in bindings.items():
            if not mgr.registered(pd):
                out.append(f"{tag}: bank {bank} bound to unregistered "
                           f"pd={pd}")
            pt = node.page_tables.get(pd)
            attached = node.smmu.banks[bank].page_table
            if pt is None:
                out.append(f"{tag}: bank {bank} bound to pd={pd} with no "
                           f"page table")
            elif attached is not pt:
                out.append(f"{tag}: bank {bank} SMMU page table is not "
                           f"pd={pd}'s (stale attach after a steal?)")
        for bank in range(mgr.capacity):
            if bank not in bindings \
                    and node.smmu.banks[bank].page_table is not None:
                out.append(f"{tag}: unbound bank {bank} still attached "
                           f"in the SMMU")
        for key in node.smmu._tlb:      # packed (bank << 32) | vpn keys
            bank, vpn = key >> 32, key & 0xFFFF_FFFF
            if bank not in bindings:
                out.append(f"{tag}: TLB entry for unbound bank {bank} "
                           f"vpn={vpn:#x} (missed shootdown)")
        st = mgr.stats
        if st.shootdowns != st.steals:
            out.append(f"{tag}: {st.steals} steals but {st.shootdowns} "
                       f"shootdowns (every steal must invalidate)")
        if st.binds < st.steals:
            out.append(f"{tag}: binds {st.binds} < steals {st.steals}")
    return out


def check_tenant_isolation(fabric) -> List[str]:
    """Cross-tenant isolation after any amount of bank thrash:

    * no physical frame is owned by two (pd, vpn) mappings — the
      FrameAllocator's owner ledger is authoritative and every owning
      page table agrees with it;
    * every TLB entry's cached frame matches the *current* owner's page
      table (a stolen bank's stale walks can never leak another
      tenant's frame);
    * SRQ accounting: held entries never exceed the configured bound
      and, once the fabric drained, every acquired entry was released.
    """
    from repro_torch.npr.pool import POOL_PD
    out = []
    for node in fabric.nodes:
        tag = f"node {node.node_id}"
        for frame, (pd, vpn) in node.allocator.owner.items():
            if pd == POOL_PD:
                continue      # NP-RDMA DMA-pool frames: no page table
            pt = node.page_tables.get(pd)
            if pt is None:
                # domain closed: release_domain should have freed these
                out.append(f"{tag}: frame {frame} owned by closed pd={pd}")
                continue
            pte = pt.entries.get(vpn)
            if pte is None or pte.frame != frame:
                out.append(f"{tag}: allocator says frame {frame} -> "
                           f"(pd={pd}, vpn={vpn:#x}) but the page table "
                           f"disagrees")
        bindings = node.tenancy.banks.bindings()
        for key, frame in node.smmu._tlb.items():
            bank, vpn = key >> 32, key & 0xFFFF_FFFF
            pd = bindings.get(bank)
            if pd is None:
                continue                    # reported by bank conservation
            pt = node.page_tables.get(pd)
            pte = pt.entries.get(vpn) if pt is not None else None
            if pte is None or pte.state.name != "RESIDENT" \
                    or pte.frame != frame:
                out.append(f"{tag}: TLB bank {bank} vpn={vpn:#x} caches "
                           f"frame {frame} not owned by pd={pd} "
                           f"(cross-tenant leak)")
        srq = node.tenancy.srq
        limit = srq.entries
        if limit is not None and srq.held > limit:
            out.append(f"{tag}: SRQ holds {srq.held} > {limit} entries")
        if srq.held < 0:
            out.append(f"{tag}: SRQ held count negative ({srq.held})")
        if fabric.loop.idle and srq.held:
            out.append(f"{tag}: {srq.held} SRQ entries still held after "
                       f"drain (leaked receive credits)")
    return out


def check_stats_accounting(fabric) -> List[str]:
    """Counter-accounting identities on the ``*Stats`` records the soak
    harness regresses on (the ``stats-coverage`` lint rule holds every
    counter to one of these checks or a justified exemption):

    * tr_ID telemetry matches the R5's live structures
      (``allocated == fresh + recycled``, ``fresh`` equals the IDs ever
      issued, ``in_flight == len(pending)``), the high-water mark sits
      between the live count and the ID-space size, and a stall is only
      possible once the whole ID space has been in flight;
    * CQ slot conservation: ``outstanding == posted - drained`` (a
      queued completion still occupies its slot), the queue never beat
      its high-water mark or depth, and polls dominate empty polls;
    * fault-FIFO occupancy equals ``pushes - pops`` and respects the
      recorded high-water mark and the hardware depth;
    * the arbiter backlog never exceeds its own high-water mark;
    * bank counters: every rebind is a bind, every immune steal a steal;
    * SRQ conservation: ``admitted - released == held`` with the peak
      between the live count and total admissions (and under the bound);
    * SMMU TLB hits never exceed translations, page-table unpins never
      exceed pins, and the NP-RDMA capacity counters mirror the live
      pool/MTT (with the reservation peak inside the pool);
    * interconnect totals are exactly the field-wise sum of the per-link
      ledgers (``LinkStats.ADDITIVE``) with ``max_queue_us`` the
      per-link maximum, and no link's worst single wait exceeds its
      summed wait.
    """
    out = []
    for node in fabric.nodes:
        tag = f"node {node.node_id}"
        r5 = node.r5
        st = r5.id_stats
        if st.allocated != st.fresh + st.recycled:
            out.append(f"{tag}: tr_id allocated {st.allocated} != fresh "
                       f"{st.fresh} + recycled {st.recycled}")
        if st.fresh != r5._fresh_next:
            out.append(f"{tag}: tr_id fresh count {st.fresh} != "
                       f"{r5._fresh_next} ids ever issued")
        if st.in_flight != len(r5.pending):
            out.append(f"{tag}: tr_id in_flight {st.in_flight} != "
                       f"{len(r5.pending)} pending blocks")
        if not st.in_flight <= st.max_in_flight <= st.space:
            out.append(f"{tag}: tr_id in_flight {st.in_flight} / "
                       f"high-water {st.max_in_flight} / space {st.space} "
                       f"out of order")
        if st.stalls and st.max_in_flight != st.space:
            out.append(f"{tag}: {st.stalls} stalls but the ID space never "
                       f"filled (max_in_flight {st.max_in_flight} < "
                       f"{st.space})")
        fifo = node.fifo
        fst = fifo.stats
        if fst.pushes - fst.pops != len(fifo):
            out.append(f"{tag}: FIFO holds {len(fifo)} entries, but pushes "
                       f"{fst.pushes} - pops {fst.pops} says "
                       f"{fst.pushes - fst.pops}")
        if not len(fifo) <= fst.max_occupancy <= fifo.depth:
            out.append(f"{tag}: FIFO occupancy {len(fifo)} / high-water "
                       f"{fst.max_occupancy} / depth {fifo.depth} "
                       f"out of order")
        arb = node.arbiter
        if arb.stats.max_queue_depth < arb.queue_depth():
            out.append(f"{tag}: arbiter backlog {arb.queue_depth()} beats "
                       f"its high-water mark {arb.stats.max_queue_depth}")
        bst = node.tenancy.banks.stats
        if bst.immune_steals > bst.steals:
            out.append(f"{tag}: immune_steals {bst.immune_steals} > "
                       f"steals {bst.steals}")
        if bst.rebinds > bst.binds:
            out.append(f"{tag}: rebinds {bst.rebinds} > binds {bst.binds}")
        srq = node.tenancy.srq
        sst = srq.stats
        if sst.admitted - sst.released != srq.held:
            out.append(f"{tag}: SRQ admitted {sst.admitted} - released "
                       f"{sst.released} != held {srq.held}")
        if not srq.held <= sst.peak_held <= sst.admitted:
            out.append(f"{tag}: SRQ held {srq.held} / peak {sst.peak_held} "
                       f"/ admitted {sst.admitted} out of order")
        if srq.entries is not None and sst.peak_held > srq.entries:
            out.append(f"{tag}: SRQ peak {sst.peak_held} > bound "
                       f"{srq.entries}")
        sm = node.smmu.stats
        if sm.tlb_hits > sm.translations:
            out.append(f"{tag}: SMMU tlb_hits {sm.tlb_hits} > "
                       f"{sm.translations} translations")
        for pd, pt in sorted(node.page_tables.items()):
            pst = pt.stats
            if pst.unpins > pst.pins:
                out.append(f"{tag} pd={pd}: unpins {pst.unpins} > pins "
                           f"{pst.pins}")
        eng = node.npr
        if eng.domains:
            nst = eng.stats
            if nst.pool_frames != eng.pool.capacity:
                out.append(f"{tag}: NPR pool_frames {nst.pool_frames} != "
                           f"pool capacity {eng.pool.capacity}")
            if nst.mtt_capacity != eng.mtt.capacity:
                out.append(f"{tag}: NPR mtt_capacity {nst.mtt_capacity} != "
                           f"MTT capacity {eng.mtt.capacity}")
            if nst.pool_reserved_peak > nst.pool_frames:
                out.append(f"{tag}: NPR pool reservation peak "
                           f"{nst.pool_reserved_peak} > {nst.pool_frames} "
                           f"frames")

    for i, cq in enumerate(getattr(fabric, "cqs", ())):
        cst = cq.stats
        drained = cst.completed - len(cq)
        if cq.outstanding != cst.posted - drained:
            out.append(f"cq {i}: {cq.outstanding} outstanding != posted "
                       f"{cst.posted} - drained {drained}")
        if not len(cq) <= cst.max_queued <= cq.depth:
            out.append(f"cq {i}: queued {len(cq)} / high-water "
                       f"{cst.max_queued} / depth {cq.depth} out of order")
        if cst.empty_polls > cst.polls:
            out.append(f"cq {i}: empty_polls {cst.empty_polls} > polls "
                       f"{cst.polls}")

    ic = fabric.interconnect
    fs = ic.stats()
    totals = {f: 0 for f in LinkStats.ADDITIVE}
    worst = 0.0
    for _, link in sorted(ic.links.items()):
        s = link.stats
        if s.max_queue_us > s.queue_us:
            out.append(f"link {link.name}: worst single wait "
                       f"{s.max_queue_us} > summed wait {s.queue_us}")
        if not (s.data_packets or s.ctrl_packets):
            continue                # ic.stats() skips quiet links the same
        for f in LinkStats.ADDITIVE:
            totals[f] += getattr(s, f)
        worst = max(worst, s.max_queue_us)
    totals["busy_us"] = round(totals["busy_us"], 6)
    totals["queue_us"] = round(totals["queue_us"], 6)
    for f in LinkStats.ADDITIVE:
        if getattr(fs, f) != totals[f]:
            out.append(f"net: fabric total {f} {getattr(fs, f)} != "
                       f"per-link sum {totals[f]}")
    if fs.max_queue_us != round(worst, 6):
        out.append(f"net: fabric max_queue_us {fs.max_queue_us} != "
                   f"per-link max {round(worst, 6)}")
    return out


# ------------------------------------------------------------------ vmem
def check_vmem_frame_conservation(pool) -> List[str]:
    """No frame double-owned across the pool's address spaces, and the
    pool's used-frame count equals the resident-page count."""
    out = []
    owner = {}
    resident = 0
    for sp in pool.spaces:
        for vpage in range(sp.n_pages):
            f = int(sp.page_table[vpage])
            if f == NON_RESIDENT:
                continue
            resident += 1
            if f in owner:
                out.append(f"frame {f} owned by both {owner[f]} and "
                           f"({sp.name!r}, {vpage})")
            owner[f] = (sp.name, vpage)
    if resident != pool.frames_used:
        out.append(f"{resident} resident pages but pool reports "
                   f"{pool.frames_used} frames used")
    free = set(pool.free)
    leaked = free & set(owner)
    if leaked:
        out.append(f"frames on the free list while mapped: {sorted(leaked)}")
    return out


def check_vmem_pins(pool) -> List[str]:
    """A pinned page is never evicted: pinned implies resident."""
    out = []
    for sp in pool.spaces:
        for vpage in range(sp.n_pages):
            if sp.pinned[vpage] and \
                    int(sp.page_table[vpage]) == NON_RESIDENT:
                out.append(f"space {sp.name!r} vpage {vpage}: pinned "
                           f"but not resident")
    return out
