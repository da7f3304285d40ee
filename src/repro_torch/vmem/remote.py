"""Fabric-backed frame pool: page-ins travel over the verbs API.

:class:`RemoteFramePool` decorates a local :class:`FramePool` so that
every pager page-in posts an asynchronous ``ProtectionDomain.post_read``
against a remote node's memory and waits for its completion on a real
:class:`~repro_torch.api.completion.CompletionQueue` — the first time the
fabric simulation and the torch data plane meet.  The local landing region
is registered ``FAULTING`` (the thesis' whole point: no pinning
ceremony), so cold page-ins take destination faults whose RAPF
retransmits surface in :class:`~repro_torch.vmem.stats.PagingStats`
(``rapf_retransmits``, ``remote_dst_faults``) and whose
:class:`WorkCompletion`s stay observable on the CQ.

This is the building block for multi-node paged serving: a KV pager
whose backing tier is another node's memory instead of local host RAM.

**Crash-fault failover.**  A pool built with a ``replica_mr`` (a second
backing region on a different node, ``build(replica_node=...)``) mirrors
every write-back (:meth:`RemoteFramePool.page_out`) to both backing
nodes and keeps per-page version counters.  When a page-in against the
primary completes with an error status (the primary backing node
crashed or partitioned away), the pool fails over: the read is re-posted
against the replica, and each page served is checked for
*read-your-writes* — the replica must hold the newest version this pool
ever wrote back (``ryw_verified`` / ``ryw_violations``).  All later
page-ins go straight to the replica.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api.completion import CompletionQueue, WorkCompletion
from repro_torch.api.config import FabricConfig
from repro_torch.api.fabric import Fabric, ProtectionDomain
from repro_torch.api.memory import BufferPrep, MemoryRegion
from repro_torch.api.policy import FaultPolicy
from repro_torch.compat import DeviceLike
from repro_torch.core import addresses as A
from repro_torch.core.arbiter import ServiceClass
from repro_torch.vmem.frames import DeviceFramePool, FramePool, PageInReceipt


class RemoteFramePool(FramePool):
    """Decorator: a local pool whose page-ins are remote verbs reads."""

    def __init__(self, local: FramePool, domain: ProtectionDomain,
                 remote_mr: MemoryRegion, local_mr: MemoryRegion,
                 cq: CompletionQueue, page_bytes: int = A.PAGE_SIZE,
                 replica_mr: Optional[MemoryRegion] = None):
        super().__init__(local.n_frames, local.page_elems)
        self.local = local
        self.free = local.free              # share allocation state
        self.domain = domain
        self.remote_mr = remote_mr
        self.local_mr = local_mr
        self.cq = cq
        self.page_bytes = page_bytes
        self.completions: list[WorkCompletion] = []
        n_pages = min(remote_mr.length, local_mr.length) // page_bytes
        if n_pages < 1:
            raise ValueError("memory regions smaller than one page")
        self.n_backing_pages = n_pages
        # ---- crash-fault failover state --------------------------------
        if replica_mr is not None:
            if replica_mr.node_id == remote_mr.node_id:
                raise ValueError(
                    "replica_mr must live on a different node than the "
                    "primary backing region (same-node replication "
                    "survives nothing)")
            if replica_mr.length // page_bytes < n_pages:
                raise ValueError("replica region smaller than the primary")
        self.replica_mr = replica_mr
        self.failed_over = False
        self.failovers = 0                  # page-ins re-served by replica
        self.ryw_verified = 0               # failover pages at newest version
        self.ryw_violations = 0             # replica missed a write-back
        # read-your-writes bookkeeping: version this pool last wrote back
        # per backing page, and the version the REPLICA is known to hold
        self._versions: dict[int, int] = {}
        self._replica_versions: dict[int, int] = {}

    # payload delegates to the local pool -------------------------------
    @property
    def dtype(self):
        return getattr(self.local, "dtype", None)

    @property
    def data(self):
        return getattr(self.local, "data", None)

    @data.setter
    def data(self, value):
        self.local.data = value

    def load(self, frame, data):
        self.local.load(frame, data)

    def store(self, frame):
        return self.local.store(frame)

    def gather(self, frames) -> torch.Tensor:
        return self.local.gather(frames)

    # transport ----------------------------------------------------------
    @property
    def active_mr(self) -> MemoryRegion:
        """The backing region page-ins currently read from."""
        return (self.replica_mr if self.failed_over and self.replica_mr
                is not None else self.remote_mr)

    def _post_read(self, mr: MemoryRegion, off: int, nbytes: int,
                   prefetch: bool) -> WorkCompletion:
        if self.cq.outstanding >= self.cq.max_outstanding:
            # keep the posting verbs unblocked; history stays in
            # ``completions`` for callers that drained nothing themselves
            self.completions.extend(self.cq.poll(self.cq.max_outstanding))
        # a demand page-in is on some tenant's critical path -> LATENCY;
        # predictive stream warm-ups share bandwidth as BULK traffic
        wr = self.domain.post_read(mr, self.local_mr,
                                   cq=self.cq, nbytes=nbytes,
                                   target_offset=off, local_offset=off,
                                   service_class=(ServiceClass.BULK
                                                  if prefetch else
                                                  ServiceClass.LATENCY))
        return wr.result()

    def page_in(self, space, vpage: int, n_pages: int,
                prefetch: bool = False) -> PageInReceipt:
        if vpage + n_pages > self.n_backing_pages:
            raise ValueError(
                f"page-in [{vpage}, {vpage + n_pages}) beyond the remote "
                f"region ({self.n_backing_pages} pages)")
        off = vpage * self.page_bytes
        nbytes = n_pages * self.page_bytes
        t0 = self.fabric.now
        wc = self._post_read(self.active_mr, off, nbytes, prefetch)
        failovers = 0
        if not wc.ok and not self.failed_over and self.replica_mr is not None:
            # primary backing node crashed/partitioned: fail over to the
            # replica pager and re-serve this read from it.  latency_us
            # below spans BOTH attempts — detection time is part of the
            # recovery latency the chaos benchmark claims.
            self.failed_over = True
            wc = self._post_read(self.replica_mr, off, nbytes, prefetch)
        if self.failed_over and wc.ok:
            failovers = 1
            self.failovers += 1
            self._verify_ryw(vpage, n_pages)
        return PageInReceipt(us=self.fabric.now - t0 if failovers
                             else wc.latency_us,
                             remote_reads=1,
                             rapf_retransmits=wc.stats.rapf_retransmits,
                             dst_faults=wc.stats.dst_faults,
                             bytes_in=nbytes if wc.ok else 0,
                             failovers=failovers,
                             mtt_hits=wc.stats.mtt_hits,
                             mtt_misses=wc.stats.mtt_misses,
                             mtt_stale=wc.stats.mtt_stale,
                             pool_redirects=wc.stats.pool_redirect_pages)

    def _verify_ryw(self, vpage: int, n_pages: int) -> None:
        """Read-your-writes check: every page served by the replica must
        carry the newest version this pool ever wrote back."""
        for p in range(vpage, vpage + n_pages):
            want = self._versions.get(p, 0)
            if self._replica_versions.get(p, 0) == want:
                self.ryw_verified += 1
            else:
                self.ryw_violations += 1

    def page_out(self, space, vpage: int, n_pages: int = 1) -> float:
        """Write back ``n_pages`` starting at ``vpage`` to the backing
        store — mirrored to the replica when one is configured, so a
        later failover read observes the write (read-your-writes).

        Returns the simulated microseconds the write-back(s) took.
        """
        if vpage + n_pages > self.n_backing_pages:
            raise ValueError(
                f"page-out [{vpage}, {vpage + n_pages}) beyond the remote "
                f"region ({self.n_backing_pages} pages)")
        off = vpage * self.page_bytes
        nbytes = n_pages * self.page_bytes
        for p in range(vpage, vpage + n_pages):
            self._versions[p] = self._versions.get(p, 0) + 1
        targets = []
        if not self.failed_over:
            targets.append((self.remote_mr, False))
        if self.replica_mr is not None:
            targets.append((self.replica_mr, True))
        t0 = self.fabric.now
        for mr, is_replica in targets:
            if self.cq.outstanding >= self.cq.max_outstanding:
                self.completions.extend(
                    self.cq.poll(self.cq.max_outstanding))
            wr = self.domain.post_write(self.local_mr, mr, cq=self.cq,
                                        nbytes=nbytes, src_offset=off,
                                        dst_offset=off,
                                        service_class=ServiceClass.BULK)
            wc = wr.result()
            if is_replica and wc.ok:
                # only a COMPLETED replica write is read-your-writes
                # visible; a failed one must surface as a violation
                for p in range(vpage, vpage + n_pages):
                    self._replica_versions[p] = self._versions[p]
            elif not is_replica and not wc.ok and self.replica_mr is not None:
                # the primary died under a write-back: stop sending it
                # traffic — subsequent reads and writes go replica-only
                self.failed_over = True
        return self.fabric.now - t0

    # telemetry ----------------------------------------------------------
    @property
    def fabric(self) -> Fabric:
        return self.domain.fabric

    def net_stats(self):
        """Interconnect telemetry of the backing fabric — on routed
        topologies a page-in's route shares links with other tenants, so
        remote paging latency reflects real path contention."""
        return self.fabric.net_stats()

    # convenience builder ------------------------------------------------
    @classmethod
    def build(cls, *, n_frames: int, page_elems: int, n_pages: int,
              fabric: Optional[Fabric] = None,
              config: Optional[FabricConfig] = None, pd: int = 1,
              policy: Optional[FaultPolicy] = None,
              local: Optional[FramePool] = None,
              page_bytes: int = A.PAGE_SIZE,
              local_node: int = 0, remote_node: int = 1,
              local_base: int = 0x10_0000_0000,
              remote_base: int = 0x20_0000_0000,
              replica_node: Optional[int] = None,
              replica_base: int = 0x30_0000_0000,
              cq_depth: int = 256, dtype=np.float32,
              device: DeviceLike = None) -> "RemoteFramePool":
        """Wire a fabric scenario: remote backing (pre-touched), faulting
        local landing buffer, one CQ, one protection domain.

        ``config`` selects the fabric when none is passed — e.g. a
        routed ``FabricConfig(n_nodes=8, topology="torus_2d")`` whose
        multi-hop paths make page-ins contend with other traffic; the
        default is the seed's two-node ALL_TO_ALL.

        ``replica_node`` registers a second (pre-touched) backing region
        there and arms crash-fault failover: if the primary backing node
        dies, page-ins transparently re-serve from the replica (with
        read-your-writes verification against mirrored write-backs).

        ``dtype`` and ``device`` place the local ``DeviceFramePool`` this
        builds when ``local`` is not given: ``device=None`` means the GPU
        and raises without one.  A ``local`` pool (e.g. a control-plane
        ``FrameIdPool``) needs neither.
        """
        if fabric is not None and config is not None:
            raise ValueError("pass either fabric= or config=, not both")
        fabric = fabric or Fabric.build(config or FabricConfig(n_nodes=2))
        n_nodes = len(fabric.nodes)
        if not (0 <= local_node < n_nodes and 0 <= remote_node < n_nodes):
            raise ValueError(
                f"local_node={local_node} / remote_node={remote_node} "
                f"outside the fabric's {n_nodes} nodes")
        if replica_node is not None:
            if not 0 <= replica_node < n_nodes:
                raise ValueError(
                    f"replica_node={replica_node} outside the fabric's "
                    f"{n_nodes} nodes")
            if replica_node == remote_node:
                raise ValueError(
                    "replica_node must differ from remote_node")
        domain = fabric.domain(pd) or fabric.open_domain(pd, policy=policy)
        size = n_pages * page_bytes
        remote_mr = domain.register_memory(remote_node, remote_base, size,
                                           prep=BufferPrep.TOUCHED)
        local_mr = domain.register_memory(local_node, local_base, size,
                                          prep=BufferPrep.FAULTING)
        replica_mr = None
        if replica_node is not None:
            replica_mr = domain.register_memory(
                replica_node, replica_base, size, prep=BufferPrep.TOUCHED)
        cq = fabric.create_cq(depth=cq_depth)
        local = local or DeviceFramePool(n_frames, page_elems, dtype,
                                         device=device)
        return cls(local, domain, remote_mr, local_mr, cq,
                   page_bytes=page_bytes, replica_mr=replica_mr)
