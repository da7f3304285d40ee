"""DEPRECATED synchronous engine — thin shim over :mod:`repro_torch.api`.

``RDMAEngine`` was the original flat, synchronous API: a 9-kwarg
constructor, one global fault-resolution strategy, raw ``(pd, va,
nbytes)`` triples, and blocking ``run_transfer``.  It is kept only so the
seed tests and any out-of-tree callers keep working; everything it does is
delegated to the verbs-style API:

* ``RDMAEngine(...)``          -> ``Fabric.build(FabricConfig(...))``
* ``map_buffer(...)``          -> ``domain.register_memory(...)``
* ``remote_write/read(...)``   -> ``domain.post_write/post_read(...)``
* ``run_transfer(t)``          -> ``cq.wait(...)`` / ``wr.result(...)``

New code should import from :mod:`repro_torch.api` directly.
"""

from __future__ import annotations

import warnings
from typing import Optional

from repro_torch.core import addresses as A
from repro_torch.core.costmodel import CostModel
from repro_torch.core.fault import FaultModel
from repro_torch.core.node import Transfer, TransferStats
from repro_torch.core.resolver import Strategy
# Canonical homes are repro_torch.api.memory; re-exported here for the old names.
from repro_torch.api.memory import BufferPrep, PrepCost

__all__ = ["BufferPrep", "PrepCost", "RDMAEngine"]


class RDMAEngine:
    """Deprecated: use :class:`repro_torch.api.Fabric` (see module docstring)."""

    def __init__(self, n_nodes: int = 2,
                 strategy: Strategy = Strategy.TOUCH_AHEAD,
                 cost: Optional[CostModel] = None,
                 hupcf: bool = True,
                 fault_model: FaultModel = FaultModel.TERMINATE,
                 frames_per_node: int = 1 << 20,
                 pin_limit_bytes: Optional[int] = None,
                 lookahead: int = A.PAGES_PER_BLOCK,
                 hops: int = 1):
        warnings.warn(
            "RDMAEngine is deprecated; build a repro_torch.api.Fabric with a "
            "FabricConfig and use the verbs API (register_memory / "
            "post_write / CompletionQueue)", DeprecationWarning, stacklevel=2)
        from repro_torch.api.config import FabricConfig
        from repro_torch.api.fabric import Fabric
        from repro_torch.api.policy import FaultPolicy
        policy = FaultPolicy(strategy=strategy, lookahead=lookahead,
                             pin_limit_bytes=pin_limit_bytes)
        self.fabric = Fabric.build(FabricConfig(
            n_nodes=n_nodes, hops=hops, cost=cost, hupcf=hupcf,
            fault_model=fault_model, frames_per_node=frames_per_node,
            default_policy=policy))
        # compatibility attributes the seed tests/benchmarks reach for
        self.loop = self.fabric.loop
        self.cost = self.fabric.cost
        self.nodes = self.fabric.nodes
        self.resolver = self.fabric.nodes[0].resolver
        self.pin_limit_bytes = pin_limit_bytes

    # ------------------------------------------------------------- buffers
    def map_buffer(self, node_idx: int, pd: int, va: int, nbytes: int,
                   prep: BufferPrep = BufferPrep.FAULTING,
                   charge: bool = True) -> PrepCost:
        """mmap (+ touch/pin) a buffer; returns the user-side cost."""
        dom = self.fabric.domain(pd) or self.fabric.open_domain(pd)
        mr = dom.register_memory(node_idx, va, nbytes, prep=prep,
                                 charge=charge)
        return mr.prep_cost

    def unmap_buffer(self, node_idx: int, pd: int, va: int, nbytes: int) -> float:
        self.nodes[node_idx].pt(pd).munmap(va, nbytes)
        return self.cost.munmap_us(nbytes)

    # ------------------------------------------------------------ transfers
    def remote_write(self, pd: int, src_node: int, src_va: int,
                     dst_node: int, dst_va: int, nbytes: int) -> Transfer:
        assert (src_va % A.PAGE_SIZE) == (dst_va % A.PAGE_SIZE), \
            "engine requires equally page-aligned src/dst (as in the thesis runs)"
        return self.fabric._start_write(pd, src_node, src_va,
                                        dst_node, dst_va, nbytes)

    def remote_read(self, pd: int, target_node: int, target_va: int,
                    local_node: int, local_va: int, nbytes: int) -> Transfer:
        """Remote read = request forwarded to the target, whose R5 turns it
        into a write back to the initiator (§1.3.2.2)."""
        return self.fabric._start_read(pd, target_node, target_va,
                                       local_node, local_va, nbytes)

    def run(self, until: Optional[float] = None) -> None:
        self.loop.run(until=until)

    def run_transfer(self, t: Transfer, deadline_us: float = 5e6) -> TransferStats:
        self.loop.run(until=self.loop.now + deadline_us)
        if not t.complete:
            raise RuntimeError(
                f"transfer tid={t.tid} incomplete after {deadline_us} us: "
                f"stats={t.stats}")
        return t.stats
