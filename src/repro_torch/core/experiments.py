"""Reusable experiment drivers mirroring the thesis' microbenchmarks.

Each function runs one configuration of the Chapter-4 methodology:

* "Real" measurements (Listing 4.2) — per-iteration timing including the
  page-fault handling on the critical path;
* buffers prepared per :class:`~repro_torch.core.engine.BufferPrep`
  (pre-touched / pinned / left faulting at source, destination, or both);
* intra-node transfers (one FPGA), matching the thesis setup, unless
  ``n_nodes``/``hops`` say otherwise.

The simulator is deterministic, so one iteration per configuration is
exact; ``iterations`` exists for THP/randomized variants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import addresses as A
from repro_torch.core.costmodel import CostModel, DEFAULT_COST_MODEL, cost_model_with_timeout
from repro_torch.core.node import TransferStats
from repro_torch.core.resolver import Strategy
from repro_torch.api import BufferPrep, Fabric, FabricConfig, FaultPolicy

# the thesis' transfer-size sweep (Chapter 4)
SIZES = (16, 64, 256, 1024, 4096, 16384, 32768, 65536)

SRC_BASE = 0x10_0000_0000
DST_BASE = 0x20_0000_0000

#: fault-handling backends a sweep can be replayed under (``--backend``):
#: * ``rapf``      — the thesis datapath with whatever strategy the sweep
#:                   configured (SMMU faults + RAPF/timeout retransmission);
#: * ``np_rdma``   — the ``repro_torch.npr`` no-pinning backend (MTT speculation
#:                   + DMA-pool abort-and-redirect);
#: * ``pin``       — pin every buffer up front (no faults; pin cost charged);
#: * ``pre_fault`` — pre-touch every buffer (no faults; touch cost charged).
BACKENDS = ("rapf", "np_rdma", "pin", "pre_fault")

_default_backend = "rapf"


def set_default_backend(name: str) -> None:
    """Set the process-wide default backend every sweep inherits (the
    ``--backend`` flag of ``benchmarks/run.py``; per-file edits stay
    unnecessary because :func:`run_remote_write` consults this)."""
    global _default_backend
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; valid backends: {', '.join(BACKENDS)}")
    _default_backend = name


def default_backend() -> str:
    return _default_backend


def _apply_backend(backend: Optional[str], src_prep: BufferPrep,
                   dst_prep: BufferPrep, strategy: Strategy):
    """Resolve a backend name into (src_prep, dst_prep, strategy)."""
    backend = backend or _default_backend
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; valid backends: "
            f"{', '.join(BACKENDS)}")
    if backend == "np_rdma":
        strategy = Strategy.NP_RDMA
    elif backend == "pin":
        src_prep = dst_prep = BufferPrep.PINNED
    elif backend == "pre_fault":
        src_prep = dst_prep = BufferPrep.TOUCHED
    return src_prep, dst_prep, strategy


@dataclasses.dataclass
class RunResult:
    size: int
    latency_us: float            # transfer-only latency (Listing 4.2 style)
    prep_us: float               # buffer prep cost, reported separately
    stats: TransferStats


def run_remote_write(size: int,
                     src_prep: BufferPrep,
                     dst_prep: BufferPrep,
                     strategy: Strategy = Strategy.TOUCH_AHEAD,
                     timeout_us: Optional[float] = None,
                     cost: Optional[CostModel] = None,
                     n_nodes: int = 1,
                     lookahead: int = A.PAGES_PER_BLOCK,
                     hupcf: bool = True,
                     backend: Optional[str] = None,
                     config_overrides: Optional[dict] = None) -> RunResult:
    """One remote write with the given buffer preparation, to completion.

    ``backend`` (default: the process-wide :func:`default_backend`)
    replays the run under a different fault-handling datapath — see
    :data:`BACKENDS`.  ``config_overrides`` merges extra
    :class:`FabricConfig` kwargs (e.g. ``dma_pool_frames``,
    ``speculation``) for backend-sizing studies.
    """
    if cost is None:
        cost = (cost_model_with_timeout(timeout_us) if timeout_us is not None
                else DEFAULT_COST_MODEL)
    src_prep, dst_prep, strategy = _apply_backend(
        backend, src_prep, dst_prep, strategy)
    cfg_kw = dict(
        n_nodes=max(1, n_nodes), cost=cost, hupcf=hupcf,
        default_policy=FaultPolicy(strategy=strategy, lookahead=lookahead))
    cfg_kw.update(config_overrides or {})
    fabric = Fabric.build(FabricConfig(**cfg_kw))
    dst_node = 0 if n_nodes <= 1 else 1
    dom = fabric.open_domain(1)
    src = dom.register_memory(0, SRC_BASE, size, prep=src_prep)
    dst = dom.register_memory(dst_node, DST_BASE, size, prep=dst_prep)
    cq = fabric.create_cq(depth=4)
    t0 = fabric.now
    wr = dom.post_write(src, dst, cq=cq)
    wc = wr.result()
    fabric.progress()           # drain trailing driver/library-thread work
    return RunResult(size=size, latency_us=wc.t_complete - t0,
                     prep_us=src.prep_cost.total_us + dst.prep_cost.total_us,
                     stats=wr.stats)


def fault_sweep(where: str, strategy: Strategy,
                timeout_us: float = A.DEFAULT_TIMEOUT_US,
                sizes=SIZES, **kw) -> list[RunResult]:
    """The Fig 4.2/4.3/4.4 experiments: faults at dst / src / both."""
    src_prep = BufferPrep.FAULTING if where in ("src", "both") else BufferPrep.TOUCHED
    dst_prep = BufferPrep.FAULTING if where in ("dst", "both") else BufferPrep.TOUCHED
    return [run_remote_write(s, src_prep, dst_prep, strategy=strategy,
                             timeout_us=timeout_us, **kw) for s in sizes]


def ideal_sweep(prep: BufferPrep = BufferPrep.TOUCHED, sizes=SIZES,
                **kw) -> list[RunResult]:
    """Fig 4.1: no faults during the RDMA (pre-touched or pinned buffers)."""
    return [run_remote_write(s, prep, prep, **kw) for s in sizes]
