"""NP-RDMA no-pinning backend (beyond paper — arXiv 2310.11062).

A *competing* fault-handling datapath next to the thesis' SMMU + fault
FIFO + RAPF mechanism: speculative VA→PA translation through a
host-managed :class:`MTTCache`, with abort-and-redirect through a
:class:`DMAPool` of pre-registered frames on mis-speculation.  Selected
per protection domain via
``FaultPolicy(strategy=Strategy.NP_RDMA)`` and sized by the
``FabricConfig`` knobs ``mtt_entries`` / ``dma_pool_frames`` /
``speculation``.  Head-to-head comparison: ``benchmarks/npr_compare.py``.
"""

from repro_torch.npr.engine import NPREngine
from repro_torch.npr.mtt import MTTCache, MTTEntry
from repro_torch.npr.pool import DMAPool, POOL_PD
from repro_torch.npr.stats import NPRStats

__all__ = ["NPREngine", "MTTCache", "MTTEntry", "DMAPool", "POOL_PD",
           "NPRStats"]
