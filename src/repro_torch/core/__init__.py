"""Core: the paper's contribution — page-fault handling for virtual-address
RDMA — as a composable library.

The public, verbs-style API lives in :mod:`repro_torch.api` (``Fabric`` /
``ProtectionDomain`` / ``MemoryRegion`` / ``CompletionQueue``); the
``RDMAEngine`` re-exported here is a deprecated shim over it.

The leaf modules are imported here; ``BufferPrep`` and ``RDMAEngine``
resolve on first use (PEP 562), because ``core.engine`` imports
``core.node``, which imports ``repro_torch.tenancy``, whose submodules
import this package: importing them eagerly would let a first import of
``repro_torch.tenancy.slo`` fail on the cycle.
"""

import importlib

from repro_torch.core.addresses import (BLOCK_SIZE, MTU, PAGE_SIZE,
                                        PAGES_PER_BLOCK, NetlinkMessage,
                                        RAPFMessage)
from repro_torch.core.arbiter import ArbiterStats, DMAArbiter, ServiceClass
from repro_torch.core.costmodel import CostModel, DEFAULT_COST_MODEL
from repro_torch.core.fault import SMMU, Access, Disposition, FaultModel
from repro_torch.core.fault_fifo import FaultFIFO, FIFOEntry
from repro_torch.core.pagetable import (FrameAllocator, PageState, PageTable,
                                        SegmentationFault)
from repro_torch.core.resolver import Resolution, Resolver, Strategy
from repro_torch.core.simulator import EventLoop, Resource

_LAZY = {"BufferPrep": "repro_torch.core.engine",
         "RDMAEngine": "repro_torch.core.engine"}

__all__ = [
    "ArbiterStats", "BLOCK_SIZE", "DMAArbiter", "MTU", "PAGE_SIZE",
    "PAGES_PER_BLOCK", "ServiceClass",
    "NetlinkMessage", "RAPFMessage", "CostModel", "DEFAULT_COST_MODEL",
    "BufferPrep", "RDMAEngine", "SMMU", "Access", "Disposition", "FaultModel",
    "FaultFIFO", "FIFOEntry", "FrameAllocator", "PageState", "PageTable",
    "SegmentationFault", "Resolution", "Resolver", "Strategy",
    "EventLoop", "Resource",
]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name]), name)
    globals()[name] = value
    return value
