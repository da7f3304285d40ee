"""``repro_torch.vmem`` — the unified demand-paging subsystem.

The thesis' core claim is that page faults can be *handled*, not
avoided, so one mechanism can serve every memory consumer without
pinning ceremony.  This package is that mechanism as an API:

* :class:`AddressSpace` + :class:`Pager` — fault → resolve → map, with
  per-tenant :class:`~repro_torch.api.policy.FaultPolicy` threading;
* :class:`FramePool` backends — :class:`DeviceFramePool` (a torch tensor
  on the chosen device, moved by the page gather / scatter kernels),
  :class:`HostFramePool` (numpy) and :class:`FrameIdPool` (control-plane
  only) and :class:`RemoteFramePool` (page-ins over the verbs fabric:
  ``post_read`` + CQ completions, RAPF stats surfaced; the payload lands
  in a local pool, on the GPU a ``DeviceFramePool``);
* pluggable eviction (:class:`LRUEviction`, :class:`ClockEviction`,
  :class:`PinAwareLRU`) and prefetch predictors (:class:`NoPrefetch`,
  :class:`TouchAheadPrefetch`, :class:`StreamPrefetch`);
* one :class:`PagingStats` telemetry record for everything.

``repro_torch.memory.paged_store.PagedTensorStore``,
``repro_torch.memory.kv_cache.PagedKVManager``,
``repro_torch.memory.offload.PagedAdamW`` and
``repro_torch.serving.engine.ServingEngine`` are thin wrappers over this
one pager.

Quick tour::

    from repro_torch.vmem import DeviceFramePool, Pager
    from repro_torch.api import FaultPolicy, Strategy

    pool = DeviceFramePool(n_frames=64, page_elems=1024)   # on the GPU
    pager = Pager(pool, policy=FaultPolicy(Strategy.TOUCH_AHEAD))
    a = pager.create_space(256, name="tenant-a")
    a.write(0, data)            # backing image
    x = a.access([0, 1, 2])     # faults + prefetch, per a's policy
    print(pager.stats.faults, a.stats.simulated_us)
"""

from repro_torch.vmem.compat import coerce_policy
from repro_torch.vmem.eviction import (ClockEviction, EvictionPolicy,
                                       LRUEviction, PinAwareLRU)
from repro_torch.vmem.frames import (DeviceFramePool, FrameIdPool, FramePool,
                                     HostFramePool, PageInReceipt)
from repro_torch.vmem.pager import NON_RESIDENT, AddressSpace, Pager
from repro_torch.vmem.prefetch import (NoPrefetch, PrefetchPredictor,
                                       StreamPrefetch, TouchAheadPrefetch,
                                       predictor_for)
from repro_torch.vmem.remote import RemoteFramePool
from repro_torch.vmem.stats import PagingStats

__all__ = [
    "AddressSpace", "ClockEviction", "DeviceFramePool", "EvictionPolicy",
    "FrameIdPool", "FramePool", "HostFramePool", "LRUEviction",
    "NON_RESIDENT", "NoPrefetch", "PageInReceipt", "Pager", "PagingStats",
    "PinAwareLRU", "PrefetchPredictor", "RemoteFramePool", "StreamPrefetch",
    "TouchAheadPrefetch", "coerce_policy", "predictor_for",
]
