"""Frame pools: where resident pages live.

A :class:`FramePool` is a fixed set of page frames shared by one or more
:class:`~repro_torch.vmem.pager.AddressSpace` tenants.  Backends differ in where
the frame payload lives and how a page-in arrives:

* :class:`DeviceFramePool` — frames are rows of a ``torch`` tensor on the
  chosen device (copies are real and go through the page gather / scatter
  kernels);
* :class:`HostFramePool` — frames are rows of a host ``numpy`` array
  (a second-tier pool, e.g. host swap in front of remote memory);
* :class:`FrameIdPool` — control-plane only: frames are just ids (the KV
  manager's case, where payload lives in the compiled step's cache pools);
* :class:`~repro_torch.vmem.remote.RemoteFramePool` — decorates any of the
  above so page-ins travel over the verbs fabric (``post_read`` + CQ).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.compat import (DeviceLike, canonicalize_dtype,
                                numpy_to_torch, resolve_device, torch_dtype,
                                torch_to_numpy)
from repro_torch.kernels.page_pack.ops import gather_pages, scatter_pages


@dataclasses.dataclass
class PageInReceipt:
    """What one backend page-in cost (returned by ``page_in``)."""
    us: float = 0.0
    remote_reads: int = 0
    rapf_retransmits: int = 0
    dst_faults: int = 0
    bytes_in: int = 0
    # crash-fault layer: page-ins served by the replica pager after the
    # primary backing node failed (RemoteFramePool failover)
    failovers: int = 0
    # NP-RDMA backend counters (zero when the domain runs the thesis path)
    mtt_hits: int = 0
    mtt_misses: int = 0
    mtt_stale: int = 0
    pool_redirects: int = 0


class FramePool:
    """Base pool: allocation bookkeeping + the payload/transport hooks."""

    def __init__(self, n_frames: int, page_elems: int):
        self.n_frames = n_frames
        self.page_elems = page_elems
        self.free: list[int] = list(range(n_frames - 1, -1, -1))
        # every address space mapped over this pool, across ALL pagers —
        # the default eviction-candidate set, so consumers sharing a pool
        # (pool=...) contend correctly even with separate Pager instances
        self.spaces: list = []

    # ------------------------------------------------------------ lifetime
    def alloc(self) -> Optional[int]:
        """Pop a free frame, or None if the pool is exhausted."""
        return self.free.pop() if self.free else None

    def release(self, frame: int) -> None:
        self.free.append(frame)

    @property
    def frames_used(self) -> int:
        return self.n_frames - len(self.free)

    # ---------------------------------------------------------- data plane
    def load(self, frame: int, data: np.ndarray) -> None:
        """Copy page payload into ``frame`` (no-op for id-only pools)."""

    def store(self, frame: int) -> Optional[np.ndarray]:
        """Read a frame's payload back out (writeback); None if id-only."""
        return None

    def gather(self, frames: np.ndarray) -> torch.Tensor:
        """Gather frame rows for an access; (n, page_elems)."""
        raise NotImplementedError(f"{type(self).__name__} holds no payload")

    # ------------------------------------------------------------ transport
    def page_in(self, space, vpage: int, n_pages: int,
                prefetch: bool = False) -> PageInReceipt:
        """Transport cost of paging ``n_pages`` starting at ``vpage``.

        Local pools are free (the resolver strategy already accounts the
        fault-handling time); the remote backend posts a verbs read here.
        ``prefetch`` marks predictive (non-demand) page-ins, which
        fabric-backed pools schedule as BULK instead of LATENCY traffic.
        """
        return PageInReceipt()


class DeviceFramePool(FramePool):
    """Device frame pool — the kernels' working set.

    ``data`` is one ``(n_frames, page_elems)`` tensor on ``device``
    (``None`` = the GPU), updated **in place**: ``load`` is a one-row
    ``page_scatter`` and ``gather`` a ``page_gather``.  The dtype is
    canonicalized as the reference does (f64→f32, i64→i32).
    """

    def __init__(self, n_frames: int, page_elems: int, dtype=np.float32,
                 device: DeviceLike = None):
        super().__init__(n_frames, page_elems)
        self.device = resolve_device(device)
        self.dtype = canonicalize_dtype(dtype)
        self.data = torch.zeros((n_frames, page_elems),
                                dtype=torch_dtype(self.dtype),
                                device=self.device)

    def _indices(self, frames) -> torch.Tensor:
        """Frame ids as int32 on the device, a negative id counted from the
        end as numpy and ``jnp.take`` count it (``-1`` is the last frame)."""
        idx = np.atleast_1d(np.asarray(frames)).astype(np.int32)
        idx = np.where(idx < 0, idx + self.n_frames, idx).astype(np.int32)
        return torch.from_numpy(idx).to(self.device)

    def load(self, frame: int, data: np.ndarray) -> None:
        row = numpy_to_torch(np.asarray(data, self.dtype).reshape(1, -1),
                             self.device)
        scatter_pages(self.data, self._indices([frame]), row)

    def store(self, frame: int) -> np.ndarray:
        return torch_to_numpy(self.data[frame])

    def gather(self, frames: np.ndarray) -> torch.Tensor:
        return gather_pages(self.data, self._indices(frames))


class HostFramePool(FramePool):
    """Host (numpy) frame pool — a spill tier or CPU-side working set."""

    def __init__(self, n_frames: int, page_elems: int, dtype=np.float32):
        super().__init__(n_frames, page_elems)
        self.dtype = canonicalize_dtype(dtype)
        self.data = np.zeros((n_frames, page_elems), self.dtype)

    def load(self, frame: int, data: np.ndarray) -> None:
        self.data[frame] = np.asarray(data, self.dtype).reshape(-1)

    def store(self, frame: int) -> np.ndarray:
        return self.data[frame].copy()

    def gather(self, frames: np.ndarray) -> torch.Tensor:
        return numpy_to_torch(self.data[np.asarray(frames, np.int64)], "cpu")


class FrameIdPool(FramePool):
    """Control-plane pool: frames are ids only (payload lives elsewhere,
    e.g. in the serving engine's decode-cache pools)."""

    def __init__(self, n_frames: int):
        super().__init__(n_frames, page_elems=0)
