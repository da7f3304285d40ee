"""Production meshes.

``make_production_mesh`` is a FUNCTION (not a module-level constant), so
importing this module touches no process group: the dry-run sets up a fake
group of 256 or 512 ranks inside a cell (``launch.dryrun.fake_world``) and
only then builds the mesh over it.
"""

from __future__ import annotations

import numpy as np

from repro_torch.compat import axis_types_kwargs
from repro_torch.distributed.logical import AbstractMesh

__all__ = ["axis_types_kwargs", "make_local_mesh", "make_production_mesh"]


def _mesh(shape: tuple, axes: tuple):
    """A DeviceMesh over the current process group when its size is the
    mesh's (``"cuda"`` meshes under NCCL, ``"cpu"`` under any other
    backend), else an :class:`AbstractMesh` with no devices."""
    import torch.distributed as dist
    n = int(np.prod(shape))
    if not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() != n:
        return AbstractMesh(shape, axes)
    from torch.distributed.device_mesh import init_device_mesh
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, shape, mesh_dim_names=axes,
                            **axis_types_kwargs(len(axes)))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16×16 = 256 devices (data, model).
    Multi-pod: 2×16×16 = 512 devices (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_local_mesh(model: int = 1):
    """(data, model) over whatever this process has: the current process
    group's ranks (one without a group)."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    if n % model:
        raise ValueError(f"model {model} does not divide {n} ranks")
    return _mesh((n // model, model), ("data", "model"))


# NVIDIA H100 SXM5 80 GB data-sheet values (per device) for the roofline
# terms: published peaks, not measurements.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 dense (no sparsity)
HBM_BW = 3.35e12                  # bytes/s, HBM3
ICI_BW_PER_LINK = 50e9            # bytes/s per NVLink 4 link (18 links: 900 GB/s)
HBM_PER_CHIP = 80 * 10**9         # bytes of HBM3
