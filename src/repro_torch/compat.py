"""Device rule, dtype maps and weight conversion for the port.

* :func:`resolve_device` owns the one rule every entry point follows:
  ``device=None`` means the GPU and raises when there is none; only an
  explicit ``"cpu"`` runs on the CPU.
* :func:`torch_dtype` / :func:`canonicalize_dtype` map numpy dtypes (and
  ``ml_dtypes.bfloat16``) to torch, narrowing 64-bit types the way the
  reference's array library does by default (f64→f32, i64→i32).
* :func:`from_jax_params` turns the reference's params / decode-cache
  pytree, given as numpy arrays, into the port's nested dict of tensors —
  keys and the stacked ``(L, ...)`` layout unchanged, a pure copy.
* :func:`axis_types_kwargs` and :func:`cost_analysis_dict` keep the
  reference's names for the launch tooling: a DeviceMesh has no axis
  types, and the port's cost analysis is a trace's
  (``analysis.trace``), not a compiled executable's.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]

_NAME_TO_TORCH = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int32": torch.int32, "int64": torch.int64, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NARROW = {"float64": "float32", "int64": "int32", "uint64": "uint32"}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the current CUDA device, or a clear error without one.

    There is no silent fallback: code that should run on the GPU never
    ends up on the CPU because a driver was missing.  Pass ``"cpu"``
    explicitly (the tests, ``--device cpu``) to run there.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available (torch.cuda.is_available() is False); pass "
                "device='cpu' explicitly to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dtype_name(dtype) -> str:
    """Canonical name of a numpy / ml_dtypes / torch dtype or a string."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def canonicalize_dtype(dtype) -> np.dtype:
    """numpy dtype after the reference's default 64→32-bit narrowing."""
    name = dtype_name(dtype)
    name = _NARROW.get(name, name)
    if name == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a numpy / ml_dtypes / torch dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NAME_TO_TORCH[dtype_name(dtype)]


def numpy_to_torch(a, device: DeviceLike = "cpu",
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Copy a numpy array (bf16 as ``ml_dtypes.bfloat16``) to a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()
        ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=torch.device(device), dtype=dtype)


def torch_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor → numpy copy on the host (bf16 comes back as ``ml_dtypes``)."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_jax_params(tree: Any, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Reference params / decode-cache pytree (numpy leaves) → tensors.

    Nested dicts (and lists / tuples) keep their keys and order; every
    leaf keeps its shape and its own dtype unless ``dtype`` is given, which
    then applies to floating-point leaves only (integer leaves such as
    ``lengths`` and ``page_table`` stay integer).
    """
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        t = numpy_to_torch(x, dev)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    return conv(tree)


def axis_types_kwargs(n_axes: int) -> dict:
    """``{}``: a torch DeviceMesh has no axis types (every mesh dim is what
    the reference's ``AxisType.Auto`` asks for: the placements say it)."""
    return {}


def cost_analysis_dict(analysis) -> dict:
    """The reference's ``{"flops", "bytes accessed"}`` of a traced step:
    the dot FLOPs and the HBM-bytes estimate of an
    ``analysis.hlo.HLOAnalysis`` made by ``analysis.trace``, per device."""
    return {"flops": float(analysis.dot_flops),
            "bytes accessed": float(analysis.hbm_bytes)}
