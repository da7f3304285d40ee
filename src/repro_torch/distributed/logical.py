"""Logical-axis activation sharding (MaxText-style logical axis rules).

Model code names its activation dims (``constrain(x, "batch", "seq",
"heads", "head_dim")``); the launcher binds logical names to mesh axes per
architecture (e.g. heads→'model' when divisible, else seq→'model' for
context parallelism).  Outside a policy context ``constrain`` is a no-op,
so tests/examples on 1 device pay nothing.

Every binding is divisibility-checked against the actual dim, so one rule
set serves all architectures (starcoder2's 24 heads silently fall back to
whatever the launcher's rules name next).

A mesh here is read for its axis names and sizes only.  It is either a
``torch.distributed.device_mesh.DeviceMesh`` built with ``mesh_dim_names``
or an :class:`AbstractMesh` (names → sizes, no devices and no process
group), in which specs for any number of devices can be computed in one
process.  A spec is a :class:`PartitionSpec`: one entry per tensor dim,
each ``None``, an axis name or a tuple of names.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

_STATE = threading.local()


class AbstractMesh:
    """Axis names and sizes, with no devices (the counterpart of
    ``jax.sharding.AbstractMesh``).  ``shape`` maps name → size in axis
    order."""

    def __init__(self, axis_sizes: tuple, axis_names: tuple) -> None:
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{axis_sizes} sizes for {axis_names} names")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, map(int, axis_sizes)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


class PartitionSpec(tuple):
    """Per tensor dim: ``None``, a mesh axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def mesh_shape(mesh) -> dict:
    """Axis name → size, in the mesh's axis order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


def placements(mesh, spec) -> tuple:
    """The DTensor placements of ``spec`` on a DeviceMesh: ``Shard(d)`` on
    each mesh dim that tensor dim ``d`` names, ``Replicate()`` on the rest.
    A tensor dim named over several mesh dims is split in the mesh's order
    (outer dim first)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _current() -> Optional[tuple]:
    return getattr(_STATE, "policy", None)


@contextlib.contextmanager
def logical_rules(mesh, rules: dict):
    """rules: logical-name -> mesh-axis (str) | tuple | None."""
    prev = _current()
    _STATE.policy = (mesh, dict(rules))
    try:
        yield
    finally:
        _STATE.policy = prev


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, (tuple, list)):
        return int(np.prod([shape[a] for a in axis]))
    return shape[axis]


def spec_for(shape: tuple, names: tuple) -> Optional[PartitionSpec]:
    pol = _current()
    if pol is None:
        return None
    mesh, rules = pol
    spec = []
    used: set = set()
    for dim, name in zip(shape, names):
        ax = rules.get(name)
        parts = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        if ax is not None and not (used & set(parts)) \
                and dim % _axis_size(mesh, ax) == 0 and dim > 0:
            spec.append(ax)
            used.update(parts)
        else:
            spec.append(None)
    return PartitionSpec(*spec)


def constrain(x, *names: str):
    """Lay ``x`` out per the active logical rules.

    Unchanged outside a policy context, as in the reference, and unchanged
    for a plain tensor: in eager SPMD every rank already holds its own
    shard, and there is no compiler to hand a constraint to.  A DTensor on
    a DeviceMesh policy is redistributed to the placements of
    :func:`spec_for`.  An all-``None`` spec leaves the DTensor as it is,
    unless it is ``Partial`` (a row-parallel matmul's result): that is
    always reduced to the spec's placements, the reduction XLA inserts at
    the reference's constraint.
    """
    pol = _current()
    if pol is None or not is_dtensor(x) or isinstance(pol[0], AbstractMesh) \
            or len(names) != x.ndim:
        return x
    # a dim of size 1 (one row of a microbatch) is left whole: split over a
    # mesh dim of size 1 it would be the same, but DTensor could then not
    # fold it into a matmul's rows
    spec = PartitionSpec(*(None if n == 1 else e for n, e in zip(
        x.shape, spec_for(x.shape, names))))
    if all(s is None for s in spec) and not any(
            p.is_partial() for p in x.placements):
        return x
    return x.redistribute(pol[0], placements(pol[0], spec))


def replicated(t, mesh):
    """``t``, a tensor the step makes itself (the same values on every
    rank), as a ``Replicate`` DTensor on ``mesh`` when that is a
    DeviceMesh, with no collective; ``t`` itself for no mesh or an
    :class:`AbstractMesh`."""
    if mesh is None or isinstance(mesh, AbstractMesh):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def mesh_of(x):
    """The DeviceMesh of a DTensor, else None."""
    return x.device_mesh if is_dtensor(x) else None


def placed_like(x, like):
    """``x`` redistributed to the mesh and placements of the DTensor
    ``like`` (a gradient to its parameter's: the data-parallel reduction
    of a ``Partial`` gradient); ``x`` itself when ``like`` is plain."""
    if not is_dtensor(like):
        return x
    return x.redistribute(like.device_mesh, like.placements)


class _GradLike(torch.autograd.Function):
    """Identity forward; the backward lays the gradient out like the
    forward input."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        # the gradient of a Partial sum is every summand's: replicated
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_like(x):
    """``x`` itself, whose gradient is laid out like ``x`` (a DTensor): the
    placement GSPMD propagates to a gradient, where DTensor's backward may
    leave it on other dims (a vocabulary-split logits' gradient split over
    the batch instead, which makes the output projection's weight gradient
    a full-vocabulary product on every rank).  A plain tensor, or one that
    needs no gradient, as it is."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    return _GradLike.apply(x)


def whole(x, *dims: int):
    """``x`` with each of ``dims`` whole on every rank: a DTensor split
    over one of them is gathered there (its other placements kept); a
    plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dims = tuple(d % x.ndim for d in dims)
    pl = [Replicate() if p.is_shard() and p.dim in dims else p
          for p in x.placements]
    return x if pl == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def unflatten_last(x, *sizes: int):
    """``x`` (..., prod(sizes)) as (..., *sizes).  A DTensor split over a
    mesh dim on its last dim whose size does not divide ``sizes[0]`` (4
    heads over 16 model ranks) cannot be unflattened in place: that split
    is gathered first."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        mesh = x.device_mesh
        pl = [Replicate() if p.is_shard(x.ndim - 1) and sizes[0] % mesh.size(i)
              else p for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(*x.shape[:-1], *sizes)


def pad(x, widths: tuple):
    """``F.pad(x, widths)`` with zeros.  A DTensor is padded in a region
    (DTensor has no padding rule in every torch version: one gave a spec
    of one placement on a 2-D mesh): the padded dims gathered whole, each
    rank's local tensor padded (a ``Partial`` sum stays one: the pad is
    zeros), and the result laid out as the input.  Differentiable."""
    import torch.nn.functional as F
    if not is_dtensor(x):
        return F.pad(x, widths)
    from torch.distributed.tensor import DTensor
    dims = [x.ndim - 1 - i for i in range(len(widths) // 2)
            if widths[2 * i] or widths[2 * i + 1]]
    x = whole(x, *dims)
    shape = list(x.shape)
    for i in range(len(widths) // 2):
        shape[x.ndim - 1 - i] += widths[2 * i] + widths[2 * i + 1]
    return DTensor.from_local(F.pad(x.to_local(), widths), x.device_mesh,
                              x.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def cumsum(x, dim: int):
    """``torch.cumsum(x, dim)``.  A DTensor's sum runs in a region, ``dim``
    gathered whole: its backward flips the gradient, and DTensor has no
    rule for ``flip`` in every torch version.  A ``Partial`` sum stays one
    (the sum is linear).  Differentiable."""
    if not is_dtensor(x):
        return torch.cumsum(x, dim)
    from torch.distributed.tensor import DTensor
    x = whole(x, dim)
    return DTensor.from_local(torch.cumsum(x.to_local(), dim),
                              x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(strides))


class _ContiguousGrad(torch.autograd.Function):
    """Identity forward; the backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_shard(x, mesh, placements, grad_placements=None):
    """``x`` (a DTensor) laid out as ``placements`` on ``mesh``, as this
    rank's local tensor, for a region's body.  Differentiable: the body's
    gradient comes back as a DTensor with ``grad_placements`` (default
    ``placements``), made contiguous first, since a DTensor takes its
    local tensor's layout to be its own (a transposed local gradient, as
    an attention backward may give, breaks a later ``view``)."""
    local = x.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements)
    return _ContiguousGrad.apply(local) if local.requires_grad else local


def full(x):
    """A DTensor's global value as a plain tensor (a ``Partial`` scalar
    such as a loss reduced); a plain tensor as it is.  Differentiable."""
    return x.full_tensor() if is_dtensor(x) else x


def current_mesh():
    pol = _current()
    return pol[0] if pol is not None else None


def rule(name: str):
    pol = _current()
    if pol is None:
        return None
    return pol[1].get(name)
