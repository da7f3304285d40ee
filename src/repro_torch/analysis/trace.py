"""Trace analysis: the port's counterpart of ``analysis/hlo.py``.

The reference analyses the optimized HLO of a compiled step, whose shapes
are already per device after GSPMD.  PyTorch compiles nothing here: the
step runs once, eagerly, and a ``TorchDispatchMode`` reads every ATen op
it dispatches.  Under ``FakeTensorMode`` (the dry-run) nothing is
allocated and no number is computed, and a fake process group makes the
collectives free.  The fields are those of :class:`HLOAnalysis`, per
device:

* **dot FLOPs** — ``torch.utils.flop_counter``'s formula for each matmul,
  convolution and attention op, on the shapes the op runs at;
* **collective bytes** — the local operand bytes of each
  ``_c10d_functional`` collective (what DTensor's redistributions call),
  by the reference's collective kinds;
* **HBM bytes** — an estimate: the bytes of the inputs plus the outputs of
  each counted matmul and collective (no fusion to read through, and
  elementwise traffic left out, as the reference's count of dots and
  fusions leaves out what XLA keeps on chip).

Per device means one rank's **local shards**.  A mode over a DTensor op
sees global shapes (``FlopCounterMode`` over DTensors counts the whole
product), so the counter passes a DTensor op on (``NotImplemented``) and
counts the local ops that DTensor dispatches for it.  DTensor also runs
each new op once on global shapes to learn its output's shape (sharding
propagation); the counter skips what runs inside that.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.hlo import HLOAnalysis

#: ``_c10d_functional`` op -> the reference's collective kind
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_IGNORED_C10D = {"wait_tensor", "_wrap_tensor_autograd"}   # not collectives
#: ops that read a tensor's metadata: most of what a DTensor step
#: dispatches, none of it work
_METADATA = frozenset({torch.ops.prim.device.default})


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _Propagating:
    """Stands in for DTensor's sharding-propagation lock, which wraps the
    op run on global shapes; ``depth`` > 0 while one runs."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.depth = 0

    def __enter__(self):
        self.inner.__enter__()
        self.depth += 1

    def __exit__(self, *exc):
        self.depth -= 1
        return self.inner.__exit__(*exc)


class TraceCounter(TorchDispatchMode):
    """Counts one rank's dot FLOPs, collective bytes and HBM-bytes estimate
    over the ops run inside it; ``analysis`` holds the sums."""

    def __init__(self) -> None:
        super().__init__()
        self.analysis = HLOAnalysis()
        self._breakdown: dict = defaultdict(float)
        self._propagating = None

    @property
    def propagating(self) -> bool:
        """True while DTensor's sharding propagation runs an op."""
        return bool(self._propagating and self._propagating.depth)

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self._propagating = _Propagating(ShardingPropagator._fake_mode_lock)
        ShardingPropagator._fake_mode_lock = self._propagating
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._fake_mode_lock = self._propagating.inner
        self.analysis.collective_breakdown = dict(self._breakdown)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # counted at its local ops
        out = func(*args, **kwargs)
        if self.propagating:
            return out
        packet = func._overloadpacket
        ana = self.analysis
        if packet in flop_registry:
            ana.dot_flops += flop_registry[packet](*args, **kwargs,
                                                  out_val=out)
            ana.dot_count += 1
            ana.hbm_bytes += _nbytes((args, kwargs)) + _nbytes(out)
        elif func.namespace == "_c10d_functional":
            name = packet.__name__
            if name in _IGNORED_C10D:
                return out
            if name not in COLLECTIVES:
                raise ValueError(f"trace: no collective kind for {func}")
            b = _nbytes(args[0])
            self._breakdown[COLLECTIVES[name]] += b
            ana.collective_bytes += b
            ana.collective_count += 1
            ana.hbm_bytes += b + _nbytes(out)
        return out


@contextlib.contextmanager
def counting():
    """A :class:`TraceCounter` over the block; read ``.analysis`` after."""
    counter = TraceCounter()
    with counter:
        yield counter


def analyze_trace(fn, *args, **kwargs) -> HLOAnalysis:
    """Run ``fn(*args, **kwargs)`` once and return its per-device
    :class:`HLOAnalysis` (``dot_flops``, ``hbm_bytes``,
    ``collective_bytes``, ``collective_breakdown``, counts).  The
    arguments may be plain tensors, DTensors (then the counts are this
    rank's) or fake tensors; the output is dropped."""
    with counting() as counter:
        fn(*args, **kwargs)
    return counter.analysis
