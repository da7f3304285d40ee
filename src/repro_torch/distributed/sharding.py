"""Partition rules: params / inputs / caches → NamedSharding per mesh.

Strategy (the reference's, unchanged):

* batch → ``('pod', 'data')``; vocab/heads/FFN-hidden → ``'model'``;
* MoE experts → ``'model'`` when divisible (EP), else TP inside experts;
* KV pools: pages → ``'data'`` (sequence/page parallelism — this is what
  makes ``long_500k`` shardable at batch 1), head_dim → ``'model'``;
* ZeRO-3 option: params *additionally* sharded over ``('data',)`` on their
  largest divisible dim;
* every rule is **divisibility-checked** per dim: axes that do not divide
  are dropped (replicated) rather than failing — small KV-head counts
  (starcoder2 kv=2) replicate under TP16.

Rules are path-regex → dim-axis preferences, resolved against the actual
leaf shapes, so one rule table covers all ten architectures.

The trees are the port's nested dicts, over any leaf that has ``.shape``
(tensors on the ``meta`` device, ``torch.Size``); a leaf's path is its
keys joined by ``/``, as the reference writes a pytree path.  A mesh is a
DeviceMesh or an :class:`~repro_torch.distributed.logical.AbstractMesh`;
a :class:`NamedSharding` on a DeviceMesh also gives the DTensor placements.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np

from repro_torch.distributed.logical import (PartitionSpec as P, _axis_size,
                                             mesh_shape, placements)
from repro_torch.tree import tree_leaves, tree_map, tree_names, tree_unflatten

# (path regex, per-dim axis preference from the LAST dim backwards)
# each entry: list over dims (aligned to the *trailing* dims of the leaf)
# of None | axis-name | tuple of axis names.
_RULES: list[tuple[str, list]] = [
    # embeddings / heads
    (r"embed$",                 ["model", None]),          # (V, d): V->model
    (r"pos_dec$",               [None, None]),
    (r"lm_head$",               [None, "model"]),          # (d, V)
    # attention projections
    (r"(wq|wq_b)$",             [None, "model"]),
    (r"(wk|wv|wkv_a|wq_a)$",    [None, "model"]),
    (r"(wo)$",                  ["model", None]),
    (r"(wk_b|wv_b)$",           [None, "model"]),
    (r"(bq|bk|bv)$",            ["model"]),
    # MLP
    (r"(wi|wg)$",               [None, "model"]),
    (r"mlp/wo$",                ["model", None]),
    (r"(bi)$",                  ["model"]),
    (r"(bo)$",                  [None]),
    # MoE experts: (E, d, f) — EP on E if divisible, else TP on f
    (r"moe/(wi|wg)$",           ["model", None, "model"]),
    (r"moe/wo$",                ["model", None, "model"]),
    (r"router$",                [None, None]),
    (r"shared/(wi|wg)$",        [None, "model"]),
    (r"shared/wo$",             ["model", None]),
    # mamba / xlstm
    (r"in_proj$",               [None, "model"]),
    (r"out_proj$",              ["model", None]),
    (r"(up|down|skip|wo_gate)$", [None, "model"]),
    (r"down$",                  ["model", None]),
    (r"(w_if|w_gates)$",        [None, "model"]),
    (r"(ffn_wi)$",              [None, "model"]),
    (r"(ffn_wo)$",              ["model", None]),
    # everything else (norms, scalars, conv, gates): replicated
]

#: keys of an sLSTM state dict: the port carries each leaf as (1, B, d)
#: where the reference's is (B, d) (ROADMAP C; models/xlstm_model.py)
_SLSTM_STATE = frozenset({"c", "n", "h", "m"})


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        """DTensor placements (the mesh must be a DeviceMesh)."""
        return placements(self.mesh, self.spec)


def _fit_spec(shape: tuple, prefs: list, mesh, stacked: int = 0) -> P:
    """Align dim preferences to trailing dims; drop non-dividing axes."""
    ndims = len(shape)
    spec: list = [None] * ndims
    # prefs align to the trailing len(prefs) dims
    for i, pref in enumerate(prefs):
        dim = ndims - len(prefs) + i
        if dim < stacked:      # never shard the stacked-layer axis
            continue
        if dim < 0 or pref is None:
            continue
        if shape[dim] % _axis_size(mesh, pref) == 0:
            spec[dim] = pref
    return P(*spec)


def _moe_rule_fixup(path: str, shape: tuple, spec: P, mesh) -> P:
    """Experts axis: 2-D EP over (model × data) when the expert count
    allows one-or-more experts per chip; else 1-D EP over 'model'; else TP
    on the hidden dim."""
    if re.search(r"moe/(wi|wg|wo)$", path) and len(shape) >= 3:
        e_dim = len(shape) - 3
        sizes = mesh_shape(mesh)
        model = sizes.get("model", 1)
        data = sizes.get("data", 1)
        new = list(spec)
        if shape[e_dim] % (model * data) == 0:
            new[e_dim] = ("model", "data")   # 2-D expert parallel
            new[e_dim + 1] = None
            new[e_dim + 2] = None
        elif shape[e_dim] % model == 0:
            new[e_dim] = "model"             # expert parallel
            new[e_dim + 1] = None
            new[e_dim + 2] = None
        else:
            new[e_dim] = None                # TP inside experts
            if re.search(r"wo$", path):
                new[e_dim + 1] = "model" if shape[e_dim + 1] % model == 0 \
                    else None
                new[e_dim + 2] = None
            else:
                new[e_dim + 1] = None
                new[e_dim + 2] = "model" if shape[e_dim + 2] % model == 0 \
                    else None
        return P(*new)
    return spec


def _flatten_with_path(tree) -> list:
    """(path, leaf) pairs in the tree's leaf order; a path is the keys
    joined by ``/``, the reference's ``_path_str`` of the same leaf."""
    return list(zip(tree_names(tree), tree_leaves(tree)))


def _is_stacked(path_str: str) -> int:
    """Leading stacked-layer axes to skip (stacked-layer params)."""
    if re.search(r"(dense_layers|moe_layers|tail|seg\d+|dec_layers|"
                 r"enc_layers|mtp)", path_str):
        return 1
    if re.search(r"groups", path_str):
        return 2     # (G, k, ...) double-stacked
    return 0


def param_shardings(params_shapes, mesh, *, zero3: bool = False) -> Any:
    """Tree of leaves with ``.shape`` -> NamedSharding tree."""
    out = []
    for ps, leaf in _flatten_with_path(params_shapes):
        stacked = _is_stacked(ps)
        shape = tuple(leaf.shape)
        spec = P()
        for pat, prefs in _RULES:
            if re.search(pat, ps):
                spec = _fit_spec(shape, prefs, mesh, stacked=stacked)
                break
        else:
            spec = P(*([None] * len(shape)))
        spec = _moe_rule_fixup(ps, shape, spec, mesh)
        if zero3:
            spec = _zero3_augment(spec, shape, mesh, stacked)
        out.append(NamedSharding(mesh, spec))
    return tree_unflatten(params_shapes, out)


def _zero3_augment(spec: P, shape: tuple, mesh, stacked: int) -> P:
    """Additionally shard the largest un-sharded dim over ('data',)
    [+ ('pod',) if present] — FSDP-style parameter sharding."""
    sizes = mesh_shape(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    if not axes:
        return spec
    # don't double-use an axis already consumed (2-D EP uses 'data')
    used = set()
    for s in spec:
        for a in (s if isinstance(s, (tuple, list)) else (s,)):
            used.add(a)
    axes = [a for a in axes if a not in used]
    if not axes:
        return spec
    factor = int(np.prod([sizes[a] for a in axes]))
    new = list(spec) + [None] * (len(shape) - len(spec))
    # pick the largest free dim that divides
    best, best_dim = 0, -1
    for d in range(stacked, len(shape)):
        if new[d] is None and shape[d] % factor == 0 and shape[d] > best:
            best, best_dim = shape[d], d
    if best_dim >= 0:
        new[best_dim] = tuple(axes) if len(axes) > 1 else axes[0]
    return P(*new)


# ------------------------------------------------------------------ inputs
def batch_spec(mesh) -> P:
    sizes = mesh_shape(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    return P(axes if len(axes) > 1 else axes[0] if axes else None)


def token_sharding(mesh, *, shardable_batch: bool = True) -> NamedSharding:
    """(B, S) tokens: batch over ('pod','data') when divisible."""
    if not shardable_batch:
        return NamedSharding(mesh, P(None, None))
    return NamedSharding(mesh, P(batch_spec(mesh)[0], None))


def _state_spec(shape: tuple, sizes: dict, daxes: tuple, dsize: int,
                batch: int) -> list:
    """The reference's rule for a batched state leaf (L, B, ...) / (B, ...)."""
    spec = [None] * len(shape)
    bdim = 1 if (len(shape) > 1 and shape[0] != batch
                 and shape[1] == batch) else 0
    if shape[bdim] == batch and batch % dsize == 0 and dsize > 1:
        spec[bdim] = daxes if len(daxes) > 1 else daxes[0]
    if len(shape) >= 3 and shape[-1] % sizes.get("model", 1) == 0:
        spec[-1] = "model"
    return spec


def cache_shardings(cache_shapes, mesh, batch: int) -> Any:
    """Decode-cache tree -> shardings.

    Pools (no batch dim): pages -> 'data', trailing feature dim ->
    'model' when divisible.  Batched state leaves: batch -> ('pod','data')
    when divisible, else replicate (long_500k batch=1 path: pages carry
    the parallelism instead — SP).  An sLSTM state leaf, ``(1, B, d)``
    here and ``(B, d)`` in the reference, takes the reference's spec of
    ``(B, d)`` behind a ``None`` for its leading axis.
    """
    sizes = mesh_shape(mesh)
    daxes = tuple(a for a in ("pod", "data") if a in sizes)
    dsize = int(np.prod([sizes[a] for a in daxes])) if daxes else 1
    flat = _flatten_with_path(cache_shapes)
    parents: dict = {}
    for ps, _ in flat:
        head, _, key = ps.rpartition("/")
        parents.setdefault(head, set()).add(key)
    out = []
    for ps, leaf in flat:
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        head, _, _ = ps.rpartition("/")
        if "pool" in ps:
            # (L, P, page, [KVH,] feat): pages over data axes; heads (or
            # else feat) over model — matching the shard-local decode
            if len(shape) >= 2 and shape[1] % dsize == 0 and dsize > 1:
                spec[1] = daxes if len(daxes) > 1 else daxes[0]
            msz = sizes.get("model", 1)
            if len(shape) >= 5 and shape[-2] % msz == 0:
                spec[-2] = "model"
            elif len(shape) >= 4 and shape[-1] % msz == 0:
                spec[-1] = "model"
        elif "table" in ps or ps == "lengths":
            pass   # small int arrays: replicated
        elif parents.get(head) == _SLSTM_STATE and len(shape) == 3 \
                and shape[0] == 1:
            spec = [None] + _state_spec(shape[1:], sizes, daxes, dsize,
                                        batch)
        else:
            spec = _state_spec(shape, sizes, daxes, dsize, batch)
        out.append(NamedSharding(mesh, P(*spec)))
    return tree_unflatten(cache_shapes, out)


def opt_state_shardings(opt_shapes, param_shardings_tree, mesh) -> Any:
    """Optimizer moments follow their parameters; step is replicated."""
    import repro_torch.optim.adamw as adamw

    def like(shapes, shardings):
        return tree_map(lambda s, sh: sh, shapes, shardings)

    return adamw.AdamWState(
        step=NamedSharding(mesh, P()),
        mu=like(opt_shapes.mu, param_shardings_tree),
        nu=like(opt_shapes.nu, param_shardings_tree),
    )
