"""GPipe-style pipeline parallelism over a 'stage' mesh dim.

``pipeline_apply`` runs L stacked layers as S stages × (L/S) layers per
stage, one stage a rank: microbatches stream through the stages, each tick
sending a stage's activation to the next by ``dist.batch_isend_irecv``.
The classic GPipe schedule (fill, steady state, drain) emerges from
running ``n_micro + n_stages - 1`` ticks with per-stage validity masking,
as in the reference.  Runs on ``gloo`` (CPU tensors) and NCCL (CUDA).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map


def pipeline_apply(layer_fn: Callable, stacked_params, x_micro, mesh, *,
                   stage_axis: str = "stage"):
    """Run ``layer_fn`` over stacked layers, pipelined across stages.

    Called by every rank of ``mesh`` (a DeviceMesh with a ``stage_axis``
    dim) with the same arguments.  stacked_params: tree with leading dim L
    (divisible by n_stages), whole on every rank — each rank takes its
    ``L / S`` slice; x_micro: (n_micro, micro_batch, ...) activations.
    Returns (n_micro, micro_batch, ...) outputs, on every rank.
    """
    group = mesh.get_group(stage_axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    stage_id = mesh.get_local_rank(stage_axis)
    n_micro = x_micro.shape[0]
    L = tree_leaves(stacked_params)[0].shape[0]
    assert L % n_stages == 0, (L, n_stages)
    per_stage = L // n_stages
    lo = stage_id * per_stage
    layers = [tree_map(lambda p, i=i: p[i], stacked_params)
              for i in range(lo, lo + per_stage)]
    nxt = dist.get_global_rank(group, (stage_id + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage_id - 1) % n_stages)

    def apply_stage(h):
        for lp in layers:
            h = layer_fn(lp, h)
        return h

    buf = torch.zeros_like(x_micro[0])    # the activation at *this* stage
    outputs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        if stage_id == 0:                 # stage 0 ingests microbatch t
            buf = x_micro[t if t < n_micro else 0]
        micro_here = t - stage_id         # which microbatch sits here
        valid = 0 <= micro_here < n_micro
        y = apply_stage(buf) if valid else buf
        if valid and stage_id == n_stages - 1:      # last stage emits
            outputs[micro_here] = y
        if n_stages > 1:
            buf = torch.empty_like(y)
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                     dist.P2POp(dist.irecv, buf, prv, group)]):
                req.wait()
        else:
            buf = y
    # every stage holds an `outputs`; only the last stage's is complete
    outputs = outputs * float(stage_id == n_stages - 1)
    dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
    return outputs
