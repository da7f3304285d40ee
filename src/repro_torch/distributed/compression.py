"""Gradient compression for the DP all-reduce: error-feedback int8 + top-k.

Composable with ``torch.distributed.all_reduce``: compress → all-reduce
the compact representation → decompress, with the quantization residual
carried per step (error feedback keeps the compressed SGD unbiased over
time — tested for convergence in tests/test_torch_distributed.py).

Trees are the port's nested dicts of tensors.  Rounding is half to even
(``torch.round``), as ``jnp.round``; top-k takes the largest magnitudes
and, among equal ones, the lower flat index first, as ``jax.lax.top_k``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_map


class Int8Compressed(NamedTuple):
    values: Any      # int8 tree
    scales: Any      # f32 per-leaf scale


def _zeros_like_f32(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def int8_compress(grads, residual=None):
    """Error-feedback int8 quantization.  Returns (compressed, residual)."""
    if residual is None:
        residual = _zeros_like_f32(grads)

    def q(g, r):
        gf = g.float() + r
        scale = gf.abs().max() / 127.0 + 1e-12
        qv = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return qv, scale, gf - qv.float() * scale

    out = tree_map(q, grads, residual)
    return (Int8Compressed(tree_map(lambda t: t[0], out),
                           tree_map(lambda t: t[1], out)),
            tree_map(lambda t: t[2], out))


def int8_decompress(comp: Int8Compressed):
    return tree_map(lambda v, s: v.float() * s, comp.values, comp.scales)


def topk_compress(grads, k_fraction: float = 0.01, residual=None):
    """Error-feedback top-k sparsification: keep the largest |g| entries."""
    if residual is None:
        residual = _zeros_like_f32(grads)

    def s(g, r):
        gf = g.float() + r
        flat = gf.reshape(-1)
        k = max(1, int(flat.shape[0] * k_fraction))
        # a stable sort: equal magnitudes keep their index order
        idx = torch.sort(flat.abs(), descending=True, stable=True)[1][:k]
        vals = flat[idx]
        kept = torch.zeros_like(flat).index_put_((idx,), vals)
        return (idx.to(torch.int32), vals), gf - kept.reshape(gf.shape)

    out = tree_map(s, grads, residual)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def topk_decompress(comp, shapes_like):
    def d(c, like):
        idx, vals = c
        flat = torch.zeros((like.numel(),), dtype=torch.float32,
                           device=vals.device)
        flat.index_put_((idx.long(),), vals)
        return flat.reshape(like.shape)
    return tree_map(d, comp, shapes_like)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def compressed_bytes(comp) -> int:
    """Wire bytes of a compressed representation (for §Perf accounting)."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(comp))
