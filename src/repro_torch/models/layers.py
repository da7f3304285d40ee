"""Shared neural-net primitives: norms, RoPE, initializers, MLPs.

Plain functions on tensors: ``init_*`` returns a params dict (nested dicts
of tensors), ``apply``-style functions take (params, inputs).  All matmul
weights are stored ``(in, out)``; layers are stacked on a leading axis by
the decoders, which loop over it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.logical import (constrain, is_dtensor, mesh_of,
                                             replicated)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------- initializers
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0):
    """(d_in, d_out) normal weights, drawn in f32 on the generator's device
    and cast."""
    std = scale / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32).mul_(std)
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32).mul_(0.02)
    return w.to(dtype)


# ----------------------------------------------------------------------- norms
def init_norm(d: int, kind: str = "rms", device="cpu"):
    if kind == "rms":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def whole_features(x):
    """``x`` with its last dim whole and summed on every rank: a norm reads
    the whole feature vector.  A DTensor left split there by an all-``None``
    constraint (a batch-1 decode's embedding) is gathered, and a
    ``Partial`` one (a projection whose contraction dim is split, as
    ZeRO-3 splits it) is reduced."""
    if not is_dtensor(x) or not any(p.is_shard(x.ndim - 1) or p.is_partial()
                                    for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(x.ndim - 1) or p.is_partial() else p
        for p in x.placements])


def apply_norm(params, x, kind: str = "rms", eps: float = 1e-5):
    """Computed in f32 and cast back.  The RMS form is one fused
    ``F.rms_norm`` call: x · rsqrt(mean(x²) + eps) · scale."""
    x = whole_features(x)
    xf = x.float()
    if kind == "rms":
        y = F.rms_norm(xf, xf.shape[-1:], params["scale"], eps)
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
            + params["bias"]
    return y.to(x.dtype)


def rms_head_norm(scale, x, eps: float = 1e-5):
    """Per-head RMS norm for qk_norm (Qwen3 / Chameleon)."""
    x = whole_features(x)
    xf = x.float()
    return F.rms_norm(xf, xf.shape[-1:], scale, eps).to(x.dtype)


# ------------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=64)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """The f32 frequency vector on ``device``, made once: a host-to-device
    copy per call would stall the launch queue on every layer."""
    return torch.from_numpy(
        rope_freqs(head_dim, theta).astype(np.float32)).to(device)


def rope_tables(positions, head_dim: int, theta: float = 10000.0):
    """(cos, sin) of shape (..., seq, 1, head_dim/2) for ``apply_rope``.

    They depend on the positions only, so a decode step makes them once
    and every layer (and both q and k) reuses them.  The frequencies are
    made in float64 by numpy and cast to f32.  For DTensor positions the
    frequencies are replicated on their mesh."""
    freqs = replicated(_rope_freqs_on(head_dim, float(theta),
                                      positions.device), mesh_of(positions))
    angles = positions[..., :, None].float() * freqs      # (..., S, hd/2)
    return (torch.cos(angles)[..., :, None, :],
            torch.sin(angles)[..., :, None, :])


def apply_rope(x, positions, theta: float = 10000.0, tables=None):
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Rotates the two halves of head_dim (not interleaved pairs).
    ``tables``: precomputed ``rope_tables(positions, head_dim, theta)``."""
    cos, sin = tables if tables is not None \
        else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, d: int, f: int, act: str, dtype,
             bias: bool = False):
    if act == "silu":   # SwiGLU
        p = {"wi": dense_init(gen, d, f, dtype),
             "wg": dense_init(gen, d, f, dtype),
             "wo": dense_init(gen, f, d, dtype)}
    else:               # plain GELU MLP
        p = {"wi": dense_init(gen, d, f, dtype),
             "wo": dense_init(gen, f, d, dtype)}
    if bias:
        p["bi"] = torch.zeros((f,), dtype=dtype, device=gen.device)
        p["bo"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    return p


def apply_mlp(p, x, act: str):
    if act == "silu":
        h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    else:
        h = x @ p["wi"]
        if "bi" in p:
            h = h + p["bi"]
        h = F.gelu(h, approximate="tanh")
    h = constrain(h, "batch", "seq", "ff")
    # the row-parallel product is reduced before the bias and the residual
    # join it: added to a replicated tensor, a Partial sum would make the
    # backward's gradient Partial too, and its matmuls gather the weight
    y = constrain(h @ p["wo"], "batch", "seq", "embed")
    if "bo" in p:
        y = y + p["bo"]
    return y


def embed(table, ids):
    """Rows ``ids`` of ``table``.  DTensor ids split over the batch are
    gathered whole for the lookup, and its rows split as the ids were
    after it: the backward then meets whole ids and a whole gradient,
    where with split ones ``index_put`` fails on some torch versions."""
    if not is_dtensor(ids):
        return table[ids.long()]
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = ids.device_mesh, ids.placements
    rows = table[ids.redistribute(mesh, [Replicate()] * mesh.ndim).long()]
    return rows.redistribute(mesh, [Shard(p.dim) if p.is_shard()
                                    else Replicate() for p in pl])


# ------------------------------------------------------- sinusoidal positions
def sinusoid_positions(n: int, d: int, device="cpu"):
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000, 2 * dim / d)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)
