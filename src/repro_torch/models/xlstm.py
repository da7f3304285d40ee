"""xLSTM blocks: mLSTM (matrix memory, pre-up-projection) and sLSTM
(scalar memory with recurrent gate connections, post-up-projection).

Attention-free: decode carries a per-layer fixed-size state instead of a
KV cache.  In thesis terms the whole state is the *resident set* — there
are no pages to fault on during decode: the state is pinned and the
serving engine copies it into and out of a batch slot every step.

Recurrences (stabilized, per head):
    mLSTM:  m_t = max(f̃ + m_{t-1}, ĩ);   C_t = e^{f̃+m_{t-1}-m_t} C_{t-1}
            + e^{ĩ-m_t} k_t v_tᵀ;  n_t likewise;  h = Cᵀq / max(|nᵀq|, 1)
    sLSTM:  c_t = σ(f) c_{t-1} + e^{ĩ-m_t} z_t;  gates see h_{t-1} through
            block-diagonal recurrent weights R.

The reference has no Pallas kernel for either block, so this module is
plain torch: ``torch.matmul`` for the projections, element-wise ops for
the recurrences.  A sequence runs token by token in chunks of ``chunk``
tokens, each chunk's body under ``torch.utils.checkpoint`` (non-reentrant)
where the reference wraps its chunk scan in ``jax.checkpoint``: the
backward keeps only the chunk-boundary states and recomputes inside a
chunk.  Without it autograd would keep the matrix memory ``C`` of every
token (S × nh × dk² floats a layer).  The last chunk is as long as the
tokens left, where the reference pads it with zeros: the padded positions
come after every real one and change no output.

Dtypes follow the reference: ``q`` / ``k`` / ``v`` are projected in the
model dtype, ``k`` divided by √dk in that dtype (√dk itself rounded to
it), then all three cast to f32; the gates, the recurrences and their
states are f32; ``w_if``, ``b_if``, ``norm_scale`` and the whole sLSTM
gate set are f32 whatever the model dtype.  The cells' own norms are RMS norms with a scale only; the
sLSTM's FFN uses the tanh GELU (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import logical
from repro_torch.distributed.logical import PartitionSpec as P
from repro_torch.distributed.logical import (grad_like, mesh_of, replicated,
                                             unflatten_last)
from repro_torch.models.attention import _data_split
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, dense_init

NEG_INIT = -1e30        # the stabiliser m before the first token


# ================================================================== mLSTM
def mlstm_dims(cfg: ModelConfig):
    d_in = int(cfg.d_model * cfg.mlstm_proj_factor)
    nh = cfg.n_heads
    dk = d_in // nh
    return d_in, nh, dk


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    d_in, nh, dk = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "up": dense_init(gen, d, 2 * d_in, dtype),
        "wq": dense_init(gen, d_in, d_in, dtype),
        "wk": dense_init(gen, d_in, d_in, dtype),
        "wv": dense_init(gen, d_in, d_in, dtype),
        "w_if": dense_init(gen, d_in, 2 * nh, torch.float32),
        "b_if": torch.cat([torch.zeros((nh,), **f32),
                           torch.full((nh,), 3.0, **f32)]),
        "wo_gate": dense_init(gen, d_in, d_in, dtype),
        "skip": dense_init(gen, d_in, d_in, dtype),
        "norm_scale": torch.ones((d_in,), **f32),
        "down": dense_init(gen, d_in, d, dtype),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cpu"):
    d_in, nh, dk = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, nh, dk, dk), **f32),
            "n": torch.zeros((batch, nh, dk), **f32),
            "m": torch.full((batch, nh), NEG_INIT, **f32)}


def _mlstm_cell(carry, inp):
    """One token: carry (C, n, m), inp (q, k, v, i_pre, f_pre) with
    q / k / v (B, nh, dk) and the gates (B, nh), all f32."""
    C, n, m = carry
    q, k, v, i_pre, f_pre = inp
    f_log = F.logsigmoid(f_pre)
    m_new = torch.maximum(f_log + m, i_pre)
    f_eff = torch.exp(f_log + m - m_new)
    i_eff = torch.exp(i_pre - m_new)
    C_new = torch.addcmul(f_eff[..., None, None] * C,
                          i_eff[..., None, None] * k[..., :, None],
                          v[..., None, :])
    n_new = torch.addcmul(f_eff[..., None] * n, i_eff[..., None], k)
    num = (q[..., None, :] @ C_new)[..., 0, :]          # Cᵀq: (B, nh, dk)
    den = (n_new * q).sum(dim=-1).abs()
    h = num / den.clamp(min=1.0)[..., None]
    return (C_new, n_new, m_new), h


@functools.lru_cache(maxsize=None)
def _sqrt_in(n: int, dtype: torch.dtype) -> float:
    """√n in f32 rounded to ``dtype``, as the reference divides by it (a
    host float: no device tensor, no copy, per call)."""
    return float(torch.tensor(math.sqrt(n), dtype=torch.float32).to(dtype))


def _project_qkv(p, cfg: ModelConfig, x_in):
    """q, k, v in f32 (k scaled by 1/√dk in the model dtype first) and the
    input / forget gate pre-activations: x_in (..., d_in) ->
    (..., nh, dk) ×3, (..., nh) ×2."""
    _, nh, dk = mlstm_dims(cfg)
    q = unflatten_last(x_in @ p["wq"], nh, dk).float()
    k = unflatten_last((x_in @ p["wk"]) / _sqrt_in(dk, x_in.dtype), nh,
                       dk).float()
    v = unflatten_last(x_in @ p["wv"], nh, dk).float()
    gates = x_in.float() @ p["w_if"] + p["b_if"]
    i_pre, f_pre = gates.chunk(2, dim=-1)
    return q, k, v, i_pre, f_pre


def _mlstm_chunk(C, n, m, q, k, v, i_pre, f_pre):
    """The recurrence over one chunk: inputs (B, Q, ...); returns the
    carry and the chunk's outputs (B, Q, nh, dk)."""
    carry, hs = (C, n, m), []
    for t in range(q.shape[1]):
        carry, h = _mlstm_cell(carry, (q[:, t], k[:, t], v[:, t],
                                       i_pre[:, t], f_pre[:, t]))
        hs.append(h)
    return carry + (torch.stack(hs, dim=1),)


# ---- the recurrences' regions: DTensor inputs, local loops
def _region(x, heads: int):
    """(mesh, data axes, head axis) of a recurrence's region on the mesh of
    ``x`` (B, ...): batch rows over the data axes where they split, heads
    over ``'model'`` where they divide (``heads`` 0: none), every other
    split gathered.  The recurrences mix nothing across rows or heads, so
    each rank runs its rows and heads on local tensors: the per-token loop
    pays no DTensor dispatch, and none of DTensor's missing rules."""
    mesh = x.device_mesh
    d, _ = _data_split(mesh, x.shape[0], x.shape[0])
    m = logical.mesh_shape(mesh).get("model", 1)
    h = "model" if heads and "model" in mesh.mesh_dim_names \
        and heads % m == 0 else None
    return mesh, d, h


def _local(ts, specs, mesh, grads=None):
    """Each of ``ts`` laid out as its spec, as this rank's local tensor
    (differentiable; ``grads``: the gradients' placements per tensor)."""
    return [logical.local_shard(t, mesh, logical.placements(mesh, s),
                                None if grads is None else g)
            for t, s, g in zip(ts, specs, grads or [None] * len(ts))]


def _wrap(ts, specs, mesh):
    from torch.distributed.tensor import DTensor
    return tuple(DTensor.from_local(t, mesh, logical.placements(mesh, s),
                                    run_check=False)
                 for t, s in zip(ts, specs))


def _mlstm_chunk_dist(C, n, m, q, k, v, i_pre, f_pre):
    """:func:`_mlstm_chunk` in a region (:func:`_region`) for DTensors."""
    if not logical.is_dtensor(q):
        return _mlstm_chunk(C, n, m, q, k, v, i_pre, f_pre)
    mesh, d, h = _region(q, q.shape[2])
    specs = (P(d, h),) * 3 + (P(d, None, h),) * 5
    out = _mlstm_chunk(*_local((C, n, m, q, k, v, i_pre, f_pre), specs,
                               mesh))
    return _wrap(out, specs[:4], mesh)


def _mlstm_cell_dist(carry, inp):
    """:func:`_mlstm_cell` in a region for DTensors (the decode step)."""
    if not logical.is_dtensor(inp[0]):
        return _mlstm_cell(carry, inp)
    mesh, d, h = _region(inp[0], inp[0].shape[1])
    specs = (P(d, h),) * 8
    local = _local(tuple(carry) + tuple(inp), specs, mesh)
    carry, h_out = _mlstm_cell(tuple(local[:3]), tuple(local[3:]))
    return _wrap(carry, specs, mesh), _wrap((h_out,), specs, mesh)[0]


def _slstm_dist(fn, p, cfg: ModelConfig, carry, pre):
    """``fn`` (:func:`_slstm_chunk` or a cell step) in a region for
    DTensors: batch rows over the data axes, the gates whole (their
    gate-major layout keeps a head's four gates apart).  The recurrent
    weights are replicated; their gradient is a part of the sum on each
    data rank (``Partial``)."""
    if not logical.is_dtensor(pre):
        return fn(p, cfg, *carry, pre)
    from torch.distributed.tensor import Partial, Replicate
    mesh, d, _ = _region(pre, 0)
    daxes = (d if isinstance(d, tuple) else (d,)) if d else ()
    r_grad = tuple(Partial() if a in daxes else Replicate()
                   for a in mesh.mesh_dim_names)
    r, *local = _local((p["r_gates"],) + tuple(carry) + (pre,),
                       (P(),) + (P(d),) * 5, mesh,
                       grads=[r_grad] + [None] * 5)
    out = fn({"r_gates": r}, cfg, *local)
    return _wrap(out, (P(d),) * len(out), mesh)


def _mlstm_sequence(p, cfg: ModelConfig, x_in, chunk: int = 64):
    """x_in: (B, S, d_in) -> h: (B, S, d_in), f32.

    Per-token recurrence in chunks of ``chunk``, each chunk checkpointed
    (module docstring)."""
    B, S, _ = x_in.shape
    xs = _project_qkv(p, cfg, x_in)
    st = init_mlstm_state(cfg, B, device=x_in.device)
    C, n, m = (replicated(st[k], mesh_of(x_in)) for k in ("C", "n", "m"))
    Q = min(chunk, S)
    outs = []
    for a in range(0, S, Q):
        C, n, m, h = checkpoint(_mlstm_chunk_dist, C, n, m,
                                *(t[:, a:a + Q] for t in xs),
                                use_reentrant=False)
        outs.append(h)
    # the gradient laid out like the heads' merge (whole over heads that do
    # not divide the model axis), or its backward cannot unflatten them
    return grad_like(torch.cat(outs, dim=1).reshape(B, S, -1))


def _mlstm_out(p, cfg: ModelConfig, h, x_in, z, dtype):
    """Output gate, skip, the cell's RMS norm and the down projection."""
    o = torch.sigmoid(x_in @ p["wo_gate"])
    h = apply_norm({"scale": p["norm_scale"]}, h.to(dtype) + x_in @ p["skip"],
                   "rms", cfg.norm_eps)
    return (h * o * F.silu(z)) @ p["down"]


def apply_mlstm(p, cfg: ModelConfig, x):
    """Pre-up-projection mLSTM block body (x already normed): (B,S,d)->..."""
    up = x @ p["up"]
    d_in = up.shape[-1] // 2
    x_in, z = up[..., :d_in], up[..., d_in:]
    h = _mlstm_sequence(p, cfg, x_in)
    return _mlstm_out(p, cfg, h, x_in, z, x.dtype)


def apply_mlstm_decode(p, cfg: ModelConfig, x, state):
    """x: (B,1,d) -> (y, state)."""
    d_in = mlstm_dims(cfg)[0]
    up = x[:, 0] @ p["up"]
    x_in, z = up[..., :d_in], up[..., d_in:]
    (C, n, m), h = _mlstm_cell_dist((state["C"], state["n"], state["m"]),
                                    _project_qkv(p, cfg, x_in))
    y = _mlstm_out(p, cfg, h.reshape(h.shape[0], -1), x_in, z, x.dtype)
    return y[:, None, :], {"C": C, "n": n, "m": m}


# ================================================================== sLSTM
def slstm_dims(cfg: ModelConfig):
    nh = cfg.n_heads
    ph = cfg.d_model // nh
    return nh, ph


def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    nh, ph = slstm_dims(cfg)
    f_up = int(d * cfg.slstm_proj_factor)
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "w_gates": dense_init(gen, d, 4 * d, torch.float32),
        "r_gates": torch.randn((4, nh, ph, ph), generator=gen, **f32)
        .div_(math.sqrt(ph)),
        "b_gates": torch.zeros((4 * d,), **f32),
        "norm_scale": torch.ones((d,), **f32),
        "ffn_wi": dense_init(gen, d, f_up, dtype),
        "ffn_wo": dense_init(gen, f_up, d, dtype),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device="cpu"):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), NEG_INIT, **f32)}


def _slstm_cell(p, cfg: ModelConfig, carry, pre_t):
    """One token: carry (c, n, h, m) each (B, d), pre_t (B, 4d), f32.  The
    recurrent product is gate-major, ``bhp,ghpq->bghq``, before the split
    into z, i, f, o."""
    c, n, h, m = carry
    B, d = c.shape
    nh, ph = slstm_dims(cfg)
    rec = torch.einsum("bhp,ghpq->bghq", h.reshape(B, nh, ph),
                       p["r_gates"]).reshape(B, 4 * d)
    zi, ii, fi, oi = (pre_t + rec).chunk(4, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    f_log = F.logsigmoid(fi)
    m_new = torch.maximum(f_log + m, ii)
    f_eff = torch.exp(f_log + m - m_new)
    i_eff = torch.exp(ii - m_new)
    c_new = torch.addcmul(f_eff * c, i_eff, z)
    n_new = f_eff * n + i_eff
    h_new = o * c_new / n_new.clamp(min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_chunk(p, cfg: ModelConfig, c, n, h, m, pre):
    carry, hs = (c, n, h, m), []
    for t in range(pre.shape[1]):
        carry, h_t = _slstm_cell(p, cfg, carry, pre[:, t])
        hs.append(h_t)
    return carry + (torch.stack(hs, dim=1),)


def _slstm_step(p, cfg: ModelConfig, c, n, h, m, pre_t):
    """One token, flat: (c, n, h, m, h_out)."""
    carry, h_out = _slstm_cell(p, cfg, (c, n, h, m), pre_t)
    return carry + (h_out,)


def _slstm_ffn(p, cfg: ModelConfig, h, dtype):
    h = apply_norm({"scale": p["norm_scale"]}, h, "rms", cfg.norm_eps)
    h = h.to(dtype)
    # gradients laid out like the activations: DTensor's backward would
    # split the tokens over 'model' where f_up does not divide it, and
    # the products' backward could not unflatten them
    return grad_like(F.gelu(grad_like(h @ p["ffn_wi"]), approximate="tanh")
                     @ p["ffn_wo"])


def apply_slstm(p, cfg: ModelConfig, x, chunk: int = 64):
    """(B, S, d) -> (B, S, d): recurrent scan + post-up FFN.

    Chunk-checkpointed like the mLSTM: backward stores only chunk-boundary
    states."""
    B, S, d = x.shape
    pre = x.float() @ p["w_gates"] + p["b_gates"]
    st = init_slstm_state(cfg, B, device=x.device)
    c, n, h, m = (replicated(st[k], mesh_of(x)) for k in ("c", "n", "h", "m"))
    Q = min(chunk, S)
    outs = []
    for a in range(0, S, Q):
        c, n, h, m, hs = checkpoint(_slstm_dist, _slstm_chunk, p, cfg,
                                    (c, n, h, m), pre[:, a:a + Q],
                                    use_reentrant=False)
        outs.append(hs)
    return _slstm_ffn(p, cfg, torch.cat(outs, dim=1), x.dtype)


def apply_slstm_decode(p, cfg: ModelConfig, x, state):
    """x: (B,1,d) -> (y, state); state leaves (B, d)."""
    pre = x[:, 0].float() @ p["w_gates"] + p["b_gates"]
    c, n, h, m, h_out = _slstm_dist(
        _slstm_step, p, cfg, (state["c"], state["n"], state["h"],
                              state["m"]), pre)
    y = _slstm_ffn(p, cfg, h_out, x.dtype)
    return y[:, None, :], {"c": c, "n": n, "h": h, "m": m}
