"""Mamba2 (SSD) block: chunked parallel scan for train/prefill, recurrent
single-step for decode.

State-space recurrence per head (P = head channels, N = state dim):
    S_t = exp(dt_t·A) · S_{t-1} + (dt_t·x_t) ⊗ B_t        S: (P, N)
    y_t = C_t · S_t + D · x_t

Train/prefill uses the SSD chunked algorithm: segment-sum decays inside a
chunk (a quadratic form), then a scan of the chunk-final states, a Python
loop over the chunks here where the reference scans.  The reference has no
Pallas kernel for either, so this module is plain torch: matmuls and
element-wise ops.  Its three-operand einsums are written as pairwise
products with the heads ahead of the positions, so the largest
intermediate is (B, nc, nh, Q, Q), never (B, nc, Q, Q, nh, P).

The decode state (S plus the depthwise-conv tail) is small and *resident*
("pinned" in thesis terms): the hybrid archs page only their attention KV
while the SSM state stays pinned.

Dtypes follow the reference's promotions: ``dt``, ``u`` and the B / C
projections in f32; the forward's causal conv in the input dtype but the
decode conv in f32 (as the reference does); the output cast back to the
input dtype before ``out_proj``.  ``F.softplus`` switches to the identity
above 20, where it differs from ``jax.nn.softplus`` by about 2e-9: inside
the f32 tolerance.

One divergence, held on purpose (``tests/test_torch_hybrid.py``
``TestMaskedExponent``): the intra-chunk decays are
``exp(where(i >= j, acum_i - acum_j, -inf))``.  The reference takes
``where(i >= j, exp(acum_i - acum_j), 0)``, whose upper triangle overflows
to inf once a chunk's decays sum past ~88 (128 steps of dt ≈ 0.8 do); the
forward masks the inf away, but the backward computes 0 · inf = NaN in the
gradients of ``in_proj``, ``A_log`` and ``dt_bias``.  The forward is the
same function; the gradients are finite.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import logical
from repro_torch.distributed.logical import mesh_of, replicated
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, whole_features


def mamba_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    d_in, nh, P, N = mamba_dims(cfg)
    conv_dim = d_in + 2 * N
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * N + nh, dtype),
        "conv_w": torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                              **f32).mul_(0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((nh,), **f32),           # A = -exp(A_log) = -1
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm_scale": torch.ones((d_in,), **f32),
        "out_proj": dense_init(gen, d_in, d, dtype),
    }


def _split_proj(p, cfg: ModelConfig, x):
    d_in, nh, P, N = mamba_dims(cfg)
    return torch.split(x @ p["in_proj"], [d_in, d_in + 2 * N, nh], dim=-1)


def _causal_conv(p, xBC, w: int):
    """Depthwise causal conv along the sequence axis."""
    S = xBC.shape[1]
    pad = logical.pad(xBC, (0, 0, w - 1, 0))
    out = sum(pad[:, k:k + S, :] * p["conv_w"][k] for k in range(w))
    return F.silu(out + p["conv_b"])


def _gated_norm(p, y, z, eps: float):
    """The gated RMS norm over the whole of ``d_in`` (a DTensor split
    there is gathered first)."""
    yf = whole_features((y * F.silu(z.float())).float())
    return F.rms_norm(yf, yf.shape[-1:], p["norm_scale"], eps)


def apply_mamba(p, cfg: ModelConfig, x, *, chunk: int = 128):
    """Chunked SSD forward.  x: (B, S, d) -> (B, S, d)."""
    Bsz, S, d = x.shape
    d_in, nh, P, N = mamba_dims(cfg)
    z, xBC, dt = _split_proj(p, cfg, x)
    xBC = _causal_conv(p, xBC, cfg.ssm_conv)
    xs = xBC[..., :d_in].reshape(Bsz, S, nh, P)
    Bmat = xBC[..., d_in:d_in + N]                     # (B, S, N), 1 group
    Cmat = xBC[..., d_in + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])         # (B, S, nh)
    A = -torch.exp(p["A_log"])                         # (nh,)
    a = dt * A                                         # log-decay (B,S,nh)
    u = dt[..., None] * xs.float()                     # (B, S, nh, P)

    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        u = logical.pad(u, (0, 0, 0, 0, 0, pad))
        Bmat = logical.pad(Bmat, (0, 0, 0, pad))
        Cmat = logical.pad(Cmat, (0, 0, 0, pad))
        a = logical.pad(a, (0, 0, 0, pad))
    nc = (S + pad) // Q
    u = u.reshape(Bsz, nc, Q, nh, P)
    Bm = Bmat.reshape(Bsz, nc, Q, N).float()
    Cm = Cmat.reshape(Bsz, nc, Q, N).float()
    acum = logical.cumsum(a.reshape(Bsz, nc, Q, nh), 2)     # (B,nc,Q,nh)

    # intra-chunk decays L[i, j] = exp(acum_i - acum_j) for i >= j, heads
    # ahead of the positions: (B, nc, nh, Q, Q); the masked exponent
    # (module docstring) keeps the upper triangle at exp(-inf) = 0
    acum_h = acum.transpose(2, 3)                       # (B,nc,nh,Q)
    diff = acum_h[..., :, None] - acum_h[..., None, :]
    mesh = mesh_of(x)
    tri = replicated(torch.ones((Q, Q), dtype=torch.bool,
                                device=x.device).tril(), mesh)
    L = torch.exp(torch.where(tri, diff, float("-inf")))
    CB = Cm @ Bm.transpose(-1, -2)                      # (B,nc,Q,Q)
    u_h = u.permute(0, 1, 3, 2, 4)                      # (B,nc,nh,Q,P)
    y_diag = ((CB[:, :, None] * L) @ u_h).permute(0, 1, 3, 2, 4)

    # chunk-final states and the inter-chunk scan
    decay_to_end = torch.exp(acum[:, :, -1:, :] - acum)      # (B,nc,Q,nh)
    S_chunk = torch.einsum("bcqhp,bcqn->bchpn", decay_to_end[..., None] * u,
                           Bm)                          # (B,nc,nh,P,N)
    total_decay = torch.exp(acum[:, :, -1, :])          # (B,nc,nh)
    state = replicated(torch.zeros((Bsz, nh, P, N), dtype=torch.float32,
                                   device=x.device), mesh)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(state)
        state = total_decay[:, c, :, None, None] * state + S_chunk[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)               # (B,nc,nh,P,N)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cm, S_prevs) \
        * torch.exp(acum)[..., None]

    y = (y_diag + y_off).reshape(Bsz, nc * Q, nh, P)[:, :S]
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(Bsz, S, d_in)
    y = _gated_norm(p, y, z, cfg.norm_eps)
    return y.to(x.dtype) @ p["out_proj"]


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu"):
    d_in, nh, P, N = mamba_dims(cfg)
    conv_dim = d_in + 2 * N
    return {"ssm": torch.zeros((batch, nh, P, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device)}


def apply_mamba_decode(p, cfg: ModelConfig, x, state):
    """Single-token recurrent step.  x: (B, 1, d) -> (y, state).

    The decode path of a serving engine runs this once per layer and token,
    so it keeps its launches few: a bf16 operand meets an f32 one and is
    promoted exactly (where the reference casts it first), and the two
    multiply-adds are ``addcmul``."""
    Bsz = x.shape[0]
    d_in, nh, P, N = mamba_dims(cfg)
    z, xBC, dt = (t[:, 0] for t in _split_proj(p, cfg, x))
    # conv over the stored tail + current input, in f32
    hist = torch.cat([state["conv"], xBC[:, None, :]], dim=1)
    conv_out = (hist.float() * p["conv_w"]).sum(dim=1)
    xBC_c = F.silu(conv_out + p["conv_b"])
    new_conv = hist[:, 1:]

    xs = xBC_c[:, :d_in].reshape(Bsz, nh, P)
    Bm = xBC_c[:, d_in:d_in + N]
    Cm = xBC_c[:, d_in + N:]
    dt = F.softplus(dt + p["dt_bias"])                  # (B, nh), f32
    decay = torch.exp(dt * -torch.exp(p["A_log"]))      # exp(dt·A)
    u = dt[..., None] * xs                              # (B, nh, P)
    S = torch.addcmul(state["ssm"] * decay[..., None, None], u[..., None],
                      Bm[:, None, None, :])
    y = torch.addcmul((S @ Cm[:, None, :, None])[..., 0],
                      p["D"][None, :, None], xs)
    y = _gated_norm(p, y.reshape(Bsz, d_in), z, cfg.norm_eps)
    out = y.to(x.dtype) @ p["out_proj"]
    return out[:, None, :], {"ssm": S,
                             "conv": new_conv.to(state["conv"].dtype)}


def mamba_reference(p, cfg: ModelConfig, x):
    """Naive per-token recurrence — oracle for the chunked implementation."""
    state = init_mamba_state(cfg, x.shape[0], dtype=x.dtype, device=x.device)
    outs = []
    for t in range(x.shape[1]):
        y, state = apply_mamba_decode(p, cfg, x[:, t:t + 1], state)
        outs.append(y)
    return torch.cat(outs, dim=1)
