"""Mixture-of-Experts layer: capacity-based dispatch (Mesh-TF style).

Top-k softmax routing, a Switch-style load-balancing auxiliary loss and
optional shared experts, as in the reference.  Dispatch is **dense**: the
tokens reach the experts through ``(T, E, C)`` one-hot einsums over all
experts — the reference's formulation, kept as it is (an index-based
dispatch would compute the same values with less work, and is a
performance change of its own).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import constrain, dense_init


def _expert_weights(gen: torch.Generator, E: int, d_in: int, d_out: int,
                    dtype) -> torch.Tensor:
    """(E, d_in, d_out) normal weights / sqrt(d_in), drawn in f32 **one
    expert at a time** and cast, so the peak stays near the ``dtype`` size
    (at DeepSeek-V3 width a whole f32 draw would be 15 GB a layer)."""
    w = torch.empty((E, d_in, d_out), dtype=dtype, device=gen.device)
    std = 1.0 / np.sqrt(d_in)
    for e in range(E):
        w[e].copy_(torch.randn((d_in, d_out), generator=gen,
                               device=gen.device,
                               dtype=torch.float32).mul_(std))
    return w


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, d, E, torch.float32),
        "wi": _expert_weights(gen, E, d, f, dtype),
        "wg": _expert_weights(gen, E, d, f, dtype),
        "wo": _expert_weights(gen, E, f, d, dtype),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"wi": dense_init(gen, d, fs, dtype),
                       "wg": dense_init(gen, d, fs, dtype),
                       "wo": dense_init(gen, fs, d, dtype)}
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


GROUP_TOKENS = 4096     # dispatch group size (bounds the one-hot tensors)


def apply_moe(p, cfg: ModelConfig, x, *, dropless: bool = False):
    """x: (B, S, d) -> (y, aux_loss).

    ``dropless=True`` sizes expert capacity to the worst case (every token
    to one expert) — the serving/decode configuration, where dropping a
    token corrupts generation.  Training uses the capacity factor (Switch
    convention); overflowing tokens fall through the residual.

    More than ``GROUP_TOKENS`` tokens are dispatched in groups of that
    many (Mesh-TF convention; the last group zero-padded), each group
    recomputed in the backward (``torch.utils.checkpoint``), so the
    (tokens × experts × capacity) one-hots stay bounded; the aux loss is
    the mean over the groups.
    """
    B, S, d = x.shape
    T_all = B * S
    if not dropless and T_all > GROUP_TOKENS:
        g = GROUP_TOKENS
        pad = (-T_all) % g
        xf = x.reshape(T_all, d)
        if pad:
            xf = F.pad(xf, (0, 0, 0, pad))
        ys, auxs = [], []
        for xg in xf.reshape(-1, g, d).unbind(0):
            y, aux = checkpoint(_moe_group, p, cfg, xg, False,
                                use_reentrant=False)
            ys.append(y)
            auxs.append(aux)
        y = torch.cat(ys)[:T_all].reshape(B, S, d)
        return y, torch.stack(auxs).mean()
    y, aux = _moe_group(p, cfg, x.reshape(T_all, d), dropless)
    return y.reshape(B, S, d), aux


def _moe_group(p, cfg: ModelConfig, xf, dropless: bool):
    """xf: (T, d) -> (y (T, d), aux)."""
    E, k = cfg.n_experts, cfg.experts_per_token
    T = xf.shape[0]
    C = T if dropless else _capacity(T, cfg)

    logits = xf.float() @ p["router"]                         # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = torch.topk(probs, k, dim=-1)             # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # position-in-expert via a cumsum over the tokens, one routing choice
    # after the other (choice-major): choice j's slots start after those
    # that choices < j took
    dispatch = torch.zeros((T, E, C), dtype=xf.dtype, device=xf.device)
    combine = torch.zeros((T, E, C), dtype=torch.float32, device=xf.device)
    fill = torch.zeros((E,), dtype=torch.int32, device=xf.device)
    slots = torch.arange(C, device=xf.device)
    for choice in range(k):
        onehot = F.one_hot(sel[:, choice], E).to(torch.int32)  # (T, E)
        pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1 + fill
        fill = fill + onehot.sum(dim=0, dtype=torch.int32)
        within = (pos < C) & (onehot > 0)
        pos_c = pos.clamp(0, C - 1)
        slot = ((pos_c[..., None] == slots) & within[..., None]).to(xf.dtype)
        dispatch = dispatch + slot
        combine = combine + slot.float() * gate_vals[:, choice, None, None]

    expert_in = torch.einsum("tec,td->ecd", dispatch, xf)
    expert_in = constrain(expert_in, "experts", "capacity", "embed")
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, p["wi"])) \
        * torch.einsum("ecd,edf->ecf", expert_in, p["wg"])
    h = constrain(h, "experts", "capacity", "moe_ff")
    expert_out = torch.einsum("ecf,efd->ecd", h, p["wo"])
    expert_out = constrain(expert_out, "experts", "capacity", "embed")
    # the gate weights round to x's dtype here, as in the reference
    y = torch.einsum("tec,ecd->td", combine.to(xf.dtype), expert_out)

    # load-balancing aux loss (Switch-style)
    density = F.one_hot(sel[:, 0], E).float().mean(dim=0)
    router_prob = probs.mean(dim=0)
    aux = (density * router_prob).sum() * E * cfg.router_aux_coef

    if "shared" in p:
        sp = p["shared"]
        y = y + (F.silu(xf @ sp["wi"]) * (xf @ sp["wg"])) @ sp["wo"]
    return y, aux
