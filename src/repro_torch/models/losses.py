"""Masked cross-entropy in the reference's iota-mask formulation.

    sel = Σ_v [v == label] · logit_v
    lse = logsumexp_v(logits)          (max taken out, without gradient)
    nll = lse - sel

The reference chose this form so a vocabulary-sharded lm_head never
gathers the logits; the port keeps it so the two packages compute the same
sums in the same order.  Arithmetic in f32 from the logits on.  For
DTensor logits the zero is replicated on their mesh and the vocabulary
iota split like their vocabulary dim, so the one-hot mask is never whole
on a rank.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.logical import mesh_of, replicated


def masked_xent(logits, labels, aux=0.0):
    """logits: (B, S, V); labels: (B, S) int (-1 = masked)."""
    V = logits.shape[-1]
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    mesh = mesh_of(logits)
    vocab_iota = replicated(torch.arange(V, device=logits.device), mesh)
    if mesh is not None:       # split like the logits' vocabulary dim
        from torch.distributed.tensor import Replicate, Shard
        vocab_iota = vocab_iota.redistribute(mesh, [
            Shard(0) if p.is_shard(logits.ndim - 1) else Replicate()
            for p in logits.placements])
    onehot_mask = vocab_iota == labels.long().clamp(min=0)[..., None]
    zero = replicated(torch.zeros((), device=lf.device), mesh)
    sel = torch.where(onehot_mask, lf, zero).sum(dim=-1)
    nll = lse - sel
    mask = labels >= 0
    loss = (nll * mask).sum() / mask.sum().clamp(min=1)
    return loss + aux
