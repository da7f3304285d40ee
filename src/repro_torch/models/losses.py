"""Masked cross-entropy in the reference's iota-mask formulation.

    sel = Σ_v [v == label] · logit_v
    lse = logsumexp_v(logits)          (max taken out, without gradient)
    nll = lse - sel

The reference chose this form so a vocabulary-sharded lm_head never
gathers the logits; the port keeps it so the two packages compute the same
sums in the same order.  Arithmetic in f32 from the logits on.
"""

from __future__ import annotations

import torch


def masked_xent(logits, labels, aux=0.0):
    """logits: (B, S, V); labels: (B, S) int (-1 = masked)."""
    V = logits.shape[-1]
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    vocab_iota = torch.arange(V, device=logits.device)
    onehot_mask = vocab_iota == labels.long().clamp(min=0)[..., None]
    sel = torch.where(onehot_mask, lf, torch.zeros((), device=lf.device)
                      ).sum(dim=-1)
    nll = lse - sel
    mask = labels >= 0
    loss = (nll * mask).sum() / mask.sum().clamp(min=1)
    return loss + aux
