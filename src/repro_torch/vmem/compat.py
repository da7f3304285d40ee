"""Legacy-kwarg handling: ONE place that deprecates ``strategy=`` /
``lookahead=`` in favour of :class:`~repro.api.policy.FaultPolicy`.

Every memory consumer (``PagedTensorStore``, ``PagedKVManager``,
``PagedAdamW``, ``ServingEngine``) funnels its constructor knobs through
:func:`coerce_policy`, so the per-tenant policy vocabulary stays
consistent with ``repro.api`` and the deprecation story lives here
instead of being re-implemented four times.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.api.policy import DEFAULT_POLICY, FaultPolicy
from repro_torch.core.resolver import Strategy


def coerce_policy(owner: str, policy: Optional[FaultPolicy],
                  strategy: Optional[Strategy] = None,
                  lookahead: Optional[int] = None,
                  default: FaultPolicy = DEFAULT_POLICY) -> FaultPolicy:
    """Resolve (policy, legacy strategy/lookahead) into one FaultPolicy.

    ``policy`` wins; passing both is an error.  Legacy kwargs emit a
    DeprecationWarning naming ``owner`` and are folded into a policy.
    """
    if policy is not None:
        if strategy is not None or lookahead is not None:
            raise TypeError(
                f"{owner}: pass either policy=FaultPolicy(...) or the "
                f"legacy strategy=/lookahead= kwargs, not both")
        return policy
    if strategy is None and lookahead is None:
        return default
    warnings.warn(
        f"{owner}(strategy=..., lookahead=...) is deprecated; pass "
        f"policy=FaultPolicy(strategy, lookahead) instead",
        DeprecationWarning, stacklevel=3)
    return dataclasses.replace(
        default,
        strategy=strategy if strategy is not None else default.strategy,
        lookahead=lookahead if lookahead is not None else default.lookahead)
