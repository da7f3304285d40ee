"""Prefetch predictors: which extra pages ride along with a fault.

Lifted out of the seed's per-consumer pagers so one implementation serves
tensors, KV frames and optimizer blocks alike.  A predictor returns two
page lists for a fault at ``vpage``:

* ``block`` — pages resolved inside the same fault event (the thesis'
  ``get_user_pages`` Touch-Ahead block, charged via ``gup_us``);
* ``stream`` — sequential-stream predictions beyond the block (charged
  per page, ``gup_per_page_us``), the beyond-paper STREAM variant.
"""

from __future__ import annotations

from repro_torch.api.policy import FaultPolicy
from repro_torch.core.resolver import Strategy


class PrefetchPredictor:
    def predict(self, space, vpage: int) -> tuple[list[int], list[int]]:
        """-> (block_pages, stream_pages), both excluding ``vpage``."""
        raise NotImplementedError


class NoPrefetch(PrefetchPredictor):
    """Touch-A-Page: exactly the faulted page."""

    def predict(self, space, vpage: int) -> tuple[list[int], list[int]]:
        return [], []


class TouchAheadPrefetch(PrefetchPredictor):
    """The faulted page + the rest of its ``lookahead``-page block."""

    def __init__(self, lookahead: int = 4):
        self.lookahead = max(1, lookahead)

    def predict(self, space, vpage: int) -> tuple[list[int], list[int]]:
        end = min(space.n_pages, vpage + self.lookahead)
        return list(range(vpage + 1, end)), []


class StreamPrefetch(TouchAheadPrefetch):
    """Touch-Ahead + the first page of the next block, so a sequential
    stream's next fault never lands on the critical path."""

    def predict(self, space, vpage: int) -> tuple[list[int], list[int]]:
        block, _ = super().predict(space, vpage)
        nxt = vpage + self.lookahead
        stream = [nxt] if nxt < space.n_pages else []
        return block, stream


def predictor_for(policy: FaultPolicy) -> PrefetchPredictor:
    """The predictor a :class:`FaultPolicy`'s strategy implies."""
    s = policy.strategy
    if s is Strategy.TOUCH_A_PAGE:
        return NoPrefetch()
    if s is Strategy.STREAM:
        return StreamPrefetch(policy.lookahead)
    # TOUCH_AHEAD / TOUCH_AHEAD_N / KERNEL_RAPF all page in block-wise
    return TouchAheadPrefetch(policy.lookahead)
