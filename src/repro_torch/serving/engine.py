"""Serving engine: continuous batching over a paged, host-spillable KV pool.

The thesis' runtime loop, applied to inference serving:

* requests arrive with a prompt; **prefill** computes the prompt's KV
  token by token through the decode step into the sequence's own pages;
* **decode** runs in lockstep over the active batch through the
  paged-attention step; the page table handed to the step names only
  resident frames — the engine (the "driver") resolves residency
  beforehand;
* when the frame pool is exhausted, pages of *waiting* sequences spill to
  host (swap-out); re-scheduling such a sequence **faults** its pages back
  in with Touch-Ahead block granularity — accounting via the calibrated
  cost model.

Data movement differs from the reference on purpose: the decode cache
**never leaves the device**.  Where the reference round-trips every cache
leaf through host arrays each step, this engine copies each active
sequence's pages into its batch slot with ``page_scatter`` before the step
and back out with ``page_gather`` after it, on the pools viewed as
``(L·P, E)`` rows.

Pinning baseline: ``pin_all=True`` sizes residency for the worst case and
refuses admission beyond it (the thesis' memory-utilization cost).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.api.policy import FaultPolicy
from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.core.arbiter import ServiceClass
from repro_torch.core.resolver import Strategy
from repro_torch.kernels.page_pack.ops import gather_pages, scatter_pages
from repro_torch.memory.kv_cache import PagedKVManager
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_for
from repro_torch.serving.sampler import SamplerConfig, sample_token
from repro_torch.tree import tree_leaves, tree_names
from repro_torch.vmem import coerce_policy


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    generated: Optional[list] = None
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    tokens_generated: int = 0
    spill_events: int = 0
    fault_page_ins: int = 0
    simulated_fault_us: float = 0.0


class ServingEngine:
    """Single-host engine over one model; batch size fixed per decode step.

    ``device=None`` means the GPU (an error without one); ``params`` must
    already live on that device.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_len: int = 256, pool_frames: Optional[int] = None,
                 strategy: Optional[Strategy] = None,
                 policy: Optional[FaultPolicy] = None,
                 pin_all: bool = False,
                 sampler: SamplerConfig = SamplerConfig(),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.model = model_for(cfg)
        self.max_batch = max_batch
        self.max_len = max_len
        self.sampler = sampler
        self.pin_all = pin_all
        # this engine is one tenant of the KV fabric: its FaultPolicy decides
        # how spilled pages fault back in (legacy ``strategy`` deprecated).
        # Serving is latency-class traffic: unless the caller pinned a
        # class, its fault-back-ins arbitrate ahead of BULK tenants.
        self.policy = coerce_policy("ServingEngine", policy, strategy)
        if self.policy.service_class is None:
            self.policy = dataclasses.replace(
                self.policy, service_class=ServiceClass.LATENCY)
        ps = cfg.kv_page_tokens
        pages_per_seq = -(-max_len // ps)
        n_frames = pool_frames or max_batch * pages_per_seq
        self.kv = PagedKVManager(n_frames, ps, pages_per_seq,
                                 policy=self.policy)
        self.stats = EngineStats()
        # accumulation cursors into the shared vmem PagingStats
        self._kv_us_seen = 0.0
        self._kv_spills_seen = 0
        # decode cache of fixed (max_batch) shape, resident on the device
        # for the engine's lifetime; batch slot i owns pool pages
        # [i·per_seq, (i+1)·per_seq) through the identity page table
        self.cache = self.model.init_decode_cache(cfg, max_batch, max_len,
                                                  device=self.device)
        self._seq_caches: dict[int, dict] = {}
        self._slot_rows: dict[tuple, torch.Tensor] = {}
        self.queue: list[Request] = []
        self.active: list[Request] = []
        self.req_counter = 0

    # -------------------------------------------------------------- intake
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> Request:
        self.req_counter += 1
        r = Request(self.req_counter, np.asarray(prompt, np.int32),
                    max_new_tokens, generated=[])
        self.queue.append(r)
        return r

    # ------------------------------------------------------------- prefill
    def _admit(self) -> None:
        while self.queue and len(self.active) < self.max_batch:
            r = self.queue.pop(0)
            need_pages = -(-(len(r.prompt) + r.max_new_tokens)
                           // self.kv.page_tokens)
            if self.pin_all and self.kv.frames_used + need_pages > \
                    self.kv.n_frames:
                self.queue.insert(0, r)     # admission control: refuse
                break
            self.kv.add_sequence(r.req_id)
            waiting = [q.req_id for q in self.queue
                       if q.req_id in self.kv.seq_spaces]
            self.kv.append_tokens(r.req_id, len(r.prompt),
                                  spill_candidates=waiting)
            self._prefill_sequence(r)
            self.active.append(r)
            self.stats.prefills += 1

    def _prefill_sequence(self, r: Request) -> None:
        """Token-by-token prefill through the decode step, on a batch-1
        cache of the sequence's own (the reference does the same; a
        chunked prefill program comes with ``forward`` / ``prefill``)."""
        cache = self.model.init_decode_cache(self.cfg, 1, self.max_len,
                                             device=self.device)
        prompt = torch.from_numpy(r.prompt.astype(np.int64)) \
            .to(self.device).reshape(-1, 1, 1)
        for t in range(prompt.shape[0]):
            _, cache = self.model.decode_step(self.params, self.cfg, cache,
                                              prompt[t])
        self._seq_caches[r.req_id] = cache

    # -------------------------------------------------------------- decode
    def _rows(self, n_layers: int, pool_pages: int, per_seq: int,
              slot: int) -> torch.Tensor:
        """Row indices of batch slot ``slot`` in a pool viewed as
        (L·P, E): l·P + slot·per_seq + j, ordered like a (L, per_seq)
        sequence pool."""
        key = (n_layers, pool_pages, per_seq, slot)
        rows = self._slot_rows.get(key)
        if rows is None:
            layer = torch.arange(n_layers, dtype=torch.int32)[:, None]
            page = torch.arange(per_seq, dtype=torch.int32)[None, :]
            rows = (layer * pool_pages + slot * per_seq + page) \
                .reshape(-1).to(self.device)
            self._slot_rows[key] = rows
        return rows

    def _copy_in(self, batch: list[Request]) -> torch.Tensor:
        """Merge per-sequence caches into the fixed-batch decode cache, on
        the device.  Returns the batch ``lengths`` (inactive slots 0).

        Convention (the reference's), on every leaf of the nested cache by
        its "/"-joined path: paths that contain "pool" are frame pools (slot
        i owns pages [i·per_seq, (i+1)·per_seq)); "table" leaves are
        per-slot page tables (identity, untouched); every other leaf but
        ``lengths`` carries the batch on axis 1 ((L, B, ...) stacked states,
        such as the hybrid's ``ssm/ssm`` and ``ssm/conv``).
        """
        lengths = torch.zeros((self.max_batch,), dtype=torch.int32,
                              device=self.device)
        for i, r in enumerate(batch):
            seq = self._seq_caches[r.req_id]
            for name, full, part in zip(tree_names(self.cache),
                                        tree_leaves(self.cache),
                                        tree_leaves(seq)):
                if name == "lengths":
                    lengths[i:i + 1] = part
                elif "pool" in name:
                    L, P = full.shape[:2]
                    per_seq = part.shape[1]
                    scatter_pages(full.view((L * P,) + full.shape[2:]),
                                  self._rows(L, P, per_seq, i),
                                  part.view((L * per_seq,) + part.shape[2:]))
                elif "table" not in name:
                    full[:, i] = part[:, 0]
        return lengths

    def _copy_out(self, i: int, r: Request, cache: dict) -> None:
        """Carry slot ``i`` of the stepped batch cache back into the
        sequence's own cache (in place, but for its new ``lengths``), on
        the device; leaves as in :meth:`_copy_in`."""
        seq = self._seq_caches[r.req_id]
        for name, part, big in zip(tree_names(seq), tree_leaves(seq),
                                   tree_leaves(cache)):
            if name == "lengths":
                seq[name] = part + 1
            elif "pool" in name:
                L, P = big.shape[:2]
                per_seq = part.shape[1]
                gather_pages(big.view((L * P,) + big.shape[2:]),
                             self._rows(L, P, per_seq, i),
                             out=part.view((L * per_seq,) + part.shape[2:]))
            elif "table" not in name:
                part[:, 0] = big[:, i]

    def step_decode(self) -> int:
        """One lockstep decode over all active sequences."""
        self._admit()
        if not self.active:
            return 0
        batch = self.active[:self.max_batch]
        # residency: fault spilled pages back in before dispatch
        waiting = [q.req_id for q in self.queue
                   if q.req_id in self.kv.seq_spaces]
        for r in batch:
            n = self.kv.ensure_resident(r.req_id, spill_candidates=waiting)
            self.stats.fault_page_ins += n
        # accumulate deltas from the shared PagingStats (the pager keeps
        # the source of truth; EngineStats no longer aliases it); a
        # negative delta means someone reset() the shared stats — the
        # post-reset total IS the delta then
        kv = self.kv.stats
        d_us = kv.simulated_us - self._kv_us_seen
        self.stats.simulated_fault_us += d_us if d_us >= 0 \
            else kv.simulated_us
        self._kv_us_seen = kv.simulated_us
        d_sp = kv.spills - self._kv_spills_seen
        self.stats.spill_events += d_sp if d_sp >= 0 else kv.spills
        self._kv_spills_seen = kv.spills

        tokens = np.zeros((self.max_batch, 1), np.int64)
        for i, r in enumerate(batch):
            last = r.generated[-1] if r.generated else r.prompt[-1]
            tokens[i, 0] = last
        cache = dict(self.cache, lengths=self._copy_in(batch))
        logits, cache = self.model.decode_step(
            self.params, self.cfg, cache,
            torch.from_numpy(tokens).to(self.device))
        self.stats.decode_steps += 1
        gen = None
        if self.sampler.temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.stats.decode_steps)
        next_tokens = sample_token(logits[:, 0] if logits.dim() == 3
                                   else logits, self.sampler, gen).tolist()
        # scatter results + updated caches back per sequence
        for i, r in enumerate(batch):
            r.generated.append(int(next_tokens[i]))
            self.kv.append_tokens(r.req_id, 1)
            self.stats.tokens_generated += 1
            self._copy_out(i, r, cache)
            if len(r.generated) >= r.max_new_tokens:
                r.done = True
        finished = [r for r in batch if r.done]
        for r in finished:
            self.active.remove(r)
            self.kv.free_sequence(r.req_id)
            self._seq_caches.pop(r.req_id, None)
        return len(batch)

    def run_until_done(self, max_steps: int = 10_000) -> None:
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            if self.step_decode() == 0:
                break
            steps += 1
