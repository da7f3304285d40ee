"""Training loop: remat, microbatch accumulation, checkpoint/restart.

``make_train_step`` builds the step the :class:`Trainer` runs: loss and
gradients by autograd (on the GPU the attention gradient comes from the
hand-written backward kernels), microbatch gradients accumulated in f32,
then AdamW.  PyTorch runs eagerly, so there is no ``jit``; parameters and
optimizer state are updated in place (see ``optim.adamw``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_for
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1           # gradient-accumulation factor
    remat: bool = True              # checkpoint every layer
    q_chunk: int = 512
    kv_chunk: int = 512
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    model = model_for(cfg)

    def loss(params, tokens, labels, *extra):
        kw = {"remat": tcfg.remat}
        if cfg.family in ("dense", "moe", "mla_moe"):
            kw.update(q_chunk=tcfg.q_chunk, kv_chunk=tcfg.kv_chunk)
        if cfg.is_encdec and extra:
            kw["frame_embeddings"] = extra[0]
        return model.loss_fn(params, cfg, tokens, labels, **kw)

    return loss


def value_and_grad(loss_fn, params, *args):
    """(loss, grads) of ``loss_fn(params, *args)`` with respect to every
    leaf of ``params``; the params themselves are not marked as requiring
    grad (detached views are), so they can be updated in place after."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """(params, opt_state, tokens, labels) -> (params, opt_state, metrics).

    tokens/labels: (global_batch, seq).  With ``microbatches = m`` the
    batch is split on axis 0 and gradients accumulate in fp32, then are
    divided by m.
    """
    loss_fn = make_loss_fn(cfg, tcfg)

    def step(params, opt_state: AdamWState, tokens, labels, *extra):
        m = tcfg.microbatches
        if m == 1:
            l, grads = value_and_grad(loss_fn, params, tokens, labels, *extra)
        else:
            B = tokens.shape[0]
            split = lambda a: a.reshape(m, B // m, *a.shape[1:])  # noqa: E731
            xs = (split(tokens), split(labels)) + tuple(
                split(e) for e in extra)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = 0.0
            for i in range(m):
                l, g = value_and_grad(loss_fn, params, *(x[i] for x in xs))
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b)
                del g
                lsum = lsum + l
            for a in tree_leaves(grads):
                a.div_(m)
            l = lsum / m
        params, opt_state, metrics = adamw.update(tcfg.optimizer, opt_state,
                                                  params, grads)
        metrics["loss"] = l
        return params, opt_state, metrics

    return step


class Trainer:
    """Host-side loop: data, step, periodic checkpoint, metrics.

    ``device=None`` is the GPU (and raises without one); the parameters
    must already live on that device.
    """

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, params,
                 dataset, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 checkpointer: Optional[Any] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        where = {p.device for p in tree_leaves(params)}
        if where != {self.device}:
            raise ValueError(f"params live on {sorted(map(str, where))}, "
                             f"the trainer runs on {self.device}")
        self.cfg = cfg
        self.tcfg = tcfg
        self.params = params
        self.opt_state = adamw.init(tcfg.optimizer, params)
        self.dataset = dataset
        self.step_fn = make_train_step(cfg, tcfg)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.checkpointer = checkpointer
        self.step = 0
        self.history: list[dict] = []

    def restore(self) -> bool:
        """Restore the latest checkpoint into this trainer's own params and
        optimizer state (in place)."""
        if self.checkpointer is None or self.checkpoint_dir is None:
            return False
        restored = self.checkpointer.restore_latest(
            self.checkpoint_dir, self.params, self.opt_state)
        if restored is None:
            return False
        self.params, self.opt_state, self.step = restored
        return True

    def _batch(self, step: int):
        tokens, labels = self.dataset.batch_at(step)
        return (torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(labels).to(self.device))

    def run(self, n_steps: int, log_every: int = 10,
            log_fn: Callable[[str], None] = print) -> list[dict]:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            tokens, labels = self._batch(self.step)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, tokens, labels)
            self.step += 1
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = self.step
            self.history.append(rec)
            if log_every and self.step % log_every == 0:
                dt = time.perf_counter() - t0
                log_fn(f"step {self.step:5d}  loss {rec['loss']:.4f}  "
                       f"gnorm {rec['grad_norm']:.3f}  "
                       f"{dt / log_every:.2f}s/step")
                t0 = time.perf_counter()
            if (self.checkpointer is not None and self.checkpoint_every
                    and self.step % self.checkpoint_every == 0):
                self.checkpointer.save(self.checkpoint_dir, self.params,
                                       self.opt_state, self.step)
        return self.history
