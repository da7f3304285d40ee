"""Port vs reference, the xLSTM family (xLSTM-125M) served and trained:
the engine's greedy tokens against a direct decode loop, the trainer and
the launchers, on the CPU; and the reference engine's xLSTM fault, held as
a divergence on purpose.  The cells and the model are in
``tests/test_torch_xlstm.py``, whose helpers this file shares; the two
files run on two workers.

Tolerances as there: whole models 1e-4 (``GRAD``); integer outputs exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import xlstm_model as jax_model
from repro.optim import adamw as jax_adamw
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.sampler import SamplerConfig as JaxSamplerConfig
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import xlstm_model as t_model
from repro_torch.optim import adamw
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training.trainer import TrainConfig, Trainer
from repro_torch.tree import tree_leaves, tree_names

from test_torch_xlstm import ARCH, GRAD, LAYOUTS, _configs, _models


# ------------------------------------------------------------- the engine
PROMPTS = (5, 9, 3, 12, 7, 4)      # prompt lengths; more requests than slots
MAX_NEW = 6


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPTS]


def _direct_tokens(cfg, params, prompt, max_new):
    """Greedy tokens of one request by a direct ``decode_step`` loop, under
    the engine's feeding rule: every prompt token, then ``prompt[-1]``
    again, then each generated token."""
    cache = t_model.init_decode_cache(cfg, 1, device="cpu")
    for t in prompt:
        _, cache = t_model.decode_step(params, cfg, cache,
                                       torch.tensor([[int(t)]]))
    tok, out = int(prompt[-1]), []
    for _ in range(max_new):
        logits, cache = t_model.decode_step(params, cfg, cache,
                                            torch.tensor([[tok]]))
        tok = int(logits[0, 0].argmax())
        out.append(tok)
    return out


class TestEngine:
    @pytest.mark.parametrize("max_batch", [1, 4])
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_engine_tokens_equal_a_direct_decode_loop(self, layout,
                                                      max_batch):
        """The port's engine, unchanged, serves xLSTM: six greedy requests
        (more than the slots at ``max_batch`` 4, so slots are reused) give
        each request the tokens of its own direct decode loop, in f32."""
        _, cfg, _, params = _models(layout)
        prompts = _prompts(cfg.vocab_size)
        eng = ServingEngine(cfg, params, max_batch=max_batch, max_len=32,
                            sampler=SamplerConfig(temperature=0.0),
                            device="cpu")
        reqs = [eng.submit(p, MAX_NEW) for p in prompts]
        eng.run_until_done()
        assert all(r.done for r in reqs)
        for r, p in zip(reqs, prompts):
            assert r.generated == _direct_tokens(cfg, params, p, MAX_NEW), \
                r.req_id

    def test_copy_in_and_out_move_whole_sequences(self):
        """``_copy_in`` puts each sequence's whole state (mLSTM ``(L_seg,
        1, ...)``, sLSTM ``(1, 1, d)``) into its batch slot; ``_copy_out``
        brings slot i back, lengths advanced by one."""
        cfg = _configs(**LAYOUTS["six_layers"])[1]
        params = t_model.init_params(cfg, 0, device="cpu")
        eng = ServingEngine(cfg, params, max_batch=2, device="cpu")
        reqs = [eng.submit(np.arange(3, dtype=np.int32) + i, 2)
                for i in range(2)]
        gen = torch.Generator().manual_seed(0)
        seqs = []
        for r in reqs:
            c = t_model.init_decode_cache(cfg, 1, device="cpu")
            for leaf in tree_leaves(c):
                if leaf.is_floating_point():
                    leaf.copy_(torch.randn(leaf.shape, generator=gen))
            c["lengths"] += 5 + r.req_id
            eng._seq_caches[r.req_id] = c
            seqs.append({n: l.clone() for n, l in
                         zip(tree_names(c), tree_leaves(c))})
        assert eng._copy_in(reqs).tolist() == [6, 7]
        full = dict(zip(tree_names(eng.cache), tree_leaves(eng.cache)))
        for i, want in enumerate(seqs):
            for name, leaf in full.items():
                if name != "lengths":
                    assert torch.equal(leaf[:, i], want[name][:, 0]), name
        full["seg3/c"][:, 1].add_(1.0)
        eng._copy_out(1, reqs[1], eng.cache)
        back = dict(zip(tree_names(eng._seq_caches[reqs[1].req_id]),
                        tree_leaves(eng._seq_caches[reqs[1].req_id])))
        assert back["lengths"].tolist() == [8]
        assert torch.equal(back["seg3/c"], seqs[1]["seg3/c"] + 1.0)
        assert torch.equal(back["seg0/C"], seqs[1]["seg0/C"])


class TestReferenceEngineFault:
    """The reference engine's xLSTM fault, held as a divergence on purpose
    (the reference unmodified): its copy rule puts the batch on axis 1 of
    every state leaf, and its sLSTM state is ``(B, d)``.  At ``max_batch``
    2 the copy-out raises ``ValueError``; at 1 it copies only column 0 of
    each sLSTM leaf, so its greedy tokens differ from its own direct decode
    loop.  The port's engine gives the loop's tokens
    (``TestEngine``)."""

    def _engine(self, jcfg, jparams, max_batch):
        eng = JaxServingEngine(jcfg, jparams, max_batch=max_batch,
                               max_len=32,
                               sampler=JaxSamplerConfig(temperature=0.0))
        prompts = _prompts(jcfg.vocab_size)[:2]
        return eng, [eng.submit(p, MAX_NEW) for p in prompts], prompts

    def test_batch_of_two_raises_and_batch_of_one_differs(self):
        jcfg, _, jparams, _ = _models("reduced")
        eng, _, _ = self._engine(jcfg, jparams, 2)
        with pytest.raises(ValueError, match="broadcast"):
            eng.run_until_done()
        eng, reqs, prompts = self._engine(jcfg, jparams, 1)
        eng.run_until_done()
        step = jax.jit(lambda p, c, t: jax_model.decode_step(p, jcfg, c, t))
        differ = []
        for r, prompt in zip(reqs, prompts):
            cache = jax_model.init_decode_cache(jcfg, 1, 32)
            for t in prompt:
                _, cache = step(jparams, cache, jnp.asarray([[t]], jnp.int32))
            tok, out = int(prompt[-1]), []
            for _ in range(MAX_NEW):
                logits, cache = step(jparams, cache,
                                     jnp.asarray([[tok]], jnp.int32))
                tok = int(jnp.argmax(logits[0, 0]))
                out.append(tok)
            differ.append(r.generated != out)
        assert all(differ)


# ------------------------------------------------- the trainer, launchers
class TestTrainerAndLaunchers:
    def test_three_step_loss_curve_matches_reference(self):
        """Twin of ``tests/test_runtime.py::TestTrainer`` for the six-layer
        reduced xLSTM: three steps of 2 microbatches with remat, loss, grad
        norm and lr within ``GRAD``."""
        jcfg, cfg, jparams, params = _models("six_layers")
        jtr = JaxTrainer(jcfg, JaxTrainConfig(
            microbatches=2, optimizer=jax_adamw.AdamWConfig(lr=1e-2)),
            jparams, JaxSyntheticLM(jcfg.vocab_size, 16, 4))
        tr = Trainer(cfg, TrainConfig(
            microbatches=2, optimizer=adamw.AdamWConfig(lr=1e-2)),
            params, SyntheticLM(cfg.vocab_size, 16, 4), device="cpu")
        jtr.run(3, log_every=0)
        tr.run(3, log_every=0)
        for got, want in zip(tr.history, jtr.history):
            assert set(got) == set(want)
            for key in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[key], want[key], **GRAD)
        assert tr.history[-1]["loss"] < tr.history[0]["loss"]

    def test_serve_on_the_cpu(self, capsys):
        t_serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "5",
                      "--max-new", "3", "--temperature", "0"])
        out = capsys.readouterr().out
        assert out.count("req ") == 5 and "tokens=15" in out

    def test_train_on_the_cpu(self, capsys):
        hist = t_train.main(["--device", "cpu", "--arch", ARCH, "--steps",
                             "3", "--batch", "2", "--seq", "16",
                             "--microbatches", "2"])
        assert len(hist) == 3 and all(np.isfinite(r["loss"]) for r in hist)
        assert "family=xlstm" in capsys.readouterr().out

    def test_need_a_gpu_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            t_serve.main(["--arch", ARCH, "--requests", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            t_train.main(["--arch", ARCH, "--steps", "1"])
