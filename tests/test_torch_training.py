"""Port vs reference, training path: ``forward`` / ``prefill`` / ``loss_fn``
and their gradients, AdamW and the schedules, the ``Trainer`` loss curve,
``PagedAdamW`` and checkpoints across the two packages.

Weights come from the reference's ``init_params`` (or numpy) and are
carried into the port with ``from_jax_params``; data comes from the
reference's ``SyntheticLM`` and its verbatim copy in the port.  The port
runs on the CPU, where attention takes the plain chunked version.
Tolerances: f32 values 2e-5, f32 gradients and multi-step losses 1e-4
(sum order differs and compounds through the layers and the steps), logits
after two layers 1e-4, bf16 2e-2; counters exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.distributed.checkpoint import Checkpointer as JaxCheckpointer
from repro.memory.offload import PagedAdamW as JaxPagedAdamW
from repro.models import decoder as jax_decoder
from repro.models.config import reduced as jax_reduced
from repro.models.losses import masked_xent as jax_masked_xent
from repro.optim import adamw as jax_adamw
from repro.optim import schedules as jax_schedules
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer

from repro_torch.compat import from_jax_params
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.launch import train as train_launcher
from repro_torch.memory.offload import PagedAdamW
from repro_torch.models import decoder as t_decoder
from repro_torch.models.config import reduced
from repro_torch.models.losses import masked_xent
from repro_torch.models.registry import model_for
from repro_torch.optim import adamw
from repro_torch.optim import schedules
from repro_torch.training.trainer import (TrainConfig, Trainer,
                                          make_loss_fn, value_and_grad)
from repro_torch.tree import tree_leaves, tree_names

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(arch, **kw):
    return jax_reduced(jax_get_config(arch), **kw), \
        reduced(get_config(arch), **kw)


def _jax_leaves(tree):
    """Leaves with their "a/b/c" names, in sorted-key order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(l, np.float32)
            for path, l in flat}


def _port_leaves(tree):
    return {n: l.detach().float().numpy()
            for n, l in zip(tree_names(tree), tree_leaves(tree))}


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1                         # a masked span
    return tokens, labels


# --------------------------------------------------------------- the model
class TestForward:
    @pytest.mark.parametrize("arch,kw,S", [
        ("qwen3_14b", {}, 12),
        ("h2o_danube_1_8b", {"sliding_window": 8}, 20),   # window < S
    ])
    def test_forward_logits_and_prefill_kv(self, arch, kw, S):
        jcfg, cfg = _configs(arch, **kw)
        jparams = jax_decoder.init_params(jcfg, jax.random.PRNGKey(0))
        params = from_jax_params(_np_tree(jparams), "cpu")
        tokens, _ = _tokens(cfg, 2, S, 1)
        jlogits, _, jkv = jax_decoder.prefill(jparams, jcfg,
                                              jnp.asarray(tokens))
        logits, aux, kv = t_decoder.prefill(params, cfg,
                                            torch.from_numpy(tokens))
        assert aux == 0.0
        assert tuple(logits.shape) == (2, S, cfg.vocab_size)
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), atol=1e-4, rtol=1e-4)
        for got, want in zip(kv["dense_layers"], jkv["dense_layers"]):
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), atol=1e-4,
                                       rtol=1e-4)
        fwd, _ = t_decoder.forward(params, cfg, torch.from_numpy(tokens))
        np.testing.assert_array_equal(fwd.detach().numpy(),
                                      logits.detach().numpy())

    @pytest.mark.parametrize("arch", ["qwen3_14b", "h2o_danube_1_8b",
                                      "mixtral_8x7b", "deepseek_v3_671b",
                                      "zamba2_7b"])
    def test_decode_matches_forward(self, arch):
        """Twin of ``tests/test_models.py::TestDecodeConsistency`` for the
        port: token-by-token ``decode_step`` == teacher-forced ``forward``
        (same tolerance as the reference's test), through the family's
        module as the registry names it."""
        cfg = reduced(get_config(arch))
        m = model_for(cfg)
        params = m.init_params(cfg, 3, device="cpu")
        B, S = 2, 12
        tokens = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, S)))
        logits_tf, _ = m.forward(params, cfg, tokens)
        cache = m.init_decode_cache(cfg, B, 32, device="cpu")
        outs = []
        for t in range(S):
            lg, cache = m.decode_step(params, cfg, cache, tokens[:, t:t + 1])
            outs.append(lg.reshape(B, -1))
        np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                                   logits_tf.detach().numpy(), atol=2e-3,
                                   rtol=2e-2)

    def test_registry_exposes_the_training_surface(self):
        m = model_for(reduced(get_config("qwen3_14b")))
        assert m.forward is t_decoder.forward
        assert m.loss_fn is t_decoder.loss_fn


class TestLoss:
    def test_masked_xent(self):
        rng = np.random.default_rng(2)
        logits = (rng.standard_normal((2, 7, 50)) * 4).astype(np.float32)
        labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
        labels[1, 2:5] = -1
        want = jax_masked_xent(jnp.asarray(logits), jnp.asarray(labels))
        got = masked_xent(torch.from_numpy(logits), torch.from_numpy(labels))
        np.testing.assert_allclose(float(got), float(want), **F32)
        all_masked = masked_xent(torch.from_numpy(logits),
                                 torch.full((2, 7), -1, dtype=torch.int32))
        assert float(all_masked) == 0.0

    @pytest.mark.parametrize("remat", [False, True])
    def test_loss_and_all_grads_match_reference(self, remat):
        jcfg, cfg = _configs("qwen3_14b")
        jparams = jax_decoder.init_params(jcfg, jax.random.PRNGKey(1))
        params = from_jax_params(_np_tree(jparams), "cpu")
        tokens, labels = _tokens(cfg, 2, 16, 3)
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: jax_decoder.loss_fn(p, jcfg, jnp.asarray(tokens),
                                          jnp.asarray(labels),
                                          remat=remat)))(jparams)
        loss = make_loss_fn(cfg, TrainConfig(remat=remat))
        tl, tg = value_and_grad(loss, params, torch.from_numpy(tokens),
                                torch.from_numpy(labels))
        np.testing.assert_allclose(float(tl), float(jl), **F32)
        want, got = _jax_leaves(jg), _port_leaves(tg)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], **GRAD,
                                       err_msg=name)
        # the params themselves are left untouched by autograd
        assert all(not p.requires_grad for p in tree_leaves(params))


# --------------------------------------------------------------- optimizer
class TestAdamW:
    @pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
    def test_update_matches_reference(self, moment_dtype):
        """Clipping active (grad norm above 0.5), weight decay, a cosine
        schedule; three steps.  bf16 moments round after every step in both
        packages: 2e-2 then."""
        rng = np.random.default_rng(4)
        params = {"a": rng.standard_normal((33, 7)).astype(np.float32),
                  "n": {"b": np.ones((11,), np.float32)}}
        grads = [{"a": rng.standard_normal((33, 7)).astype(np.float32),
                  "n": {"b": np.full((11,), 0.5, np.float32)}}
                 for _ in range(3)]
        kw = dict(lr=1e-2, grad_clip=0.5, weight_decay=0.01,
                  moment_dtype=moment_dtype)
        jcfg = jax_adamw.AdamWConfig(
            schedule=jax_schedules.cosine_with_warmup(1e-2, 2, 5), **kw)
        cfg = adamw.AdamWConfig(
            schedule=schedules.cosine_with_warmup(1e-2, 2, 5), **kw)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jstate = jax_adamw.init(jcfg, jp)
        tp = from_jax_params(params, "cpu")
        state = adamw.init(cfg, tp)
        assert state.mu["a"].dtype == (torch.bfloat16 if moment_dtype ==
                                       "bfloat16" else torch.float32)
        tol = F32 if moment_dtype == "float32" else dict(atol=2e-2,
                                                         rtol=2e-2)
        for g in grads:
            jp, jstate, jm = jax_adamw.update(
                jcfg, jstate, jp, jax.tree_util.tree_map(jnp.asarray, g))
            tp2, state, m = adamw.update(cfg, state, tp,
                                         from_jax_params(g, "cpu"))
            assert tp2 is tp                     # in place
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), **F32)
            np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                       **F32)
            assert int(state.step) == int(jstate.step)
            for got, want in ((tp, jp), (state.mu, jstate.mu),
                              (state.nu, jstate.nu)):
                want, got = _jax_leaves(want), _port_leaves(got)
                for name in want:
                    np.testing.assert_allclose(got[name], want[name], **tol)

    def test_chunked_update_equals_whole_leaf(self, monkeypatch):
        cfg = adamw.AdamWConfig(lr=1e-2)
        rng = np.random.default_rng(5)
        p = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
        outs = []
        for chunk in (1 << 24, 64):
            monkeypatch.setattr(adamw, "CHUNK_ELEMS", chunk)
            params = {"w": p.clone()}
            state = adamw.init(cfg, params)
            adamw.update(cfg, state, params, {"w": g})
            outs.append(params["w"])
        assert torch.equal(outs[0], outs[1])

    def test_schedules(self):
        f = schedules.cosine_with_warmup(3e-3, 20, 100)
        jf = jax_schedules.cosine_with_warmup(3e-3, 20, 100)
        for s in (0, 1, 10, 19, 20, 21, 50, 99, 100, 150):
            np.testing.assert_allclose(float(f(s)),
                                       float(jf(jnp.asarray(s, jnp.int32))),
                                       rtol=1e-6)
            assert float(f(torch.tensor(s, dtype=torch.int32))) == \
                float(f(s))
        assert float(schedules.constant(0.25)(7)) == 0.25


# ----------------------------------------------------------------- trainer
def _jax_and_port_trainers(arch="qwen3_14b", microbatches=2, steps_seed=0):
    jcfg, cfg = _configs(arch, n_layers=2)
    jparams = jax_decoder.init_params(jcfg, jax.random.PRNGKey(steps_seed))
    params = from_jax_params(_np_tree(jparams), "cpu")
    jtcfg = JaxTrainConfig(microbatches=microbatches, optimizer=jax_adamw
                           .AdamWConfig(lr=1e-2, schedule=jax_schedules
                                        .cosine_with_warmup(1e-2, 2, 5)))
    tcfg = TrainConfig(microbatches=microbatches, optimizer=adamw.AdamWConfig(
        lr=1e-2, schedule=schedules.cosine_with_warmup(1e-2, 2, 5)))
    jtr = JaxTrainer(jcfg, jtcfg, jparams, JaxSyntheticLM(jcfg.vocab_size,
                                                          16, 4))
    tr = Trainer(cfg, tcfg, params, SyntheticLM(cfg.vocab_size, 16, 4),
                 device="cpu")
    return jtr, tr


class TestTrainer:
    def test_five_step_loss_curve_matches_reference(self):
        jtr, tr = _jax_and_port_trainers()
        jtr.run(5, log_every=0)
        logs = []
        tr.run(5, log_every=5, log_fn=logs.append)
        assert [r["step"] for r in tr.history] == [1, 2, 3, 4, 5]
        assert logs and logs[0].startswith("step     5  loss ")
        for got, want in zip(tr.history, jtr.history):
            assert set(got) == set(want) == {"loss", "grad_norm", "lr",
                                             "step"}
            for key in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[key], want[key], **GRAD)
        assert tr.history[-1]["loss"] < tr.history[0]["loss"]

    def test_restart_resumes_identically(self, tmp_path):
        """Twin of ``tests/test_runtime.py::TestTrainerCheckpointRestart``
        on the port: stop at step 4, restore into a trainer built from other
        weights, run 2 more == 6 uninterrupted steps."""
        cfg = reduced(get_config("starcoder2_3b"), n_layers=2)
        ds = SyntheticLM(cfg.vocab_size, 16, 4)
        tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3))
        ck = Checkpointer()
        tr = Trainer(cfg, tcfg, t_decoder.init_params(cfg, 0, device="cpu"),
                     ds, checkpoint_dir=str(tmp_path), checkpoint_every=2,
                     checkpointer=ck, device="cpu")
        tr.run(4, log_every=0)
        tr2 = Trainer(cfg, tcfg, t_decoder.init_params(cfg, 9, device="cpu"),
                      ds, checkpoint_dir=str(tmp_path), checkpointer=ck,
                      device="cpu")
        assert tr2.restore() and tr2.step == 4
        tr2.run(2, log_every=0)
        tr3 = Trainer(cfg, tcfg, t_decoder.init_params(cfg, 0, device="cpu"),
                      ds, device="cpu")
        tr3.run(6, log_every=0)
        assert tr2.history[-1]["loss"] == pytest.approx(
            tr3.history[-1]["loss"], rel=1e-6)

    def test_device_default_is_the_gpu(self):
        cfg = reduced(get_config("qwen3_14b"))
        params = t_decoder.init_params(cfg, 0, device="cpu")
        ds = SyntheticLM(cfg.vocab_size, 8, 2)
        if torch.cuda.is_available():
            with pytest.raises(ValueError, match="live on"):
                Trainer(cfg, TrainConfig(), params, ds)
            return
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, TrainConfig(), params, ds)
        with pytest.raises(RuntimeError, match="CUDA"):
            train_launcher.main(["--steps", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            PagedAdamW(adamw.AdamWConfig(), params)

    def test_launcher_on_the_cpu(self, capsys):
        hist = train_launcher.main(["--device", "cpu", "--steps", "3",
                                    "--batch", "2", "--seq", "16",
                                    "--microbatches", "2"])
        assert len(hist) == 3 and all(np.isfinite(r["loss"]) for r in hist)
        assert "final loss" in capsys.readouterr().out


# -------------------------------------------------------------- PagedAdamW
class TestPagedAdamW:
    def test_matches_reference_and_its_paging(self):
        """Twin of ``tests/test_runtime.py::TestOffloadedOptimizer``: three
        updates agree with the reference's ``PagedAdamW`` (and with plain
        AdamW), and the pager's counters are identical."""
        cfg_kw = dict(lr=1e-2, grad_clip=0.0, weight_decay=0.01)
        rng = np.random.default_rng(0)
        params = {"a": rng.standard_normal((33, 7)).astype(np.float32),
                  "b": np.ones((11,), np.float32)}
        grads = {"a": rng.standard_normal((33, 7)).astype(np.float32),
                 "b": np.full((11,), 0.5, np.float32)}
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jg = jax.tree_util.tree_map(jnp.asarray, grads)
        jpo = JaxPagedAdamW(jax_adamw.AdamWConfig(**cfg_kw), jp,
                            block_elems=64)
        po = PagedAdamW(adamw.AdamWConfig(**cfg_kw),
                        from_jax_params(params, "cpu"), block_elems=64,
                        device="cpu")
        tp, tg = from_jax_params(params, "cpu"), from_jax_params(grads, "cpu")
        plain = from_jax_params(params, "cpu")
        state = adamw.init(adamw.AdamWConfig(**cfg_kw), plain)
        for _ in range(3):
            jp = jpo.update(jp, jg)
            tp = po.update(tp, tg)
            adamw.update(adamw.AdamWConfig(**cfg_kw), state, plain, tg)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-5)
            np.testing.assert_allclose(tp[k].numpy(), plain[k].numpy(),
                                       atol=1e-5)
        np.testing.assert_allclose(po.mu_host, jpo.mu_host, atol=1e-6)
        np.testing.assert_allclose(po.nu_host, jpo.nu_host, atol=1e-6)
        assert po.stats.prefetch_overlapped > 0
        assert dataclasses.asdict(po.stats) == dataclasses.asdict(jpo.stats)

    def test_device_residency_bounded(self):
        po = PagedAdamW(adamw.AdamWConfig(),
                        {"w": torch.zeros((1 << 16,))}, block_elems=1 << 10,
                        device="cpu")
        assert po.device_bytes_resident() == 2 * (1 << 10) * 8
        assert po.device_bytes_resident() < 2 * 4 * (1 << 16) // 8


# ------------------------------------------------------------- checkpoints
def _ckpt_state(dtype):
    """Params and AdamW state in both packages, same numbers, ``dtype``
    params and moments (the int32 step too)."""
    rng = np.random.default_rng(11)
    params = {"dense": {"w": rng.standard_normal((4, 6)).astype(np.float32)},
              "embed": rng.standard_normal((5, 3)).astype(np.float32)}
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), params)
    jcfg = jax_adamw.AdamWConfig(moment_dtype=dtype)
    jstate = jax_adamw.init(jcfg, jp)
    jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a * 0.1, jd), params)
    jp, jstate, _ = jax_adamw.update(jcfg, jstate, jp, jg)
    tp = from_jax_params(_np_tree(jp), "cpu")
    state = adamw.AdamWState(
        step=torch.tensor(int(jstate.step), dtype=torch.int32),
        mu=from_jax_params(_np_tree(jstate.mu), "cpu"),
        nu=from_jax_params(_np_tree(jstate.nu), "cpu"))
    return jp, jstate, tp, state


def _port_blank(tp, state):
    zeros = lambda t: torch.zeros_like(t) + 7        # noqa: E731
    return ({k: (dict((kk, zeros(vv)) for kk, vv in v.items())
                 if isinstance(v, dict) else zeros(v))
             for k, v in tp.items()},
            adamw.AdamWState(torch.zeros((), dtype=torch.int32),
                             {k: (dict((kk, zeros(vv)) for kk, vv in
                                       v.items()) if isinstance(v, dict)
                                  else zeros(v))
                              for k, v in state.mu.items()},
                             {k: (dict((kk, zeros(vv)) for kk, vv in
                                       v.items()) if isinstance(v, dict)
                                  else zeros(v))
                              for k, v in state.nu.items()}))


class TestCheckpointAcrossPackages:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_port_writes_reference_restores(self, tmp_path, dtype):
        jp, jstate, tp, state = _ckpt_state(dtype)
        Checkpointer().save(str(tmp_path), tp, state, 3)
        like_p = jax.tree_util.tree_map(jnp.zeros_like, jp)
        like_s = jax_adamw.init(jax_adamw.AdamWConfig(moment_dtype=dtype),
                                like_p)
        rp, rs, step = JaxCheckpointer().restore_latest(str(tmp_path),
                                                        like_p, like_s)
        assert step == 3 and int(rs.step) == int(jstate.step)
        for got, want in ((rp, jp), (rs.mu, jstate.mu), (rs.nu, jstate.nu)):
            for a, b in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(want)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(np.asarray(a, np.float32),
                                              np.asarray(b, np.float32))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_reference_writes_port_restores(self, tmp_path, dtype):
        """The reference stores a bf16 leaf as raw 2-byte records (which
        its own restore cannot read back); the port reads them by bits."""
        jp, jstate, tp, state = _ckpt_state(dtype)
        JaxCheckpointer().save(str(tmp_path), jp, jstate, 5)
        like_p, like_s = _port_blank(tp, state)
        rp, rs, step = Checkpointer().restore_latest(str(tmp_path), like_p,
                                                     like_s)
        assert step == 5 and rp is like_p            # in place
        assert int(rs.step) == int(state.step)
        for got, want in ((rp, tp), (rs.mu, state.mu), (rs.nu, state.nu)):
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                assert a.dtype == b.dtype
                assert torch.equal(a, b)

    def test_layout_and_gc(self, tmp_path):
        _, _, tp, state = _ckpt_state("bfloat16")
        ck = Checkpointer()
        for s in range(1, 6):
            ck.save(str(tmp_path), tp, state, s)
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "step_00000003", "step_00000004", "step_00000005"]
        d = tmp_path / "step_00000005"
        assert sorted(p.name for p in d.iterdir()) == ["manifest.json",
                                                       "shard_h000.npz"]
        z = np.load(d / "shard_h000.npz")
        assert "params::dense::w" in z and "opt::mu::embed" in z
        assert z["params::embed"].dtype == np.float32      # bf16 as f32
        import json
        man = json.loads((d / "manifest.json").read_text())
        names = [l["name"] for l in man["leaves"]]
        assert names == sorted(names) and "opt/step" in names
        assert {l["dtype"] for l in man["leaves"]} == {"bfloat16", "int32"}
