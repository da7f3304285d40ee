"""Port vs reference, the encoder-decoder family (Whisper-medium): the
encoder, the pinned cross-attention K/V, the whole reduced model (forward,
loss, every gradient), decode over an encoded cache, the trainer, the
serving engine and the launchers, on the CPU.

Weights come from the reference's ``init_params`` and are carried into the
port with ``from_jax_params``; inputs are made by numpy from a seed.
Tolerances: f32 values ``atol=rtol=2e-5`` (sums in another order); whole
models' gradients and logits through several layers 1e-4 (``GRAD``, as
the other families' twins hold them); integer outputs exact.  Where a test
states another bound it says why.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FaultPolicy as JaxFaultPolicy
from repro.api import Strategy as JaxStrategy
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import encdec as jax_encdec
from repro.models.config import reduced as jax_reduced
from repro.optim import adamw as jax_adamw
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer

from repro_torch.api import FaultPolicy, Strategy
from repro_torch.compat import from_jax_params
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import encdec as t_encdec
from repro_torch.models.config import reduced
from repro_torch.models.registry import model_for
from repro_torch.optim import adamw
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.trainer import (TrainConfig, Trainer,
                                          make_loss_fn, value_and_grad)
from repro_torch.tree import tree_leaves, tree_names, tree_unflatten

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
ARCH = "whisper_medium"

# the reduced model as reduced() makes it, and one whose decoder positions
# wrap inside the sequences below (pos % max_target_positions)
LAYOUTS = {"reduced": {}, "positions_wrap": {"max_target_positions": 8}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(**kw):
    return jax_reduced(jax_get_config(ARCH), **kw), \
        reduced(get_config(ARCH), **kw)


def _models(layout="reduced", seed=0, **kw):
    jcfg, cfg = _configs(**LAYOUTS[layout], **kw)
    jparams = jax_encdec.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, from_jax_params(_np_tree(jparams), "cpu")


def _jax_leaves(tree):
    """Leaves by their "a/b/c" names, in the reference's (sorted) order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in flat}


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


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.max_source_positions, cfg.d_model)).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------- the model
class TestEncDecModel:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_params_tree_like_the_reference(self, dtype):
        """``init_params`` gives the reference's tree (stacked encoder and
        decoder layers, leaf shapes and dtypes); ``from_jax_params``
        carries it across unchanged."""
        jcfg, cfg = _configs(dtype=dtype)
        jparams = jax_encdec.init_params(jcfg, jax.random.PRNGKey(0))
        params = t_encdec.init_params(cfg, 0, device="cpu")
        carried = from_jax_params(_np_tree(jparams), "cpu")
        jleaves = _jax_leaves(jparams)
        want = {n: (tuple(l.shape), l.dtype.name) for n, l in jleaves.items()}
        for tree in (params, carried):
            got = {n: (tuple(l.shape), str(l.dtype).split(".")[-1])
                   for n, l in zip(tree_names(tree), tree_leaves(tree))}
            assert got == want
        for n, got in zip(tree_names(carried), tree_leaves(carried)):
            np.testing.assert_array_equal(_np(got),
                                          jleaves[n].astype(np.float32))

    @pytest.mark.parametrize("remat", [False, True])
    def test_encode_matches_reference(self, remat):
        jcfg, cfg, jparams, params = _models(seed=1)
        frames = _frames(cfg, 2, 2)
        want = jax_encdec.encode(jparams, jcfg, jnp.asarray(frames),
                                 remat=remat)
        got = t_encdec.encode(params, cfg, torch.from_numpy(frames),
                              remat=remat)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)

    def test_cross_kv_matches_reference(self):
        """(L, B, T_src, H, hd) each, from the encoder's output."""
        jcfg, cfg, jparams, params = _models(seed=2)
        frames = _frames(cfg, 3, 3)
        jenc = jax_encdec.encode(jparams, jcfg, jnp.asarray(frames))
        enc = t_encdec.encode(params, cfg, torch.from_numpy(frames))
        jk, jv = jax_encdec.cross_kv(jparams, jcfg, jenc)
        k, v = t_encdec.cross_kv(params, cfg, enc)
        assert tuple(k.shape) == jk.shape == (
            cfg.n_layers, 3, cfg.max_source_positions, cfg.n_heads,
            cfg.head_dim)
        np.testing.assert_allclose(_np(k), np.asarray(jk), **F32)
        np.testing.assert_allclose(_np(v), np.asarray(jv), **F32)

    @pytest.mark.parametrize("frames", ["random", "none", "embeddings"])
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_forward_logits(self, layout, frames):
        """With random frame embeddings, without (zeros of
        ``max_source_positions``), and given as ``embeddings=`` (the
        reference's stand-in)."""
        jcfg, cfg, jparams, params = _models(layout)
        tokens, _ = _tokens(cfg, 2, 12, 1)
        f = _frames(cfg, 2, 4)
        jkw, kw = {}, {}
        if frames != "none":
            name = "frame_embeddings" if frames == "random" else "embeddings"
            jkw[name], kw[name] = jnp.asarray(f), torch.from_numpy(f)
        jlogits, jaux = jax_encdec.forward(jparams, jcfg,
                                           jnp.asarray(tokens), **jkw)
        logits, aux = t_encdec.forward(params, cfg, torch.from_numpy(tokens),
                                       **kw)
        assert aux == jaux == 0.0
        assert tuple(logits.shape) == (2, 12, cfg.vocab_size)
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **GRAD)

    @pytest.mark.parametrize("remat", [False, True])
    @pytest.mark.parametrize("frames", [True, False],
                             ids=["random_frames", "zero_frames"])
    def test_loss_and_all_grads_match_reference(self, frames, remat):
        """The trainer's loss (``make_loss_fn``, frames forwarded as its
        extra argument) and every leaf's gradient against ``jax.grad``."""
        jcfg, cfg, jparams, params = _models(seed=1)
        tokens, labels = _tokens(cfg, 2, 14, 3)
        f = _frames(cfg, 2, 5)
        jkw = {"frame_embeddings": jnp.asarray(f)} if frames else {}
        extra = (torch.from_numpy(f),) if frames else ()
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: jax_encdec.loss_fn(p, jcfg, jnp.asarray(tokens),
                                         jnp.asarray(labels), remat=remat,
                                         **jkw)))(jparams)
        loss = make_loss_fn(cfg, TrainConfig(remat=remat))
        tl, tg = value_and_grad(loss, params, torch.from_numpy(tokens),
                                torch.from_numpy(labels), *extra)
        np.testing.assert_allclose(float(tl), float(jl), **F32)
        want, got = _jax_leaves(jg), _port_leaves(tg)
        assert set(got) == set(want)
        for name in want:
            assert np.isfinite(got[name]).all(), name
            np.testing.assert_allclose(got[name], want[name], **GRAD,
                                       err_msg=name)


# ------------------------------------------------------------ decoding
def _encoded_caches(jcfg, cfg, jparams, params, B, max_len, seed):
    """Both packages' decode caches with cross K/V filled from
    ``cross_kv(encode(frames))`` of the same random frames."""
    f = _frames(cfg, B, seed)
    jk, jv = jax_encdec.cross_kv(jparams, jcfg, jax_encdec.encode(
        jparams, jcfg, jnp.asarray(f)))
    k, v = t_encdec.cross_kv(params, cfg, t_encdec.encode(
        params, cfg, torch.from_numpy(f)))
    jcache = dict(jax_encdec.init_decode_cache(jcfg, B, max_len),
                  cross_k=jk, cross_v=jv)
    cache = t_encdec.init_decode_cache(cfg, B, max_len, device="cpu")
    cache["cross_k"].copy_(k)
    cache["cross_v"].copy_(v)
    return f, jcache, cache


class TestDecode:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_decode_step_matches_reference_cache(self, layout):
        """Token by token over an encoded cache: each step's logits equal
        the reference's, and after the steps every cache leaf (lengths and
        page table exact; the paged pools and the pinned cross K/V)."""
        jcfg, cfg, jparams, params = _models(layout, seed=2)
        B, S = 2, 12
        tokens, _ = _tokens(cfg, B, S, 7)
        _, jcache, cache = _encoded_caches(jcfg, cfg, jparams, params, B, 32,
                                           8)
        step = jax.jit(lambda p, c, t: jax_encdec.decode_step(p, jcfg, c, t))
        for t in range(S):
            lg, cache = t_encdec.decode_step(
                params, cfg, cache, torch.from_numpy(tokens[:, t:t + 1]))
            jlg, jcache = step(jparams, jcache,
                               jnp.asarray(tokens[:, t:t + 1]))
            np.testing.assert_allclose(_np(lg), np.asarray(jlg), **GRAD)
        jleaves = _jax_leaves(jcache)
        assert tree_names(cache) == list(jleaves)
        for (name, want), got in zip(jleaves.items(), tree_leaves(cache)):
            assert tuple(got.shape) == want.shape, name
            assert str(got.dtype).split(".")[-1] == want.dtype.name, name
            if name in ("lengths", "page_table"):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                np.testing.assert_allclose(_np(got), np.asarray(want),
                                           **F32, err_msg=name)
        assert cache["lengths"].tolist() == [S] * B

    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_decode_matches_teacher_forced_forward(self, layout):
        """The reference's ``TestDecodeConsistency`` leaves Whisper out:
        token-by-token ``decode_step`` over the cross K/V of
        ``encode(frames)`` equals ``forward(tokens, frames)`` (its
        tolerance, atol 2e-3 / rtol 2e-2: paged against chunked
        attention), through wrapped decoder positions too."""
        jcfg, cfg, jparams, params = _models(layout, seed=3)
        B, S = 2, 12
        tokens, _ = _tokens(cfg, B, S, 9)
        f, _, cache = _encoded_caches(jcfg, cfg, jparams, params, B, 32, 10)
        logits_tf, _ = t_encdec.forward(params, cfg, torch.from_numpy(tokens),
                                        frame_embeddings=torch.from_numpy(f))
        outs = []
        for t in range(S):
            lg, cache = t_encdec.decode_step(
                params, cfg, cache, torch.from_numpy(tokens[:, t:t + 1]))
            outs.append(lg.reshape(B, -1))
        np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(logits_tf),
                                   atol=2e-3, rtol=2e-2)

    @pytest.mark.parametrize("t_src", [0, 7])
    def test_cache_layout(self, t_src):
        """The reference's layout: paged pools (L, P, page, KVH, hd), the
        identity page table, pinned cross K/V (L, B, T_src, H, hd) with
        T_src defaulting to ``max_source_positions``; ``dtype=`` applies to
        the pools and the cross K/V."""
        jcfg, cfg = _configs()
        c = t_encdec.init_decode_cache(cfg, 3, 40, dtype=torch.bfloat16,
                                       t_src=t_src, device="cpu")
        jc = jax_encdec.init_decode_cache(jcfg, 3, 40, dtype=jnp.bfloat16,
                                          t_src=t_src)
        jleaves = _jax_leaves(jc)
        assert tree_names(c) == list(jleaves)
        for name, got in zip(tree_names(c), tree_leaves(c)):
            assert tuple(got.shape) == jleaves[name].shape, name
            assert str(got.dtype).split(".")[-1] == \
                jleaves[name].dtype.name, name
        np.testing.assert_array_equal(c["page_table"].numpy(),
                                      np.asarray(jc["page_table"]))
        assert c["cross_k"].shape[2] == (t_src or cfg.max_source_positions)

    def test_published_cache_size(self):
        """``init_decode_cache(whisper_medium, 1, 448)`` on the meta device:
        paged self-attention KV 50,331,648 B (24 layers x 2 pages of 256 x
        16 heads x 64, K and V, bf16) against pinned cross K/V 147,456,000
        B (1,500 frames)."""
        cfg = get_config(ARCH)
        c = t_encdec.init_decode_cache(cfg, 1, 448, device="meta")
        nbytes = {n: l.numel() * l.element_size()
                  for n, l in zip(tree_names(c), tree_leaves(c))}
        assert nbytes["k_pool"] + nbytes["v_pool"] == 50_331_648
        assert nbytes["cross_k"] + nbytes["cross_v"] == 147_456_000

    def test_registry_and_device_rule(self):
        m = model_for(get_config(ARCH))
        for fn in ("init_params", "forward", "loss_fn", "init_decode_cache",
                   "decode_step"):
            assert getattr(m, fn) is getattr(t_encdec, fn)
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        cfg = reduced(get_config(ARCH))
        with pytest.raises(RuntimeError, match="CUDA"):
            t_encdec.init_params(cfg, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_encdec.init_decode_cache(cfg, 1, 32)


# --------------------------------------------------- TestArchSmoke twins
class TestArchSmoke:
    """Twins of ``tests/test_models.py::TestArchSmoke`` for
    ``whisper_medium`` on the port's own initialisation."""

    def _setup(self):
        cfg = reduced(get_config(ARCH))
        params = t_encdec.init_params(cfg, 0, device="cpu")
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        frames = torch.randn((2, cfg.max_source_positions, cfg.d_model),
                             generator=gen)
        return cfg, params, tokens, frames

    def test_forward_shapes_and_finite(self):
        cfg, params, tokens, frames = self._setup()
        logits, aux = model_for(cfg).forward(params, cfg, tokens,
                                             frame_embeddings=frames)
        assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())

    def test_train_step_reduces_loss_no_nans(self):
        cfg, params, tokens, frames = self._setup()
        labels = torch.roll(tokens, -1, dims=1)
        m = model_for(cfg)

        def loss(p):
            return m.loss_fn(p, cfg, tokens, labels, frame_embeddings=frames)

        l0, grads = value_and_grad(lambda p, *_: loss(p), params)
        assert bool(torch.isfinite(l0))
        gnorm = torch.sqrt(sum((g.float() ** 2).sum()
                               for g in tree_leaves(grads)))
        assert bool(torch.isfinite(gnorm))
        params2 = tree_unflatten(params, [
            (p.float() - 0.05 * g.float()).to(p.dtype)
            for p, g in zip(tree_leaves(params), tree_leaves(grads))])
        assert float(loss(params2)) < float(l0)


# ------------------------------------------------------- the engine
PROMPT_LENGTHS = (20, 5, 36, 18)       # pages of 16: 2, 1, 3 and 2 pages
MAX_NEW = 6
_SERVED = {}


def _serve_both(pool_frames):
    """The reference's and the port's ``ServingEngine`` on reduced
    Whisper, greedy, the same prompts (the engine never encodes: both
    decode over the zero cross K/V of ``init_decode_cache``)."""
    if pool_frames in _SERVED:
        return _SERVED[pool_frames]
    jcfg, cfg, jparams, params = _models()
    jeng = JaxServingEngine(
        jcfg, jparams, max_batch=2, max_len=64, pool_frames=pool_frames,
        policy=JaxFaultPolicy(JaxStrategy.TOUCH_AHEAD, lookahead=4))
    eng = ServingEngine(
        cfg, params, max_batch=2, max_len=64, pool_frames=pool_frames,
        policy=FaultPolicy(Strategy.TOUCH_AHEAD, lookahead=4), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENGTHS]
    out = []
    for e in (jeng, eng):
        reqs = [e.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        e.run_until_done()
        out.append((e, reqs))
    _SERVED[pool_frames] = out
    return out


class TestGreedyServingParity:
    @pytest.mark.parametrize("pool_frames", [None, 3],
                             ids=["exact_fit", "undersized"])
    def test_tokens_identical(self, pool_frames):
        (_, jreqs), (_, reqs) = _serve_both(pool_frames)
        assert all(r.done for r in reqs)
        assert [len(r.generated) for r in reqs] == [MAX_NEW] * 4
        assert [r.generated for r in reqs] == [r.generated for r in jreqs]

    @pytest.mark.parametrize("pool_frames", [None, 3],
                             ids=["exact_fit", "undersized"])
    def test_stats_equal(self, pool_frames):
        (jeng, _), (eng, _) = _serve_both(pool_frames)
        assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)
        assert dataclasses.asdict(eng.kv.stats) == \
            dataclasses.asdict(jeng.kv.stats)
        assert (eng.stats.spill_events > 0) == (pool_frames is not None)

    def test_spilling_changes_no_token(self):
        (_, fit), (_, small) = (_serve_both(pf)[1] for pf in (None, 3))
        assert [r.generated for r in fit] == [r.generated for r in small]

    def test_cross_kv_is_carried_by_batch_slot(self):
        """The engine's copy rule for a leaf that is neither a pool nor a
        table (batch on axis 1) moves each sequence's pinned cross K/V
        into its slot and back."""
        cfg = reduced(get_config(ARCH))
        params = t_encdec.init_params(cfg, 0, device="cpu")
        eng = ServingEngine(cfg, params, max_batch=2, max_len=32,
                            device="cpu")
        reqs = [eng.submit(np.arange(3, dtype=np.int32) + i, 2)
                for i in range(2)]
        gen = torch.Generator().manual_seed(0)
        for r in reqs:
            c = t_encdec.init_decode_cache(cfg, 1, 32, device="cpu")
            c["cross_k"].copy_(torch.randn(c["cross_k"].shape, generator=gen))
            c["cross_v"].copy_(torch.randn(c["cross_v"].shape, generator=gen))
            eng._seq_caches[r.req_id] = c
        eng._copy_in(reqs)
        for i, r in enumerate(reqs):
            seq = eng._seq_caches[r.req_id]
            for name in ("cross_k", "cross_v"):
                assert torch.equal(eng.cache[name][:, i], seq[name][:, 0])
        want = eng.cache["cross_v"][:, 1].clone() + 1.0
        eng.cache["cross_v"][:, 1].add_(1.0)
        eng._copy_out(1, reqs[1], eng.cache)
        assert torch.equal(eng._seq_caches[reqs[1].req_id]["cross_v"][:, 0],
                           want)


# ------------------------------------------------------------ the trainer
class TestEncDecTrainer:
    def test_three_step_loss_curve_matches_reference(self):
        """Twin of ``tests/test_runtime.py::TestTrainer`` for reduced
        Whisper (zero frames, as both trainers feed ``SyntheticLM``):
        three steps of 2 microbatches with remat, loss, grad norm and lr
        within ``GRAD``."""
        jcfg, cfg, jparams, params = _models()
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


class TestLaunchers:
    def test_serve_on_the_cpu(self, capsys):
        t_serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                      "--max-new", "3", "--max-len", "48", "--pool-frames",
                      "3", "--temperature", "0"])
        out = capsys.readouterr().out
        assert out.count("req ") == 3 and "tokens=9" in out

    def test_train_on_the_cpu(self, capsys):
        hist = t_train.main(["--device", "cpu", "--arch", ARCH, "--steps",
                             "3", "--batch", "2", "--seq", "16",
                             "--microbatches", "2"])
        assert len(hist) == 3 and all(np.isfinite(r["loss"]) for r in hist)
        assert "family=encdec" in capsys.readouterr().out

    def test_need_a_gpu_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            t_serve.main(["--arch", ARCH, "--requests", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            t_train.main(["--arch", ARCH, "--steps", "1"])
