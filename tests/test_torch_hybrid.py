"""Port vs reference, the hybrid family (Zamba2-7B): the Mamba2 block, the
whole reduced model (forward, loss, gradients, decode and its cache), the
trainer, the launchers and the engine's walk over the nested decode cache,
on the CPU.

Weights come from the reference's ``init_mamba`` / ``init_params`` and are
carried into the port with ``from_jax_params``; inputs are made by numpy.
Tolerances: f32 per module ``atol=rtol=2e-5`` (``tests/test_kernels.py::
_tol``); whole models 1e-4 for logits and gradients (``GRAD``: the sum
order differs and compounds through the layers); bf16 2e-2; integer
outputs exact.  Where a test states another bound it says why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import hybrid as jax_hybrid
from repro.models import mamba as jax_mamba
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.config import reduced as jax_reduced
from repro.optim import adamw as jax_adamw
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer

from repro_torch.compat import from_jax_params
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import hybrid as t_hybrid
from repro_torch.models import mamba as t_mamba
from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.registry import model_for
from repro_torch.optim import adamw
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.trainer import (TrainConfig, Trainer,
                                          make_loss_fn, value_and_grad)
from repro_torch.tree import tree_leaves, tree_names, tree_unflatten

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
ARCH = "zamba2_7b"

# the two layouts of the reduced model: one group and no tail, and
# reduced()'s own 5 layers in groups of 2 (2 groups and a 1-layer tail)
LAYOUTS = {"one_group": {"n_layers": 2}, "groups_and_tail": {}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(**kw):
    return jax_reduced(jax_get_config(ARCH), **kw), \
        reduced(get_config(ARCH), **kw)


def _models(layout, seed=0):
    jcfg, cfg = _configs(**LAYOUTS[layout])
    jparams = jax_hybrid.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, from_jax_params(_np_tree(jparams), "cpu")


def _jax_leaves(tree):
    """Leaves by their "a/b/c" names, in the reference's (sorted) order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
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


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------- the block
def _mamba_cfgs(d_model=32, state=8, head=8, dtype="float32"):
    """The reference's ``TestMamba`` config (d_model 32), or a wider one."""
    kw = dict(family="hybrid", d_model=d_model, n_layers=1, ssm_state=state,
              ssm_head_dim=head, ssm_expand=2, ssm_conv=4, dtype=dtype)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _mamba_params(jcfg, dtype=jnp.float32, seed=0):
    p = jax_mamba.init_mamba(jax.random.PRNGKey(seed), jcfg, dtype)
    return p, from_jax_params(_np_tree(p), "cpu")


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


class TestMamba:
    """Twins of ``tests/test_models.py::TestMamba`` on the port (same
    tolerances as the reference's own test), then the port against the
    reference function by function."""

    def test_chunked_matches_recurrence(self):
        _, cfg = _mamba_cfgs()
        _, p = _mamba_params(_mamba_cfgs()[0])
        x = torch.from_numpy(_x((2, 24, cfg.d_model), 1, 0.5))
        y_chunk = t_mamba.apply_mamba(p, cfg, x, chunk=8)
        y_ref = t_mamba.mamba_reference(p, cfg, x)
        np.testing.assert_allclose(_np(y_chunk), _np(y_ref), atol=1e-4,
                                   rtol=1e-3)

    def test_chunk_size_invariance(self):
        _, cfg = _mamba_cfgs()
        _, p = _mamba_params(_mamba_cfgs()[0])
        x = torch.from_numpy(_x((1, 32, cfg.d_model), 2))
        y8, y16, y32 = (_np(t_mamba.apply_mamba(p, cfg, x, chunk=c))
                        for c in (8, 16, 32))
        np.testing.assert_allclose(y8, y16, atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(y16, y32, atol=1e-4, rtol=1e-3)

    @pytest.mark.parametrize("S,chunk", [(24, 8), (40, 16), (37, 8),
                                         (20, 128)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_apply_mamba_matches_reference(self, S, chunk, dtype):
        """Padded (37 / 8, 40 / 16) and whole chunks, and one chunk
        shorter than ``chunk``."""
        jcfg, cfg = _mamba_cfgs(dtype=dtype)
        jp, p = _mamba_params(jcfg, getattr(jnp, dtype))
        x = _x((2, S, cfg.d_model), 3)
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        want = jax_mamba.apply_mamba(jp, jcfg, jx, chunk=chunk)
        got = t_mamba.apply_mamba(p, cfg, torch.from_numpy(x).to(
            getattr(torch, dtype)), chunk=chunk)
        assert str(got.dtype).endswith(dtype)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **(F32 if dtype == "float32" else BF16))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode_step_and_state_match_reference(self, dtype):
        """Five recurrent steps from a random state: the output and both
        state leaves (``ssm`` f32, ``conv`` in the cache dtype)."""
        jcfg, cfg = _mamba_cfgs(dtype=dtype)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        jp, p = _mamba_params(jcfg, jdt, seed=4)
        B = 3
        jst = jax_mamba.init_mamba_state(jcfg, B, dtype=jdt)
        st = t_mamba.init_mamba_state(cfg, B, dtype=tdt)
        jst = {"ssm": jnp.asarray(_x(jst["ssm"].shape, 5, 0.3)),
               "conv": jnp.asarray(_x(jst["conv"].shape, 6)).astype(jdt)}
        st = from_jax_params(_np_tree(jst), "cpu")
        tol = F32 if dtype == "float32" else BF16
        for t in range(5):
            x = _x((B, 1, cfg.d_model), 10 + t)
            jy, jst = jax_mamba.apply_mamba_decode(
                jp, jcfg, jnp.asarray(x).astype(jdt), jst)
            y, st = t_mamba.apply_mamba_decode(
                p, cfg, torch.from_numpy(x).to(tdt), st)
            assert y.dtype == tdt and st["conv"].dtype == tdt
            assert st["ssm"].dtype == torch.float32
            np.testing.assert_allclose(_np(y), np.asarray(jy, np.float32),
                                       **tol)
            for name in ("ssm", "conv"):
                np.testing.assert_allclose(
                    _np(st[name]), np.asarray(jst[name], np.float32), **tol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_init_state_and_params_like_the_reference(self, dtype):
        jcfg, cfg = _mamba_cfgs(dtype=dtype)
        jst = jax_mamba.init_mamba_state(jcfg, 2, dtype=getattr(jnp, dtype))
        st = t_mamba.init_mamba_state(cfg, 2, dtype=getattr(torch, dtype))
        assert tree_names(st) == sorted(jst)
        for name in jst:
            assert tuple(st[name].shape) == jst[name].shape
            assert str(st[name].dtype).split(".")[-1] == jst[name].dtype.name
            assert not st[name].any()
        assert t_mamba.mamba_dims(cfg) == jax_mamba.mamba_dims(jcfg)
        jp = jax_mamba.init_mamba(jax.random.PRNGKey(0), jcfg,
                                  getattr(jnp, dtype))
        p = t_mamba.init_mamba(torch.Generator().manual_seed(0), cfg,
                               getattr(torch, dtype))
        assert tree_names(p) == sorted(jp)
        for name in jp:
            assert tuple(p[name].shape) == jp[name].shape, name
            assert str(p[name].dtype).split(".")[-1] == jp[name].dtype.name
        for name in ("A_log", "D", "dt_bias", "norm_scale", "conv_b"):
            np.testing.assert_array_equal(_np(p[name]),
                                          np.asarray(jp[name], np.float32))


class TestMaskedExponent:
    """The port's one divergence from the reference's Mamba2 (module
    docstring of ``repro_torch.models.mamba``), at d_model 128, S 256 and
    the trainer's chunk of 128, unit-normal input: the upper triangle of
    the reference's intra-chunk decays overflows, so its gradients of
    ``in_proj``, ``A_log`` and ``dt_bias`` are not finite; the port's
    forward is the same function and its gradients are finite and agree
    with the recurrence's."""

    S, CHUNK = 256, 128
    NAN_LEAVES = ("A_log", "dt_bias", "in_proj")

    @pytest.fixture(scope="class")
    def case(self):
        jcfg, cfg = _mamba_cfgs(d_model=128, state=16, head=16)
        jp, p = _mamba_params(jcfg)
        x = _x((1, self.S, 128), 1)
        cot = _x((1, self.S, 128), 2)
        return jcfg, cfg, jp, p, x, cot

    def _port_grads(self, case, fn):
        _, _, _, p, x, cot = case
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
        y = fn(tree_unflatten(p, leaves), torch.from_numpy(x))
        grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                    leaves)
        return dict(zip(tree_names(p), (_np(g) for g in grads)))

    def _jax_grads(self, case, chunk):
        jcfg, _, jp, _, x, cot = case
        g = jax.grad(lambda q: jnp.sum(jax_mamba.apply_mamba(
            q, jcfg, jnp.asarray(x), chunk=chunk) * cot))(jp)
        return {k: np.asarray(v) for k, v in g.items()}

    def test_forward_equals_the_reference(self, case):
        jcfg, cfg, jp, p, x, _ = case
        want = jax_mamba.apply_mamba(jp, jcfg, jnp.asarray(x),
                                     chunk=self.CHUNK)
        got = t_mamba.apply_mamba(p, cfg, torch.from_numpy(x),
                                  chunk=self.CHUNK)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)

    def test_reference_gradients_are_not_finite(self, case):
        g = self._jax_grads(case, self.CHUNK)
        bad = sorted(k for k, v in g.items() if not np.isfinite(v).all())
        assert bad == sorted(self.NAN_LEAVES)

    def test_port_gradients_finite_and_match_the_recurrence(self, case):
        """Every leaf finite, within 1e-4 x max|ref| of the gradients of
        ``mamba_reference`` (the per-token recurrence, which has no
        exponent to mask)."""
        _, cfg, _, _, _, _ = case
        got = self._port_grads(case, lambda q, x: t_mamba.apply_mamba(
            q, cfg, x, chunk=self.CHUNK))
        want = self._port_grads(case, lambda q, x: t_mamba.mamba_reference(
            q, cfg, x))
        for name, g in got.items():
            assert np.isfinite(g).all(), name
            scale = np.abs(want[name]).max()
            assert np.abs(g - want[name]).max() <= 1e-4 * scale, name

    def test_short_chunks_match_the_reference_gradients(self, case):
        """At chunk 8 nothing overflows: the port's gradients equal the
        reference's, within 2e-5 x max|ref| per leaf (absolute) and 2e-5
        relative; gradients sum 256 positions of terms up to ~300 in
        another order, which an element-wise 2e-5 does not allow."""
        _, cfg, _, _, _, _ = case
        want = self._jax_grads(case, 8)
        got = self._port_grads(case, lambda q, x: t_mamba.apply_mamba(
            q, cfg, x, chunk=8))
        assert all(np.isfinite(v).all() for v in want.values())
        for name in want:
            np.testing.assert_allclose(
                got[name], want[name], rtol=2e-5,
                atol=2e-5 * np.abs(want[name]).max(), err_msg=name)


# --------------------------------------------------------------- the model
class TestHybridModel:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_params_tree_like_the_reference(self, layout):
        """``init_params`` gives the reference's tree: the groups stacked
        (G, k, ...), the tail (tail, ...), dtypes per leaf (bf16 weights,
        f32 ``A_log`` / ``D`` / ``dt_bias`` / ``norm_scale`` at published
        dtype); ``from_jax_params`` carries it across unchanged."""
        for over in ({}, {"dtype": "bfloat16"}):
            jcfg, cfg = _configs(**LAYOUTS[layout], **over)
            jparams = jax_hybrid.init_params(jcfg, jax.random.PRNGKey(0))
            params = t_hybrid.init_params(cfg, 0, device="cpu")
            carried = from_jax_params(_np_tree(jparams), "cpu")
            jleaves = _jax_leaves(jparams)
            want = {n: (tuple(l.shape), l.dtype.name)
                    for n, l in jleaves.items()}
            for tree in (params, carried):
                got = {n: (tuple(l.shape), str(l.dtype).split(".")[-1])
                       for n, l in zip(tree_names(tree), tree_leaves(tree))}
                assert got == want
            assert ("tail" in params) == (t_hybrid.group_layout(cfg)[2] > 0)
            assert t_hybrid.group_layout(cfg) == \
                jax_hybrid.group_layout(jcfg)
            for n, got in zip(tree_names(carried), tree_leaves(carried)):
                np.testing.assert_array_equal(
                    _np(got), jleaves[n].astype(np.float32))

    def test_published_layout(self):
        cfg = get_config(ARCH)
        assert t_hybrid.group_layout(cfg) == (13, 6, 3)
        assert cfg.head_dim == 112

    @pytest.mark.parametrize("ssm_chunk", [128, 8])
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_forward_logits(self, layout, ssm_chunk):
        jcfg, cfg, jparams, params = _models(layout)
        tokens, _ = _tokens(cfg, 2, 20, 1)
        jlogits, jaux = jax_hybrid.forward(jparams, jcfg, jnp.asarray(tokens),
                                           ssm_chunk=ssm_chunk)
        logits, aux = t_hybrid.forward(params, cfg, torch.from_numpy(tokens),
                                       ssm_chunk=ssm_chunk)
        assert aux == jaux == 0.0
        assert tuple(logits.shape) == (2, 20, cfg.vocab_size)
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        emb = np.asarray(jparams["embed"])[tokens]
        elogits, _ = t_hybrid.forward(params, cfg, torch.zeros_like(
            torch.from_numpy(tokens)), embeddings=torch.from_numpy(emb),
            ssm_chunk=ssm_chunk)
        np.testing.assert_array_equal(_np(elogits), _np(logits))

    @pytest.mark.parametrize("remat", [False, True])
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_loss_and_all_grads_match_reference(self, layout, remat):
        """The trainer's loss (``make_loss_fn``: ``remat`` only, the default
        ``ssm_chunk``) and every leaf's gradient."""
        jcfg, cfg, jparams, params = _models(layout, seed=1)
        tokens, labels = _tokens(cfg, 2, 16, 3)
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: jax_hybrid.loss_fn(p, jcfg, jnp.asarray(tokens),
                                         jnp.asarray(labels),
                                         remat=remat)))(jparams)
        loss = make_loss_fn(cfg, TrainConfig(remat=remat))
        tl, tg = value_and_grad(loss, params, torch.from_numpy(tokens),
                                torch.from_numpy(labels))
        np.testing.assert_allclose(float(tl), float(jl), **F32)
        want, got = _jax_leaves(jg), _port_leaves(tg)
        assert set(got) == set(want)
        for name in want:
            assert np.isfinite(got[name]).all(), name
            np.testing.assert_allclose(got[name], want[name], **GRAD,
                                       err_msg=name)


class TestDecode:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_decode_matches_forward_and_the_reference_cache(self, layout):
        """Twin of ``TestDecodeConsistency`` (``zamba2_7b``; the
        reference's tolerance): token-by-token ``decode_step`` ==
        teacher-forced ``forward``; each step's logits equal the
        reference's, and after the S steps every leaf of the decode cache
        (lengths, page table exact; the Mamba states and the KV pools of
        every site) equals the reference's cache."""
        jcfg, cfg, jparams, params = _models(layout)
        B, S = 2, 12
        tokens, _ = _tokens(cfg, B, S, 7)
        logits_tf, _ = t_hybrid.forward(params, cfg, torch.from_numpy(tokens))
        cache = t_hybrid.init_decode_cache(cfg, B, 32, device="cpu")
        jcache = jax_hybrid.init_decode_cache(jcfg, B, 32)
        step = jax.jit(lambda p, c, t: jax_hybrid.decode_step(p, jcfg, c, t))
        outs = []
        for t in range(S):
            lg, cache = t_hybrid.decode_step(params, cfg, cache,
                                             torch.from_numpy(
                                                 tokens[:, t:t + 1]))
            jlg, jcache = step(jparams, jcache, jnp.asarray(
                tokens[:, t:t + 1]))
            np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=1e-4,
                                       rtol=1e-4)
            outs.append(lg.reshape(B, -1))
        np.testing.assert_allclose(_np(torch.stack(outs, 1)),
                                   _np(logits_tf), atol=2e-3, rtol=2e-2)
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

    def test_cache_layout(self):
        cfg = reduced(get_config(ARCH))
        c = t_hybrid.init_decode_cache(cfg, 3, 40, device="cpu")
        G, _, _ = t_hybrid.group_layout(cfg)
        assert tuple(c["k_pool"].shape) == (G, 3 * 3, 16, cfg.n_kv_heads,
                                            cfg.head_dim)
        assert tuple(c["ssm"]["ssm"].shape[:2]) == (cfg.n_layers, 3)
        assert tuple(c["ssm"]["conv"].shape[:2]) == (cfg.n_layers, 3)
        assert c["ssm"]["ssm"].dtype == torch.float32
        assert tuple(c["page_table"].shape) == (3, 3)

    def test_published_cache_size(self):
        """``init_decode_cache(zamba2_7b, 4, 1024)`` on the meta device:
        KV pools 763 MB (13 sites), pinned SSM / conv state 609 MB (81
        layers)."""
        cfg = get_config(ARCH)
        c = t_hybrid.init_decode_cache(cfg, 4, 1024, device="meta")
        nbytes = {n: l.numel() * l.element_size()
                  for n, l in zip(tree_names(c), tree_leaves(c))}
        assert nbytes["k_pool"] + nbytes["v_pool"] == 763_363_328
        assert nbytes["ssm/ssm"] + nbytes["ssm/conv"] == 608_726_016

    def test_registry_and_device_rule(self):
        m = model_for(get_config(ARCH))
        for fn in ("init_params", "forward", "loss_fn", "init_decode_cache",
                   "decode_step"):
            assert getattr(m, fn) is getattr(t_hybrid, fn)
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        cfg = reduced(get_config(ARCH))
        with pytest.raises(RuntimeError, match="CUDA"):
            t_hybrid.init_params(cfg, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_hybrid.init_decode_cache(cfg, 1, 32)


# ------------------------------------------------------------ the trainer
class TestHybridTrainer:
    def test_three_step_loss_curve_matches_reference(self):
        """Twin of ``tests/test_runtime.py::TestTrainer`` for reduced
        Zamba2 (2 groups and a tail): three steps of 2 microbatches with
        remat, loss, grad norm and lr within ``GRAD``."""
        jcfg, cfg, jparams, params = _models("groups_and_tail")
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
        assert "family=hybrid" in capsys.readouterr().out

    def test_need_a_gpu_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            t_serve.main(["--arch", ARCH, "--requests", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            t_train.main(["--arch", ARCH, "--steps", "1"])


# ------------------------------------------------------------- the engine
class TestEngineNestedCache:
    def test_nested_state_leaf_round_trips(self):
        """``_copy_in`` puts each sequence's nested state leaves
        (``ssm/ssm``, ``ssm/conv``: batch on axis 1) and its pool pages
        into its batch slot; ``_copy_out`` brings slot i back into the
        sequence's own cache, lengths advanced by one."""
        cfg = reduced(get_config(ARCH))
        params = t_hybrid.init_params(cfg, 0, device="cpu")
        eng = ServingEngine(cfg, params, max_batch=2, max_len=32,
                            device="cpu")
        reqs = [eng.submit(np.arange(3, dtype=np.int32) + i, 2)
                for i in range(2)]
        gen = torch.Generator().manual_seed(0)
        seqs = []
        for r in reqs:
            c = t_hybrid.init_decode_cache(cfg, 1, 32, device="cpu")
            for leaf in tree_leaves(c):
                if leaf.is_floating_point():
                    leaf.copy_(torch.randn(leaf.shape, generator=gen))
            c["lengths"] += 5 + r.req_id
            eng._seq_caches[r.req_id] = c
            seqs.append({n: l.clone() for n, l in
                         zip(tree_names(c), tree_leaves(c))})
        lengths = eng._copy_in(reqs)
        assert lengths.tolist() == [6, 7]
        per = eng.cache["page_table"].shape[1]
        for i, want in enumerate(seqs):
            for name in ("ssm/ssm", "ssm/conv"):
                got = dict(zip(tree_names(eng.cache),
                               tree_leaves(eng.cache)))[name][:, i]
                assert torch.equal(got, want[name][:, 0]), name
            for name in ("k_pool", "v_pool"):
                got = eng.cache[name][:, i * per:(i + 1) * per]
                assert torch.equal(got, want[name]), name
        # the step's output cache: move slot 1's state, check the copy out
        out = {n: l for n, l in zip(tree_names(eng.cache),
                                    tree_leaves(eng.cache))}
        out["ssm/conv"][:, 1].add_(1.0)
        eng._copy_out(1, reqs[1], eng.cache)
        back = eng._seq_caches[reqs[1].req_id]
        assert back["lengths"].tolist() == [8]
        assert torch.equal(back["ssm"]["conv"][:, 0],
                           seqs[1]["ssm/conv"][:, 0] + 1.0)
        assert torch.equal(back["ssm"]["ssm"], seqs[1]["ssm/ssm"])
        assert torch.equal(back["k_pool"], seqs[1]["k_pool"])
