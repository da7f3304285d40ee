"""Port vs reference, the xLSTM family (xLSTM-125M): the mLSTM and sLSTM
cells and blocks and the whole reduced model (params tree, forward, loss,
gradients, decode and its cache), on the CPU.  The engine, the reference
engine's xLSTM fault, the trainer and the launchers are in
``tests/test_torch_xlstm_serving.py``.

Weights come from the reference's ``init_*`` and are carried into the port
with ``from_jax_params``; inputs are made by numpy.  Tolerances: f32 per
module ``atol=rtol=2e-5`` (``tests/test_kernels.py::_tol``); whole models
1e-4 for logits and gradients (``GRAD``: the sum order differs and
compounds through the layers); bf16 2e-2; integer outputs exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.models import xlstm as jax_xlstm
from repro.models import xlstm_model as jax_model
from repro.models.config import reduced as jax_reduced

from repro_torch.compat import from_jax_params
from repro_torch.configs import get_config
from repro_torch.models import xlstm as t_xlstm
from repro_torch.models import xlstm_model as t_model
from repro_torch.models.config import reduced
from repro_torch.models.registry import model_for
from repro_torch.training.trainer import (TrainConfig, make_loss_fn,
                                          value_and_grad)
from repro_torch.tree import tree_leaves, tree_names

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
ARCH = "xlstm_125m"

# reduced()'s own two layers (m[0,1) s[1,2)), and six layers with sLSTM at
# 2 and 5: m[0,2) s[2,3) m[3,5) s[5,6), three segment boundaries
LAYOUTS = {"reduced": {}, "six_layers": {"n_layers": 6, "slstm_at": (2, 5)}}
SEQS = [12, 64, 70, 130]        # one chunk, exact, a short last, several


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(**kw):
    return jax_reduced(jax_get_config(ARCH), **kw), \
        reduced(get_config(ARCH), **kw)


def _models(layout, seed=0, **kw):
    jcfg, cfg = _configs(**LAYOUTS[layout], **kw)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, from_jax_params(_np_tree(jparams), "cpu")


def _jax_leaves(tree):
    """Leaves by their "a/b/c" names, in the reference's (sorted) order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path):
            leaf if isinstance(leaf, jax.ShapeDtypeStruct) else
            np.asarray(leaf) for path, leaf in flat}


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


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


# --------------------------------------------------------------- the cells
def _cell_params(kind, dtype, seed=0):
    jcfg, cfg = _configs()
    init = {"m": (jax_xlstm.init_mlstm, t_xlstm.init_mlstm),
            "s": (jax_xlstm.init_slstm, t_xlstm.init_slstm)}[kind]
    jp = init[0](jax.random.PRNGKey(seed), jcfg, getattr(jnp, dtype))
    if kind == "s":      # non-zero biases: every gate term reaches the output
        jp = dict(jp, b_gates=jnp.asarray(_x(jp["b_gates"].shape, 99, 0.5)))
    return jcfg, cfg, jp, from_jax_params(_np_tree(jp), "cpu")


def _mlstm_state(jcfg, B, seed):
    """A random mLSTM state: C and n of unit scale, m in [-2, 2]."""
    st = jax_xlstm.init_mlstm_state(jcfg, B)
    return {"C": jnp.asarray(_x(st["C"].shape, seed, 0.3)),
            "n": jnp.asarray(_x(st["n"].shape, seed + 1)),
            "m": jnp.asarray(_x(st["m"].shape, seed + 2))}


def _slstm_state(jcfg, B, seed):
    st = jax_xlstm.init_slstm_state(jcfg, B)
    return {k: jnp.asarray(_x(v.shape, seed + i, 0.5))
            for i, (k, v) in enumerate(st.items())}


class TestCells:
    def test_dims_and_init_states_like_the_reference(self):
        jcfg, cfg = _configs()
        assert t_xlstm.mlstm_dims(cfg) == jax_xlstm.mlstm_dims(jcfg)
        assert t_xlstm.slstm_dims(cfg) == jax_xlstm.slstm_dims(jcfg)
        for jfn, tfn in ((jax_xlstm.init_mlstm_state,
                          t_xlstm.init_mlstm_state),
                         (jax_xlstm.init_slstm_state,
                          t_xlstm.init_slstm_state)):
            want, got = jfn(jcfg, 3), tfn(cfg, 3)
            assert tree_names(got) == sorted(want)
            for k in want:
                assert got[k].dtype == torch.float32
                np.testing.assert_array_equal(_np(got[k]),
                                              np.asarray(want[k]))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("kind", ["m", "s"])
    def test_init_params_like_the_reference(self, kind, dtype):
        """Keys, shapes and dtypes (the gate weights, biases and the cells'
        norm scales f32 at any model dtype); the constant leaves equal."""
        jcfg, cfg = _configs()
        jinit, tinit = {"m": (jax_xlstm.init_mlstm, t_xlstm.init_mlstm),
                        "s": (jax_xlstm.init_slstm, t_xlstm.init_slstm)}[kind]
        jp = jinit(jax.random.PRNGKey(0), jcfg, getattr(jnp, dtype))
        p = tinit(torch.Generator().manual_seed(0), cfg,
                  getattr(torch, dtype))
        assert tree_names(p) == sorted(jp)
        for k in jp:
            assert tuple(p[k].shape) == jp[k].shape, k
            assert str(p[k].dtype).split(".")[-1] == jp[k].dtype.name, k
        for k in ("b_if", "norm_scale", "b_gates"):
            if k in jp:
                np.testing.assert_array_equal(_np(p[k]), np.asarray(jp[k]))

    def test_mlstm_cell(self):
        """Five steps of ``_mlstm_cell`` from a random state, f32: the
        output and the carry (C, n, m)."""
        jcfg, cfg = _configs()
        _, nh, dk = t_xlstm.mlstm_dims(cfg)
        B = 3
        jst = _mlstm_state(jcfg, B, 1)
        jc = (jst["C"], jst["n"], jst["m"])
        tc = tuple(torch.from_numpy(np.array(a)) for a in jc)
        for t in range(5):
            inp = [_x((B, nh, dk), 10 * t + i) for i in range(3)] + \
                [_x((B, nh), 10 * t + i, 2.0) for i in (3, 4)]
            jc, jh = jax_xlstm._mlstm_cell(jc, tuple(map(jnp.asarray, inp)))
            tc, th = t_xlstm._mlstm_cell(tc, tuple(map(torch.from_numpy,
                                                       inp)))
            np.testing.assert_allclose(_np(th), np.asarray(jh), **F32)
            for a, b in zip(tc, jc):
                np.testing.assert_allclose(_np(a), np.asarray(b), **F32)

    def test_slstm_cell(self):
        """Five steps of ``_slstm_cell`` from a random state, f32: the
        gate-major recurrent product, the normaliser floor of 1e-6."""
        jcfg, cfg, jp, p = _cell_params("s", "float32")
        B, d = 3, cfg.d_model
        jst = _slstm_state(jcfg, B, 1)
        jc = (jst["c"], jst["n"], jst["h"], jst["m"])
        tc = tuple(torch.from_numpy(np.array(a)) for a in jc)
        for t in range(5):
            pre = _x((B, 4 * d), 20 + t, 2.0)
            jc, jh = jax_xlstm._slstm_cell(jp, jcfg, jc, jnp.asarray(pre))
            tc, th = t_xlstm._slstm_cell(p, cfg, tc, torch.from_numpy(pre))
            np.testing.assert_allclose(_np(th), np.asarray(jh), **F32)
            for a, b in zip(tc, jc):
                np.testing.assert_allclose(_np(a), np.asarray(b), **F32)

    def test_slstm_normaliser_floor(self):
        """A zero normaliser divides by 1e-6 (the mLSTM's floor is 1): a
        cell whose input gate is shut keeps n = 0 and h = o·c / 1e-6."""
        jcfg, cfg, jp, p = _cell_params("s", "float32")
        B, d = 2, cfg.d_model
        c = _x((B, d), 3, 1e-6)
        zeros = np.zeros((B, d), np.float32)
        carry = (c, zeros, zeros, zeros)
        pre = np.zeros((B, 4 * d), np.float32)
        pre[:, d:2 * d] = -1e4                   # i: exp(i - m) = 0
        jc, jh = jax_xlstm._slstm_cell(jp, jcfg, tuple(map(jnp.asarray,
                                                           carry)),
                                       jnp.asarray(pre))
        tc, th = t_xlstm._slstm_cell(p, cfg, tuple(map(torch.from_numpy,
                                                       carry)),
                                     torch.from_numpy(pre))
        assert not np.asarray(jc[1]).any() and not _np(tc[1]).any()
        np.testing.assert_allclose(_np(th), np.asarray(jh), **F32)
        assert np.abs(np.asarray(jh)).max() > 0.1

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("S", SEQS)
    def test_apply_mlstm(self, S, dtype):
        jcfg, cfg, jp, p = _cell_params("m", dtype)
        x = _x((2, S, cfg.d_model), 3)
        want = jax_xlstm.apply_mlstm(jp, jcfg,
                                     jnp.asarray(x).astype(getattr(jnp,
                                                                   dtype)))
        got = t_xlstm.apply_mlstm(p, cfg, torch.from_numpy(x).to(
            getattr(torch, dtype)))
        assert str(got.dtype).endswith(dtype)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **_tol(dtype))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("S", SEQS)
    def test_apply_slstm(self, S, dtype):
        jcfg, cfg, jp, p = _cell_params("s", dtype)
        x = _x((2, S, cfg.d_model), 4)
        want = jax_xlstm.apply_slstm(jp, jcfg,
                                     jnp.asarray(x).astype(getattr(jnp,
                                                                   dtype)))
        got = t_xlstm.apply_slstm(p, cfg, torch.from_numpy(x).to(
            getattr(torch, dtype)))
        assert str(got.dtype).endswith(dtype)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **_tol(dtype))

    def test_chunk_size_invariance(self):
        """The chunked sequence equals itself at another chunk: chunks
        change where the backward keeps states, not the result."""
        _, cfg, _, p = _cell_params("m", "float32")
        x = torch.from_numpy(_x((1, 40, 2 * cfg.d_model), 5))
        a = t_xlstm._mlstm_sequence(p, cfg, x, chunk=64)
        b = t_xlstm._mlstm_sequence(p, cfg, x, chunk=7)
        np.testing.assert_allclose(_np(a), _np(b), **F32)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("kind", ["m", "s"])
    def test_decode_functions(self, kind, dtype):
        """Five steps of ``apply_mlstm_decode`` / ``apply_slstm_decode``
        from a random state: outputs in the model dtype (its tolerance),
        states f32 and held to the f32 tolerance at either dtype: the
        bf16 projections round as the reference's do (``k`` divided by
        √dk in bf16, then cast), and the recurrences are f32."""
        jcfg, cfg, jp, p = _cell_params(kind, dtype, seed=4)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        B = 3
        jst = (_mlstm_state if kind == "m" else _slstm_state)(jcfg, B, 7)
        st = from_jax_params(_np_tree(jst), "cpu")
        jfn, tfn = {"m": (jax_xlstm.apply_mlstm_decode,
                          t_xlstm.apply_mlstm_decode),
                    "s": (jax_xlstm.apply_slstm_decode,
                          t_xlstm.apply_slstm_decode)}[kind]
        for t in range(5):
            x = _x((B, 1, cfg.d_model), 30 + t)
            jy, jst = jfn(jp, jcfg, jnp.asarray(x).astype(jdt), jst)
            y, st = tfn(p, cfg, torch.from_numpy(x).to(tdt), st)
            assert y.dtype == tdt and tuple(y.shape) == (B, 1, cfg.d_model)
            np.testing.assert_allclose(_np(y), np.asarray(jy, np.float32),
                                       **_tol(dtype))
            assert tree_names(st) == sorted(jst)
            for k in jst:
                assert st[k].dtype == torch.float32
                np.testing.assert_allclose(_np(st[k]), np.asarray(jst[k]),
                                           **F32, err_msg=k)


# --------------------------------------------------------------- the model
class TestModel:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_params_tree_like_the_reference(self, layout):
        """``init_params`` gives the reference's tree: the mLSTM runs
        stacked ``(L_seg, ...)``, the sLSTM blocks single, dtypes per leaf
        (f32 gates at bf16); ``from_jax_params`` carries it unchanged."""
        for over in ({}, {"dtype": "bfloat16"}):
            jcfg, cfg = _configs(**LAYOUTS[layout], **over)
            assert t_model.segments(cfg) == jax_model.segments(jcfg)
            jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
            params = t_model.init_params(cfg, 0, device="cpu")
            carried = from_jax_params(_np_tree(jparams), "cpu")
            jleaves = _jax_leaves(jparams)
            want = {n: (tuple(l.shape), l.dtype.name)
                    for n, l in jleaves.items()}
            for tree in (params, carried):
                got = {n: (tuple(l.shape), str(l.dtype).split(".")[-1])
                       for n, l in zip(tree_names(tree), tree_leaves(tree))}
                assert got == want
            for n, got in zip(tree_names(carried), tree_leaves(carried)):
                np.testing.assert_array_equal(
                    _np(got), jleaves[n].astype(np.float32))

    def test_published_segments_and_size(self):
        """12 blocks, sLSTM at 5 and 11; the published tree (shapes only:
        fake tensors here, ``jax.eval_shape`` in the reference) leaf by
        leaf, 239,828,048 parameters."""
        cfg = get_config(ARCH)
        assert t_model.segments(cfg) == [("m", 0, 5), ("s", 5, 6),
                                         ("m", 6, 11), ("s", 11, 12)]
        with FakeTensorMode():
            params = t_model.init_params(cfg, 0, device="cpu")
            got = {n: (tuple(l.shape), str(l.dtype).split(".")[-1])
                   for n, l in zip(tree_names(params), tree_leaves(params))}
        shapes = jax.eval_shape(lambda: jax_model.init_params(
            jax_get_config(ARCH), jax.random.PRNGKey(0)))
        assert got == {n: (tuple(s.shape), s.dtype.name)
                       for n, s in _jax_leaves(shapes).items()}
        assert sum(int(np.prod(s)) for s, _ in got.values()) == 239_828_048

    @pytest.mark.parametrize("remat", [False, True])
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_forward_logits(self, layout, remat):
        jcfg, cfg, jparams, params = _models(layout)
        tokens, _ = _tokens(cfg, 2, 70, 1)
        jlogits, jaux = jax_model.forward(jparams, jcfg, jnp.asarray(tokens),
                                          remat=remat)
        logits, aux = t_model.forward(params, cfg, torch.from_numpy(tokens),
                                      remat=remat)
        assert aux == jaux == 0.0
        assert tuple(logits.shape) == (2, 70, cfg.vocab_size)
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **GRAD)
        emb = np.asarray(jparams["embed"])[tokens]
        elogits, _ = t_model.forward(params, cfg, torch.zeros_like(
            torch.from_numpy(tokens)), embeddings=torch.from_numpy(emb),
            remat=remat)
        np.testing.assert_array_equal(_np(elogits), _np(logits))

    @pytest.mark.parametrize("remat", [False, True])
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_loss_and_all_grads_match_reference(self, layout, remat):
        """The trainer's loss (``make_loss_fn``: ``remat`` only) and every
        leaf's gradient, over a sequence of two chunks and a short one."""
        jcfg, cfg, jparams, params = _models(layout, seed=1)
        tokens, labels = _tokens(cfg, 2, 70, 3)
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: jax_model.loss_fn(p, jcfg, jnp.asarray(tokens),
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
        """Twin of ``TestDecodeConsistency`` (``xlstm_125m``; the
        reference's tolerance): token-by-token ``decode_step`` ==
        teacher-forced ``forward``; each step's logits equal the
        reference's, and after the S steps every leaf of the decode cache
        equals the reference's, the sLSTM leaves modulo their leading
        axis of one."""
        jcfg, cfg, jparams, params = _models(layout)
        B, S = 2, 12
        tokens, _ = _tokens(cfg, B, S, 7)
        logits_tf, _ = t_model.forward(params, cfg, torch.from_numpy(tokens))
        cache = t_model.init_decode_cache(cfg, B, 32, device="cpu")
        jcache = jax_model.init_decode_cache(jcfg, B, 32)
        step = jax.jit(lambda p, c, t: jax_model.decode_step(p, jcfg, c, t))
        outs = []
        for t in range(S):
            lg, cache = t_model.decode_step(params, cfg, cache,
                                            torch.from_numpy(
                                                tokens[:, t:t + 1]))
            jlg, jcache = step(jparams, jcache, jnp.asarray(
                tokens[:, t:t + 1]))
            np.testing.assert_allclose(_np(lg), np.asarray(jlg), **GRAD)
            outs.append(lg.reshape(B, -1))
        np.testing.assert_allclose(_np(torch.stack(outs, 1)),
                                   _np(logits_tf), atol=2e-3, rtol=2e-2)
        jleaves = _jax_leaves(jcache)
        assert tree_names(cache) == list(jleaves)
        slstm = {f"seg{si}" for si, (kind, _, _) in
                 enumerate(t_model.segments(cfg)) if kind == "s"}
        for (name, want), got in zip(jleaves.items(), tree_leaves(cache)):
            if name.split("/")[0] in slstm:
                assert got.shape[0] == 1, name
                got = got[0]
            assert tuple(got.shape) == want.shape, name
            assert str(got.dtype).split(".")[-1] == want.dtype.name, name
            if name == "lengths":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                np.testing.assert_allclose(_np(got), np.asarray(want),
                                           **F32, err_msg=name)
        assert cache["lengths"].tolist() == [S] * B

    def test_cache_layout(self):
        """mLSTM leaves ``(L_seg, B, ...)``, sLSTM leaves ``(1, B, d)``:
        the batch on axis 1 everywhere but ``lengths``; m starts at
        -1e30."""
        cfg = _configs(**LAYOUTS["six_layers"])[1]
        c = t_model.init_decode_cache(cfg, 3, device="cpu")
        names = dict(zip(tree_names(c), tree_leaves(c)))
        assert sorted(names) == sorted(
            ["lengths"] + [f"seg{i}/{k}" for i in (0, 2) for k in "Cmn"]
            + [f"seg{i}/{k}" for i in (1, 3) for k in "chmn"])
        d_in, nh, dk = t_xlstm.mlstm_dims(cfg)
        assert tuple(names["seg0/C"].shape) == (2, 3, nh, dk, dk)
        assert tuple(names["seg2/n"].shape) == (2, 3, nh, dk)
        for k in "chmn":
            assert tuple(names[f"seg3/{k}"].shape) == (1, 3, cfg.d_model)
        for n, t in names.items():
            if n != "lengths":
                assert t.dtype == torch.float32 and t.shape[1] == 3, n
                assert (t == -1e30).all() if n.endswith("/m") \
                    else not t.any(), n

    def test_published_cache_size(self):
        """``init_decode_cache(xlstm_125m, 1)`` on the meta device: the
        pinned state of one sequence is 23,679,136 B, of which the mLSTM
        matrix memories C are 23,592,960 B (2 segments, 10 layers)."""
        cfg = get_config(ARCH)
        c = t_model.init_decode_cache(cfg, 1, device="meta")
        nbytes = {n: l.numel() * l.element_size()
                  for n, l in zip(tree_names(c), tree_leaves(c))
                  if n != "lengths"}
        assert sum(nbytes.values()) == 23_679_136
        assert sum(v for n, v in nbytes.items() if n.endswith("/C")) == \
            23_592_960

    def test_registry_and_device_rule(self):
        m = model_for(get_config(ARCH))
        for fn in ("init_params", "forward", "loss_fn", "init_decode_cache",
                   "decode_step"):
            assert getattr(m, fn) is getattr(t_model, fn)
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        cfg = reduced(get_config(ARCH))
        with pytest.raises(RuntimeError, match="CUDA"):
            t_model.init_params(cfg, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_model.init_decode_cache(cfg, 1)


def test_published_config_is_the_reference_s():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
