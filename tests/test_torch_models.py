"""Port vs reference, model path: layers, attention decode (paged and
ring) and whole ``decode_step`` logits on the CPU.

Inputs and weights are made by numpy (or by the reference's
``init_params``) and carried into the port with ``from_jax_params``, so
both packages compute the same function on the same numbers.  All in
float32 unless a test says otherwise; tolerances are stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import attention_ops as jax_ops
from repro.models import decoder as jax_decoder
from repro.models import encdec as jax_encdec
from repro.models import hybrid as jax_hybrid
from repro.models import layers as jax_layers
from repro.models import xlstm_model as jax_xlstm_model
from repro.models.config import reduced as jax_reduced
from repro.models.registry import model_for as jax_model_for

from repro_torch.compat import from_jax_params, resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import attention as t_attn
from repro_torch.models import attention_ops as t_ops
from repro_torch.models import decoder as t_decoder
from repro_torch.models import encdec as t_encdec
from repro_torch.models import hybrid as t_hybrid
from repro_torch.models import layers as t_layers
from repro_torch.models import xlstm_model as t_xlstm_model
from repro_torch.models.config import reduced
from repro_torch.models.registry import NOT_PORTED, model_for

# float32 on both sides: the two libraries order their sums differently
# (matmul blocking, reductions), nothing else differs
F32 = dict(atol=2e-5, rtol=2e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _rng(seed=0):
    return np.random.default_rng(seed)


class TestLayers:
    @pytest.mark.parametrize("kind", ["rms", "ln"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_apply_norm(self, kind, dtype):
        rng = _rng(1)
        x = rng.standard_normal((2, 3, 64)).astype(np.float32) * 3 + 0.5
        p = {"scale": rng.standard_normal(64).astype(np.float32)}
        if kind == "ln":
            p["bias"] = rng.standard_normal(64).astype(np.float32)
        jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        want = jax_layers.apply_norm(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, jd),
            kind, 1e-5)
        got = t_layers.apply_norm({k: _t(v) for k, v in p.items()},
                                  _t(x, td), kind, 1e-5)
        assert got.dtype == td
        tol = F32 if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)

    def test_rms_head_norm(self):
        rng = _rng(2)
        x = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
        s = rng.standard_normal(16).astype(np.float32)
        want = jax_layers.rms_head_norm(jnp.asarray(s), jnp.asarray(x), 1e-6)
        got = t_layers.rms_head_norm(_t(s), _t(x), 1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    @pytest.mark.parametrize("theta", [10000.0, 1000000.0])
    def test_apply_rope(self, theta):
        """Rotates halves, frequencies from float64 numpy: positions up to
        a few thousand keep sin/cos within 1e-4 in float32."""
        rng = _rng(3)
        x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
        pos = np.array([[0, 1, 2, 3, 4], [100, 511, 512, 2047, 4000]],
                       np.int32)
        want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = t_layers.apply_rope(_t(x), _t(pos), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)

    @pytest.mark.parametrize("act,bias", [("silu", False), ("gelu", True),
                                          ("gelu", False)])
    def test_apply_mlp(self, act, bias):
        rng = _rng(4)
        d, f = 32, 80
        p = {"wi": rng.standard_normal((d, f)).astype(np.float32) / 6,
             "wo": rng.standard_normal((f, d)).astype(np.float32) / 9}
        if act == "silu":
            p["wg"] = rng.standard_normal((d, f)).astype(np.float32) / 6
        if bias:
            p["bi"] = rng.standard_normal(f).astype(np.float32)
            p["bo"] = rng.standard_normal(d).astype(np.float32)
        x = rng.standard_normal((2, 3, d)).astype(np.float32)
        want = jax_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), act)
        got = t_layers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    def test_sinusoid_positions(self):
        np.testing.assert_allclose(
            t_layers.sinusoid_positions(12, 16).numpy(),
            np.asarray(jax_layers.sinusoid_positions(12, 16)), atol=1e-6)


def _attn_params(cfg, seed):
    p = jax_attn.init_attention(jax.random.PRNGKey(seed), cfg, jnp.float32)
    p = _np_tree(p)
    rng = _rng(seed)
    for k in p:                      # biases / norm scales away from 0 / 1
        if p[k].ndim == 1:
            p[k] = (p[k] + 0.3 * rng.standard_normal(p[k].shape)
                    ).astype(np.float32)
    return p


class TestAttention:
    @pytest.mark.parametrize("arch", ["qwen3_14b", "codeqwen15_7b",
                                      "starcoder2_3b"])
    def test_qkv(self, arch):
        """qk_norm (qwen3), attention bias (codeqwen, starcoder2)."""
        cfg = reduced(get_config(arch))
        jcfg = jax_reduced(jax_get_config(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        p = _attn_params(jcfg, 5)
        rng = _rng(5)
        x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
        pos = np.array([[7, 8, 9], [0, 1, 2]], np.int32)
        want = jax_attn._qkv({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                             jnp.asarray(x), jnp.asarray(pos))
        got = t_attn._qkv(from_jax_params(p, "cpu"), cfg, _t(x), _t(pos))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=1e-4)

    def test_init_attention_shapes_match_reference(self):
        for arch in ("qwen3_14b", "codeqwen15_7b"):
            cfg = reduced(get_config(arch))
            want = _attn_params(jax_reduced(jax_get_config(arch)), 0)
            gen = torch.Generator().manual_seed(0)
            got = t_attn.init_attention(gen, cfg, torch.float32)
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: v.shape for k, v in want.items()}

    def test_decode_paged(self):
        """Several lockstep steps through the paged pool; the pools evolve
        identically (the new K/V lands at row 0's offset for every row)."""
        cfg = reduced(get_config("qwen3_14b"))
        jcfg = jax_reduced(jax_get_config("qwen3_14b"))
        p = _attn_params(jcfg, 6)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = from_jax_params(p, "cpu")
        rng = _rng(6)
        B, ps, NP = 3, cfg.kv_page_tokens, 2
        shape = (B * NP, ps, cfg.n_kv_heads, cfg.head_dim)
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        pt = np.arange(B * NP, dtype=np.int32).reshape(B, NP)
        jk, jv = jnp.asarray(kp), jnp.asarray(vp)
        tk, tv = _t(kp), _t(vp)
        lengths = np.array([3, 14, 20], np.int32)    # ragged on purpose
        for step in range(4):
            lengths = lengths + 1
            x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
            jo, jk, jv = jax_attn.apply_attention_decode_paged(
                jp, jcfg, jnp.asarray(x), jk, jv, jnp.asarray(pt),
                jnp.asarray(lengths))
            to, tk2, tv2 = t_attn.apply_attention_decode_paged(
                tp, cfg, _t(x), tk, tv, _t(pt), _t(lengths))
            assert tk2.data_ptr() == tk.data_ptr()          # in place
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4,
                                       rtol=1e-4)
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)

    def test_decode_ring(self):
        """Sliding-window ring, wrapping past the window."""
        cfg = reduced(get_config("h2o_danube_1_8b"), sliding_window=8)
        jcfg = jax_reduced(jax_get_config("h2o_danube_1_8b"),
                           sliding_window=8)
        p = _attn_params(jcfg, 7)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = from_jax_params(p, "cpu")
        rng = _rng(7)
        B, W = 2, 8
        shape = (B, W, cfg.n_kv_heads, cfg.head_dim)
        jk = jv = jnp.zeros(shape, jnp.float32)
        tk, tv = torch.zeros(shape), torch.zeros(shape)
        lengths = np.zeros((B,), np.int32)
        for step in range(11):
            lengths = lengths + 1
            x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
            jo, jk, jv = jax_attn.apply_attention_decode_ring(
                jp, jcfg, jnp.asarray(x), jk, jv, jnp.asarray(lengths))
            to, _, _ = t_attn.apply_attention_decode_ring(
                tp, cfg, _t(x), tk, tv, _t(lengths))
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4,
                                       rtol=1e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)

    def test_mha_reference_and_ring_ops(self):
        rng = _rng(8)
        q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
        k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
        ln = np.array([9, 6], np.int32)
        for kw in (dict(causal=True, q_offset=4), dict(causal=False),
                   dict(causal=True, window=3, q_offset=4)):
            want = jax_ops.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v),
                                         lengths=jnp.asarray(ln), **kw)
            got = t_ops.mha_reference(_t(q), _t(k), _t(v), lengths=_t(ln),
                                      **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        for cur in ([3, 8], [9, 30]):
            want = jax_ops.ring_buffer_attention(
                jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(cur, jnp.int32), 9)
            got = t_ops.ring_buffer_attention(
                _t(q[:, 0]), _t(k), _t(v), torch.tensor(cur,
                                                       dtype=torch.int32), 9)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


class TestDecodeStep:
    @pytest.mark.parametrize("arch", ["qwen3_14b", "codeqwen15_7b",
                                      "starcoder2_3b", "h2o_danube_1_8b"])
    def test_logits_match_reference(self, arch):
        """Six decode steps, batch 2, converted weights.  f32 logits agree
        to 1e-4: per-op differences of ~1e-6 (sum order in matmuls and
        softmax) grow through two layers, the norms and the vocabulary
        projection, and feed back through the KV cache over the steps."""
        jcfg = jax_reduced(jax_get_config(arch))
        cfg = reduced(get_config(arch))
        jparams = jax_decoder.init_params(jcfg, jax.random.PRNGKey(0))
        params = from_jax_params(_np_tree(jparams), "cpu")
        B, max_len = 2, 40
        jcache = jax_decoder.init_decode_cache(jcfg, B, max_len)
        cache = t_decoder.init_decode_cache(cfg, B, max_len, device="cpu")
        assert set(cache) == set(jcache)
        for k in cache:
            assert tuple(cache[k].shape) == jcache[k].shape, k
        rng = _rng(9)
        for step in range(6):
            tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
            jlogits, jcache = jax_decoder.decode_step(jparams, jcfg, jcache,
                                                      jnp.asarray(tokens))
            logits, cache = t_decoder.decode_step(params, cfg, cache,
                                                  _t(tokens))
            assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(cache["lengths"].numpy(),
                                      np.asarray(jcache["lengths"]))
        for k in cache:
            if "pool" in k or "ring" in k:
                np.testing.assert_allclose(cache[k].numpy(),
                                           np.asarray(jcache[k]), atol=1e-4)

    def test_bf16_params_roundtrip_and_step(self):
        """bf16 weights come across bit for bit; one bf16 decode step stays
        within 2e-2·max|logit| of the reference (bf16 rounds after every
        op, at different places in the two libraries)."""
        jcfg = jax_reduced(jax_get_config("qwen3_14b"), dtype="bfloat16")
        cfg = reduced(get_config("qwen3_14b"), dtype="bfloat16")
        jparams = jax_decoder.init_params(jcfg, jax.random.PRNGKey(1))
        np_params = _np_tree(jparams)
        params = from_jax_params(np_params, "cpu")
        wq = params["dense_layers"]["attn"]["wq"]
        assert wq.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            wq.view(torch.int16).numpy(),
            np_params["dense_layers"]["attn"]["wq"].view(np.int16))
        assert params["final_norm"]["scale"].dtype == torch.float32
        jcache = jax_decoder.init_decode_cache(jcfg, 2, 32)
        cache = t_decoder.init_decode_cache(cfg, 2, 32, device="cpu")
        assert cache["k_pool"].dtype == torch.bfloat16
        tokens = np.array([[3], [77]], np.int32)
        jlogits, _ = jax_decoder.decode_step(jparams, jcfg, jcache,
                                             jnp.asarray(tokens))
        logits, _ = t_decoder.decode_step(params, cfg, cache, _t(tokens))
        want = np.asarray(jlogits, np.float32)
        np.testing.assert_allclose(logits.float().numpy(), want,
                                   atol=2e-2 * np.abs(want).max())

    def test_from_jax_params_casts_floats_only(self):
        tree = {"w": np.ones((2, 3), np.float32),
                "lengths": np.zeros((2,), np.int32)}
        out = from_jax_params(tree, "cpu", dtype=torch.bfloat16)
        assert out["w"].dtype == torch.bfloat16
        assert out["lengths"].dtype == torch.int32


class TestInitAndRegistry:
    def test_init_params_layout_matches_reference(self):
        """Same keys, stacked (L, ...) shapes and dtypes as the reference's
        pytree, so converted and native params are interchangeable."""
        for arch in ("qwen3_14b", "starcoder2_3b"):
            jcfg = jax_reduced(jax_get_config(arch))
            cfg = reduced(get_config(arch))
            want = _np_tree(jax_decoder.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
            got = t_decoder.init_params(cfg, 0, device="cpu")

            def walk(a, b, path=""):
                assert set(a) == set(b), path
                for k in a:
                    if isinstance(a[k], dict):
                        walk(a[k], b[k], path + "/" + k)
                    else:
                        assert tuple(a[k].shape) == b[k].shape, path + k
                        assert str(a[k].dtype).endswith(b[k].dtype.name)
            walk(got, want)

    def test_init_params_statistics_and_determinism(self):
        cfg = reduced(get_config("qwen3_14b"), d_model=128, d_ff=256)
        a = t_decoder.init_params(cfg, 3, device="cpu")
        b = t_decoder.init_params(cfg, 3, device="cpu")
        c = t_decoder.init_params(cfg, 4, device="cpu")
        wi = a["dense_layers"]["mlp"]["wi"]
        assert torch.equal(wi, b["dense_layers"]["mlp"]["wi"])
        assert not torch.equal(wi, c["dense_layers"]["mlp"]["wi"])
        assert not torch.equal(wi[0], wi[1])          # layers differ
        assert abs(float(wi.std()) - 1 / np.sqrt(cfg.d_model)) < 0.01
        assert abs(float(a["embed"].std()) - 0.02) < 0.002

    def test_identity_page_table_and_layer_slice(self):
        np.testing.assert_array_equal(
            t_decoder._identity_page_table(3, 40, 16).numpy(),
            np.asarray(jax_decoder._identity_page_table(3, 40, 16)))
        cfg = reduced(get_config("qwen3_14b"))
        p = t_decoder.init_params(cfg, 0, device="cpu")
        lp = t_decoder.layer_slice(p["dense_layers"], 1)
        assert lp["attn"]["wq"].shape == (cfg.d_model,
                                         cfg.n_heads * cfg.head_dim)
        assert t_decoder.uses_ring(reduced(get_config("h2o_danube_1_8b")))
        assert not t_decoder.uses_ring(cfg)

    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_model_for(self, arch):
        cfg = get_config(arch)
        assert dataclasses.asdict(cfg) == \
            dataclasses.asdict(jax_get_config(arch))
        if cfg.family in ("dense", "moe", "mla_moe"):
            assert model_for(cfg).decode_step is t_decoder.decode_step
            assert jax_model_for(jax_get_config(arch)).decode_step \
                is jax_decoder.decode_step
        elif cfg.family == "hybrid":
            assert model_for(cfg).decode_step is t_hybrid.decode_step
            assert jax_model_for(jax_get_config(arch)).decode_step \
                is jax_hybrid.decode_step
        elif cfg.family == "encdec":
            assert model_for(cfg).decode_step is t_encdec.decode_step
            assert jax_model_for(jax_get_config(arch)).decode_step \
                is jax_encdec.decode_step
        else:
            assert cfg.family == "xlstm"
            assert model_for(cfg).decode_step is t_xlstm_model.decode_step
            assert jax_model_for(jax_get_config(arch)).decode_step \
                is jax_xlstm_model.decode_step

    def test_families_still_to_port(self):
        """moe and mla_moe are served by the decoder's API, hybrid, encdec
        and xlstm by their own modules; no family is left to port, and an
        unknown family is a ``KeyError``."""
        assert NOT_PORTED == ()
        for arch in ("mixtral_8x7b", "deepseek_v3_671b"):
            m = model_for(get_config(arch))
            for fn in ("init_params", "forward", "loss_fn",
                       "init_decode_cache", "decode_step"):
                assert getattr(m, fn) is getattr(t_decoder, fn), (arch, fn)
        m = model_for(get_config("xlstm_125m"))
        for fn in ("init_params", "forward", "loss_fn", "init_decode_cache",
                   "decode_step"):
            assert getattr(m, fn) is getattr(t_xlstm_model, fn), fn
        with pytest.raises(KeyError):
            model_for(dataclasses.replace(get_config("xlstm_125m"),
                                          family="rwkv"))

    def test_device_default_is_the_gpu(self):
        """Entry points take device=None as the GPU and raise without one;
        only an explicit "cpu" runs on the CPU."""
        cfg = reduced(get_config("qwen3_14b"))
        assert resolve_device("cpu").type == "cpu"
        if torch.cuda.is_available():
            assert resolve_device(None).type == "cuda"
            return
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_decoder.init_params(cfg, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_decoder.init_decode_cache(cfg, 1, 16)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
