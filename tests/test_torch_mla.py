"""Port vs reference, Multi-head Latent Attention and the ``mla_moe`` family
(DeepSeek-V3): the MLA layer, its absorbed decode through the paged latent
cache, and the whole reduced model on the CPU.

Weights come from the reference's ``init_mla`` / ``init_params`` and are
carried into the port with ``from_jax_params``; inputs are made by numpy.
Tolerances: f32 per module ``atol=rtol=2e-5``; whole models 1e-4 for
logits and ``GRAD`` (1e-4) for gradients; bf16 2e-2 x max|ref|; integer
outputs and pool rows left alone exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decoder as jax_decoder
from repro.models import mla as jax_mla
from repro.models.config import reduced as jax_reduced

from repro_torch.compat import from_jax_params
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.models import decoder as t_decoder
from repro_torch.models import mla as t_mla
from repro_torch.models.config import reduced
from repro_torch.models.registry import model_for
from repro_torch.training.trainer import (TrainConfig, make_loss_fn,
                                          value_and_grad)
from repro_torch.tree import tree_leaves, tree_map, tree_names

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
ARCH = "deepseek_v3_671b"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(**kw):
    return jax_reduced(jax_get_config(ARCH), **kw), \
        reduced(get_config(ARCH), **kw)


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(l, np.float32)
            for path, l in flat}


def _port_leaves(tree):
    return {n: l.detach().float().numpy()
            for n, l in zip(tree_names(tree), tree_leaves(tree))}


def _walk_layout(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _walk_layout(got[k], want[k], f"{path}/{k}")
        else:
            assert tuple(got[k].shape) == want[k].shape, f"{path}/{k}"
            assert str(got[k].dtype).endswith(want[k].dtype.name), \
                f"{path}/{k}"


def _mla_case(dtype="float32", seed=0):
    jcfg, cfg = _configs(dtype=dtype)
    jdt = getattr(jnp, dtype)
    jp = jax_mla.init_mla(jax.random.PRNGKey(seed), jcfg, jdt)
    return jcfg, cfg, jp, from_jax_params(_np_tree(jp), "cpu")


def _both(x, name="float32"):
    return jnp.asarray(x, getattr(jnp, name)), \
        torch.from_numpy(np.asarray(x)).to(getattr(torch, name))


# ------------------------------------------------------------ the MLA layer
class TestApplyMla:
    def test_init_layout_matches_reference(self):
        jcfg, cfg = _configs(dtype="bfloat16")
        want = jax.eval_shape(lambda k: jax_mla.init_mla(k, jcfg,
                                                         jnp.bfloat16),
                              jax.random.PRNGKey(0))
        got = t_mla.init_mla(torch.Generator().manual_seed(0), cfg,
                             torch.bfloat16)
        _walk_layout(got, want)

    def test_latents_match_reference(self):
        jcfg, cfg, jp, p = _mla_case()
        x = np.random.default_rng(1).standard_normal(
            (2, 7, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(3, 10), (2, 7)).astype(np.int32)
        want = jax.jit(lambda p_, x_, pos_: jax_mla._latents(
            p_, jcfg, x_, pos_))(jp, jnp.asarray(x), jnp.asarray(pos))
        got = t_mla._latents(p, cfg, torch.from_numpy(x),
                             torch.from_numpy(pos))
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)

    @pytest.mark.parametrize("S,q_chunk,kv_chunk", [(10, 512, 512),
                                                    (13, 4, 4)])
    def test_forward_matches_reference(self, S, q_chunk, kv_chunk):
        """Per-head K/V expanded from the latents, v padded to the qk head
        dim for the flash call and stripped after."""
        jcfg, cfg, jp, p = _mla_case()
        x = np.random.default_rng(2).standard_normal(
            (2, S, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
        want = jax.jit(lambda p_, x_, pos_: jax_mla.apply_mla(
            p_, jcfg, x_, pos_, q_chunk=q_chunk, kv_chunk=kv_chunk))(
            jp, jnp.asarray(x), jnp.asarray(pos))
        got = t_mla.apply_mla(p, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos), q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    def test_forward_bf16(self):
        jcfg, cfg, jp, p = _mla_case("bfloat16")
        x = np.random.default_rng(3).standard_normal(
            (2, 9, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
        jx, tx = _both(x, "bfloat16")
        want = np.asarray(jax.jit(lambda p_, x_, pos_: jax_mla.apply_mla(
            p_, jcfg, x_, pos_))(jp, jx, jnp.asarray(pos)), np.float32)
        got = t_mla.apply_mla(p, cfg, tx, torch.from_numpy(pos))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2e-2 * np.abs(want).max())


class TestFlashHeadDim192:
    """The MLA forward's flash call has head_dim nope + rope = 192 at
    DeepSeek-V3's widths; the CUDA kernels serve it on both routes (bf16
    on the tensor cores, f32 on the CUDA cores), with no fallback to the
    plain version on the card."""

    def test_deepseek_qk_head_dim_is_192(self):
        cfg = get_config(ARCH)
        assert cfg.qk_nope_head_dim + cfg.qk_rope_head_dim == 192
        assert 192 in fa_kernel.SUPPORTED_HEAD_DIMS

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_route_error_names_192(self, dtype):
        """192 has a route in each dtype (it raised before the kernels
        served it); a head dim past it still raises, naming itself."""
        want = fa_kernel.TENSOR_CORES if dtype == torch.bfloat16 \
            else fa_kernel.F32
        assert fa_kernel.route(dtype, 192) == want
        with pytest.raises(ValueError, match="head_dim 200"):
            fa_kernel.route(dtype, 200)

    def test_non_cpu_tensors_go_to_the_kernel_binding(self):
        """A tensor not on the CPU never takes the plain version: the MLA
        forward reaches the binding, which raises for a tensor that is not
        on a CUDA device."""
        cfg = get_config(ARCH)
        H, d = 2, 64
        small = dataclasses.replace(cfg, n_heads=H, d_model=d, q_lora_rank=32)
        p = tree_map(lambda t: t.to("meta"), t_mla.init_mla(
            torch.Generator().manual_seed(0), small, torch.bfloat16))
        x = torch.zeros((1, 4, d), dtype=torch.bfloat16, device="meta")
        pos = torch.arange(4, device="meta").expand(1, 4)
        with pytest.raises(ValueError,
                           match="flash_attention_kernel: q must be a CUDA"):
            t_mla.apply_mla(p, small, x, pos)


class TestMlaDecode:
    def _pools(self, cfg, P, seed):
        rng = np.random.default_rng(seed)
        ps = cfg.kv_page_tokens
        return (rng.standard_normal((P, ps, cfg.kv_lora_rank))
                .astype(np.float32),
                rng.standard_normal((P, ps, cfg.qk_rope_head_dim))
                .astype(np.float32))

    def _step_both(self, jcfg, cfg, jp, p, x, pools, table, lengths):
        ckv, kr = pools
        jout, jckv, jkr = jax.jit(
            lambda *a: jax_mla.apply_mla_decode_paged(jp, jcfg, *a))(
            jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
            jnp.asarray(table), jnp.asarray(lengths))
        tckv, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
        out, ckv2, kr2 = t_mla.apply_mla_decode_paged(
            p, cfg, torch.from_numpy(x), tckv, tkr, torch.from_numpy(table),
            torch.from_numpy(lengths))
        assert ckv2 is tckv and kr2 is tkr                # in place
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
        np.testing.assert_allclose(tckv.numpy(), np.asarray(jckv), **F32)
        np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), **F32)
        return tckv.numpy(), tkr.numpy()

    def test_ragged_steps_match_reference(self):
        """Four steps at lengths 5/21 and 1/16 (pages of 16): the output and
        both latent pools match the reference after every step."""
        jcfg, cfg, jp, p = _mla_case()
        table = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
        pools = self._pools(cfg, 6, 4)
        rng = np.random.default_rng(5)
        for lengths in ([5, 21], [6, 22], [1, 16], [2, 17]):
            x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
            pools = self._step_both(jcfg, cfg, jp, p, x, pools, table,
                                    np.array(lengths, np.int32))

    def test_lock_step_offset(self):
        """The whole batch writes at the page offset of row 0: row 1's
        latents land at offset (5 - 1) % 16 of its own page, not at its own
        position (23 % 16); both packages do the same."""
        jcfg, cfg, jp, p = _mla_case()
        table = np.array([[0, 1], [2, 3]], np.int32)
        before = self._pools(cfg, 4, 6)
        x = np.random.default_rng(7).standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32)
        ckv, kr = self._step_both(jcfg, cfg, jp, p, x, before, table,
                                  np.array([5, 24], np.int32))
        changed = np.argwhere((ckv != before[0]).any(-1))
        assert sorted(map(tuple, changed)) == [(0, 4), (3, 4)]
        np.testing.assert_array_equal(ckv[3, 23 % 16], before[0][3, 23 % 16])
        np.testing.assert_array_equal(kr[3, 23 % 16], before[1][3, 23 % 16])

    def test_unmapped_frame_clamped_and_masked(self):
        """Row 1's current page is unmapped (-1): the write goes to frame 0
        (the clamp), and the page is masked out of the scan."""
        jcfg, cfg, jp, p = _mla_case()
        table = np.array([[1, 2], [3, -1]], np.int32)
        before = self._pools(cfg, 4, 8)
        x = np.random.default_rng(9).standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32)
        ckv, _ = self._step_both(jcfg, cfg, jp, p, x, before, table,
                                 np.array([3, 20], np.int32))
        changed = sorted(map(tuple, np.argwhere((ckv != before[0]).any(-1))))
        assert changed == [(0, 2), (1, 2)]


# ---------------------------------------------------------- the whole model
def _model(seed=0, **kw):
    jcfg, cfg = _configs(**kw)
    jparams = jax_decoder.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, from_jax_params(_np_tree(jparams), "cpu")


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    return tokens, labels


class TestDeepSeekModel:
    @pytest.mark.parametrize("mtp_depth", [0, 1])
    def test_init_layout_matches_reference(self, mtp_depth):
        """Dense then MoE stacks, MLA in both, the f32 router, the shared
        expert; with ``mtp_depth`` the MTP stack (initialised only)."""
        jcfg, cfg = _configs(mtp_depth=mtp_depth, n_layers=3,
                             first_k_dense=1)
        want = jax.eval_shape(lambda k: jax_decoder.init_params(jcfg, k),
                              jax.random.PRNGKey(0))
        got = t_decoder.init_params(cfg, 0, device="cpu")
        _walk_layout(got, want)
        assert set(got) == {"embed", "final_norm", "lm_head", "dense_layers",
                            "moe_layers"} | ({"mtp"} if mtp_depth else set())
        assert got["moe_layers"]["moe"]["router"].shape[0] == 2
        if mtp_depth:
            assert "shared" in got["mtp"]["moe"]
            # the reference's MTP weights convert leaf for leaf
            ref = _np_tree(jax_decoder.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
            conv = from_jax_params(ref["mtp"], "cpu")
            for n, a, b in zip(tree_names(conv), tree_leaves(conv),
                               tree_leaves(got["mtp"])):
                assert a.shape == b.shape and a.dtype == b.dtype, n
                np.testing.assert_array_equal(
                    a.numpy(), np.asarray(_jax_leaves(ref["mtp"])[n]))

    def test_forward_logits_and_aux(self):
        """``prefill`` collects no K/V for MLA: (logits, aux) only."""
        jcfg, cfg, jparams, params = _model()
        tokens, _ = _tokens(cfg, 2, 12, 1)
        jlogits, jaux = jax_decoder.prefill(jparams, jcfg,
                                            jnp.asarray(tokens))
        out = t_decoder.prefill(params, cfg, torch.from_numpy(tokens))
        assert len(out) == 2
        logits, aux = out
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(aux), float(jaux), **F32)
        assert float(aux) > 0

    @pytest.mark.parametrize("remat", [False, True])
    def test_loss_and_all_grads_match_reference(self, remat):
        jcfg, cfg, jparams, params = _model(seed=1)
        tokens, labels = _tokens(cfg, 2, 16, 3)
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: jax_decoder.loss_fn(p, jcfg, jnp.asarray(tokens),
                                          jnp.asarray(labels),
                                          remat=remat)))(jparams)
        tl, tg = value_and_grad(make_loss_fn(cfg, TrainConfig(remat=remat)),
                                params, torch.from_numpy(tokens),
                                torch.from_numpy(labels))
        np.testing.assert_allclose(float(tl), float(jl), **F32)
        want, got = _jax_leaves(jg), _port_leaves(tg)
        assert set(got) == set(want)
        assert any("wkv_a" in n for n in got) and \
            any("shared" in n for n in got)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], **GRAD,
                                       err_msg=name)

    def test_decode_logits_and_latent_pools_match_reference(self):
        """Six decode steps, batch 2, max_len 40 (3 pages of 16 a
        sequence): logits, both latent pools and the page table."""
        jcfg, cfg, jparams, params = _model()
        jcache = jax_decoder.init_decode_cache(jcfg, 2, 40)
        cache = t_decoder.init_decode_cache(cfg, 2, 40, device="cpu")
        assert set(cache) == set(jcache) == {"lengths", "ckv_pool",
                                             "krope_pool", "page_table"}
        for k in cache:
            assert tuple(cache[k].shape) == jcache[k].shape, k
        jstep = jax.jit(lambda p, c, t: jax_decoder.decode_step(p, jcfg, c,
                                                                t))
        rng = np.random.default_rng(9)
        for _ in range(6):
            tokens = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
            jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tokens))
            logits, cache = t_decoder.decode_step(params, cfg, cache,
                                                  torch.from_numpy(tokens))
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(cache["lengths"].numpy(),
                                      np.asarray(jcache["lengths"]))
        np.testing.assert_array_equal(cache["page_table"].numpy(),
                                      np.asarray(jcache["page_table"]))
        for k in ("ckv_pool", "krope_pool"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), atol=1e-4)

    def test_decode_matches_forward(self):
        """Twin of ``tests/test_models.py::TestDecodeConsistency``: the
        absorbed latent decode, token by token, equals the expanded
        teacher-forced forward (same tolerance as the reference's test)."""
        cfg = reduced(get_config(ARCH))
        params = t_decoder.init_params(cfg, 3, device="cpu")
        B, S = 2, 12
        tokens = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, S)))
        logits_tf, _ = t_decoder.forward(params, cfg, tokens)
        cache = t_decoder.init_decode_cache(cfg, B, 32, device="cpu")
        outs = []
        for t in range(S):
            lg, cache = t_decoder.decode_step(params, cfg, cache,
                                              tokens[:, t:t + 1])
            outs.append(lg.reshape(B, -1))
        np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                                   logits_tf.detach().numpy(), atol=2e-3,
                                   rtol=2e-2)

    def test_arch_smoke(self):
        """Twin of ``tests/test_models.py::TestArchSmoke``."""
        cfg = reduced(get_config(ARCH))
        m = model_for(cfg)
        assert m.decode_step is t_decoder.decode_step
        params = m.init_params(cfg, 0, device="cpu")
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        logits, _ = m.forward(params, cfg, tokens)
        assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        labels = torch.roll(tokens, -1, dims=1)
        loss = lambda p: m.loss_fn(p, cfg, tokens, labels)  # noqa: E731
        l0, grads = value_and_grad(loss, params)
        assert torch.isfinite(l0)
        assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
        stepped = tree_map(lambda p, g: p - 0.05 * g, params, grads)
        assert float(loss(stepped)) < float(l0)
