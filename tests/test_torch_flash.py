"""Port vs reference, flash attention: the port's plain versions against the
reference's Pallas ``flash_attention_kernel`` (interpret mode, as
``tests/test_kernels.py`` runs it), its ``flash_attention_ref`` oracle and
its chunked ``flash_attention_xla`` — values and gradients.

Inputs are made by numpy from a seed and fed to both packages; the port's
side runs on the CPU, where ``kernels.flash_attention.ops`` takes the plain
chunked version (the CUDA kernels are held against ``ref.py`` on the GPU by
``chip_smoke.py``).  Tolerances: f32 values 2e-5 (sums in another order),
f32 gradients 1e-4 (the same, through the softmax's backward), bf16 2e-2
(one bf16 rounding of the output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref
from repro.models.attention_ops import flash_attention_xla as jax_flash_xla
from repro.models.attention_ops import mha_reference as jax_mha_reference

from repro_torch.kernels.flash_attention.flash_attention import \
    check_shapes as kernel_check_shapes
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.models.attention_ops import flash_attention_xla

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _inputs(B, S, H, KVH, D, seed=0, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sk or S
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, D)).astype(np.float32))


def _kl(x):          # model layout (B, S, H, D) -> kernel layout (B, H, S, D)
    return x.transpose(0, 2, 1, 3)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


class TestFlashAttentionPlain:
    """Twins of ``tests/test_kernels.py::TestFlashAttentionKernel``."""

    @pytest.mark.parametrize("B,S,H,KVH,D", [
        (1, 32, 4, 4, 16),
        (2, 48, 4, 2, 32),    # GQA + a tail (48 % 32 != 0)
        (1, 128, 8, 1, 64),   # MQA
        (1, 40, 10, 2, 16),   # a group of 5 query heads (Qwen3-14B's G)
        (1, 48, 2, 2, 192),   # DeepSeek-V3's MLA head_dim (nope + rope)
    ])
    @pytest.mark.parametrize("name", ["float32", "bfloat16"])
    def test_causal_matches_reference(self, B, S, H, KVH, D, name):
        q, k, v = _inputs(B, S, H, KVH, D)
        jd = jnp.bfloat16 if name == "bfloat16" else jnp.float32
        td = torch.bfloat16 if name == "bfloat16" else torch.float32
        jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
        tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
        ref = _kl(jax_flash_ref(_kl(jq), _kl(jk), _kl(jv), causal=True))
        # the Pallas kernel in interpret mode costs seconds per shape: it is
        # run in f32, where it and the oracle agree to 2e-5 anyway
        wants = [ref] if name == "bfloat16" else [ref, jax_flash_attention(
            jq, jk, jv, causal=True, block_q=32, block_k=32, interpret=True)]
        tol = BF16 if name == "bfloat16" else F32
        got_ref = flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                                      tv.transpose(1, 2)).transpose(1, 2)
        got_ops = flash_attention(tq, tk, tv, causal=True)
        for got in (got_ref, got_ops):
            assert got.dtype == td and tuple(got.shape) == q.shape
            for want in wants:
                np.testing.assert_allclose(_f32(got), _f32(want), **tol)

    @pytest.mark.parametrize("window", [8, 24])
    def test_sliding_window(self, window):
        q, k, v = _inputs(1, 64, 4, 2, 16, seed=1)
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        kern = jax_flash_attention(jq, jk, jv, causal=True, window=window,
                                   block_q=16, block_k=16, interpret=True)
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        got_ref = flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                                      tv.transpose(1, 2), causal=True,
                                      window=window).transpose(1, 2)
        got_ops = flash_attention(tq, tk, tv, causal=True, window=window,
                                  kv_chunk=16)
        for got in (got_ref, got_ops):
            np.testing.assert_allclose(_f32(got), _f32(kern), **F32)

    def test_non_causal(self):
        q, k, v = _inputs(2, 32, 4, 4, 16, seed=2)
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        kern = jax_flash_attention(jq, jk, jv, causal=False, block_q=16,
                                   block_k=16, interpret=True)
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        got_ref = flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                                      tv.transpose(1, 2),
                                      causal=False).transpose(1, 2)
        got_ops = flash_attention(tq, tk, tv, causal=False, kv_chunk=8)
        for got in (got_ref, got_ops):
            np.testing.assert_allclose(_f32(got), _f32(kern), **F32)

    @pytest.mark.parametrize("S,H,KVH,causal,window", [
        (37, 4, 4, True, 0),
        (40, 10, 2, True, 0),       # a group of 5 query heads
        (40, 10, 2, True, 9),       # sliding window
        (24, 4, 2, False, 0),       # non-causal
    ])
    def test_backward_ref_matches_reference_vjp(self, S, H, KVH, causal,
                                                window):
        """The plain backward (the kernels' yardstick on the card) equals
        ``jax.vjp`` of the reference's oracle, given the forward's own
        output."""
        q, k, v = _inputs(2, S, H, KVH, 16, seed=7)
        cot = np.random.default_rng(8).standard_normal(
            q.shape).astype(np.float32)
        kw = dict(causal=causal, window=window)
        _, vjp = jax.vjp(lambda q, k, v: jax_flash_ref(q, k, v, **kw),
                         *(jnp.asarray(_kl(x)) for x in (q, k, v)))
        want = vjp(jnp.asarray(_kl(cot)))
        tq, tk, tv, tc = (torch.from_numpy(_kl(x)) for x in (q, k, v, cot))
        o = flash_attention_ref(tq, tk, tv, **kw)
        got = flash_attention_bwd_ref(tq, tk, tv, o, tc, **kw)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(_f32(g), np.asarray(w), **GRAD)


XLA_CASES = [
    # B, Sq, Sk, H, KVH, D, causal, window, q_offset, kv_chunk
    (1, 16, 16, 4, 4, 8, True, 0, 0, 16),
    (1, 40, 40, 4, 4, 192, True, 0, 0, 16),   # MLA's head_dim 192
    (2, 33, 33, 8, 1, 32, True, 0, 0, 16),    # MQA, padded last chunk
    (2, 40, 40, 10, 2, 16, True, 8, 0, 16),   # G = 5, sliding window
    (1, 24, 24, 4, 2, 16, False, 0, 0, 8),    # non-causal
    (2, 5, 21, 4, 2, 16, True, 0, 16, 8),     # q_offset: a chunk of decode
    (1, 7, 30, 4, 2, 16, True, 6, 23, 8),     # q_offset + window
]


class TestFlashHeadDim192:
    """Head dim 192 (DeepSeek-V3: q, k nope 128 + rope 64; v zero-padded
    to 192 as ``mla.apply_mla`` pads it): the plain versions the CUDA
    kernels are held to on the card, against the reference."""

    @pytest.mark.parametrize("causal,window", [(True, 0), (True, 12),
                                               (False, 0)])
    def test_forward_matches_pallas(self, causal, window):
        q, k, v = _inputs(1, 40, 4, 2, 192, seed=11)
        v[..., 128:] = 0.0                       # V padded as MLA pads it
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        kern = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                                   block_q=16, block_k=16, interpret=True)
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        got_ref = flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                                      tv.transpose(1, 2), causal=causal,
                                      window=window).transpose(1, 2)
        got_ops = flash_attention(tq, tk, tv, causal=causal, window=window,
                                  kv_chunk=16)
        for got in (got_ref, got_ops):
            np.testing.assert_allclose(_f32(got), _f32(kern), **F32)
            assert np.all(_f32(got)[..., 128:] == 0.0)

    @pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2)])
    def test_backward_ref_matches_reference_vjp(self, H, KVH):
        """The plain backward at D=192 equals ``jax.vjp`` of the
        reference's oracle."""
        q, k, v = _inputs(1, 33, H, KVH, 192, seed=12)
        cot = np.random.default_rng(13).standard_normal(
            q.shape).astype(np.float32)
        _, vjp = jax.vjp(lambda q, k, v: jax_flash_ref(q, k, v, causal=True),
                         *(jnp.asarray(_kl(x)) for x in (q, k, v)))
        want = vjp(jnp.asarray(_kl(cot)))
        tq, tk, tv, tc = (torch.from_numpy(_kl(x)) for x in (q, k, v, cot))
        o = flash_attention_ref(tq, tk, tv)
        got = flash_attention_bwd_ref(tq, tk, tv, o, tc)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_f32(g), np.asarray(w), **GRAD)


class TestFlashAttentionXla:
    @pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,causal,window,q_offset,kv_chunk",
                             XLA_CASES)
    def test_values_and_grads_match_reference(self, B, Sq, Sk, H, KVH, D,
                                              causal, window, q_offset,
                                              kv_chunk):
        q, k, v = _inputs(B, Sq, H, KVH, D, seed=3, Sk=Sk)
        cot = np.random.default_rng(4).standard_normal(
            (B, Sq, H, D)).astype(np.float32)
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_chunk=kv_chunk)

        def jloss(q, k, v):
            out = jax_flash_xla(q, k, v, **kw)
            return jnp.sum(out * cot), out

        (_, want), jgrads = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        out = flash_attention_xla(tq, tk, tv, **kw)
        np.testing.assert_allclose(_f32(out), np.asarray(want), **F32)
        (out * torch.from_numpy(cot)).sum().backward()
        for t, jg in zip((tq, tk, tv), jgrads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **GRAD)

    def test_cpu_wrapper_gradient_equals_the_oracles(self):
        """The CPU route of ``ops.flash_attention`` is differentiated by
        autograd; its gradient equals autograd of the materializing
        ``ref.py``."""
        q, k, v = _inputs(1, 45, 10, 2, 16, seed=5)
        cot = torch.from_numpy(np.random.default_rng(6).standard_normal(
            q.shape).astype(np.float32))
        grads = []
        for fn in ("ops", "ref"):
            tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                          for x in (q, k, v))
            if fn == "ops":
                out = flash_attention(tq, tk, tv, window=12, kv_chunk=16)
            else:
                out = flash_attention_ref(
                    tq.transpose(1, 2), tk.transpose(1, 2),
                    tv.transpose(1, 2), window=12).transpose(1, 2)
            (out * cot).sum().backward()
            grads.append([t.grad.numpy() for t in (tq, tk, tv)])
        for a, b in zip(*grads):
            np.testing.assert_allclose(a, b, **GRAD)


CROSS_SHAPES = [(Sq, Sk) for Sq in (1, 5, 33) for Sk in (1, 17, 40)]


class TestCrossAttentionShapes:
    """Sq != Sk, non-causal and unwindowed: the encoder-decoder family's
    cross-attention (decoder rows over encoder frames; Sq = 1 at decode).
    The plain versions the CUDA kernels are held to on the card, and the
    CPU route of ``ops.flash_attention``, against the reference's
    ``mha_reference`` / ``flash_attention_xla``."""

    @pytest.mark.parametrize("Sq,Sk", CROSS_SHAPES)
    @pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2)], ids=["G1", "G2"])
    def test_ref_forward_and_backward_match_reference(self, Sq, Sk, H, KVH):
        """``ref.py``'s forward and its backward oracle (given the
        forward's own output) against the values and ``jax.vjp`` of the
        reference's ``mha_reference``."""
        q, k, v = _inputs(2, Sq, H, KVH, 16, seed=11, Sk=Sk)
        cot = np.random.default_rng(12).standard_normal(
            q.shape).astype(np.float32)
        want, vjp = jax.vjp(
            lambda q, k, v: jax_mha_reference(q, k, v, causal=False),
            *(jnp.asarray(x) for x in (q, k, v)))
        want_grads = vjp(jnp.asarray(cot))
        tq, tk, tv, tc = (torch.from_numpy(_kl(x)) for x in (q, k, v, cot))
        o = flash_attention_ref(tq, tk, tv, causal=False)
        assert tuple(o.shape) == (2, H, Sq, 16)
        np.testing.assert_allclose(_f32(o.transpose(1, 2)),
                                   np.asarray(want), **F32)
        got = flash_attention_bwd_ref(tq, tk, tv, o, tc, causal=False)
        for g, w in zip(got, want_grads):
            np.testing.assert_allclose(_f32(g.transpose(1, 2)),
                                       np.asarray(w), **GRAD)

    @pytest.mark.parametrize("Sq,Sk", CROSS_SHAPES)
    @pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2)], ids=["G1", "G2"])
    def test_cpu_route_values_and_grads(self, Sq, Sk, H, KVH):
        """The CPU route of ``ops.flash_attention`` (the chunked plain
        version, autograd) against ``flash_attention_xla`` of the
        reference and its gradient."""
        q, k, v = _inputs(1, Sq, H, KVH, 16, seed=13, Sk=Sk)
        cot = np.random.default_rng(14).standard_normal(
            q.shape).astype(np.float32)

        def jloss(q, k, v):
            out = jax_flash_xla(q, k, v, causal=False, kv_chunk=16)
            return jnp.sum(out * cot), out

        (_, want), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(x) for x in (q, k, v)))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        out = flash_attention(tq, tk, tv, causal=False, kv_chunk=16)
        np.testing.assert_allclose(_f32(out), np.asarray(want), **F32)
        (out * torch.from_numpy(cot)).sum().backward()
        for t, jg in zip((tq, tk, tv), jgrads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **GRAD)


class TestKernelShapeCheck:
    """``check_shapes``: what the CUDA entry points take, from shapes alone
    (run on the CPU; the card's calls go through it)."""

    @pytest.mark.parametrize("Sq,Sk", [(1, 1500), (448, 1500), (65, 33),
                                       (7, 7)])
    def test_takes_cross_attention_shapes(self, Sq, Sk):
        assert kernel_check_shapes((4, Sq, 16, 64), (4, Sk, 16, 64),
                                   (4, Sk, 16, 64), False, 0) == \
            (4, Sq, Sk, 16, 16, 64)

    @pytest.mark.parametrize("causal,window", [(True, 0), (False, 32),
                                               (True, 32)])
    @pytest.mark.parametrize("Sq,Sk", [(1, 1500), (448, 1500), (65, 33)])
    def test_refuses_sq_ne_sk_with_a_mask(self, Sq, Sk, causal, window):
        with pytest.raises(ValueError, match="Sq"):
            kernel_check_shapes((2, Sq, 4, 64), (2, Sk, 4, 64),
                                (2, Sk, 4, 64), causal, window)

    @pytest.mark.parametrize("causal,window", [(True, 0), (True, 32)])
    def test_sq_eq_sk_keeps_its_masks(self, causal, window):
        assert kernel_check_shapes((1, 40, 8, 64), (1, 40, 2, 64),
                                   (1, 40, 2, 64), causal, window) == \
            (1, 40, 40, 8, 2, 64)

    @pytest.mark.parametrize("q,k,v", [
        ((2, 5, 4, 64), (3, 9, 4, 64), (3, 9, 4, 64)),    # batch
        ((2, 5, 4, 64), (2, 9, 4, 32), (2, 9, 4, 32)),    # head dim
        ((2, 5, 4, 64), (2, 9, 4, 64), (2, 8, 4, 64)),    # k vs v
        ((2, 5, 6, 64), (2, 9, 4, 64), (2, 9, 4, 64)),    # heads vs KV heads
    ])
    def test_refuses_mismatches(self, q, k, v):
        with pytest.raises(ValueError):
            kernel_check_shapes(q, k, v, False, 0)
