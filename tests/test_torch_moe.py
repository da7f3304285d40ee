"""Port vs reference, the expert family (``moe``, Mixtral-8x7B): the MoE
layer and the whole reduced model on the CPU.

Weights come from the reference's ``init_moe`` / ``init_params`` and are
carried into the port with ``from_jax_params``; inputs are made by numpy.
Tolerances: f32 per module ``atol=rtol=2e-5``; whole models 1e-4 for
logits and ``GRAD`` (1e-4) for gradients and multi-step losses (sum order
differs and compounds through the layers); bf16 2e-2; integer outputs and
statistics exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import decoder as jax_decoder
from repro.models import moe as jax_moe
from repro.models.config import reduced as jax_reduced
from repro.optim import adamw as jax_adamw
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer

from repro_torch.compat import from_jax_params
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import decoder as t_decoder
from repro_torch.models import moe as t_moe
from repro_torch.models.config import reduced
from repro_torch.models.registry import model_for
from repro_torch.optim import adamw
from repro_torch.training.trainer import (TrainConfig, Trainer,
                                          make_loss_fn, value_and_grad)
from repro_torch.tree import (tree_leaves, tree_map, tree_names,
                              tree_unflatten)

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
ARCH = "mixtral_8x7b"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(arch=ARCH, **kw):
    return jax_reduced(jax_get_config(arch), **kw), \
        reduced(get_config(arch), **kw)


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(l, np.float32)
            for path, l in flat}


def _port_leaves(tree):
    return {n: l.detach().float().numpy()
            for n, l in zip(tree_names(tree), tree_leaves(tree))}


def _walk_layout(got, want, path=""):
    """Same keys, shapes and dtypes in a port tree and a reference tree."""
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _walk_layout(got[k], want[k], f"{path}/{k}")
        else:
            assert tuple(got[k].shape) == want[k].shape, f"{path}/{k}"
            assert str(got[k].dtype).endswith(want[k].dtype.name), \
                f"{path}/{k}"


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1                         # a masked span
    return tokens, labels


def _moe_case(arch=ARCH, dtype="float32", B=2, S=9, seed=0, **kw):
    """(jcfg, cfg, reference params, port params, x as numpy)."""
    jcfg, cfg = _configs(arch, dtype=dtype, **kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, jdt)
    p = from_jax_params(_np_tree(jp), "cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, x


def _x(x, name="float32"):
    """x in ``name`` for both packages."""
    return jnp.asarray(x, getattr(jnp, name)), \
        torch.from_numpy(x).to(getattr(torch, name))


# ---------------------------------------------------------------- the layer
class TestInitMoe:
    @pytest.mark.parametrize("arch", [ARCH, "deepseek_v3_671b"])
    def test_layout_matches_reference(self, arch):
        jcfg, cfg = _configs(arch, dtype="bfloat16")
        want = jax.eval_shape(lambda k: jax_moe.init_moe(k, jcfg,
                                                         jnp.bfloat16),
                              jax.random.PRNGKey(0))
        gen = torch.Generator().manual_seed(0)
        got = t_moe.init_moe(gen, cfg, torch.bfloat16)
        _walk_layout(got, want)
        assert got["router"].dtype == torch.float32
        assert ("shared" in got) == (cfg.n_shared_experts > 0)

    def test_statistics_and_determinism(self):
        _, cfg = _configs(d_model=256, moe_d_ff=512)
        a = t_moe.init_moe(torch.Generator().manual_seed(3), cfg,
                           torch.float32)
        b = t_moe.init_moe(torch.Generator().manual_seed(3), cfg,
                           torch.float32)
        for k in ("wi", "wg", "wo", "router"):
            assert torch.equal(a[k], b[k])
        assert not torch.equal(a["wi"][0], a["wi"][1])     # experts differ
        for k, d_in in (("wi", 256), ("wg", 256), ("wo", 512)):
            for e in range(cfg.n_experts):
                assert abs(float(a[k][e].std()) - d_in ** -0.5) \
                    < 0.05 * d_in ** -0.5, (k, e)

    @pytest.mark.parametrize("T", [1, 4, 9, 18, 33, 100, 4096])
    @pytest.mark.parametrize("arch", [ARCH, "deepseek_v3_671b"])
    def test_capacity_matches_reference(self, arch, T):
        cfg = get_config(arch)
        assert t_moe._capacity(T, cfg) == \
            jax_moe._capacity(T, jax_get_config(arch))
        assert t_moe.GROUP_TOKENS == jax_moe.GROUP_TOKENS


class TestApplyMoe:
    @pytest.mark.parametrize("arch,dropless", [
        (ARCH, True), (ARCH, False),
        ("deepseek_v3_671b", True),            # + one shared expert
        ("deepseek_v3_671b", False)])
    def test_values_and_aux_match_reference(self, arch, dropless):
        jcfg, cfg, jp, p, x = _moe_case(arch)
        jx, tx = _x(x)
        jy, jaux = jax_moe.apply_moe(jp, jcfg, jx, dropless=dropless)
        y, aux = t_moe.apply_moe(p, cfg, tx, dropless=dropless)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
        np.testing.assert_allclose(float(aux), float(jaux), **F32)
        assert float(aux) > 0

    def test_capacity_drops_the_reference_tokens(self):
        """Capacity factor 0.5: experts overflow and the same (token,
        choice) pairs fall through in both packages, choice-major."""
        jcfg, cfg, jp, p, x = _moe_case(capacity_factor=0.5, S=16)
        jx, tx = _x(x)
        jy, _ = jax_moe.apply_moe(jp, jcfg, jx)
        y, _ = t_moe.apply_moe(p, cfg, tx)
        full, _ = t_moe.apply_moe(p, cfg, tx, dropless=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
        # which tokens lost an expert: the rows that differ from dropless
        lost = (y - full).abs().amax(-1) > 1e-6
        jlost = np.abs(np.asarray(jy) - full.numpy()).max(-1) > 1e-6
        assert 0 < int(lost.sum()) < lost.numel()
        np.testing.assert_array_equal(lost.numpy(), jlost)
        T = x.shape[0] * x.shape[1]
        C = t_moe._capacity(T, cfg)
        assert C == jax_moe._capacity(T, jcfg) and C < T

    @pytest.mark.parametrize("S", [13, 16])          # padded, exact groups
    def test_grouped_path(self, monkeypatch, S):
        """Above ``GROUP_TOKENS`` tokens the dispatch runs in zero-padded
        groups, each checkpointed; the aux loss is the groups' mean.
        Values and gradients (through the checkpoints) match."""
        monkeypatch.setattr(jax_moe, "GROUP_TOKENS", 8)
        monkeypatch.setattr(t_moe, "GROUP_TOKENS", 8)
        jcfg, cfg, jp, p, x = _moe_case(S=S)
        jx, tx = _x(x)
        w = np.random.default_rng(5).standard_normal(x.shape) \
            .astype(np.float32)

        def jloss(params, xx):
            y, aux = jax_moe.apply_moe(params, jcfg, xx)
            return jnp.sum(y * w) + aux, (y, aux)

        (jl, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(jp, jx)
        leaves = [t.clone().requires_grad_(True) for t in tree_leaves(p)]
        names = tree_names(p)
        pp = tree_unflatten(p, leaves)
        xx = tx.clone().requires_grad_(True)
        y, aux = t_moe.apply_moe(pp, cfg, xx)
        loss = (y * torch.from_numpy(w)).sum() + aux
        grads = torch.autograd.grad(loss, leaves + [xx])
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **F32)
        np.testing.assert_allclose(float(aux.detach()), float(jaux), **F32)
        want = _jax_leaves(jg)
        for n, g in zip(names, grads[:-1]):
            np.testing.assert_allclose(g.numpy(), want[n], **GRAD,
                                       err_msg=n)
        np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx),
                                   **GRAD)

    @pytest.mark.parametrize("arch", [ARCH, "deepseek_v3_671b"])
    def test_bf16(self, arch):
        """bf16 weights and activations; the combine weights round to bf16
        before the last einsum on both sides.  2e-2 x max|y|."""
        jcfg, cfg, jp, p, x = _moe_case(arch, dtype="bfloat16")
        jx, tx = _x(x, "bfloat16")
        jy, jaux = jax_moe.apply_moe(jp, jcfg, jx, dropless=True)
        y, aux = t_moe.apply_moe(p, cfg, tx, dropless=True)
        assert y.dtype == torch.bfloat16
        want = np.asarray(jy, np.float32)
        np.testing.assert_allclose(y.float().numpy(), want,
                                   atol=2e-2 * np.abs(want).max())
        np.testing.assert_allclose(float(aux), float(jaux), **BF16)


# ---------------------------------------------------------- the whole model
class TestMixtralModel:
    def test_init_layout_matches_reference(self):
        jcfg, cfg = _configs()
        want = jax.eval_shape(lambda k: jax_decoder.init_params(jcfg, k),
                              jax.random.PRNGKey(0))
        got = t_decoder.init_params(cfg, 0, device="cpu")
        _walk_layout(got, want)
        assert set(got) == {"embed", "final_norm", "lm_head", "moe_layers"}

    def test_forward_logits_and_aux(self):
        jcfg, cfg = _configs()
        jparams = jax_decoder.init_params(jcfg, jax.random.PRNGKey(0))
        params = from_jax_params(_np_tree(jparams), "cpu")
        tokens, _ = _tokens(cfg, 2, 12, 1)
        jlogits, jaux, jkv = jax_decoder.prefill(jparams, jcfg,
                                                 jnp.asarray(tokens))
        logits, aux, kv = t_decoder.prefill(params, cfg,
                                            torch.from_numpy(tokens))
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(aux), float(jaux), **F32)
        assert float(aux) > 0
        assert set(kv) == set(jkv) == {"moe_layers"}
        for got, want in zip(kv["moe_layers"], jkv["moe_layers"]):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), atol=1e-4,
                                       rtol=1e-4)

    @pytest.mark.parametrize("remat", [False, True])
    def test_loss_and_all_grads_match_reference(self, remat):
        """The loss carries the aux term (``masked_xent(logits, labels,
        aux)``) in both packages."""
        jcfg, cfg = _configs()
        jparams = jax_decoder.init_params(jcfg, jax.random.PRNGKey(1))
        params = from_jax_params(_np_tree(jparams), "cpu")
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
        assert any("router" in n for n in got)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], **GRAD,
                                       err_msg=name)

    def test_decode_logits_and_rings_match_reference(self):
        """Six decode steps, batch 2, through the sliding-window rings;
        dropless dispatch in every MoE layer."""
        jcfg, cfg = _configs()
        jparams = jax_decoder.init_params(jcfg, jax.random.PRNGKey(0))
        params = from_jax_params(_np_tree(jparams), "cpu")
        jcache = jax_decoder.init_decode_cache(jcfg, 2, 40)
        cache = t_decoder.init_decode_cache(cfg, 2, 40, device="cpu")
        assert set(cache) == set(jcache) == {"lengths", "k_ring", "v_ring"}
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
        for k in ("k_ring", "v_ring"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                       atol=1e-4)

    def test_decode_matches_forward(self):
        """Twin of ``tests/test_models.py::TestDecodeConsistency`` for the
        port (same tolerance as the reference's test)."""
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
        """Twin of ``tests/test_models.py::TestArchSmoke``: finite logits of
        the right shape, finite gradients, and one SGD step lowers the
        loss."""
        cfg = reduced(get_config(ARCH))
        m = model_for(cfg)
        params = m.init_params(cfg, 0, device="cpu")
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        logits, aux = m.forward(params, cfg, tokens)
        assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        labels = torch.roll(tokens, -1, dims=1)
        loss = lambda p: m.loss_fn(p, cfg, tokens, labels)  # noqa: E731
        l0, grads = value_and_grad(loss, params)
        assert torch.isfinite(l0)
        assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
        stepped = tree_map(lambda p, g: p - 0.05 * g, params, grads)
        assert float(loss(stepped)) < float(l0)

    def test_registry_serves_the_decoder(self):
        m = model_for(reduced(get_config(ARCH)))
        assert m.forward is t_decoder.forward
        assert m.decode_step is t_decoder.decode_step


class TestMixtralTrainer:
    def test_three_step_loss_curve_matches_reference(self):
        """Twin of ``tests/test_runtime.py::TestTrainer`` for reduced
        Mixtral: three steps of 2 microbatches, loss (aux included), grad
        norm and lr within ``GRAD``."""
        jcfg, cfg = _configs()
        jparams = jax_decoder.init_params(jcfg, jax.random.PRNGKey(0))
        params = from_jax_params(_np_tree(jparams), "cpu")
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
