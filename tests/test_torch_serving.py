"""Port vs reference, the serving slice as a whole: greedy generation
through ``ServingEngine`` on the CPU with weights carried across by
``from_jax_params``.  Token ids must be **identical**, ``EngineStats`` and
the KV manager's ``PagingStats`` equal — once with an exact-fit KV pool and
once with a pool too small for the active sequences (spills and
Touch-Ahead fault-back-ins), where the tokens must also equal the
exact-fit run's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import FaultPolicy as JaxFaultPolicy
from repro.api import Strategy as JaxStrategy
from repro.configs import get_config as jax_get_config
from repro.models.config import reduced as jax_reduced
from repro.models.registry import model_for as jax_model_for
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.sampler import SamplerConfig as JaxSamplerConfig
from repro.serving.sampler import sample_token as jax_sample_token

from repro_torch.api import FaultPolicy, Strategy
from repro_torch.compat import from_jax_params
from repro_torch.configs import get_config
from repro_torch.launch import serve as t_serve
from repro_torch.models.config import reduced
from repro_torch.models.registry import model_for
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampler import SamplerConfig, sample_token

PROMPT_LENGTHS = (20, 5, 36, 18)       # pages of 16: 2, 1, 3 and 2 pages
MAX_NEW = 6


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in PROMPT_LENGTHS]


_CACHE = {}


def _run_both(arch, pool_frames):
    """Serve the scenario on both packages; cached per (arch, pool)."""
    key = (arch, pool_frames)
    if key in _CACHE:
        return _CACHE[key]
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    jparams = jax_model_for(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    jeng = JaxServingEngine(
        jcfg, jparams, max_batch=2, max_len=64, pool_frames=pool_frames,
        policy=JaxFaultPolicy(JaxStrategy.TOUCH_AHEAD, lookahead=4))
    eng = ServingEngine(
        cfg, params, max_batch=2, max_len=64, pool_frames=pool_frames,
        policy=FaultPolicy(Strategy.TOUCH_AHEAD, lookahead=4), device="cpu")
    out = []
    for e in (jeng, eng):
        reqs = [e.submit(p, max_new_tokens=MAX_NEW)
                for p in _prompts(cfg.vocab_size)]
        e.run_until_done()
        out.append((e, reqs))
    _CACHE[key] = out
    return out


@pytest.mark.parametrize("arch", ["qwen3_14b", "h2o_danube_1_8b"])
class TestGreedyServingParity:
    @pytest.mark.parametrize("pool_frames", [None, 3],
                             ids=["exact_fit", "undersized"])
    def test_tokens_identical(self, arch, pool_frames):
        (_, jreqs), (_, reqs) = _run_both(arch, pool_frames)
        assert all(r.done for r in reqs)
        assert [len(r.generated) for r in reqs] == [MAX_NEW] * 4
        assert [r.generated for r in reqs] == [r.generated for r in jreqs]

    @pytest.mark.parametrize("pool_frames", [None, 3],
                             ids=["exact_fit", "undersized"])
    def test_stats_equal(self, arch, pool_frames):
        (jeng, _), (eng, _) = _run_both(arch, pool_frames)
        assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)
        assert dataclasses.asdict(eng.kv.stats) == \
            dataclasses.asdict(jeng.kv.stats)
        assert eng.stats.prefills == 4
        assert eng.stats.tokens_generated == 4 * MAX_NEW
        if pool_frames is None:
            assert eng.stats.spill_events == 0
            assert eng.stats.fault_page_ins == 0
        else:
            assert eng.stats.spill_events > 0
            assert eng.stats.fault_page_ins > 0
            assert eng.stats.simulated_fault_us > 0

    def test_spilling_changes_no_token(self, arch):
        """The page tables are bookkeeping: an undersized pool must not
        change what is generated."""
        (_, fit), (_, small) = (_run_both(arch, pf)[1] for pf in (None, 3))
        assert [r.generated for r in fit] == [r.generated for r in small]


class TestEngine:
    def _engine(self, **kw):
        cfg = reduced(get_config("h2o_danube_1_8b"), n_layers=2)
        params = model_for(cfg).init_params(cfg, 0, device="cpu")
        return cfg, ServingEngine(cfg, params, max_batch=2, max_len=64,
                                  device="cpu", **kw)

    def test_continuous_batching_completes(self):
        _, eng = self._engine()
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, 100, size=4), max_new_tokens=5)
                for _ in range(4)]
        eng.run_until_done()
        assert all(r.done for r in reqs)
        assert all(len(r.generated) == 5 for r in reqs)
        assert eng.stats.decode_steps > 0
        assert not eng.active and not eng.queue and not eng._seq_caches

    def test_greedy_deterministic(self):
        _, e1 = self._engine()
        _, e2 = self._engine()
        prompt = np.array([5, 6, 7], np.int32)
        r1, r2 = e1.submit(prompt, 6), e2.submit(prompt, 6)
        e1.run_until_done()
        e2.run_until_done()
        assert r1.generated == r2.generated

    def test_pin_all_admission_control(self):
        """pin_all refuses a request that does not fit beside the active
        ones, and admits it once they have finished."""
        _, eng = self._engine(pin_all=True, pool_frames=3)
        a = eng.submit(np.arange(30, dtype=np.int32), 4)     # 3 pages
        b = eng.submit(np.arange(20, dtype=np.int32), 4)     # 2 pages
        eng.step_decode()
        assert [r.req_id for r in eng.active] == [a.req_id]
        eng.run_until_done()
        assert a.done and b.done and eng.stats.spill_events == 0

    def test_sampled_mode_runs_and_is_seeded(self):
        """Non-greedy sampling draws from a generator seeded with the
        decode step: two engines agree with each other (the stream cannot
        match the reference's)."""
        outs = []
        for _ in range(2):
            _, eng = self._engine(sampler=SamplerConfig(temperature=0.8,
                                                        top_k=20, top_p=0.9))
            r = eng.submit(np.array([1, 2, 3], np.int32), 5)
            eng.run_until_done()
            outs.append(r.generated)
        assert outs[0] == outs[1] and len(outs[0]) == 5

    def test_default_device_is_the_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        cfg = reduced(get_config("qwen3_14b"))
        params = model_for(cfg).init_params(cfg, 0, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(cfg, params, max_batch=2, max_len=64)
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(cfg, params, max_batch=2, max_len=64, device=None)


class TestSampler:
    def test_greedy_matches_reference(self):
        rng = np.random.default_rng(3)
        logits = rng.standard_normal((5, 50)).astype(np.float32)
        want = jax_sample_token(jax.numpy.asarray(logits),
                                JaxSamplerConfig(), jax.random.PRNGKey(0))
        got = sample_token(torch.from_numpy(logits), SamplerConfig())
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.5), (5, 0.7)])
    def test_sampled_tokens_stay_in_the_reference_support(self, top_k, top_p):
        """Per distribution: every token the port samples is one the
        reference's top-k / top-p filter keeps."""
        rng = np.random.default_rng(4)
        logits = (rng.standard_normal((4, 40)) * 3).astype(np.float32)
        jcfg = JaxSamplerConfig(temperature=0.7, top_k=top_k, top_p=top_p)
        support = [set() for _ in range(4)]
        for seed in range(200):
            toks = np.asarray(jax_sample_token(
                jax.numpy.asarray(logits), jcfg, jax.random.PRNGKey(seed)))
            for b, t in enumerate(toks):
                support[b].add(int(t))
        gen = torch.Generator().manual_seed(0)
        cfg = SamplerConfig(temperature=0.7, top_k=top_k, top_p=top_p)
        for _ in range(50):
            toks = sample_token(torch.from_numpy(logits), cfg, gen).tolist()
            for b, t in enumerate(toks):
                assert t in support[b] or top_k == 0 and top_p == 1.0


class TestLauncher:
    def test_main_runs_on_cpu(self, capsys):
        t_serve.main(["--device", "cpu", "--requests", "3", "--max-new", "4",
                      "--max-len", "48", "--pool-frames", "4",
                      "--temperature", "0"])
        out = capsys.readouterr().out
        assert out.count("req ") == 3
        assert "prefills=3" in out and "tokens=12" in out

    def test_main_other_arch_and_strategy(self, capsys):
        t_serve.main(["--device", "cpu", "--arch", "h2o_danube_1_8b",
                      "--requests", "2", "--max-new", "3", "--max-len", "32",
                      "--strategy", "kernel_rapf"])
        assert "tokens=6" in capsys.readouterr().out

    def test_main_needs_a_gpu_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            t_serve.main(["--requests", "1"])

    def test_unported_family_is_named(self):
        with pytest.raises(NotImplementedError, match="moe"):
            t_serve.main(["--device", "cpu", "--arch", "mixtral_8x7b"])
