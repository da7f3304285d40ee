"""Port vs reference, the distribution layer: fault tolerance, gradient
compression, the partition rules of every published config, the pipeline,
``constrain`` and the shard-local paged decode.

In one process: fault tolerance and compression on the same numpy inputs
as the reference (exact where the reference is integer), and the specs of
``param_shardings`` / ``cache_shardings`` / ``opt_state_shardings`` leaf by
leaf against the reference's at three abstract meshes — the port's shape
trees on the ``meta`` device, the reference's from ``jax.eval_shape``.

On ``gloo`` over up to four CPU processes (this file run as a script, one
process a rank, rendezvous through a ``file://`` store): ``constrain`` on a
DTensor, ``pipeline_apply`` against sequential layers, and the sharded GQA
and MLA decodes against the port's unsharded calls at f32
``atol = rtol = 2e-5``, their pools exactly.  The unsharded calls are held
to the reference's here too (``TestUnshardedDecode``), so the chain reaches
the reference.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.compression import (compressed_bytes,
                                                 int8_compress,
                                                 int8_decompress,
                                                 topk_compress,
                                                 topk_decompress)
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     StragglerDetector,
                                                     plan_rescale)
from repro_torch.distributed.logical import AbstractMesh

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=2e-5)

# GQA decode shapes: B rows, pages of PS tokens, P_LOCAL frames a data rank
B, H, KVH, D, PS, P_LOCAL, MAX_PAGES = 4, 4, 2, 16, 4, 8, 4
# every row's current token at page offset 1 (decode steps are in lockstep)
LENGTHS = (6, 10, 14, 2)
RKV, ROPE, MLA_H = 32, 8, 4


# ---------------------------------------------------------------------------
# shared inputs (numpy, from a seed)
# ---------------------------------------------------------------------------
def identity_layout_table(n_ranks: int, rows: int = B) -> np.ndarray:
    """Each data rank's rows own pages in its own pool slice, shuffled;
    slots past a row's length unmapped (-1)."""
    rng = np.random.default_rng(7)
    per_rank = rows // n_ranks
    pt = np.full((rows, MAX_PAGES), -1, np.int32)
    for r in range(n_ranks):
        frames = r * P_LOCAL + rng.permutation(P_LOCAL)
        for i in range(per_rank):
            b = r * per_rank + i
            used = -(-LENGTHS[b] // PS)
            pt[b, :used] = frames[i * MAX_PAGES:i * MAX_PAGES + used]
    return pt


def gqa_inputs(n_ranks: int) -> dict:
    rng = np.random.default_rng(0)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q1=n(B, H, D), k1=n(B, KVH, D), v1=n(B, KVH, D),
                k_pool=n(n_ranks * P_LOCAL, PS, KVH, D),
                v_pool=n(n_ranks * P_LOCAL, PS, KVH, D),
                page_table=identity_layout_table(n_ranks),
                lengths=np.asarray(LENGTHS, np.int32))


def mla_inputs(n_ranks: int) -> dict:
    rng = np.random.default_rng(1)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q_abs=n(B, MLA_H, RKV), q_rope=n(B, MLA_H, ROPE),
                c_new=n(B, RKV), kr_new=n(B, ROPE),
                ckv_pool=n(n_ranks * P_LOCAL, PS, RKV),
                krope_pool=n(n_ranks * P_LOCAL, PS, ROPE),
                page_table=identity_layout_table(n_ranks),
                lengths=np.asarray(LENGTHS, np.int32))


def torch_inputs(arrays: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# fault tolerance (a verbatim copy: the reference's tests, on the port)
# ---------------------------------------------------------------------------
class TestFaultTolerance:
    def test_heartbeat_detects_silent_death(self):
        hb = HeartbeatMonitor(4, timeout=10.0)
        for t in (0.0, 5.0):
            for n in range(4):
                hb.beat(n, t)
        hb.beat(0, 12.0)
        hb.beat(1, 12.0)
        hb.beat(2, 12.0)          # node 3 silent since t=5
        assert hb.check(16.0) == [3]
        assert hb.alive_nodes == [0, 1, 2]

    def test_straggler_detection(self):
        sd = StragglerDetector(4, threshold=1.5)
        for _ in range(5):
            for n in range(4):
                sd.record(n, 1.0 if n != 2 else 2.5)
        assert sd.stragglers() == [2]

    def test_rescale_plan_drops_dead_data_slice(self):
        plan = plan_rescale({"data": 16, "model": 16}, dead_nodes=[37])
        assert plan.viable
        assert plan.new_shape == (15, 16)     # one data slice lost
        assert plan.reshard_data_factor == pytest.approx(16 / 15)

    def test_rescale_multi_pod_keeps_pods_when_balanced(self):
        plan = plan_rescale({"pod": 2, "data": 16, "model": 16},
                            dead_nodes=[0, 256])
        assert plan.new_shape == (2, 15, 16)

    def test_plans_equal_the_reference(self):
        from repro.distributed import fault_tolerance as ref
        for shape, dead in (({"data": 16, "model": 16}, [37]),
                            ({"pod": 2, "data": 16, "model": 16}, [0, 256]),
                            ({"data": 4, "model": 2}, [0, 1, 2, 3, 4, 5]),
                            ({"pod": 2, "data": 4, "model": 2}, [3, 9])):
            got = plan_rescale(shape, dead_nodes=dead)
            want = ref.plan_rescale(shape, dead_nodes=dead)
            assert got.__dict__ == want.__dict__, (shape, dead)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "b": {"w": rng.standard_normal((16, 4)).astype(np.float32),
                  "s": np.ones((4,), np.float32)}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _to_jax(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _flat(tree, prefix=""):
    """name -> numpy array of a nested dict (tuples indexed)."""
    if isinstance(tree, dict):
        return {n: a for k in sorted(tree)
                for n, a in _flat(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, tuple):
        return {n: a for i, t in enumerate(tree)
                for n, a in _flat(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


class TestCompression:
    def test_int8_error_feedback_converges(self):
        """Compressed-sum with error feedback tracks the true sum."""
        g = torch.from_numpy(
            np.random.default_rng(0).standard_normal((64, 64))
            .astype(np.float32))
        residual = None
        acc_true = torch.zeros((64, 64))
        acc_comp = torch.zeros((64, 64))
        for i in range(20):
            gi = {"w": g * (1 + 0.01 * i)}
            comp, residual = int8_compress(gi, residual)
            acc_comp += int8_decompress(comp)["w"]
            acc_true += gi["w"]
        err = (acc_comp - acc_true).abs().max() / acc_true.abs().max()
        assert float(err) < 0.02

    def test_int8_wire_bytes_4x_smaller(self):
        g = {"w": torch.ones((128, 128), dtype=torch.float32)}
        comp, _ = int8_compress(g)
        assert compressed_bytes(comp.values) * 4 <= compressed_bytes(g)

    def test_topk_keeps_largest(self):
        g = {"w": torch.from_numpy(
            np.linspace(-1, 1, 100).reshape(10, 10).astype(np.float32))}
        comp, res = topk_compress(g, k_fraction=0.1)
        dec = topk_decompress(comp, g)
        nz = np.nonzero(dec["w"].numpy().ravel())[0]
        assert len(nz) == 10
        mags = np.abs(np.linspace(-1, 1, 100))
        assert set(nz) == set(np.argsort(-mags)[:10])

    def test_int8_equals_the_reference(self):
        """Three steps of error feedback: int8 values and their bytes
        exactly, scales, residuals and decompressed values at f32."""
        from repro.distributed import compression as ref
        t_res = j_res = None
        for step in range(3):
            g = _grads(step)
            t_comp, t_res = int8_compress(_to_torch(g), t_res)
            j_comp, j_res = ref.int8_compress(_to_jax(g), j_res)
            tv, jv = _flat(t_comp.values), _flat(j_comp.values)
            assert tv.keys() == jv.keys()
            for k in tv:
                assert tv[k].dtype == jv[k].dtype == np.int8
                np.testing.assert_array_equal(tv[k], jv[k])
            for got, want in ((t_comp.scales, j_comp.scales),
                              (t_res, j_res),
                              (int8_decompress(t_comp),
                               ref.int8_decompress(j_comp))):
                got, want = _flat(got), _flat(want)
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], **TOL)
            assert compressed_bytes(t_comp) == ref.compressed_bytes(j_comp)

    def test_int8_rounds_half_to_even(self):
        """``torch.round`` and ``jnp.round`` both round x.5 to even: a leaf
        whose scaled values land on halves gives the reference's ints."""
        from repro.distributed import compression as ref
        g = {"w": np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5],
                             np.float32)}
        t = int8_compress(_to_torch(g))[0].values["w"].numpy()
        j = np.asarray(ref.int8_compress(_to_jax(g))[0].values["w"])
        np.testing.assert_array_equal(t, j)

    @pytest.mark.parametrize("k_fraction", [0.01, 0.1, 0.37])
    def test_topk_equals_the_reference(self, k_fraction):
        """Same indices (int32), values, residuals and decompressed trees
        over two steps of error feedback."""
        from repro.distributed import compression as ref
        t_res = j_res = None
        for step in range(2):
            g = _grads(10 + step)
            t_comp, t_res = topk_compress(_to_torch(g), k_fraction, t_res)
            j_comp, j_res = ref.topk_compress(_to_jax(g), k_fraction, j_res)
            tc, jc = _flat(t_comp), _flat(j_comp)
            assert tc.keys() == jc.keys()
            for k in jc:
                if k.endswith("/0"):
                    assert tc[k].dtype == jc[k].dtype == np.int32
                    np.testing.assert_array_equal(tc[k], jc[k])
                else:
                    np.testing.assert_array_equal(tc[k], jc[k])
            for got, want in ((t_res, j_res),
                              (topk_decompress(t_comp, _to_torch(g)),
                               ref.topk_decompress(j_comp, _to_jax(g)))):
                got, want = _flat(got), _flat(want)
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], **TOL)
            assert compressed_bytes(t_comp) == ref.compressed_bytes(j_comp)

    def test_topk_ties_take_the_lower_index_first(self):
        """Equal magnitudes at the cut: both packages keep, among them, the
        lowest flat indices, in index order (``jax.lax.top_k`` is stable;
        the port sorts stably)."""
        from repro.distributed import compression as ref
        w = np.asarray([0.5, -1.0, 0.5, 1.0, -0.5, 0.25, 1.0, 0.5, -0.5,
                        0.5], np.float32)
        t = topk_compress({"w": torch.from_numpy(w)}, 0.5)[0]["w"]
        j = ref.topk_compress(_to_jax({"w": w}), 0.5)[0]["w"]
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
        np.testing.assert_array_equal(t[0].numpy(), [1, 3, 6, 0, 2])
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))


# ---------------------------------------------------------------------------
# partition rules: every published config, three meshes
# ---------------------------------------------------------------------------
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHES = ((4, 2048), (1, 524288))     # (batch, max_len); 1: the long_500k path


@pytest.fixture(scope="module")
def shape_trees():
    """arch -> (reference params, port params, reference caches, port
    caches, reference opt state, port opt state): reference shapes from
    ``jax.eval_shape``, the port's tensors on the ``meta`` device."""
    import jax
    from repro.configs import all_configs as ref_configs
    from repro.models import registry as ref_registry
    from repro.optim import adamw as ref_adamw
    from repro_torch.configs import all_configs
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    out = {}
    for arch, cfg in all_configs().items():
        rcfg = ref_configs()[arch]
        rmod, tmod = ref_registry.model_for(rcfg), registry.model_for(cfg)
        rp = jax.eval_shape(
            lambda: rmod.init_params(rcfg, jax.random.PRNGKey(0)))
        tp = tmod.init_params(cfg, 0, device="meta")
        rc = {b: jax.eval_shape(
            lambda b=b, m=m: rmod.init_decode_cache(rcfg, b, m))
            for b, m in CACHES}
        tc = {b: tmod.init_decode_cache(cfg, b, m, device="meta")
              for b, m in CACHES}
        ro = jax.eval_shape(lambda: ref_adamw.init(ref_adamw.AdamWConfig(),
                                                   rp))
        to = adamw.init(adamw.AdamWConfig(), tp)
        out[arch] = (rp, tp, rc, tc, ro, to)
    return out


def _ref_specs(tree):
    import jax
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(tree)]


def _port_specs(tree):
    from repro_torch.tree import tree_leaves
    return [tuple(s.spec) for s in tree_leaves(tree)]


def _meshes(name):
    from jax.sharding import AbstractMesh as RefAbstractMesh
    sizes, names = MESHES[name]
    return RefAbstractMesh(sizes, names), AbstractMesh(sizes, names)


class TestShardingSpecs:
    def test_port_trees_are_the_reference_s(self, shape_trees):
        """Same leaf paths and shapes, the one difference the port keeps
        (the sLSTM cache leaves' leading axis) aside."""
        import jax
        from repro.distributed.sharding import _path_str as ref_path_str
        from repro_torch.tree import tree_leaves, tree_names
        for arch, (rp, tp, rc, tc, _, _) in shape_trees.items():
            for ref, port in [(rp, tp)] + [(rc[b], tc[b]) for b, _ in CACHES]:
                flat = jax.tree_util.tree_flatten_with_path(ref)[0]
                want = [(ref_path_str(p), tuple(x.shape)) for p, x in flat]
                got = [(n, tuple(x.shape)[1:] if tuple(x.shape)[:1] == (1,)
                        and len(x.shape) == 3 and arch == "xlstm_125m"
                        and n.split("/")[-1] in "cnhm" else tuple(x.shape))
                       for n, x in zip(tree_names(port), tree_leaves(port))]
                assert got == want, arch
                assert {x.device.type for x in tree_leaves(port)} == {"meta"}

    @pytest.mark.parametrize("zero3", [False, True])
    @pytest.mark.parametrize("mesh", list(MESHES))
    def test_param_and_opt_state_specs(self, shape_trees, mesh, zero3):
        from repro.distributed import sharding as ref
        from repro_torch.distributed import sharding
        ref_mesh, port_mesh = _meshes(mesh)
        for arch, (rp, tp, _, _, ro, to) in shape_trees.items():
            r = ref.param_shardings(rp, ref_mesh, zero3=zero3)
            t = sharding.param_shardings(tp, port_mesh, zero3=zero3)
            assert _port_specs(t) == _ref_specs(r), arch
            ro_sh = ref.opt_state_shardings(ro, r, ref_mesh)
            to_sh = sharding.opt_state_shardings(to, t, port_mesh)
            assert tuple(to_sh.step.spec) == tuple(ro_sh.step.spec) == ()
            for part in ("mu", "nu"):
                assert _port_specs(getattr(to_sh, part)) == \
                    _ref_specs(getattr(ro_sh, part)), (arch, part)

    @pytest.mark.parametrize("mesh", list(MESHES))
    def test_cache_specs(self, shape_trees, mesh):
        """Equal leaf by leaf; an sLSTM leaf, ``(1, B, d)`` in the port,
        carries the reference's spec behind ``None``, so its batch entry
        sits on the port's axis 1."""
        from repro.distributed import sharding as ref
        from repro_torch.distributed import sharding
        from repro_torch.tree import tree_leaves, tree_names
        ref_mesh, port_mesh = _meshes(mesh)
        n_slstm = 0
        for arch, (_, _, rc, tc, _, _) in shape_trees.items():
            for batch, _ in CACHES:
                want = _ref_specs(ref.cache_shardings(rc[batch], ref_mesh,
                                                      batch))
                got = _port_specs(sharding.cache_shardings(
                    tc[batch], port_mesh, batch))
                leaves = tree_leaves(tc[batch])
                for name, leaf, g, w in zip(tree_names(tc[batch]), leaves,
                                            got, want):
                    if arch == "xlstm_125m" and len(leaf.shape) == 3 \
                            and leaf.shape[0] == 1 and len(w) == 2:
                        n_slstm += 1
                        assert g[0] is None and g[1:] == w, (arch, name)
                    else:
                        assert g == w, (arch, batch, name)
        assert n_slstm == 16          # 2 sLSTM segments x 4 leaves x 2 batches

    @pytest.mark.parametrize("mesh", list(MESHES))
    def test_batch_and_token_specs(self, mesh):
        from repro.distributed import sharding as ref
        from repro_torch.distributed import sharding
        ref_mesh, port_mesh = _meshes(mesh)
        assert tuple(sharding.batch_spec(port_mesh)) == \
            tuple(ref.batch_spec(ref_mesh))
        for shardable in (True, False):
            assert tuple(sharding.token_sharding(
                port_mesh, shardable_batch=shardable).spec) == tuple(
                ref.token_sharding(ref_mesh,
                                   shardable_batch=shardable).spec)

    def test_logical_spec_for_equals_the_reference(self):
        from repro.distributed import logical as ref
        from repro_torch.distributed import logical
        rules = {"batch": ("pod", "data"), "heads": "model",
                 "kv_heads": "model", "seq": None, "embed": "model"}
        ref_mesh, port_mesh = _meshes("2x16x16")
        for shape, names in (((64, 128, 32, 128), ("batch", "seq", "heads",
                                                   "head_dim")),
                             ((32, 1, 8, 128), ("batch", "seq", "kv_heads",
                                                "head_dim")),
                             ((3, 7, 24, 64), ("batch", "seq", "heads",
                                               "embed"))):
            with ref.logical_rules(ref_mesh, rules):
                want = tuple(ref.spec_for(shape, names))
            with logical.logical_rules(port_mesh, rules):
                assert tuple(logical.spec_for(shape, names)) == want
                assert logical.current_mesh() is port_mesh
                assert logical.rule("heads") == "model"
            assert logical.current_mesh() is None
            assert logical.spec_for(shape, names) is None


# ---------------------------------------------------------------------------
# the unsharded decode: the end of the chain held to the reference
# ---------------------------------------------------------------------------
class TestUnshardedDecode:
    def test_gqa_without_a_mesh_equals_the_reference(self):
        import jax.numpy as jnp
        from repro.models import attention as ref
        from repro_torch.models import attention
        a = gqa_inputs(2)
        for window in (0, 6):
            want = ref._paged_update_and_attend_dist(
                *(jnp.asarray(a[k]) for k in a), window)
            t = torch_inputs(a)
            got = attention._paged_update_and_attend_dist(*t.values(),
                                                          window)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    def test_mla_without_a_mesh_equals_the_reference(self):
        import jax.numpy as jnp
        from repro.models import mla as ref
        from repro_torch.models import mla
        a = mla_inputs(2)
        want = ref._mla_update_and_attend_dist(
            *(jnp.asarray(a[k]) for k in a), scale=0.125)
        got = mla._mla_update_and_attend_dist(*torch_inputs(a).values(),
                                              scale=0.125)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    def test_plain_tensors_under_an_abstract_mesh_take_the_local_body(self):
        from repro_torch.distributed.logical import logical_rules
        from repro_torch.models import attention
        t, u = torch_inputs(gqa_inputs(2)), torch_inputs(gqa_inputs(2))
        with logical_rules(AbstractMesh((2, 2), ("data", "model")),
                           {"batch": "data"}):
            got = attention._paged_update_and_attend_dist(*t.values(), 0)
        want = attention._paged_update_and_attend(*u.values(), 0)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_chip_phase_runs_on_the_cpu_at_reduced_width(capsys):
    """``chip_smoke.py``'s ``dist_local`` phase at reduced width: on the CPU
    every call is the plain version, so no launch is counted."""
    import chip_smoke
    sz = chip_smoke.Sizes(full_width=False)
    table = [{"name": "paged_attention"}]
    chip_smoke.phase_dist_local(torch.device("cpu"), sz,
                                chip_smoke._arch_config(sz, sz.arch), table)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "dist_local" and line["pools_equal"]
    assert line["bit_identical_to_unsharded"]
    assert line["rank_offsets_bytes"][0] == 0 < line["rank_offsets_bytes"][1]
    rank1 = line["page_table"][line["batch"] // 2:]
    assert min(f for row in rank1 for f in row if f >= 0) \
        >= line["frames_per_rank"]
    assert table[0]["launches_by_path"] == {"dist_local": 0}


# ---------------------------------------------------------------------------
# multi-rank: gloo, one process a rank
# ---------------------------------------------------------------------------
def _run_ranks(mode: str, world: int, tmp_path) -> dict:
    """Run this file as ``world`` rank processes in ``mode``; every rank
    prints one JSON object of check -> error text ("" when it passed)."""
    store = tmp_path / f"store_{mode}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(world), str(store)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    results = {}
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
            results[r] = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def _check(results: dict, name: str) -> None:
    errors = {r: res[name] for r, res in results.items() if res[name]}
    assert not errors, errors


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    return _run_ranks("mesh_2x2", 4, tmp_path_factory.mktemp("gloo"))


class TestMultiRank:
    def test_constrain_redistributes_a_dtensor(self, mesh_2x2):
        _check(mesh_2x2, "constrain")

    def test_gqa_decode_2_data_x_2_model(self, mesh_2x2):
        _check(mesh_2x2, "gqa")

    def test_mla_decode_2_data_x_2_model(self, mesh_2x2):
        _check(mesh_2x2, "mla")

    def test_gqa_decode_2_data_x_1(self, tmp_path):
        _check(_run_ranks("mesh_2x1", 2, tmp_path), "gqa")

    def test_pipeline_over_4_stages(self, tmp_path):
        _check(_run_ranks("pipeline", 4, tmp_path), "pipeline")


# ---- the rank process ------------------------------------------------------
def _rank_checks(mode: str, rank: int, world: int, store: str) -> dict:
    import datetime
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        if mode == "pipeline":
            mesh = init_device_mesh("cpu", (world,),
                                    mesh_dim_names=("stage",))
            checks = {"pipeline": _pipeline_check}
        else:
            n_data = 2
            mesh = init_device_mesh("cpu", (n_data, world // n_data),
                                    mesh_dim_names=("data", "model"))
            checks = {"gqa": _gqa_check}
            if mode == "mesh_2x2":
                checks.update(constrain=_constrain_check, mla=_mla_check)
        out = dict.fromkeys(checks, "not run: an earlier check failed")
        for name, fn in checks.items():
            try:
                fn(mesh)
                out[name] = ""
            except Exception:       # reported; the peers' collectives fail
                out[name] = traceback.format_exc()[-2000:]
                break
        return out
    finally:
        dist.destroy_process_group()


def _dtensors(mesh, arrays: dict, sharded: set) -> dict:
    """Replicated DTensors, but those named in ``sharded``, which start on
    rows over ``data``: the region redistributes either."""
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    return {k: distribute_tensor(
        v, mesh, [Shard(0) if k in sharded else Replicate(), Replicate()])
        for k, v in torch_inputs(arrays).items()}


def _constrain_check(mesh) -> None:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed.logical import constrain, logical_rules
    full = torch.arange(4 * 6 * 4 * 8, dtype=torch.float32).reshape(4, 6, 4,
                                                                     8)
    x = distribute_tensor(full, mesh, [Replicate(), Replicate()])
    names = ("batch", "seq", "heads", "head_dim")
    assert constrain(x, *names) is x                      # no policy
    with logical_rules(mesh, {"batch": "data", "heads": "model"}):
        y = constrain(x, *names)
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert tuple(y.to_local().shape) == (2, 6, 2, 8)
        assert torch.equal(y.full_tensor(), full)
        assert constrain(full, *names) is full            # a plain tensor
        assert constrain(x, "batch", "seq") is x          # rank mismatch
    with logical_rules(mesh, {"batch": "model", "heads": "model"}):
        z = constrain(x, *names)                          # model once only
        assert tuple(z.placements) == (Replicate(), Shard(0))
    with logical_rules(AbstractMesh((2, 2), ("data", "model")),
                       {"batch": "data"}):
        assert constrain(x, *names) is x


def _gqa_check(mesh) -> None:
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.models import attention
    n_model = mesh.size(1)
    for window in (0, 6):
        a = gqa_inputs(2)
        want = attention._paged_update_and_attend(
            *torch_inputs(a).values(), window)
        x = _dtensors(mesh, a, {"k_pool", "page_table"})
        # the write slots the decoder makes from the whole table: the
        # shard-local body must not use them
        slots = attention.paged_write_slots(
            torch.from_numpy(a["page_table"]), torch.from_numpy(a["lengths"]),
            PS)
        with logical_rules(mesh, {"batch": "data"}):
            got = attention._paged_update_and_attend_dist(
                *x.values(), window, slots)
        assert all(isinstance(g, DTensor) for g in got)
        assert tuple(got[0].placements) == (Shard(0), Shard(1))
        assert tuple(got[1].to_local().shape) == (P_LOCAL, PS,
                                                  KVH // n_model, D)
        torch.testing.assert_close(got[0].full_tensor(), want[0], **TOL)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g.full_tensor(), w)


def _mla_check(mesh) -> None:
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.models import mla
    a = mla_inputs(2)
    want = mla._mla_update_and_attend(*torch_inputs(a).values(), scale=0.125)
    x = _dtensors(mesh, a, {"ckv_pool", "q_abs"})
    with logical_rules(mesh, {"batch": "data"}):
        got = mla._mla_update_and_attend_dist(*x.values(), scale=0.125)
    assert all(isinstance(g, DTensor) for g in got)
    assert tuple(got[0].placements) == (Shard(0), Shard(1))
    assert tuple(got[1].placements) == (Shard(0), Replicate())
    torch.testing.assert_close(got[0].full_tensor(), want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.full_tensor(), w)


def _pipeline_check(mesh) -> None:
    from repro_torch.distributed.pipeline import pipeline_apply
    rng = np.random.default_rng(0)
    L, Dm = 8, 16
    ws = torch.from_numpy((rng.standard_normal((L, Dm, Dm)) * 0.3)
                          .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((6, 4, Dm)).astype(np.float32))

    def layer_fn(w, h):
        return torch.tanh(h @ w)

    out = pipeline_apply(layer_fn, ws, x, mesh)
    ref = x
    for i in range(L):
        ref = torch.tanh(ref @ ws[i])
    torch.testing.assert_close(out, ref, **TOL)
    tree = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                          {"w": ws, "b": ws[:, 0]}, x, mesh)
    ref = x
    for i in range(L):
        ref = torch.tanh(ref @ ws[i] + ws[i, 0])
    torch.testing.assert_close(tree, ref, **TOL)


if __name__ == "__main__":
    mode, rank, world, store = sys.argv[1:5]
    print(json.dumps(_rank_checks(mode, int(rank), int(world), store)))
