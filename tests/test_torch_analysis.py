"""Port vs reference, the launch and analysis tooling: the twins of
``tests/test_analysis.py`` and of ``TestDryRunMachinery``.

* ``analysis/hlo.py`` is a verbatim copy: fed the reference's compiled HLO
  text it gives the reference's numbers.  ``analysis/trace.py`` is the
  port's counterpart: the same four functions written in torch give the
  reference's dot FLOPs, and on a fake (2 x 4) mesh a sharded matmul
  counts one rank's FLOPs and its all-reduce operand.
* ``launch/specs.py`` gives the reference's ``jax.eval_shape`` trees for
  every config and shape; ``launch/mesh.py`` the production meshes over a
  fake group, and abstract ones without; ``launch/dryrun.py`` the
  reference's logical rules, and its cells run in two subprocesses.
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

from repro_torch.analysis.hlo import analyze_hlo, shape_bytes, shape_elems
from repro_torch.analysis.trace import analyze_trace
from repro_torch.distributed.logical import (AbstractMesh, constrain,
                                             logical_rules, spec_for)

ROOT = Path(__file__).resolve().parents[1]


class TestShapeParsing:
    def test_shape_bytes(self):
        assert shape_bytes("f32[256,512]") == 256 * 512 * 4
        assert shape_bytes("bf16[8,128]{1,0}") == 8 * 128 * 2
        assert shape_bytes("(f32[4], s32[2,2])") == 16 + 16
        assert shape_bytes("pred[]") == 1

    def test_shape_elems(self):
        assert shape_elems("f32[3,5,7]") == 105


# ---------------------------------------------------------------------------
# the four functions of the reference's TestAnalyzeHLO, in both packages
# ---------------------------------------------------------------------------
B_SCAN, D_SCAN = 64, 32
B_NEST, D_NEST, L_NEST = 16, 8, 4


def _jax_cases():
    """name -> (reference's compiled HLO text, analytic dot FLOPs)."""
    import jax
    import jax.numpy as jnp

    def scan(x, ws):
        return jax.lax.scan(lambda c, w: (c @ w, None), x, ws)[0]

    def nested(x, ws):
        def outer(c, w):
            inner = lambda ci, _: (ci @ w, None)  # noqa: E731
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, ws)[0]

    def hlo(fn, *shapes):
        return jax.jit(fn).lower(*(jnp.zeros(s) for s in shapes)) \
            .compile().as_text()

    cases = {"matmul": (hlo(lambda a, b: a @ b, (128, 64), (64, 32)),
                        2 * 128 * 64 * 32),
             "aat": (hlo(lambda a: a @ a.T, (32, 32)), 2 * 32 ** 3),
             "nested": (hlo(nested, (B_NEST, D_NEST),
                            (L_NEST, D_NEST, D_NEST)),
                        L_NEST * 3 * 2 * B_NEST * D_NEST * D_NEST)}
    for L in (2, 4, 8):
        cases[f"scan{L}"] = (hlo(scan, (B_SCAN, D_SCAN),
                                 (L, D_SCAN, D_SCAN)),
                             L * 2 * B_SCAN * D_SCAN * D_SCAN)
    return cases


def _torch_case(name: str):
    """The same function in torch: (fn, args)."""
    z = torch.zeros
    if name == "matmul":
        return (lambda a, b: a @ b), (z(128, 64), z(64, 32))
    if name == "aat":
        return (lambda a: a @ a.T), (z(32, 32),)
    if name == "nested":
        def nested(x, ws):
            for w in ws:
                for _ in range(3):
                    x = x @ w
            return x
        return nested, (z(B_NEST, D_NEST), z(L_NEST, D_NEST, D_NEST))
    L = int(name[len("scan"):])

    def scan(x, ws):
        for w in ws:
            x = x @ w
        return x
    return scan, (z(B_SCAN, D_SCAN), z(L, D_SCAN, D_SCAN))


@pytest.fixture(scope="module")
def jax_cases():
    return _jax_cases()


CASES = ("matmul", "aat", "nested", "scan2", "scan4", "scan8")


class TestAnalyzeHLO:
    @pytest.mark.parametrize("name", CASES)
    def test_copy_reads_the_reference_hlo_as_the_reference(self, jax_cases,
                                                           name):
        from repro.analysis.hlo import analyze_hlo as ref_analyze_hlo
        text, analytic = jax_cases[name]
        got, want = analyze_hlo(text), ref_analyze_hlo(text)
        assert got.__dict__ == want.__dict__
        assert got.dot_flops == pytest.approx(analytic, rel=0.01)

    @pytest.mark.parametrize("name", CASES)
    def test_trace_gives_the_reference_dot_flops(self, jax_cases, name):
        from repro.analysis.hlo import analyze_hlo as ref_analyze_hlo
        text, analytic = jax_cases[name]
        fn, args = _torch_case(name)
        res = analyze_trace(fn, *args)
        assert res.dot_flops == pytest.approx(
            ref_analyze_hlo(text).dot_flops, rel=0.01)
        assert res.dot_flops == pytest.approx(analytic, rel=0.01)
        assert res.collective_bytes == 0.0 and res.collective_count == 0
        n_in = sum(a.numel() for a in args) * 4
        assert res.hbm_bytes >= n_in

    def test_trace_under_fake_tensors(self):
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            a, b = torch.empty(4096, 5120), torch.empty(5120, 17408)
            res = analyze_trace(lambda x, y: x @ y, a, b)
        assert res.dot_flops == 2 * 4096 * 5120 * 17408


def test_sharded_matmul_counts_one_rank():
    """Rows over ``data``, the contraction over ``model``: each of the 8
    ranks does an eighth of the product, then one all-reduce over
    ``model`` of its (32, 256) partial sums.  ``FlopCounterMode`` over the
    same DTensors reads the global product (the trap the counter avoids)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.dryrun import fake_world
    M, K, N = 64, 512, 256
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        a = DTensor.from_local(torch.zeros(M // 2, K // 4), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        b = DTensor.from_local(torch.zeros(K // 4, N), mesh,
                               [Replicate(), Shard(0)], run_check=False)

        def step(x, y):
            return (x @ y).redistribute(mesh, [Shard(0), Replicate()])

        res = analyze_trace(step, a, b)
        with FlopCounterMode(display=False) as fc:
            step(a, b)
    assert res.dot_flops * 8 == 2 * M * K * N
    assert fc.get_total_flops() == 2 * M * K * N
    local_out = (M // 2) * N * 4
    assert res.collective_bytes == local_out
    assert res.collective_breakdown == {"all-reduce": local_out}
    assert res.collective_count == 1


# ---------------------------------------------------------------------------
# logical rules: the reference's cases that tests/test_torch_distributed.py
# does not twin
# ---------------------------------------------------------------------------
class TestLogicalRules:
    def _mesh(self):
        return AbstractMesh((1, 1), ("data", "model"))

    def test_noop_without_policy(self):
        x = torch.ones((4, 8))
        assert constrain(x, "batch", "embed") is x

    def test_divisibility_drops_axis(self):
        with logical_rules(self._mesh(), {"heads": "model",
                                          "batch": "data"}):
            # heads=24 % model size 1 == 0 -> kept (size-1 axis trivially ok)
            spec = spec_for((2, 24), ("batch", "heads"))
            assert spec is not None
            assert tuple(spec) == ("data", "model")

    def test_duplicate_axis_never_emitted(self):
        """The deepseek DuplicateSpecError regression."""
        with logical_rules(self._mesh(), {"experts": ("model", "data"),
                                          "moe_ff": "model"}):
            spec = spec_for((4, 8, 16), ("experts", "capacity", "moe_ff"))
            flat = []
            for s in spec:
                flat.extend(s if isinstance(s, tuple) else [s])
            named = [a for a in flat if a]
            assert len(named) == len(set(named))

    def test_wrong_rank_is_noop(self):
        with logical_rules(self._mesh(), {"batch": "data"}):
            x = torch.ones((4, 8, 2))
            assert constrain(x, "batch", "embed") is x


# ---------------------------------------------------------------------------
# launch/specs.py: every config, every shape
# ---------------------------------------------------------------------------
def _ref_tree(tree) -> list:
    import jax
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    from repro.distributed.sharding import _path_str
    return [(_path_str(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in flat]


def _port_tree(tree, slstm: bool = False) -> list:
    from repro_torch.tree import tree_leaves, tree_names
    out = []
    for n, x in zip(tree_names(tree), tree_leaves(tree)):
        assert x.device.type == "meta", n
        shape = tuple(x.shape)
        # the port's sLSTM cache leaves are (1, B, d), the reference's (B, d)
        if slstm and len(shape) == 3 and shape[0] == 1 \
                and n.split("/")[-1] in ("c", "n", "h", "m"):
            shape = shape[1:]
        out.append((n, shape, str(x.dtype).split(".")[-1]))
    return out


ARCHS = ("chameleon_34b", "codeqwen15_7b", "deepseek_v3_671b",
         "h2o_danube_1_8b", "mixtral_8x7b", "qwen3_14b", "starcoder2_3b",
         "whisper_medium", "xlstm_125m", "zamba2_7b")


class TestSpecs:
    def test_the_archs_are_the_configs(self):
        from repro_torch.configs import ARCH_IDS
        assert sorted(ARCH_IDS) == sorted(ARCHS)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_input_and_param_specs_equal_the_reference(self, arch):
        from repro.configs import get_config as ref_get_config
        from repro.configs.shapes import SHAPES as REF_SHAPES
        from repro.launch import specs as ref_specs
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import SHAPES
        from repro_torch.launch import specs
        rcfg, cfg = ref_get_config(arch), get_config(arch)
        assert sorted(SHAPES) == sorted(REF_SHAPES)
        for name in SHAPES:
            want = ref_specs.input_specs(rcfg, REF_SHAPES[name])
            got = specs.input_specs(cfg, SHAPES[name])
            assert got.kind == want.kind == SHAPES[name].kind
            assert [(tuple(a.shape), str(a.dtype).split(".")[-1])
                    for a in got.args] == \
                [(tuple(a.shape), np.dtype(a.dtype).name) for a in want.args]
            assert (got.cache is None) == (want.cache is None)
            if want.cache is not None:
                assert _port_tree(got.cache, slstm=arch == "xlstm_125m") \
                    == _ref_tree(want.cache), (arch, name)
        assert _port_tree(specs.params_specs(cfg)) == \
            _ref_tree(ref_specs.params_specs(rcfg))


# ---------------------------------------------------------------------------
# launch/mesh.py and compat.py
# ---------------------------------------------------------------------------
class TestMesh:
    def test_without_a_group_the_meshes_are_abstract(self):
        from repro_torch.launch.mesh import (make_local_mesh,
                                             make_production_mesh)
        single = make_production_mesh()
        multi = make_production_mesh(multi_pod=True)
        assert isinstance(single, AbstractMesh)
        assert single.shape == {"data": 16, "model": 16}
        assert multi.shape == {"pod": 2, "data": 16, "model": 16}
        assert make_local_mesh().shape == {"data": 1, "model": 1}

    @pytest.mark.parametrize("multi", [False, True])
    def test_over_a_fake_group_the_mesh_is_a_device_mesh(self, multi):
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import (make_local_mesh,
                                             make_production_mesh)
        n = 512 if multi else 256
        with fake_world(n):
            mesh = make_production_mesh(multi_pod=multi)
            assert isinstance(mesh, DeviceMesh) and mesh.size() == n
            assert mesh.mesh_dim_names == (("pod",) if multi else ()) + (
                "data", "model")
            local = make_local_mesh(model=16)
            assert tuple(local.shape) == (n // 16, 16)
        assert not torch.distributed.is_initialized()

    def test_constants_are_the_h100_data_sheet(self):
        from repro.launch import mesh as ref_mesh
        from repro_torch.launch import mesh
        assert mesh.PEAK_FLOPS_BF16 == 989e12
        assert mesh.HBM_BW == 3.35e12
        assert mesh.HBM_PER_CHIP == 80e9
        assert mesh.ICI_BW_PER_LINK == 50e9
        for name in ("PEAK_FLOPS_BF16", "HBM_BW", "HBM_PER_CHIP"):
            assert getattr(mesh, name) != getattr(ref_mesh, name)   # not a TPU's

    def test_compat_helpers(self):
        from repro_torch.analysis.hlo import HLOAnalysis
        from repro_torch.compat import axis_types_kwargs, cost_analysis_dict
        assert axis_types_kwargs(3) == {}
        ana = HLOAnalysis(dot_flops=5.0, hbm_bytes=7.0)
        assert cost_analysis_dict(ana) == {"flops": 5.0,
                                           "bytes accessed": 7.0}


# ---------------------------------------------------------------------------
# launch/dryrun.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sizes", [(16, 16), (2, 16, 16)])
def test_logical_rules_for_equal_the_reference(arch, sizes):
    from jax.sharding import AbstractMesh as RefAbstractMesh
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import logical_rules_for
    names = ("pod", "data", "model")[-len(sizes):]
    ref = _ref_logical_rules_for(ref_get_config(arch),
                                 RefAbstractMesh(sizes, names))
    assert logical_rules_for(get_config(arch),
                             AbstractMesh(sizes, names)) == ref


def _ref_logical_rules_for(cfg, mesh):
    """The reference's ``logical_rules_for``: its module sets the host
    device count at import, so the function is read from its source and
    run here without importing the module."""
    import ast
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "logical_rules_for")
    ns: dict = {}
    exec(compile(ast.Module([fn], []), "dryrun.py", "exec"), ns)
    return ns["logical_rules_for"](cfg, mesh)


DRYRUN_SMOKE = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
out = {}
for cell in sys.argv[1:]:
    arch, shape, mesh = cell.split("/")
    rec = run_cell(arch, shape, multi_pod=mesh == "multi", save=False)
    rec.pop("traceback", None)
    out[f"{arch}/{shape}"] = rec
print(json.dumps(out, default=str))
"""
#: the cells, in two subprocesses run side by side: the train cell alone
DRYRUN_CELLS = (("starcoder2_3b/train_4k/single",),
                ("codeqwen15_7b/decode_32k/multi", "zamba2_7b/decode_32k/multi",
                 "xlstm_125m/decode_32k/multi"))


@pytest.fixture(scope="module")
def dryrun_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", DRYRUN_SMOKE, *cells],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for cells in DRYRUN_CELLS]
    out = {}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=900)
            assert p.returncode == 0, stdout[-500:] + stderr[-3000:]
            out.update(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


class TestDryRunMachinery:
    def test_multipod_decode_cell_traces_on_512_devices(self, dryrun_cells):
        rec = dryrun_cells["codeqwen15_7b/decode_32k"]
        assert rec["status"] == "ok", rec.get("error")
        assert rec["n_devices"] == 512
        assert rec["mesh"] == "pod2x16x16" and rec["traced_path"] == "plain"
        assert rec["per_device_bytes"] > 0
        # per device, not global: 512 ranks' FLOPs at least the model's,
        # one rank's far below it
        assert 0 < rec["hlo_dot_flops_per_dev"] * 16 \
            < rec["model_flops_total"] \
            <= rec["hlo_dot_flops_per_dev"] * 512
        assert rec["hlo_collective_bytes_per_dev"] > 0
        assert rec["lower_s"] == rec["compile_s"] > 0

    def test_single_pod_train_cell(self, dryrun_cells):
        rec = dryrun_cells["starcoder2_3b/train_4k"]
        assert rec["status"] == "ok", rec.get("error")
        assert rec["n_devices"] == 256 and rec["mesh"] == "pod16x16"
        assert rec["logical_rules"]["q_seq"] == "model"   # 24 heads
        assert 0 < rec["hlo_dot_flops_per_dev"] * 16 \
            < rec["model_flops_total"] \
            <= rec["hlo_dot_flops_per_dev"] * 256
        assert set(rec["collective_breakdown"]) <= {
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"}

    def test_a_family_not_yet_sharded_records_its_error(self,
                                                         dryrun_cells):
        """The hybrid family's multi-pod decode cell (named from before
        A3c, when the family did not run under DTensor and its cell
        recorded ``status: "error"``): it traces, with per-device FLOPs,
        bytes and collective bytes."""
        rec = dryrun_cells["zamba2_7b/decode_32k"]
        assert rec["status"] == "ok", rec.get("error")
        assert rec["mesh"] == "pod2x16x16" and rec["kind"] == "decode"
        assert rec["n_devices"] == 512
        assert rec["hlo_dot_flops_per_dev"] > 0
        assert rec["hlo_hbm_bytes_per_dev"] > 0
        assert rec["per_device_bytes"] > 0
        assert rec["hlo_collective_bytes_per_dev"] > 0

    def test_xlstm_cell_traces_on_512_devices(self, dryrun_cells):
        """The twin of the reference's ``TestDryRunMachinery`` cell,
        xLSTM-125M on 512 devices, at its ``decode_32k`` shape (the
        reference's ``train_4k`` walks 4,096 tokens one at a time through
        DTensor dispatch here: minutes of trace, past this fixture's
        time)."""
        rec = dryrun_cells["xlstm_125m/decode_32k"]
        assert rec["status"] == "ok", rec.get("error")
        assert rec["n_devices"] == 512 and rec["mesh"] == "pod2x16x16"
        assert 0 < rec["hlo_dot_flops_per_dev"] * 16 \
            < rec["model_flops_total"] \
            <= rec["hlo_dot_flops_per_dev"] * 512
        assert rec["per_device_bytes"] > 0
        assert rec["hlo_collective_bytes_per_dev"] > 0

    def test_records_have_the_reference_keys(self, dryrun_cells):
        keys = {"arch", "shape", "mesh", "kind", "status", "n_devices",
                "lower_s", "compile_s", "cost_analysis_flops",
                "cost_analysis_bytes", "hlo_dot_flops_per_dev",
                "hlo_hbm_bytes_per_dev", "hlo_collective_bytes_per_dev",
                "collective_breakdown", "memory_analysis",
                "per_device_bytes", "fits_hbm", "model_flops_total",
                "useful_flops_ratio", "roofline_terms_s", "dominant_term",
                "logical_rules"}
        for rec in dryrun_cells.values():
            if rec["status"] == "ok":
                assert keys <= set(rec)
