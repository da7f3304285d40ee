"""Hygiene of the PyTorch port: it stands alone (no ``jax``, nothing of
``repro``), its verbatim copies of the reference's jax-free leaf modules
have not drifted, and ``chip_smoke.py`` imports only the port.
"""

import ast
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
REF = SRC / "repro"
PORT = SRC / "repro_torch"
EXAMPLE_TWINS = sorted(ROOT.glob("examples/torch_*.py"))

# copied file by file from the reference; only the import prefix, the
# lint passes' root (src/repro_torch/) and the suppression marker differ: the
# port's is ``# torch-lint: allow(...)``, which the reference's gate (it reads
# every file under src and tests) does not take for one of its own
VERBATIM = [
    "errors.py", "core/addresses.py", "core/costmodel.py",
    "core/pagetable.py", "core/resolver.py", "core/arbiter.py",
    "tenancy/slo.py", "api/policy.py", "models/config.py",
    "configs/__init__.py", "vmem/stats.py", "vmem/eviction.py",
    "vmem/prefetch.py", "vmem/compat.py", "data/pipeline.py",
    # the verbs fabric, its simulator and the control plane under it
    "core/simulator.py", "core/shards.py", "core/fault.py",
    "core/fault_fifo.py", "core/engine.py", "core/node.py",
    "core/experiments.py", "core/firehose.py",
    "net/__init__.py", "net/topology.py", "net/link.py", "net/router.py",
    "net/interconnect.py",
    "npr/__init__.py", "npr/stats.py", "npr/mtt.py", "npr/pool.py",
    "npr/engine.py",
    "tenancy/banks.py", "tenancy/qp.py", "tenancy/manager.py",
    "lint/__init__.py", "lint/common.py", "lint/race.py", "lint/specs.py",
    "lint/cli.py", "lint/conformance.py", "lint/determinism.py",
    "lint/model.py", "lint/stats_coverage.py", "lint/typed_errors.py",
    "lint/__main__.py",
    "distributed/fault_tolerance.py", "analysis/hlo.py",
    "api/__init__.py", "api/memory.py", "api/completion.py",
    "api/config.py", "api/fabric.py",
    "testing/__init__.py", "testing/traffic.py", "testing/invariants.py",
    "testing/soak.py",
] + sorted("configs/" + p.name for p in (REF / "configs").glob("*.py")
           if p.name != "__init__.py")

FORBIDDEN = re.compile(r"^(jax|jaxlib|repro)(\.|$)")


#: the port's spellings of the reference's, mapped back before comparing
PORT_SPELLINGS = (("repro_torch.", "repro."), ("src/repro_torch/", "src/repro/"),
                  ("torch-lint:", "lint:"))


def _normalize(text: str) -> list[str]:
    for port, ref in PORT_SPELLINGS:
        text = text.replace(port, ref)
    return text.splitlines()


def _suppressions(sf) -> list[tuple]:
    """A parsed file's suppressions: line, rules and reason."""
    return [(s.line, s.rules, s.justification)
            for s in sf.suppressions.values()]


def _imported_modules(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) in \
                ("import_module", "__import__"):
            for a in node.args[:1]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    mods.add(a.value)
                elif isinstance(a, ast.JoinedStr) and a.values and \
                        isinstance(a.values[0], ast.Constant):
                    mods.add(str(a.values[0].value))
    return mods


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_has_not_drifted(rel):
    """Line for line, suppression comments included; and the port's lint
    reads the copy's suppressions where the reference's reads the
    original's."""
    from repro.lint.common import SourceFile as RefSourceFile
    from repro_torch.lint.common import SourceFile
    ref_text, port_text = (REF / rel).read_text(), (PORT / rel).read_text()
    assert _normalize(port_text) == ref_text.splitlines(), \
        f"{rel} differs from src/repro/{rel}"
    assert _suppressions(SourceFile(rel, port_text)) == \
        _suppressions(RefSourceFile(rel, ref_text))


def _port_texts() -> list[pathlib.Path]:
    return (sorted(PORT.rglob("*.py")) + sorted(ROOT.glob("tests/test_torch_*.py"))
            + [ROOT / "chip_smoke.py"] + EXAMPLE_TWINS)


def test_port_carries_no_reference_marker():
    """No line of the port, its tests or ``chip_smoke.py`` is a reference
    suppression: the reference's gate lints these files too, and would
    report each as unused."""
    from repro.lint.common import _SUPPRESS_RE
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in _port_texts()
            for i, ln in enumerate(p.read_text().splitlines(), start=1)
            if _SUPPRESS_RE.search(ln)]
    assert hits == []


def _public_definitions(path: pathlib.Path) -> set[str]:
    """Public top-level functions, classes and assigned names."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _top_level_names(path: pathlib.Path) -> set[str]:
    """Every top-level name a module binds: definitions and imports."""
    names = _public_definitions(path)
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


# reference names with no twin, each by name: compat.py's import_shard_map
# has none to come: torch has no shard_map, and the port's shard-local
# bodies run once per rank (axis_types_kwargs and cost_analysis_dict came
# over with the launch tooling)
NAMES_NOT_CARRIED = {
    "compat.py": {"import_shard_map"},
}

TWINS = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
               if (PORT / p.relative_to(REF)).is_file()
               and p.relative_to(REF).as_posix() not in VERBATIM)


@pytest.mark.parametrize("rel", TWINS)
def test_twin_keeps_the_reference_public_names(rel):
    """Every public top-level name of a reference module is a top-level
    name of its twin, but for the exceptions listed by name."""
    missing = _public_definitions(REF / rel) - _top_level_names(PORT / rel)
    assert missing == NAMES_NOT_CARRIED.get(rel, set()), rel


def test_the_one_exception_to_the_public_names_is_import_shard_map():
    assert NAMES_NOT_CARRIED == {"compat.py": {"import_shard_map"}}
    for rel, names in NAMES_NOT_CARRIED.items():
        assert names <= _public_definitions(REF / rel)


def test_every_reference_module_has_a_twin():
    """``comm`` of the two file lists: no reference file without a twin."""
    missing = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
                     if not (PORT / p.relative_to(REF)).is_file())
    assert missing == []


def test_restored_names_are_the_port_s_own():
    """The reference's names kept in the port are aliases of the port's
    functions and values, not copies."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.memory.offload import OffloadStats
    from repro_torch.models import attention_ops
    from repro_torch.vmem import PagingStats
    assert OffloadStats is PagingStats
    assert attention_ops.paged_attention_xla is \
        attention_ops.paged_attention_scan
    assert fa.NEG_INF == pa.NEG_INF == fa_ref.NEG_INF == pa_ref.NEG_INF \
        == -1e30
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_kernel(q, q, q)
    with pytest.raises(TypeError):            # no Pallas-only knobs
        fa.flash_attention_kernel(q, q, q, interpret=True)


def test_all_ten_arch_configs_are_carried():
    from repro_torch.configs import ARCH_IDS
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert (PORT / "configs" / f"{arch}.py").is_file()


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_module_imports_no_jax_and_no_reference(path):
    bad = sorted(m for m in _imported_modules(path) if FORBIDDEN.match(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_example_has_a_twin():
    refs = sorted(p.name for p in (ROOT / "examples").glob("*.py")
                  if not p.name.startswith("torch_"))
    assert [p.name for p in EXAMPLE_TWINS] == [f"torch_{n}" for n in refs]


@pytest.mark.parametrize("path", EXAMPLE_TWINS, ids=lambda p: p.name)
def test_example_twin_imports_no_jax_and_no_reference(path):
    mods = _imported_modules(path)
    bad = sorted(m for m in mods if FORBIDDEN.match(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    assert any(m.startswith("repro_torch") for m in mods)


def test_chip_smoke_parses_and_imports_only_the_port():
    path = ROOT / "chip_smoke.py"
    mods = _imported_modules(path)          # ast.parse: not executed
    bad = sorted(m for m in mods if FORBIDDEN.match(m))
    assert not bad, f"chip_smoke.py imports {bad}"
    assert any(m.startswith("repro_torch") for m in mods)
    text = path.read_text()
    assert "torch.cuda.is_available()" in text
    assert '"platform": "gpu"' in text


def test_importing_the_launcher_loads_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.models.xlstm_model\n"
        "import repro_torch.vmem, repro_torch.kernels\n"
        "import repro_torch.kernels.paged_attention.ops\n"
        "import repro_torch.kernels.page_pack.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.memory.offload\n"
        "import repro_torch.api, repro_torch.testing, repro_torch.lint\n"
        "import repro_torch.npr, repro_torch.vmem.remote\n"
        "import repro_torch.core.experiments, repro_torch.core.firehose\n"
        "import repro_torch.launch.dryrun, repro_torch.analysis.trace\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "clean"


def test_thin_package_inits_do_not_recreate_the_import_cycle():
    """``import repro_torch.tenancy`` first must work (in the reference
    the tenancy <-> core cycle makes that order fail)."""
    for first in ("repro_torch.tenancy", "repro_torch.tenancy.slo",
                  "repro_torch.tenancy.banks", "repro_torch.api",
                  "repro_torch.core", "repro_torch.core.node",
                  "repro_torch.vmem.remote"):
        r = subprocess.run(
            [sys.executable, "-c", f"import {first}; import repro_torch.api; "
             "from repro_torch.tenancy import TenancyManager; "
             "from repro_torch.core import RDMAEngine"],
            capture_output=True, text=True, timeout=120,
            env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
        assert r.returncode == 0, (first, r.stderr[-1500:])


def test_no_build_or_device_decision_at_import():
    """Kernel modules import ctypes-loaded libraries and anything CUDA
    lazily: importing them must not build, and must leave nothing in
    ``build/``-like state."""
    from repro_torch.kernels import _build
    assert _build._LIB is None or _build.BuildInfo.path is not None
    assert [s.name for s in _build.sources()] == [
        "flash_attention.cu", "flash_attention_wgmma.cu",
        "flash_attention_wgmma_bwd.cu", "flash_decode.cu", "page_pack.cu",
        "paged_attention.cu"]
    for s in _build.sources():
        text = s.read_text()
        assert "torch/extension.h" not in text
        assert 'extern "C"' in text
        assert "src/repro/kernels/" in text        # names what it replaces
    for name in _build.SIGNATURES:
        assert any(name in s.read_text() for s in _build.sources())


def test_ops_wrappers_have_no_fallback():
    """No try/except around a build or a launch in the kernel packages,
    and every public function of an ``ops.py`` wrapper starts with the
    DTensor check (``require_local``, a plain ``isinstance`` test: no
    exception caught either)."""
    for path in (PORT / "kernels").rglob("*.py"):
        tree = ast.parse(path.read_text())
        tries = [n for n in ast.walk(tree) if isinstance(n, ast.Try)
                 and n.handlers]
        assert not tries, f"{path.relative_to(ROOT)} catches exceptions"
    wrappers = sorted((PORT / "kernels").glob("*/ops.py"))
    assert len(wrappers) == 3
    for path in wrappers:
        fns = [n for n in ast.parse(path.read_text()).body
               if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")]
        assert fns, path
        for fn in fns:
            body = fn.body[1:] if isinstance(fn.body[0], ast.Expr) \
                and isinstance(fn.body[0].value, ast.Constant) else fn.body
            first = body[0]
            assert isinstance(first, ast.Expr) and isinstance(
                first.value, ast.Call) and getattr(
                first.value.func, "id", "") == "require_local", \
                f"{path.relative_to(ROOT)}::{fn.name}"
