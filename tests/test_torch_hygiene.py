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

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
REF = SRC / "repro"
PORT = SRC / "repro_torch"

# copied file by file from the reference; only the import prefix differs
# (and the determinism linter's suppression comments, which are unused
# outside src/repro and would be findings there)
VERBATIM = [
    "errors.py", "core/addresses.py", "core/costmodel.py",
    "core/pagetable.py", "core/resolver.py", "core/arbiter.py",
    "tenancy/slo.py", "api/policy.py", "models/config.py",
    "configs/__init__.py", "vmem/stats.py", "vmem/eviction.py",
    "vmem/prefetch.py", "vmem/compat.py", "data/pipeline.py",
] + sorted("configs/" + p.name for p in (REF / "configs").glob("*.py")
           if p.name != "__init__.py")

FORBIDDEN = re.compile(r"^(jax|jaxlib|repro)(\.|$)")


def _normalize(text: str, prefix: str) -> list[str]:
    lines = [ln for ln in text.splitlines()
             if not re.match(r"\s*# lint: allow\(", ln)]
    return [ln.replace(prefix + ".", "repro.") for ln in lines]


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
    ref = _normalize((REF / rel).read_text(), "repro")
    port = _normalize((PORT / rel).read_text(), "repro_torch")
    assert port == ref, f"{rel} differs from src/repro/{rel}"
    assert "lint: allow" not in (PORT / rel).read_text()


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
        "import repro_torch.vmem, repro_torch.kernels\n"
        "import repro_torch.kernels.paged_attention.ops\n"
        "import repro_torch.kernels.page_pack.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.memory.offload\n"
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
                  "repro_torch.api", "repro_torch.core"):
        r = subprocess.run(
            [sys.executable, "-c", f"import {first}; import repro_torch.api"],
            capture_output=True, text=True, timeout=120,
            env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
        assert r.returncode == 0, (first, r.stderr[-1500:])


def test_no_build_or_device_decision_at_import():
    """Kernel modules import ctypes-loaded libraries and anything CUDA
    lazily: importing them must not build, and must leave nothing in
    ``build/``-like state."""
    from repro_torch.kernels import _build
    assert _build._LIB is None or _build.BuildInfo.path is not None
    assert [s.name for s in _build.sources()] == ["flash_attention.cu",
                                                  "flash_attention_tc.cu",
                                                  "page_pack.cu",
                                                  "paged_attention.cu"]
    for s in _build.sources():
        text = s.read_text()
        assert "torch/extension.h" not in text
        assert 'extern "C"' in text
        assert "src/repro/kernels/" in text        # names what it replaces
    for name in _build.SIGNATURES:
        assert any(name in s.read_text() for s in _build.sources())


def test_ops_wrappers_have_no_fallback():
    """No try/except around a build or a launch in the kernel packages."""
    for path in (PORT / "kernels").rglob("*.py"):
        tree = ast.parse(path.read_text())
        tries = [n for n in ast.walk(tree) if isinstance(n, ast.Try)
                 and n.handlers]
        assert not tries, f"{path.relative_to(ROOT)} catches exceptions"
