"""Port vs reference, the examples: ``examples/torch_*.py`` against the
reference's ``examples/*.py``, each run as a script in a subprocess on the
CPU.

The three simulator twins print exactly what their references print.  The
serving twin (``--device cpu``) prints the reference's output, its two
stats lines those that ``chip_smoke.py``'s ``examples`` phase holds the
twin to on the card (``SERVE_EXAMPLE_STATS``), and the same lines with the
window off (the paged KV pools).  The training twin, at a small size and a
few steps, gives finite losses and resumes from its checkpoint in a second
run.  Without ``--device`` the serving and training twins run on the GPU,
and raise without one.
"""

from __future__ import annotations

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SIMULATOR_TWINS = ["quickstart", "rdma_fault_demo", "remote_paged_kv"]
SMALL_TRAIN = ["--layers", "2", "--d-model", "64", "--heads", "4",
               "--kv-heads", "2", "--head-dim", "16", "--d-ff", "128",
               "--vocab", "512", "--seq", "32", "--batch", "4"]


def _run(script: str, *args: str, check: bool = True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                        *args], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    if check:
        assert r.returncode == 0, r.stderr[-3000:]
    return r


@pytest.fixture(scope="module")
def reference_serving():
    """The reference's ``serve_paged_kv.py`` output (JAX, once)."""
    return _run("serve_paged_kv.py").stdout


@pytest.mark.parametrize("name", SIMULATOR_TWINS)
def test_simulator_twin_prints_the_reference_s_output(name):
    want = _run(f"{name}.py").stdout
    assert want.strip()
    assert _run(f"torch_{name}.py").stdout == want


def test_serving_twin_prints_the_reference_s_output(reference_serving):
    got = _run("torch_serve_paged_kv.py", "--device", "cpu").stdout
    assert got == reference_serving


def test_the_chip_phase_holds_the_reference_s_stats_lines(
        reference_serving):
    import chip_smoke
    stats = [ln for ln in reference_serving.splitlines() if "tokens" in ln]
    assert tuple(stats) == chip_smoke.SERVE_EXAMPLE_STATS


def test_serving_twin_over_the_paged_pools_gives_the_same_stats():
    """``--window 0``: decode through the paged KV pools (on the card,
    paged attention and the page copies); the pager's stats are the
    window's."""
    import chip_smoke
    out = _run("torch_serve_paged_kv.py", "--device", "cpu", "--window",
               "0").stdout
    stats = [ln for ln in out.splitlines() if "tokens" in ln]
    assert tuple(stats) == chip_smoke.SERVE_EXAMPLE_STATS


def _losses(out: str) -> dict:
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step\s+(\d+)\s+loss\s+(\S+)\s", out, re.M)}


def test_training_twin_resumes_from_its_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    common = ["--device", "cpu", *SMALL_TRAIN, "--log-every", "1",
              "--checkpoint-every", "3", "--checkpoint-dir", ckpt]
    first = _run("torch_train_demand_paged.py", *common, "--steps", "3")
    assert first.stdout.splitlines()[0] == \
        "model: qwen3-14b-reduced, 0.1M params"
    assert "  checkpoint @ 3" in first.stdout.splitlines()
    assert first.stdout.rstrip().endswith("done.")
    second = _run("torch_train_demand_paged.py", *common, "--steps", "5")
    assert "resumed from checkpoint at step 3" in second.stdout.splitlines()
    a, b = _losses(first.stdout), _losses(second.stdout)
    assert sorted(a) == [1, 2, 3] and sorted(b) == [4, 5]
    assert all(math.isfinite(x) and 0 < x < 20 for x in (*a.values(),
                                                        *b.values()))


def test_training_twin_defaults_are_the_reference_s():
    """The size and logging flags default to the reference's values: the
    parser's defaults against the reference's literals."""
    text = (ROOT / "examples" / "torch_train_demand_paged.py").read_text()
    ref = (ROOT / "examples" / "train_demand_paged.py").read_text()
    defaults = dict(re.findall(r'add_argument\("--([a-z-]+)", type=int, '
                               r'default=(\d+)\)', text))
    assert defaults["steps"] == "300"
    want = {"layers": "n_layers=6", "d-model": "d_model=512",
            "head-dim": "head_dim=64", "heads": "n_heads=8",
            "kv-heads": "n_kv_heads=4", "d-ff": "d_ff=1536",
            "vocab": "vocab_size=32768", "seq": "seq_len=64",
            "batch": "batch_per_shard=8", "log-every": "% 25 == 0",
            "checkpoint-every": "% 100 == 0"}
    for flag, literal in want.items():
        assert literal in ref, literal
        assert re.search(rf"(?<!\d){defaults[flag]}(?!\d)", literal), \
            (flag, literal)


@pytest.mark.parametrize("script,args", [
    ("torch_serve_paged_kv.py", []),
    ("torch_train_demand_paged.py", SMALL_TRAIN + ["--steps", "1"])])
def test_twin_runs_on_the_gpu_by_default(script, args, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    if "train" in script:
        args = args + ["--checkpoint-dir", str(tmp_path)]
    r = _run(script, *args, check=False)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
