"""``chip_smoke.py``'s ``dist_families`` phases rehearsed on the CPU: the
five non-dense families' decode and train steps with DTensor parameters on
a (1 x 1) mesh over a one-rank gloo group against the same steps on plain
parameters, at reduced width (the card runs them at published width over
NCCL).  The sharded steps themselves are held to the reference on eight
ranks in ``tests/test_torch_sharded_families.py``."""

from __future__ import annotations

import json

import pytest

FAMILIES = ("mixtral_8x7b", "deepseek_v3_671b", "zamba2_7b",
            "whisper_medium", "xlstm_125m")


@pytest.mark.parametrize("phase", ["dist_families", "dist_families_side"])
def test_chip_phase_runs_on_the_cpu_at_reduced_width(capsys, phase):
    """``chip_smoke.py``'s ``dist_families`` phases at reduced width over a
    one-rank gloo group: on the CPU every call is the plain version, so no
    launch is counted, and each family's DTensor runs equal its plain
    ones."""
    import torch
    import chip_smoke
    small = tuple((a, 2, 16) for a, _, _ in chip_smoke.Sizes.dist_family_train)
    sz = chip_smoke.Sizes(full_width=False, dist_family_train=small)
    table = [{"name": n} for n in ("paged_attention", "flash_attention",
                                   "flash_attention_bwd")]
    getattr(chip_smoke, f"phase_{phase}")(torch.device("cpu"), sz, table)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    archs = chip_smoke.DIST_PARENT if phase == "dist_families" \
        else chip_smoke.DIST_SIDE
    assert line["phase"] == phase and line["backend"] == "gloo"
    assert sorted(line["families"]) == sorted(archs)
    for arch, fam in line["families"].items():
        assert all(v == {} for v in fam["launches"].values()), arch
        assert max(fam["max_abs_err"].values()) <= line["tolerance"], arch
        assert fam["train"]["seq"] == 16
    assert {a for a, _, _ in sz.dist_family_depth} \
        == set(chip_smoke.DIST_FAMILY_KERNELS) \
        == set(chip_smoke.DIST_PARENT + chip_smoke.DIST_SIDE) == set(FAMILIES)
    for row in table:
        assert row.get("launches_by_path", {}) == {
            f"dist_{a}": 0 for a in archs
            if row["name"] in sum(chip_smoke.DIST_FAMILY_KERNELS[a], ())}
    assert not torch.distributed.is_initialized()
