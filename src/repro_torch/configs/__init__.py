"""Assigned architecture configs (--arch <id>).  One module per arch."""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "chameleon_34b", "codeqwen15_7b", "qwen3_14b", "starcoder2_3b",
    "h2o_danube_1_8b", "mixtral_8x7b", "deepseek_v3_671b", "zamba2_7b",
    "xlstm_125m", "whisper_medium",
)

# CLI aliases (--arch accepts either form)
ALIASES = {
    "chameleon-34b": "chameleon_34b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "qwen3-14b": "qwen3_14b",
    "starcoder2-3b": "starcoder2_3b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "zamba2-7b": "zamba2_7b",
    "xlstm-125m": "xlstm_125m",
    "whisper-medium": "whisper_medium",
}


def get_config(arch: str):
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; one of {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
