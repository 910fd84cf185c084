"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

A copy of ``repro.configs`` (the config files are data), so that the port's
CLI takes the same ``--arch`` names.  Smoke configs are reduced
same-family models that run on the CPU; the port builds and serves the
dense GQA, MoE and SSM families, and the others raise when a model is
built.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "yi_9b",
    "minicpm3_4b",
    "qwen2_0_5b",
    "granite_34b",
    "zamba2_7b",
    "seamless_m4t_large_v2",
    "mixtral_8x22b",
    "dbrx_132b",
    "mamba2_2_7b",
    "internvl2_2b",
]

# accepted CLI aliases (--arch yi-9b etc.)
ALIASES: Dict[str, str] = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "yi-9b": "yi_9b", "minicpm3-4b": "minicpm3_4b", "qwen2-0.5b": "qwen2_0_5b",
    "granite-34b": "granite_34b", "zamba2-7b": "zamba2_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mixtral-8x22b": "mixtral_8x22b", "dbrx-132b": "dbrx_132b",
    "mamba2-2.7b": "mamba2_2_7b", "internvl2-2b": "internvl2_2b",
})


def _module(arch: str):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG
