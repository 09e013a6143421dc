"""Assigned-architecture registry: ``get_config(arch_id)``.

Every module defines ``config() -> ModelConfig`` with the exact assigned
numbers, plus the paper's own ``wikikv_router`` (the distilled
routing/navigation LM of §V-B).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "xlstm_350m",
    "qwen3_1_7b",
    "codeqwen1_5_7b",
    "granite_8b",
    "olmo_1b",
    "internvl2_1b",
    "dbrx_132b",
    "kimi_k2_1t_a32b",
    "jamba_v0_1_52b",
    "whisper_medium",
]

#: canonical dashed ids (CLI --arch) → module names
ALIASES = {
    "xlstm-350m": "xlstm_350m",
    "qwen3-1.7b": "qwen3_1_7b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "granite-8b": "granite_8b",
    "olmo-1b": "olmo_1b",
    "internvl2-1b": "internvl2_1b",
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "whisper-medium": "whisper_medium",
    "wikikv-router": "wikikv_router",
}


def get_config(arch: str):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.config()


def all_arch_ids() -> list[str]:
    return [a for a in ALIASES if a != "wikikv-router"]
