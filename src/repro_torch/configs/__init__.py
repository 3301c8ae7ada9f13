"""Config registry of the port: `get_config(arch)` / `get_smoke_config`.

Every architecture the JAX package registers is listed, its config a
copy of the reference's. The serving cost model reads any of them; the
model path runs RecurrentGemma and Mamba-2, and raises
`NotImplementedError` for the families it lacks (MLA, MoE,
multi-codebook heads, prefix embeddings; ROADMAP queue 1 item 7). An
unknown name raises `KeyError`, as in the JAX package.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, scaled_down  # noqa: F401

ARCH_IDS: List[str] = [
    "minicpm3-4b",
    "yi-34b",
    "phi3-mini-3.8b",
    "qwen2-72b",
    "paligemma-3b",
    "musicgen-medium",
    "recurrentgemma-9b",
    "deepseek-v2-lite-16b",
    "dbrx-132b",
    "mamba2-780m",
]

_MODULES: Dict[str, str] = {
    "minicpm3-4b": "minicpm3_4b",
    "yi-34b": "yi_34b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2-72b": "qwen2_72b",
    "paligemma-3b": "paligemma_3b",
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "dbrx-132b": "dbrx_132b",
    "mamba2-780m": "mamba2_780m",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


def get_smoke_config(arch: str, **kw) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return scaled_down(get_config(arch), **kw)
