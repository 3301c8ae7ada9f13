"""Config registry of the port: `get_config(arch)` / `get_smoke_config`.

Only the architectures the port runs are listed; any other name raises
`KeyError`, as an unknown name does in the JAX package.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, scaled_down  # noqa: F401

ARCH_IDS: List[str] = ["recurrentgemma-9b", "mamba2-780m"]

_MODULES: Dict[str, str] = {"recurrentgemma-9b": "recurrentgemma_9b",
                            "mamba2-780m": "mamba2_780m"}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


def get_smoke_config(arch: str, **kw) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return scaled_down(get_config(arch), **kw)
