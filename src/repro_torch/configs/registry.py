"""Registry of the 10 assigned architectures × 4 input shapes (40 cells)."""
from __future__ import annotations

import importlib
from typing import Dict, Iterator, List, Tuple

from repro_torch.configs.base import (
    ModelConfig,
    SHAPES,
    ShapeConfig,
    cell_is_runnable,
)

_ARCH_MODULES = {
    "mixtral-8x22b":     "repro_torch.configs.mixtral_8x22b",
    "arctic-480b":       "repro_torch.configs.arctic_480b",
    "qwen3-0.6b":        "repro_torch.configs.qwen3_0_6b",
    "llama3-8b":         "repro_torch.configs.llama3_8b",
    "minicpm-2b":        "repro_torch.configs.minicpm_2b",
    "gemma2-2b":         "repro_torch.configs.gemma2_2b",
    "whisper-base":      "repro_torch.configs.whisper_base",
    "mamba2-780m":       "repro_torch.configs.mamba2_780m",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "internvl2-2b":      "repro_torch.configs.internvl2_2b",
}

ARCH_NAMES: List[str] = list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return importlib.import_module(_ARCH_MODULES[name]).smoke_config()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells() -> Iterator[Tuple[ModelConfig, ShapeConfig, bool, str]]:
    """Yield all 40 (arch, shape, runnable, skip_reason) cells."""
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = cell_is_runnable(cfg, shape)
            yield cfg, shape, ok, why


def runnable_cells() -> List[Tuple[ModelConfig, ShapeConfig]]:
    return [(c, s) for c, s, ok, _ in all_cells() if ok]


def matrix_summary() -> Dict[str, Dict[str, str]]:
    out: Dict[str, Dict[str, str]] = {}
    for cfg, shape, ok, why in all_cells():
        out.setdefault(cfg.name, {})[shape.name] = "run" if ok else f"skip: {why}"
    return out
