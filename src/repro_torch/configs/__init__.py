"""Architecture registry of the port: the paper's Qwen-R1 family, its
ablation model Llama 3.2 1B, and the other dense GQA decoders the port runs
(minitron-4b, phi3-mini-3.8b).

``get_arch(name)`` returns the full-size :class:`ArchConfig`; ``get_smoke``
the reduced same-family config the CPU tests run.
"""
from __future__ import annotations

import importlib
from repro_torch.core.config import ArchConfig

_ARCH_MODULES = {
    "qwen-r1-1.5b": "repro_torch.configs.qwen_r1_1p5b",
    "qwen-r1-7b": "repro_torch.configs.qwen_r1_7b",
    "qwen-r1-32b": "repro_torch.configs.qwen_r1_32b",
    "llama32-1b": "repro_torch.configs.llama32_1b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini",
}


def get_arch(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_smoke(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).SMOKE

