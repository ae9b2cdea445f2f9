"""Architecture registry of the port: the paper's Qwen-R1 family, its
ablation model Llama 3.2 1B, the other dense GQA decoders (minitron-4b,
phi3-mini-3.8b), gemma2-2b (local and global layers, softcaps, post-norm,
GeGLU), chatglm3-6b (half RoPE), qwen2-vl-7b (M-RoPE, the text path),
the granite MoE models (top-k experts) and the hybrids recurrentgemma-2b
(RG-LRU and local attention) and mamba2-2.7b (SSD, no attention), and the
encoder–decoder seamless-m4t-large-v2 (a bidirectional encoder over
precomputed audio frames, cross-attention in every decoder layer).

``get_arch(name)`` returns the full-size :class:`ArchConfig`; ``get_smoke``
the reduced same-family config the CPU tests run.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.core.config import ArchConfig

_ARCH_MODULES = {
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t",
    # the paper's own model family (Qwen-R1 distills + Llama 3.2 1B)
    "qwen-r1-1.5b": "repro_torch.configs.qwen_r1_1p5b",
    "qwen-r1-7b": "repro_torch.configs.qwen_r1_7b",
    "qwen-r1-32b": "repro_torch.configs.qwen_r1_32b",
    "llama32-1b": "repro_torch.configs.llama32_1b",
}

#: the dry-run's default grid (``--all``), in the reference's order
ASSIGNED_ARCHS: List[str] = list(_ARCH_MODULES)[:10]
PAPER_ARCHS: List[str] = list(_ARCH_MODULES)[10:]


def get_arch(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_smoke(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).SMOKE

