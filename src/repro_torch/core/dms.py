"""Dynamic Memory Sparsification (paper §3): the inference subset.

α-logits come from the "borrowed" neuron (Appendix B): the first dim of the
first query head of each query group, read from the raw (pre-RoPE) query
projection, which is then zeroed so it no longer affects attention.
Inference binarises α = round(sigmoid(logit)).

Shapes: ``alpha`` is per KV head, ``(batch, kv_heads, seq)``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.config import DMSConfig

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free


def alpha_logits_from_q(q_raw: torch.Tensor, num_kv_heads: int,
                        bias: float) -> torch.Tensor:
    """``q_raw``: (B, T, Hq, Dh) pre-RoPE.  Returns (B, Hkv, T) fp32."""
    g = q_raw.shape[2] // num_kv_heads
    first = q_raw[:, :, ::g, 0]                       # (B, T, Hkv)
    return first.float().transpose(1, 2) + bias


def zero_borrowed_neuron(q: torch.Tensor, num_kv_heads: int,
                         scale: float = 0.0) -> torch.Tensor:
    """Multiply the borrowed neuron by ``scale`` (0 at inference)."""
    hq, dh = q.shape[2], q.shape[3]
    g = hq // num_kv_heads
    mask = torch.ones((hq, dh), dtype=q.dtype, device=q.device)
    mask[::g, 0] = scale
    return q * mask


def binary_alpha(logits: torch.Tensor) -> torch.Tensor:
    """α^bin = round(sigmoid(logit)) (§3.3), as bool."""
    return torch.sigmoid(logits.float()) > 0.5


def infer_alphas(q_raw: torch.Tensor, num_kv_heads: int,
                 cfg: DMSConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(binary alpha (B, Hkv, T), q with the borrowed neuron zeroed)."""
    logits = alpha_logits_from_q(q_raw, num_kv_heads, cfg.logit_bias)
    return binary_alpha(logits), zero_borrowed_neuron(q_raw, num_kv_heads)
