"""Common layers: RMSNorm, softcap, interleaved RoPE, the SwiGLU MLP.

Plain functions on tensors over a params dict, as in the reference
``repro.models.layers``.  Matmuls run in the compute dtype (bf16 by
default); norm statistics and RoPE angles in fp32.  Weights are stored
``(in, out)`` and applied as ``x @ W``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.config import MLPConfig


def norm_apply(p: dict, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics; the result is cast back to x's dtype."""
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               kind: str = "full") -> torch.Tensor:
    """x: (..., T, H, Dh); positions: (..., T) int.  Kind ``full`` rotates
    every head dim in *interleaved* pairs ``(x[2i], x[2i+1])`` — the
    reference's layout, not the half-split ``rotate_half`` form."""
    if kind == "none":
        return x
    if kind != "full":
        raise NotImplementedError(f"rope {kind!r} is not ported yet")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions.float()[..., None] * freqs                 # (..., T, Dh/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def mlp_apply(p: dict, x: torch.Tensor, cfg: MLPConfig,
              dtype: torch.dtype) -> Tuple[torch.Tensor, dict]:
    """Dense SwiGLU MLP.  Returns (y, aux) like the reference (aux is the
    MoE loss dict there, always empty here)."""
    if cfg.moe is not None or cfg.kind != "swiglu":
        raise NotImplementedError(f"mlp {cfg.kind!r}/moe is not ported yet")
    xd = x.to(dtype)
    gate = xd @ p["w_gate"].to(dtype)
    h = gate * torch.sigmoid(gate) * (xd @ p["w_up"].to(dtype))
    return (h @ p["w_down"].to(dtype)).to(x.dtype), {}
