"""Dynamic Memory Sparsification (paper §3): inference and training.

α-logits come from the "borrowed" neuron (Appendix B): the first dim of the
first query head of each query group, read from the raw (pre-RoPE) query
projection, which is then zeroed so it no longer affects attention.
Inference binarises α = round(sigmoid(logit)); training relaxes it with a
Gumbel-sigmoid (Eq. 1), masks attention with the delayed-eviction mask and
pulls the mean α towards the annealed target with a one-sided L1 loss.

Noise comes from an explicit :class:`torch.Generator`, or the caller hands
the uniforms ``u`` in (the tests feed the reference's own draws).

Shapes: ``alpha`` is per KV head, ``(batch, kv_heads, seq)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.config import DMSConfig

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free
_EPS = 1e-6


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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def uniform_noise(shape, generator: torch.Generator,
                  device=None) -> torch.Tensor:
    """Uniforms in [1e-6, 1 - 1e-6), the range of the reference's
    ``jax.random.uniform(rng, shape, minval=1e-6, maxval=1 - 1e-6)``."""
    u = torch.rand(shape, generator=generator, device=device)
    return _EPS + u * (1.0 - 2 * _EPS)


def gumbel_sigmoid(logits: torch.Tensor, tau: float,
                   generator: Optional[torch.Generator] = None,
                   hard: bool = False,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary-concrete / Gumbel-sigmoid sample in [0, 1] (Eq. 1).

    Logistic noise ``log u - log(1 - u)`` comes from ``u`` if given, else
    from ``generator``; with neither it returns the deterministic
    relaxation sigmoid(logits / tau).  ``hard=True`` uses a straight-through
    estimator."""
    logits = logits.float()
    if u is None and generator is not None:
        u = uniform_noise(logits.shape, generator, device=logits.device)
    if u is not None:
        logits = logits + (torch.log(u) - torch.log1p(-u))
    y = torch.sigmoid(logits / tau)
    if hard:
        y = y + ((y > 0.5).to(y.dtype) - y).detach()
    return y


def eviction_log_survival(alpha: torch.Tensor) -> torch.Tensor:
    """log(1 - α_j), with α clipped to 1 - 1e-6 — the additive mask
    contribution of key j on the reference path.  (The flash kernels' wrapper
    clips to [0, 1] and floors at -1e30 instead, as the reference's does.)"""
    return torch.log1p(-torch.clamp(alpha.float(), 0.0, 1.0 - _EPS))


def build_dms_mask(alpha: torch.Tensor, q_positions: torch.Tensor,
                   k_positions: torch.Tensor, cfg: DMSConfig,
                   causal: bool = True,
                   local_window: Optional[int] = None) -> torch.Tensor:
    """The additive mask ``M_alpha`` (B, Hkv, Tq, Tk) of the reference
    attention path: key j's ``log(1 - α_j)`` applies to queries i with
    ``i - j >= w`` (``w = 1`` for immediate eviction)."""
    i = q_positions[:, None].long()
    j = k_positions[None, :].long()
    delay = 1 if cfg.immediate_eviction else cfg.window
    zone = (i - j) >= delay
    mask = torch.where(zone, eviction_log_survival(alpha)[:, :, None, :], 0.0)
    if causal:
        mask = torch.where(j <= i, mask, NEG_INF)
    if local_window is not None:
        mask = torch.where((i - j) < local_window, mask, NEG_INF)
    return mask


def cr_schedule(step, cfg: DMSConfig) -> torch.Tensor:
    """CR(t) = min(1 + t / steps_per_cr_unit, target)  (§4), fp32."""
    cr = 1.0 + torch.as_tensor(step, dtype=torch.float32) / cfg.steps_per_cr_unit
    return torch.clamp(cr, max=cfg.target_cr)


def target_alpha(step, cfg: DMSConfig) -> torch.Tensor:
    """α*(t) = 1 - 1/CR(t): the annealed mean-eviction target."""
    return 1.0 - 1.0 / cr_schedule(step, cfg)


def aux_compression_loss(alpha_sum: torch.Tensor, alpha_count, step,
                         cfg: DMSConfig) -> torch.Tensor:
    """L_aux = max(α* · N − Σ α, 0) / N, N the α count over all layers."""
    a_star = target_alpha(step, cfg).to(alpha_sum.device)
    count = torch.as_tensor(alpha_count, dtype=torch.float32,
                            device=alpha_sum.device)
    return torch.clamp(a_star * count - alpha_sum, min=0.0) / torch.clamp(
        count, min=1.0)


def train_alphas(q_raw: torch.Tensor, num_kv_heads: int, cfg: DMSConfig,
                 generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(relaxed alpha (B, Hkv, T), q with the borrowed neuron zeroed); the
    noise as in :func:`gumbel_sigmoid`, none without ``generator`` or
    ``u``."""
    logits = alpha_logits_from_q(q_raw, num_kv_heads, cfg.logit_bias)
    alpha = gumbel_sigmoid(logits, cfg.tau, generator, u=u)
    return alpha, zero_borrowed_neuron(q_raw, num_kv_heads)
