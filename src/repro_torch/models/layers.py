"""Common layers: RMSNorm and LayerNorm, softcap, RoPE (full, half,
M-RoPE), the gated and plain MLPs and the top-k MoE.

Plain functions on tensors over a params dict, as in the reference
``repro.models.layers``.  Matmuls run in the compute dtype (bf16 by
default); norm statistics, RoPE angles and router probabilities in fp32.
Weights are stored ``(in, out)`` and applied as ``x @ W``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import MLPConfig
from repro_torch.parallel import spmd


def norm_apply(p: dict, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    """RMSNorm (``scale``) or LayerNorm (``scale`` and ``bias``, the
    population variance, as ``jnp.var``) with fp32 statistics; the result
    is cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)
    if kind != "layernorm":
        raise NotImplementedError(f"norm {kind!r}")
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               kind: str = "full",
               mrope_sections: Sequence[int] = ()) -> torch.Tensor:
    """x: (..., T, H, Dh); positions: (..., T) int, or (3, ..., T) for
    ``mrope``.  Every kind rotates *interleaved* pairs ``(x[2i], x[2i+1])``
    (the reference's layout, not the half-split ``rotate_half`` form):

    * ``full`` rotates every head dim;
    * ``half`` rotates the first Dh/2 dims only (ChatGLM), with the
      frequencies of a Dh/2-wide rotation;
    * ``mrope`` (Qwen2-VL) drives the Dh/2 frequency slots by section: slot
      ``i`` takes the position stream of the section it falls in.  The
      sections fill the slots in order; past their sum the last section
      continues, and slots beyond Dh/2 are cut, as ``jnp.repeat(...,
      total_repeat_length=Dh/2)`` does in the reference."""
    dh = x.shape[-1]
    if kind == "none":
        return x
    if kind == "half":
        rot, keep = x[..., :dh // 2], x[..., dh // 2:]
        return torch.cat([_rotate(rot, positions.float(), theta), keep],
                         dim=-1)
    if kind == "mrope":
        # each section's stream, repeated over its run of slots (built from
        # views: no index tensor to copy to the device)
        runs, left = [], dh // 2
        for i, n in enumerate(mrope_sections):
            last = i == len(mrope_sections) - 1
            take = left if last else min(n, left)
            if take:
                runs.append((i, take))
            left -= take
        pos = positions.float()
        slots = torch.cat([pos[i][..., None].expand(pos.shape[1:] + (n,))
                           for i, n in runs], dim=-1)
        return _apply_angles(x, slots * rope_freqs(dh, theta, device=x.device))
    if kind != "full":
        raise NotImplementedError(f"rope {kind!r}")
    return _rotate(x, positions.float(), theta)


def _rotate(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    return _apply_angles(x, pos[..., None] * freqs)          # (..., T, Dh/2)


def _apply_angles(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """ang: (..., T, Dh_rot/2); x: (..., T, H, Dh_rot)."""
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """SiLU for ``swiglu``; GELU in its tanh form (``jax.nn.gelu``'s
    default) for ``geglu`` and ``gelu``."""
    if kind == "swiglu":
        return x * torch.sigmoid(x)
    return F.gelu(x, approximate="tanh")


def mlp_apply(p: dict, x: torch.Tensor, cfg: MLPConfig,
              dtype: torch.dtype) -> Tuple[torch.Tensor, dict]:
    """The dense MLP (gated for ``swiglu``/``geglu``, else ``gelu``) or,
    with ``cfg.moe``, :func:`moe_apply`.  Returns (y, aux): aux is the MoE
    loss dict, empty for a dense MLP."""
    if cfg.moe is not None:
        return moe_apply(p, x, cfg, dtype)
    xd = x.to(dtype)
    if cfg.kind in ("swiglu", "geglu"):
        h = _act(xd @ p["w_gate"].to(dtype), cfg.kind) * (xd @ p["w_up"].to(dtype))
    else:
        h = _act(xd @ p["w_up"].to(dtype), cfg.kind)
    return (h @ p["w_down"].to(dtype)).to(x.dtype), {}


def moe_route(p: dict, xt: torch.Tensor, k: int):
    """The router on ``xt`` (B, T, D) in the compute dtype: the
    probabilities (B, T, E) fp32, and each token's top ``k`` (weights
    renormalised over the k, expert ids), ties to the lower expert index
    (a stable descending sort: ``lax.top_k``'s order)."""
    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def moe_apply(p: dict, x: torch.Tensor, cfg: MLPConfig, dtype: torch.dtype,
              capacity_factor: float = 1.25) -> Tuple[torch.Tensor, dict]:
    """Token-choice top-k MoE with per-row capacity, as the reference
    computes it.  Each batch row fills its own expert queues of capacity
    ``C = max(int(capacity_factor · T · k / E), 4)`` (truncated) in
    (token, slot) order; a (token, slot) past its queue's capacity drops
    that expert.  The top-k probabilities are renormalised over the k
    choices *before* the drop, and the dropped slots' weights are zeroed
    without renormalising again.  Top-k ties go to the lower expert index
    (:func:`moe_route`).  A token's k expert outputs are summed in slot
    order in the compute dtype, one rounding a slot, as the reference's
    scatter-add does, so the result does not depend on the order of
    atomics.  Returns (y, aux) with
    ``moe_aux_loss`` (the Switch load-balance loss) and ``moe_drop_frac``."""
    if spmd.first_dtensor(x, p) is not None:
        return spmd.local_moe(_moe_tokens, p, x, cfg, dtype, capacity_factor)
    moe = cfg.moe
    b, t = x.shape[:2]
    e = moe.num_experts
    y, probs, onehot, keep = _moe_tokens(p, x, cfg, dtype, capacity_factor)
    frac_tokens = onehot.sum(dim=2).reshape(b * t, e).float().mean(dim=0)
    frac_probs = probs.reshape(b * t, e).mean(dim=0)
    aux = {"moe_aux_loss": moe.aux_loss_weight * e
           * torch.sum(frac_tokens * frac_probs),
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return y, aux


def _moe_tokens(p: dict, x: torch.Tensor, cfg: MLPConfig, dtype: torch.dtype,
                capacity_factor: float,
                experts: Optional[Tuple[int, int]] = None):
    """:func:`moe_apply`'s routing, dispatch, experts and combine: (y,
    router probs (B, T, E), one-hot choices (B, T, k, E), keep (B, T, k)).
    ``experts`` (offset, count): the expert weights hold only these experts
    (expert parallelism), and y is their part of the sum."""
    moe = cfg.moe
    b, t, d = x.shape
    e, k = moe.num_experts, moe.top_k
    xt = x.to(dtype)
    probs, top_p, top_e = moe_route(p, xt, k)

    capacity = max(int(capacity_factor * t * k / e), 4)
    onehot = (top_e[..., None] == torch.arange(e, device=x.device)).long()
    pos_in_e = torch.cumsum(onehot.reshape(b, t * k, e), dim=1) - 1
    pos = (pos_in_e.reshape(b, t, k, e) * onehot).sum(dim=-1)       # (B, T, k)
    keep = pos < capacity
    top_p = torch.where(keep, top_p, 0.0)

    # dispatch: scatter-add each (token, slot) times its keep flag into its
    # queue slot; a dropped one adds an exact zero to the clipped last slot,
    # so the sum is the kept token whatever order the additions take
    bi = torch.arange(b, device=x.device)[:, None, None].expand(b, t, k)
    ci = pos.clamp(max=capacity - 1)
    w_disp = keep.to(dtype)[..., None]
    buf = xt.new_zeros((b, e, capacity, d))
    buf.index_put_((bi, top_e, ci), xt[:, :, None, :] * w_disp,
                   accumulate=True)
    ei = top_e
    if experts is not None:
        off, cnt = experts
        ei = top_e - off
        w_disp = w_disp * ((ei >= 0) & (ei < cnt)).to(dtype)[..., None]
        ei = ei.clamp(0, cnt - 1)
        buf = buf[:, off:off + cnt]
    wd = lambda name: p[name].to(dtype)                             # noqa: E731
    if cfg.kind in ("swiglu", "geglu"):
        h = _act(torch.einsum("becd,edf->becf", buf, wd("w_gate")), cfg.kind)
        h = h * torch.einsum("becd,edf->becf", buf, wd("w_up"))
    else:
        h = _act(torch.einsum("becd,edf->becf", buf, wd("w_up")), cfg.kind)
    out_buf = torch.einsum("becf,efd->becd", h, wd("w_down"))

    # combine: each (token, slot)'s expert output times its weight, summed
    # slot after slot from zero in the compute dtype
    contrib = out_buf[bi, ei, ci] * (top_p.to(dtype)[..., None] * w_disp)
    y = xt.new_zeros((b, t, d))
    for j in range(k):
        y = y + contrib[:, :, j]
    return y.to(x.dtype), probs, onehot, keep
