"""Plain PyTorch versions of the DMS flash-attention kernels.

``flash_fwd_plain``, ``flash_dq_plain`` and ``flash_dkv_plain`` compute what
the CUDA kernels (``csrc/dms_attention.cu``) compute, on the same folded,
padded operands and with the same :class:`FlashConfig`, densely and in fp32:
the whole (Tp, Tp) score matrix of each (kv head, query head of its group)
at once.  They take the kernels' ``hr`` table (or None) and ignore it: a tile the
kernel skips adds exactly zero (its scores are -1e30, or carry log_surv =
-1e30), so skipping changes no value.  The CPU path and the tests use them;
``chip_smoke.py`` holds the kernels against them on the card.

``dms_attention_plain`` is the unfolded oracle of
``repro.kernels.dms_attention.ref.dms_attention_ref``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30


class FlashConfig(NamedTuple):
    t: int                      # true sequence length (pre-padding)
    orig_dh: int                # true head dim -> softmax scale
    hq: int
    hkv: int
    window: Optional[int]       # local-attention window, or None
    dms_delay: int              # eviction delay w (0 = no DMS mask)
    causal: bool
    logit_cap: Optional[float]
    block_k: int                # keys per block of the `hr` table
    skip_blocks: bool           # binarised alpha -> dead-block skipping


def _grouped(q: torch.Tensor, cfg: FlashConfig) -> torch.Tensor:
    """(B*Hq, Tp, Dh) -> (B*Hkv, G, Tp, Dh): query head h sits in kv row
    b*Hkv + (h % Hq) // G, at group slot h % G."""
    bhq, tp, dh = q.shape
    return q.reshape(bhq // cfg.hq * cfg.hkv, cfg.hq // cfg.hkv, tp, dh)


def _scores(q, k, ls, cfg: FlashConfig):
    """Masked scores (BHkv, G, Tp, Tp) fp32, the capped scores before the
    masks, the eviction zone (Tp, Tp) or None, and the query ids."""
    tp = k.shape[1]
    qg = _grouped(q, cfg).float()
    s = torch.einsum("hgid,hjd->hgij", qg, k.float()) * (cfg.orig_dh ** -0.5)
    if cfg.logit_cap is not None:
        s = cfg.logit_cap * torch.tanh(s / cfg.logit_cap)
    capped = s
    ids = torch.arange(tp, device=k.device)
    ids_q, ids_k = ids[:, None], ids[None, :]
    zone = None
    if cfg.dms_delay > 0:
        zone = (ids_q - ids_k) >= cfg.dms_delay
        s = s + torch.where(zone, ls[:, None, None, :], 0.0)
    dead = ids_k >= cfg.t
    if cfg.causal:
        dead = dead | (ids_k > ids_q)
    if cfg.window is not None:
        dead = dead | (ids_q - ids_k >= cfg.window)
    s = torch.where(dead, NEG_INF, s)
    return s, capped, zone, ids_q


def flash_fwd_plain(q, k, v, ls, hr, cfg: FlashConfig):
    """q: (BHq, Tp, Dh); k/v: (BHkv, Tp, Dh); ls: (BHkv, Tp) fp32.
    Returns (out (BHq, Tp, Dh) q.dtype, lse (BHq, Tp) fp32)."""
    del hr                                  # skipping changes no value
    s, _, _, _ = _scores(q, k, ls, cfg)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l <= 0.0, 1.0, l)
    out = torch.einsum("hgij,hjd->hgid", p, v.float()) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return out.reshape(q.shape).to(q.dtype), lse.reshape(q.shape[:2])


def _probs_and_dscores(q, k, v, ls, do, lse, delta, cfg: FlashConfig):
    """p, ds before the softcap derivative, the capped scores and the zone,
    each (BHkv, G, Tp, Tp)."""
    s, capped, zone, ids_q = _scores(q, k, ls, cfg)
    lse_g = _grouped(lse[..., None], cfg)                 # (BHkv, G, Tp, 1)
    delta_g = _grouped(delta[..., None], cfg)
    p = torch.where(ids_q < cfg.t, torch.exp(s - lse_g), 0.0)
    dp = torch.einsum("hgid,hjd->hgij", _grouped(do, cfg).float(), v.float())
    ds = p * (dp - delta_g)
    return p, ds, capped, zone


def _cap_grad(ds, capped, cfg: FlashConfig):
    if cfg.logit_cap is None:
        return ds
    return ds * (1.0 - (capped / cfg.logit_cap) ** 2)


def flash_dq_plain(q, k, v, ls, do, lse, delta, hr, cfg: FlashConfig):
    """dq (BHq, Tp, Dh) in q.dtype."""
    del hr
    _, ds, capped, _ = _probs_and_dscores(q, k, v, ls, do, lse, delta, cfg)
    ds = _cap_grad(ds, capped, cfg)
    dq = torch.einsum("hgij,hjd->hgid", ds, k.float()) * (cfg.orig_dh ** -0.5)
    return dq.reshape(q.shape).to(q.dtype)


def flash_dkv_plain(q, k, v, ls, do, lse, delta, hr, cfg: FlashConfig):
    """(dk, dv) (BHkv, Tp, Dh) in k's and v's dtype, dls (BHkv, Tp) fp32,
    each summed over the G query heads of the group."""
    del hr
    p, ds, capped, zone = _probs_and_dscores(q, k, v, ls, do, lse, delta, cfg)
    dv = torch.einsum("hgij,hgid->hjd", p, _grouped(do, cfg).float())
    if zone is not None:
        dls = torch.where(zone, ds, 0.0).sum(dim=(1, 2))
    else:
        dls = torch.zeros(ls.shape, dtype=torch.float32, device=ls.device)
    ds = _cap_grad(ds, capped, cfg)
    dk = torch.einsum("hgij,hgid->hjd", ds,
                      _grouped(q, cfg).float()) * (cfg.orig_dh ** -0.5)
    return dk.to(k.dtype), dv.to(v.dtype), dls


def dms_attention_plain(
    q: torch.Tensor,                  # (B, T, Hq, Dh)
    k: torch.Tensor,                  # (B, T, Hkv, Dh)
    v: torch.Tensor,                  # (B, T, Hkv, Dh)
    log_surv: Optional[torch.Tensor],  # (B, Hkv, T) = log1p(-alpha), or None
    *,
    window: Optional[int] = None,
    dms_window: int = 0,
    causal: bool = True,
    logit_cap: Optional[float] = None,
    immediate: bool = False,
) -> torch.Tensor:
    """Masked-softmax oracle of the flash kernels: causal and window masks,
    then the DMS additive mask ``log_surv[j]`` where ``i - j >= delay``,
    with the softcap applied to the raw scores first."""
    b, t, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, t, hkv, g, dh).float()
    s = torch.einsum("bihgd,bjhd->bhgij", qg, k.float()) * (dh ** -0.5)
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    if causal:
        s = torch.where(j <= i, s, NEG_INF)
    if window is not None:
        s = torch.where((i - j) < window, s, NEG_INF)
    if log_surv is not None:
        delay = 1 if immediate else dms_window
        zone = (i - j) >= delay
        s = s + torch.where(zone, log_surv[:, :, None, None, :], 0.0)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgij,bjhd->bihgd", p, v.float())
    return out.reshape(b, t, hq, dh).to(q.dtype)
