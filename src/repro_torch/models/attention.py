"""GQA attention with pluggable KV-cache policies; DMS is a first-class mode.

* :func:`full_attention` — full-sequence forward (training / prefill).  In
  DMS modes it takes α from the borrowed query neuron, relaxes it with a
  Gumbel-sigmoid (``dms_train``) or binarises it (``dms_eval``), and applies
  the delayed-eviction mask — through the flash-attention kernels
  (``impl="kernel"``) or the masked-softmax reference.
* :func:`decode_attention` runs one decode token against a
  :class:`~repro_torch.core.policy.PolicyCache`: project q/k/v, take the DMS
  eviction (or DMC merge) decision from the borrowed query neuron, rotate q
  and k, let the policy absorb the token, and attend — through the block-table
  flash-decode kernel (``use_kernel=True``) or the reference einsum path.
  A policy that evicts by attention weights (TOVA, H2O, Keyformer) gets
  them back: the kernel in its weights-out mode, or the reference softmax.
* :func:`attention_ref` — the O(T²) masked-softmax oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import dms as dms_lib
from repro_torch.core import policy as policy_lib
from repro_torch.core.config import ArchConfig, AttentionConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels.dms_attention import ops as fkops
from repro_torch.kernels.dms_decode import ops as dkops
from repro_torch.models.layers import apply_rope, softcap

NEG_INF = dms_lib.NEG_INF


def project_qkv(p: dict, x: torch.Tensor, cfg: AttentionConfig,
                dtype: torch.dtype):
    b, t, _ = x.shape
    xd = x.to(dtype)
    q = (xd @ p["wq"].to(dtype)).reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = (xd @ p["wk"].to(dtype)).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = (xd @ p["wv"].to(dtype)).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor],
                  logit_cap: Optional[float] = None) -> torch.Tensor:
    """Masked-softmax GQA oracle with fp32 statistics.  q: (B, Tq, Hq, Dh);
    k/v: (B, Tk, Hkv, Dh); mask: (B, Hkv, Tq, Tk) additive, or None."""
    b, tq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, tq, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = softcap(scores * (dh ** -0.5), logit_cap)
    if mask is not None:
        scores = scores + mask[:, :, None].float()
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(b, tq, hq, dh).to(q.dtype)


def full_attention(
    p: dict,
    x: torch.Tensor,                 # (B, T, D)
    cfg: AttentionConfig,
    arch: ArchConfig,
    *,
    layer_window: Optional[int] = None,
    mode: str = "vanilla",           # vanilla | dms_train | dms_eval | dms_phase1
    dms_u: Optional[torch.Tensor] = None,   # (B, Hkv, T) uniforms for dms_train
    positions: Optional[torch.Tensor] = None,
    neuron_scale=0.0,
    use_kernel: bool = False,
    collect_kv: bool = False,
    kv_override=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence attention; returns (output (B, T, D), aux).

    aux keys: ``alpha_sum`` / ``alpha_count`` (the DMS loss) in the DMS
    modes, ``alpha_bin`` in ``dms_eval``.  ``dms_train`` takes its Gumbel
    noise from the uniforms ``dms_u``; without them it uses the
    deterministic relaxation, as the reference does without ``dms_rng``.
    ``use_kernel`` routes attention through the flash kernels, else the
    masked-softmax reference."""
    if collect_kv or kv_override is not None:
        raise NotImplementedError("collect_kv and kv_override (cross-attention) "
                                  "are not ported yet")
    dtype = torch_dtype(arch.dtype)
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)
    q_raw, k, v = project_qkv(p, x, cfg, dtype)

    aux: Dict[str, Any] = {}
    alpha = None
    dms = arch.dms
    if mode == "dms_train" and dms.enabled:
        alpha, q_raw = dms_lib.train_alphas(q_raw, cfg.num_kv_heads, dms,
                                            u=dms_u)
        aux["alpha_sum"] = alpha.sum()
        aux["alpha_count"] = float(alpha.numel())
    elif mode == "dms_eval" and dms.enabled:
        alpha_bin, q_raw = dms_lib.infer_alphas(q_raw, cfg.num_kv_heads, dms)
        alpha = alpha_bin.float()
        aux["alpha_bin"] = alpha_bin
        aux["alpha_sum"] = alpha.sum()
        aux["alpha_count"] = float(alpha.numel())
    elif mode == "dms_phase1" and dms.enabled:
        # phase-1 retrofit: gradually zero the borrowed neuron, no masking yet
        q_raw = dms_lib.zero_borrowed_neuron(q_raw, cfg.num_kv_heads,
                                             neuron_scale)

    q = apply_rope(q_raw, positions, cfg.rope_theta, cfg.rope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope)
    window = layer_window if layer_window is not None else cfg.window

    if use_kernel:
        out = fkops.dms_flash_attention(
            q, k, v, alpha, window=window,
            dms_window=dms.window if alpha is not None else 0,
            causal=cfg.causal, logit_cap=cfg.logit_softcap,
            immediate=dms.immediate_eviction)
    else:
        i = torch.arange(t, device=x.device)[:, None]
        j = torch.arange(t, device=x.device)[None, :]
        mask = None
        if cfg.causal:
            mask = torch.where(j <= i, 0.0, NEG_INF)
        if window is not None:
            wm = torch.where((i - j) < window, 0.0, NEG_INF)
            mask = wm if mask is None else mask + wm
        if mask is not None:
            mask = mask.expand(b, cfg.num_kv_heads, t, t)
        if alpha is not None:
            qpos = positions if positions.dim() == 1 else torch.arange(
                t, device=x.device)
            dmask = dms_lib.build_dms_mask(
                alpha, qpos, torch.arange(t, device=x.device), dms, causal=False)
            mask = dmask if mask is None else mask + dmask
        out = attention_ref(q, k, v, mask, cfg.logit_softcap)

    y = out.reshape(b, t, cfg.num_heads * cfg.head_dim) @ p["wo"].to(dtype)
    return y.to(x.dtype), aux


def decode_attention(
    p: dict,
    x_t: torch.Tensor,             # (B, 1, D)
    cache: policy_lib.PolicyCache,
    cfg: AttentionConfig,
    arch: ArchConfig,
    *,
    layer_window: Optional[int] = None,
    pos_t=None,                    # int or per-lane (B,) positions
    use_kernel: bool = False,
    active: Optional[torch.Tensor] = None,   # (B,) live-lane mask
    layer_salt: Optional[torch.Tensor] = None,
    step_aux: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, policy_lib.PolicyCache, Dict[str, Any]]:
    """One decode step.  Returns (output (B, 1, D), cache, aux) with
    ``aux["live_tokens"]``/``aux["reads_tokens"]`` (B,) and
    ``aux["attn_impl"]`` ("kernel" | "ref").  The cache is updated in
    place.  ``layer_salt`` (a 0-d int64 tensor holding a uint32; None is
    0) seeds the noise of stochastic policies (Keyformer): the bits of this
    layer's fp32 ``wo[0, 0]``, as :func:`repro_torch.models.transformer.
    layer_salts` gives them.  ``step_aux`` is this layer's entry of the
    policy's ``prepare_step``."""
    dtype = torch_dtype(arch.dtype)
    b = x_t.shape[0]
    dms = arch.dms
    q_raw, k_new, v_new = project_qkv(p, x_t, cfg, dtype)
    if pos_t is None:
        pos_t = cache.length
    pos_lane = torch.as_tensor(pos_t, dtype=torch.int32,
                               device=x_t.device).expand(b)
    pol = policy_lib.get_policy(cache.policy)

    alpha_bin = None
    if pol.alpha_mode == "dms" and dms.enabled:
        alpha_bin, q_raw = dms_lib.infer_alphas(q_raw, cfg.num_kv_heads, dms)
        alpha_bin = alpha_bin[..., 0]                         # (B, Hkv)
    elif pol.alpha_mode == "always":
        logits = dms_lib.alpha_logits_from_q(q_raw, cfg.num_kv_heads,
                                             dms.logit_bias)
        alpha_bin = dms_lib.binary_alpha(logits)[..., 0]
        q_raw = dms_lib.zero_borrowed_neuron(q_raw, cfg.num_kv_heads)

    q = apply_rope(q_raw, pos_lane[:, None], cfg.rope_theta, cfg.rope)
    k_new = apply_rope(k_new, pos_lane[:, None], cfg.rope_theta, cfg.rope)
    k_new_c = k_new.transpose(1, 2)                           # (B, Hkv, 1, Dh)
    v_new_c = v_new.transpose(1, 2)

    window = layer_window if layer_window is not None else cfg.window
    pol_aux = {"alpha_bin": alpha_bin, "pos_t": pos_lane, "attn_cfg": cfg,
               "arch": arch, "dtype": dtype, "active": active,
               "layer_salt": layer_salt, **(step_aux or {})}
    inner, spec, meters = pol.decode_update(cache.cache, q, k_new_c, v_new_c,
                                            pol_aux)
    out, w_group, impl = _masked_decode(
        q, spec, window if spec.positions is not None else None, cfg,
        use_kernel, pos_lane, need_weights=spec.needs_weights)
    if spec.needs_weights:
        inner, meters = pol.post_attend(inner, w_group, active=active,
                                        aux=pol_aux)
    cache = dataclasses.replace(cache, cache=inner)
    y = out.reshape(b, 1, cfg.num_heads * cfg.head_dim) @ p["wo"].to(dtype)
    aux = dict(meters, attn_impl=impl)
    return y.to(x_t.dtype), cache, aux


def _masked_decode(q, spec, window, cfg, use_kernel, pos_t=None,
                   need_weights=False):
    """q: (B, 1, Hq, Dh); ``spec``: an AttendSpec.  Local-window layers also
    hide slots with position <= t - window (a subset of ``spec.visible``, so
    the table stays a valid cover).  Hkv comes from the K arena (the page
    map when paged), never from the mask: a lazy (B, 1, P) mask is
    materialised to (B, Hkv, P), as the reference's ``AttendSpec`` does.
    Returns (out (B, 1, Hq, Dh), the group-summed post-softmax weights (B,
    Hkv, P) fp32 or None, the implementation used: "kernel" | "ref")."""
    vis, pos = spec.visible, spec.positions
    b, _, hq, dh = q.shape
    hkv = (spec.phys if spec.pool is not None else spec.k).shape[1]
    g = hq // hkv
    if window is not None and pos is not None and pos_t is not None:
        ptl = torch.as_tensor(pos_t, dtype=torch.int32, device=q.device).expand(b)
        vis = vis & (pos > (ptl[:, None, None] - window))
    if vis.shape[1] != hkv:
        vis = vis.expand(b, hkv, vis.shape[2]).contiguous()
    if use_kernel:
        res = dkops.dms_decode_attention(
            q, spec.k, spec.v, vis, block_tbl=spec.block_tbl,
            block_n=spec.block_n, block_p=spec.block_p or None,
            logit_cap=cfg.logit_softcap, pool_k=spec.pool_k,
            pool_v=spec.pool_v, phys=spec.phys, need_weights=need_weights)
        if need_weights:
            return res[0], res[1], "kernel"
        return res, None, "kernel"
    k, v = spec.kv()              # a paged spec gathers its dense view here
    # bf16 operands, fp32 accumulation: the products of bf16 values are exact
    # in fp32, so fp32 matmuls of the upcast operands reproduce it
    qg = q[:, 0].reshape(b, hkv, g, dh).to(k.dtype)
    scores = torch.einsum("bhgd,bhpd->bhgp", qg.float(), k.float())
    scores = softcap(scores * (dh ** -0.5), cfg.logit_softcap)
    scores = torch.where(vis[:, :, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgp,bhpd->bhgd", w.to(v.dtype).float(), v.float())
    return (out.reshape(b, 1, hq, dh).to(q.dtype),
            w.sum(dim=2) if need_weights else None, "ref")
