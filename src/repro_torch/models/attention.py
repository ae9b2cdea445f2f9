"""GQA decode attention over a policy cache; DMS is a first-class mode.

:func:`decode_attention` runs one decode token against a
:class:`~repro_torch.core.policy.PolicyCache`: project q/k/v, take the DMS
eviction decision from the borrowed query neuron, rotate q and k, let the
policy absorb the token, and attend — through the block-table flash-decode
kernel (``use_kernel=True``) or the reference einsum path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import dms as dms_lib
from repro_torch.core import policy as policy_lib
from repro_torch.core.config import ArchConfig, AttentionConfig
from repro_torch.device import torch_dtype
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
) -> Tuple[torch.Tensor, policy_lib.PolicyCache, Dict[str, Any]]:
    """One decode step.  Returns (output (B, 1, D), cache, aux) with
    ``aux["live_tokens"]``/``aux["reads_tokens"]`` (B,) and
    ``aux["attn_impl"]`` ("kernel" | "ref").  The cache is updated in
    place."""
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

    q = apply_rope(q_raw, pos_lane[:, None], cfg.rope_theta, cfg.rope)
    k_new = apply_rope(k_new, pos_lane[:, None], cfg.rope_theta, cfg.rope)
    k_new_c = k_new.transpose(1, 2)                           # (B, Hkv, 1, Dh)
    v_new_c = v_new.transpose(1, 2)

    window = layer_window if layer_window is not None else cfg.window
    pol_aux = {"alpha_bin": alpha_bin, "pos_t": pos_lane, "attn_cfg": cfg,
               "arch": arch, "dtype": dtype, "active": active}
    inner, spec, live = pol.decode_update(cache.cache, q, k_new_c, v_new_c,
                                          pol_aux)
    out, impl = _masked_decode(q, spec, window if spec.positions is not None
                               else None, cfg, use_kernel, pos_lane)
    cache = dataclasses.replace(cache, cache=inner)
    y = out.reshape(b, 1, cfg.num_heads * cfg.head_dim) @ p["wo"].to(dtype)
    aux = {"live_tokens": live, "reads_tokens": live, "attn_impl": impl}
    return y.to(x_t.dtype), cache, aux


def _masked_decode(q, spec, window, cfg, use_kernel, pos_t=None):
    """q: (B, 1, Hq, Dh); ``spec``: an AttendSpec.  Local-window layers also
    hide slots with position <= t - window (a subset of ``spec.visible``, so
    the table stays a valid cover).  Returns (out (B, 1, Hq, Dh), the
    implementation used: "kernel" | "ref")."""
    k, v, vis, pos = spec.k, spec.v, spec.visible, spec.positions
    b, _, hq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    if window is not None and pos is not None and pos_t is not None:
        ptl = torch.as_tensor(pos_t, dtype=torch.int32, device=q.device).expand(b)
        vis = vis & (pos > (ptl[:, None, None] - window))
    if use_kernel:
        out = dkops.dms_decode_attention(
            q, k, v, vis, block_tbl=spec.block_tbl, block_n=spec.block_n,
            block_p=spec.block_p or None, logit_cap=cfg.logit_softcap)
        return out, "kernel"
    # bf16 operands, fp32 accumulation: the products of bf16 values are exact
    # in fp32, so fp32 matmuls of the upcast operands reproduce it
    qg = q[:, 0].reshape(b, hkv, g, dh).to(k.dtype)
    scores = torch.einsum("bhgd,bhpd->bhgp", qg.float(), k.float())
    scores = softcap(scores * (dh ** -0.5), cfg.logit_softcap)
    scores = torch.where(vis[:, :, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgp,bhpd->bhgd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype), "ref"
