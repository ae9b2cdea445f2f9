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
  flash-decode kernel (``use_kernel=True``) or the reference einsum path;
  cross-attention over an encoder memory (``cross_kv``) reads no cache.
  A policy that evicts by attention weights (TOVA, H2O, Keyformer) gets
  them back: the kernel in its weights-out mode, or the reference softmax.
* :func:`attention_ref` — the O(T²) masked-softmax oracle.
* :func:`attention_chunked` — flash-style chunked attention in plain
  PyTorch (online softmax): the dry-run's lowering path
  (``attn_impl="chunked"``), which fake tensors can run where the CUDA
  kernels cannot.
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
from repro_torch.kernels.dms_decode import ref as dkref
from repro_torch.models.layers import apply_rope, softcap
from repro_torch.parallel import spmd

NEG_INF = dms_lib.NEG_INF


def project_qkv(p: dict, x: torch.Tensor, cfg: AttentionConfig,
                dtype: torch.dtype):
    b, t, _ = x.shape
    xd = x.to(dtype)
    q = spmd.split_heads(xd @ p["wq"].to(dtype), cfg.num_heads, cfg.head_dim)
    k = spmd.split_heads(xd @ p["wk"].to(dtype), cfg.num_kv_heads,
                         cfg.head_dim)
    v = spmd.split_heads(xd @ p["wv"].to(dtype), cfg.num_kv_heads,
                         cfg.head_dim)
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


def attention_chunked(
    q: torch.Tensor,                 # (B, Tq, Hq, Dh)
    k: torch.Tensor,                 # (B, Tk, Hkv, Dh)
    v: torch.Tensor,
    alpha: Optional[torch.Tensor],   # (B, Hkv, Tk) or None
    *,
    dms_delay: int = 0,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    chunk_q: int = 2048,
    chunk_k: int = 2048,
) -> torch.Tensor:
    """Flash-style chunked attention (online softmax over ``chunk_q`` ×
    ``chunk_k`` tiles).  Never materialises T×T: the live intermediate is
    one tile's scores.  Chunk pairs dead by causality or the window are
    skipped statically.  Products take the operands in their dtype and sum
    in fp32 (the reference's ``preferred_element_type``): the products of
    bf16 values are exact in fp32, so fp32 einsums of the upcast operands
    give the same sums.  The DMS delayed-eviction mask adds the keys' log
    survival where ``q - k >= dms_delay``.

    The reference has a second form, ``attention_chunked_scan``, whose
    ``lax.scan`` makes XLA's buffer liveness sequential for its memory
    pass; an eager loop already runs one tile at a time, so
    ``attn_impl="chunked_scan"`` takes this same function."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    cq, ck = min(chunk_q, tq), min(chunk_k, tk)
    nq, nk = -(-tq // cq), -(-tk // ck)
    scale = dh ** -0.5
    qg = q.reshape(b, tq, hkv, g, dh)
    log_surv = (dms_lib.eviction_log_survival(alpha) if alpha is not None
                else None)
    dev = q.device

    out_rows = []
    for qi in range(nq):
        q0, q1 = qi * cq, min((qi + 1) * cq, tq)
        # (B, Hkv, G, cq, Dh) in the key dtype, then fp32
        qc = qg[:, q0:q1].to(k.dtype).permute(0, 2, 3, 1, 4).float()
        m = torch.full((b, hkv, g, q1 - q0), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, q1 - q0), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, q1 - q0, dh), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k0, k1 = ki * ck, min((ki + 1) * ck, tk)
            if causal and k0 > q1 - 1:
                continue                                   # static causal skip
            if window is not None and k1 - 1 < q0 - window + 1:
                continue                                   # static window skip
            kc = k[:, k0:k1].permute(0, 2, 3, 1).float()[:, :, None]
            vc = v[:, k0:k1]
            s = torch.matmul(qc, kc) * scale             # (B, Hkv, G, cq, ck)
            if logit_cap is not None:
                s = logit_cap * torch.tanh(s / logit_cap)
            # masks only where a tile straddles a boundary (static ranges)
            near, far = q0 - (k1 - 1), (q1 - 1) - k0        # min / max q - k
            ids = None
            if ((log_surv is not None and dms_delay > 0 and far >= dms_delay)
                    or (causal and near < 0)
                    or (window is not None and far >= window)):
                ids = (torch.arange(q0, q1, device=dev)[:, None]
                       - torch.arange(k0, k1, device=dev)[None, :])
            if log_surv is not None and dms_delay > 0 and far >= dms_delay:
                ls = log_surv[:, :, None, None, k0:k1]
                s = s + (ls if near >= dms_delay
                         else torch.where(ids >= dms_delay, ls, 0.0))
            dead = None
            if causal and near < 0:
                dead = ids < 0
            if window is not None and far >= window:
                dead = (ids >= window) if dead is None else dead | (ids >= window)
            if dead is not None:
                s = torch.where(dead, NEG_INF, s)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                p.to(vc.dtype).float(),
                vc.permute(0, 2, 1, 3).float()[:, :, None])
            m = m_new
        l = torch.where(l <= 0.0, 1.0, l)
        out_rows.append((acc / l[..., None]).permute(0, 3, 1, 2, 4))
    out = torch.cat(out_rows, dim=1)                     # (B, Tq, Hkv, G, Dh)
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
    attn_impl: Optional[str] = None,   # ref | chunked | chunked_scan | kernel
    collect_kv: bool = False,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence attention; returns (output (B, T, D), aux).

    aux keys: ``alpha_sum`` / ``alpha_count`` (the DMS loss) in the DMS
    modes, ``alpha_bin`` in ``dms_eval``.  ``dms_train`` takes its Gumbel
    noise from the uniforms ``dms_u``; without them it uses the
    deterministic relaxation, as the reference does without ``dms_rng``.
    ``attn_impl`` picks the attention core: ``"kernel"`` the flash kernels,
    ``"chunked"`` (or ``"chunked_scan"``, the same loop here)
    :func:`attention_chunked` with ``max(2048, T // 8)`` chunks, ``"ref"``
    the masked-softmax reference; None takes ``"kernel"`` under
    ``use_kernel``, else ``"ref"``.  ``collect_kv`` adds the prefill export:
    ``k_rope`` and ``v`` (B, Hkv, T, Dh) post-RoPE, and in ``dms_eval``
    ``retained`` (:func:`~repro_torch.core.dms.retained_after_prefill`).

    ``kv_override`` (k, v), each (B, S, Hkv, Dh), is cross-attention's
    encoder memory: only q is projected from ``x``, k is not rotated, and
    attention always takes the masked-softmax reference, as the
    reference's kernel branch requires no override."""
    dtype = torch_dtype(arch.dtype)
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)
    if kv_override is None:
        q_raw, k, v = project_qkv(p, x, cfg, dtype)
    else:
        q_raw = spmd.split_heads(x.to(dtype) @ p["wq"].to(dtype),
                                 cfg.num_heads, cfg.head_dim)
        k, v = kv_override

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

    rope_pos = positions
    if cfg.rope == "mrope" and positions.dim() == 1:
        rope_pos = positions.expand((3,) + positions.shape)
    q = apply_rope(q_raw, rope_pos, cfg.rope_theta, cfg.rope,
                   cfg.mrope_sections)
    if kv_override is None:
        k = apply_rope(k, rope_pos, cfg.rope_theta, cfg.rope,
                       cfg.mrope_sections)
    window = layer_window if layer_window is not None else cfg.window
    impl = attn_impl or ("kernel" if use_kernel else "ref")
    if impl not in ("ref", "chunked", "chunked_scan", "kernel"):
        raise ValueError(f"unknown attn_impl {impl!r}")

    if impl == "kernel" and kv_override is None:
        out = spmd.local_attention(
            fkops.dms_flash_attention, q, k, v, alpha, window=window,
            dms_window=dms.window if alpha is not None else 0,
            causal=cfg.causal, logit_cap=cfg.logit_softcap,
            immediate=dms.immediate_eviction)
    elif impl in ("chunked", "chunked_scan") and kv_override is None:
        delay = ((1 if dms.immediate_eviction else dms.window)
                 if alpha is not None else 0)
        chunk = max(2048, t // 8)    # the reference's bound on chunk pairs
        out = spmd.local_attention(
            attention_chunked, q, k, v, alpha, dms_delay=delay,
            causal=cfg.causal, window=window, logit_cap=cfg.logit_softcap,
            chunk_q=chunk, chunk_k=chunk)
    else:
        tk = k.shape[1]
        i = torch.arange(t, device=x.device)[:, None]
        j = torch.arange(tk, device=x.device)[None, :]
        mask = None
        if cfg.causal:
            mask = torch.where(j <= i, 0.0, NEG_INF)
        if window is not None:
            wm = torch.where((i - j) < window, 0.0, NEG_INF)
            mask = wm if mask is None else mask + wm
        if mask is not None:
            mask = mask.expand(b, cfg.num_kv_heads, t, tk)
        if alpha is not None:
            qpos = positions if positions.dim() == 1 else torch.arange(
                t, device=x.device)
            dmask = dms_lib.build_dms_mask(
                alpha, qpos, torch.arange(tk, device=x.device), dms,
                causal=False)
            mask = dmask if mask is None else mask + dmask
        out = attention_ref(q, k, v, mask, cfg.logit_softcap)

    y = spmd.merge_heads(out) @ p["wo"].to(dtype)
    if collect_kv:
        aux["k_rope"] = k.transpose(1, 2)
        aux["v"] = v.transpose(1, 2)
        if "alpha_bin" in aux:
            aux["retained"] = dms_lib.retained_after_prefill(
                aux["alpha_bin"], t, dms)
    return y.to(x.dtype), aux


def decode_attention(
    p: dict,
    x_t: torch.Tensor,             # (B, 1, D)
    cache: Optional[policy_lib.PolicyCache],
    cfg: AttentionConfig,
    arch: ArchConfig,
    *,
    layer_window: Optional[int] = None,
    pos_t=None,                    # int or per-lane (B,) positions
    use_kernel: bool = False,
    active: Optional[torch.Tensor] = None,   # (B,) live-lane mask
    layer_salt: Optional[torch.Tensor] = None,
    step_aux: Optional[Dict[str, Any]] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor,
                             torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[policy_lib.PolicyCache], Dict[str, Any]]:
    """One decode step.  Returns (output (B, 1, D), cache, aux) with
    ``aux["live_tokens"]``/``aux["reads_tokens"]`` (B,) and
    ``aux["attn_impl"]`` ("kernel" | "ref").  The cache is updated in
    place.  ``layer_salt`` (a 0-d int64 tensor holding a uint32; None is
    0) seeds the noise of stochastic policies (Keyformer): the bits of this
    layer's fp32 ``wo[0, 0]``, as :func:`repro_torch.models.transformer.
    layer_salts` gives them.  ``step_aux`` is this layer's entry of the
    policy's ``prepare_step``.

    ``cross_kv`` (k, v (B, Hkv, S, Dh), valid (B, Hkv, S) bool) is
    cross-attention over the encoder memory: ``cache`` is None and nothing
    is written; attention takes the decode kernel's dense mode (no table:
    the wrapper derives one from ``valid``) or the reference einsum; the
    meters count the valid slots."""
    dtype = torch_dtype(arch.dtype)
    b = x_t.shape[0]
    dms = arch.dms
    if cross_kv is not None:
        q = spmd.split_heads(x_t.to(dtype) @ p["wq"].to(dtype),
                             cfg.num_heads, cfg.head_dim)  # no RoPE
        k_all, v_all, valid = cross_kv
        out, _, impl = _masked_decode(
            q, policy_lib.AttendSpec(k_all, v_all, valid), None, cfg,
            use_kernel)
        y = spmd.merge_heads(out) @ p["wo"].to(dtype)
        live = valid.sum(dim=-1).float().mean(dim=-1)
        return y.to(x_t.dtype), cache, {"live_tokens": live,
                                        "reads_tokens": live,
                                        "attn_impl": impl}
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

    rpos = pos_lane[:, None]
    if cfg.rope == "mrope":
        rpos = rpos.expand((3,) + rpos.shape)
    q = apply_rope(q_raw, rpos, cfg.rope_theta, cfg.rope, cfg.mrope_sections)
    k_new = apply_rope(k_new, rpos, cfg.rope_theta, cfg.rope,
                       cfg.mrope_sections)
    k_new_c = k_new.transpose(1, 2)                           # (B, Hkv, 1, Dh)
    v_new_c = v_new.transpose(1, 2)

    window = layer_window if layer_window is not None else cfg.window
    pol_aux = {"alpha_bin": alpha_bin, "pos_t": pos_lane, "attn_cfg": cfg,
               "arch": arch, "dtype": dtype, "active": active,
               "layer_salt": layer_salt, **(step_aux or {})}

    def core(inner, q, k_new_c, v_new_c, pol_aux, attend):
        inner, spec, meters = pol.decode_update(inner, q, k_new_c, v_new_c,
                                                pol_aux)
        out, w_group, impl = attend(
            q, spec, window if spec.positions is not None else None, cfg,
            use_kernel, pol_aux["pos_t"], need_weights=spec.needs_weights)
        if spec.needs_weights:
            inner, meters = pol.post_attend(inner, w_group,
                                            active=pol_aux["active"],
                                            aux=pol_aux)
        return inner, out, meters, impl

    inner, out, meters, impl = spmd.local_decode(
        core, cache.cache, q, k_new_c, v_new_c, pol_aux,
        _masked_decode, _split_decode)
    cache = dataclasses.replace(cache, cache=inner)
    y = spmd.merge_heads(out) @ p["wo"].to(dtype)
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


@dataclasses.dataclass
class ShardPartial:
    """One slot shard's part of a decode step's attention (see
    :func:`shard_partial`): its max ``m`` and denominator ``l`` (B, Hkv, G)
    fp32, its unnormalised accumulator ``acc`` (B, Hkv, G, Dh) fp32 and,
    when weights were asked for, ``weights(m_all, l_all)`` -> the shard's
    (B, Hkv, P_local) group-summed weights under the combined statistics."""

    m: torch.Tensor
    l: torch.Tensor
    acc: torch.Tensor
    weights: Optional[Any] = None


def shard_partial(q, spec, window, cfg, use_kernel, pos_t, offset: int,
                  need_weights: bool = False) -> ShardPartial:
    """The attention of :func:`_masked_decode` on one slot shard of a split
    arena, before the shards are combined: ``spec`` holds the local K/V
    (slots ``[offset, offset + P_local)``), the whole slot mask and
    positions and the whole row's block table.  Under ``use_kernel`` the
    decode kernel's slot-shard mode reads the shard's listed slots (on a
    CUDA tensor it launches the kernel or raises); else the plain einsum
    over the shard."""
    if spec.pool is not None:
        raise NotImplementedError("a slot-split arena has no pool: the "
                                  "sharding rule replicates the pool")
    k, v = spec.k, spec.v
    p_loc = k.shape[2]
    vis, pos = spec.visible, spec.positions
    b, _, hq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    vis = vis[..., offset:offset + p_loc]
    if window is not None and pos is not None and pos_t is not None:
        pos = pos[..., offset:offset + p_loc]
        ptl = torch.as_tensor(pos_t, dtype=torch.int32,
                              device=q.device).expand(b)
        vis = vis & (pos > (ptl[:, None, None] - window))
    vis = vis.expand(b, hkv, p_loc)
    if use_kernel:
        out, m, l, weights = dkops.dms_decode_shard(
            q, k, v, vis.contiguous(), block_tbl=spec.block_tbl,
            block_n=spec.block_n, block_p=spec.block_p, slot_lo=offset,
            logit_cap=cfg.logit_softcap, need_weights=need_weights)
        acc = out[:, 0].reshape(b, hkv, g, dh).float() * l[..., None]
        return ShardPartial(m, l, acc, weights)
    qg = q[:, 0].reshape(b, hkv, g, dh).to(k.dtype)
    scores = torch.einsum("bhgd,bhpd->bhgp", qg.float(), k.float())
    scores = softcap(scores * (dh ** -0.5), cfg.logit_softcap)
    scores = torch.where(vis[:, :, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    acc = torch.einsum("bhgp,bhpd->bhgd", p, v.float())
    weights = None
    if need_weights:
        def weights(m_all, l_all):
            f = torch.exp(m - m_all) / l_all
            return (p * f[..., None]).sum(dim=2)
    return ShardPartial(m, p.sum(dim=-1), acc, weights)


def combine_shards(part: ShardPartial, reduce, q_shape):
    """The step's attention from each shard's :class:`ShardPartial`, by
    :func:`~repro_torch.kernels.dms_decode.ref.combine_partials` with
    ``reduce(x, op)`` (an all-reduce over the slot shards).  Returns (out
    ``q_shape`` fp32, the shard's weights or None)."""
    m, den, num = dkref.combine_partials(part.m, part.l, part.acc, reduce)
    out = num / torch.where(den > 0, den, 1.0)[..., None]
    weights = None if part.weights is None else part.weights(m, den)
    return out.reshape(q_shape), weights


def _split_decode(groups, offset: int):
    """The attention of :func:`_masked_decode` on one slot shard of a split
    arena (:func:`repro_torch.parallel.spmd.local_decode`): each rank
    attends over its shard (:func:`shard_partial`; under ``use_kernel`` the
    decode kernel) and the partial maxima, denominators and outputs are
    reduced over ``groups`` (:func:`combine_shards`).  With
    ``need_weights`` the weights returned are the shard's own (B, Hkv,
    P_local), normalised over the whole row."""

    def reduce(x, op):
        return spmd.all_reduce(x, op, groups)

    def attend(q, spec, window, cfg, use_kernel, pos_t=None,
               need_weights=False):
        part = shard_partial(q, spec, window, cfg, use_kernel, pos_t, offset,
                             need_weights)
        out, weights = combine_shards(part, reduce, q.shape)
        return (out.to(q.dtype), weights,
                "kernel" if use_kernel else "ref")

    return attend
