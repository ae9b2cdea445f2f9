"""Transformer of the port: init, the encoder, the full-sequence forward
(training and prefill), the decode step and the lane lifecycle.

Layers are grouped into *superblocks*, one repetition of
``arch.layer_pattern`` each (gemma2: a local then a global attention
layer), and params keep the reference's layout
(``repro.models.transformer``)::

    {"embed": (V_pad, D),
     "blocks": {"0": <stacked over superblocks>, "1": ...},   # per position
     "enc_blocks": {...}, "enc_final_norm": {...},            # enc-dec only
     "final_norm": {"scale": (D,)[, "bias"]}, "lm_head": (D, V_pad) unless tied}

A position's block holds an attention layer (``attn``/``attn_local``), an
RG-LRU layer (``rglru``: :mod:`repro_torch.models.rglru`) or an SSD layer
(``ssd``: :mod:`repro_torch.models.ssd`), as in recurrentgemma's
(rglru, attn_local) and mamba2's (ssd,) patterns.  An encoder–decoder
(seamless) adds a bidirectional encoder stack over precomputed frame
embeddings (:func:`encode`) and, in every decoder attention block,
cross-attention (``cross_norm``, ``cross``) over the encoder's output
between the self-attention and the MLP; LayerNorm norms carry a ``bias``.

For serving, matmul weights are stored in the compute dtype (cast once, at
load or init); for training they are fp32 (``init_model(dtype=float32)``),
as the reference keeps them, and cast at each matmul.  Norm scales and the
recurrent layers' decay and bias vectors stay fp32.  The tree comes as
:class:`Params`, a dict that also carries each layer's noise salt
(:func:`layer_salts`).  The decode state mirrors it: ``{"0": PolicyCache,
...}``, one cache per attention position and a raw recurrent state
(:class:`~repro_torch.models.rglru.RGLRUState`,
:class:`~repro_torch.models.ssd.SSDState`) per recurrent one, every leaf
stacked over superblocks with the lane axis at position 1; under a
``KVPolicyConfig.layer_map`` two positions may hold two policies.  The
reference scans superblocks with ``jax.lax.scan``; here a Python loop walks
superblocks, then positions, and each layer's cache is a view into the
stacked state, updated in place by the step.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core import dms as dms_lib
from repro_torch.core import policy as policy_lib
from repro_torch.core import threefry
from repro_torch.core.block_pool import BlockPool
from repro_torch.core.config import ArchConfig, KVPolicyConfig
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import attention as attn_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.layers import mlp_apply, norm_apply, softcap

_ATTN_KINDS = ("attn", "attn_local")
_KINDS = _ATTN_KINDS + ("rglru", "ssd")


def check_supported(arch: ArchConfig) -> None:
    """The port runs every model the reference builds: global and local
    attention layers, RG-LRU and SSD recurrent layers, dense or MoE MLPs
    (or none, as mamba2), RMSNorm or LayerNorm, precomputed vision patch
    embeddings, and an encoder over precomputed audio frames with
    cross-attention in the decoder.  What the reference cannot build (an
    unknown layer kind or norm, a layer without its config) raises, and so
    does an encoder of recurrent layers, which no config has."""
    kinds = set(arch.layer_pattern)
    missing = [what for what, bad in (
        (f"layer kinds {sorted(kinds - set(_KINDS))}",
         not kinds <= set(_KINDS)),
        ("attention", arch.attn is None and bool(kinds & set(_ATTN_KINDS))),
        ("an RG-LRU config", arch.rglru is None and "rglru" in kinds),
        ("an SSM config", arch.ssm is None and "ssd" in kinds),
        (f"norm {arch.norm!r}", arch.norm not in ("rmsnorm", "layernorm")),
        (f"frontend {arch.frontend!r}",
         arch.frontend not in ("none", "vision_patches", "audio_frames")),
        ("an encoder of recurrent layers",
         bool(arch.encoder_layers) and not kinds <= set(_ATTN_KINDS)))
        if bad]
    if missing:
        raise NotImplementedError(
            f"{arch.name}: not supported: {', '.join(missing)}")


def _layer_window(arch: ArchConfig, kind: str) -> Optional[int]:
    return arch.attn.window if kind == "attn_local" else None


def _attn_positions(arch: ArchConfig) -> List[int]:
    return [pi for pi, kind in enumerate(arch.layer_pattern)
            if kind in _ATTN_KINDS]


def _layers(arch: ArchConfig):
    """(layer index, superblock, position, kind) in the reference's layer
    order: superblocks, then the positions of the pattern."""
    period = arch.pattern_period
    for sb in range(arch.num_superblocks):
        for pi, kind in enumerate(arch.layer_pattern):
            yield sb * period + pi, sb, pi, kind


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


class Params(dict):
    """A params tree (the dict above) that also carries ``layer_salt``:
    (L,) int64 in the reference's layer order (superblock-major), the IEEE
    bits of each attention layer's fp32 ``attn.wo[0, 0]`` (0 for a
    recurrent layer, which reads none).

    The reference seeds stochastic policies (Keyformer) per layer with those
    bits, taken from its fp32 master weights; a bf16 copy no longer holds
    them (its upcast gives other bits, hence other noise and other tokens),
    so :func:`init_model` and :func:`repro_torch.bridge.params_from_numpy`
    record them before the cast.  It is an attribute, not a key: the tree
    helpers, the optimizer and checkpoints never see it."""

    layer_salt: Optional[torch.Tensor] = None


def layer_salts(params: dict) -> torch.Tensor:
    """(L,) int64 noise salts in layer order: the recorded ``layer_salt``,
    else the bits of each stored ``wo[0, 0]`` (exact when the weights are
    fp32)."""
    salt = getattr(params, "layer_salt", None)
    if salt is None:
        cols = []
        for pi in range(len(params["blocks"])):
            blk = params["blocks"][str(pi)]
            nsb = tree_leaves(blk)[0].shape[0]
            cols.append(threefry.float_bits(blk["attn"]["wo"][:, 0, 0])
                        if "attn" in blk else
                        torch.zeros((nsb,), dtype=torch.int64,
                                    device=params["embed"].device))
        salt = torch.stack(cols, dim=1).reshape(-1)
    return salt


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_model(arch: ArchConfig, *, seed: int = 0,
               device: DeviceLike = None,
               dtype: Optional[torch.dtype] = None) -> dict:
    """Random weights with the reference's distributions and scales
    (N(0, 1) · d_in^-0.5 for projections and experts, N(0, 1) · 0.02 for
    the embedding and the router, ones for norm scales and zeros for
    LayerNorm biases; the recurrent
    layers' as :func:`~repro_torch.models.rglru.init_rglru` and
    :func:`~repro_torch.models.ssd.init_ssd` draw them), drawn from a
    seeded :class:`torch.Generator` on ``device``.  The draws differ from
    the reference's threefry streams; tests copy reference weights in
    through :func:`repro_torch.bridge.params_from_numpy` instead.  Matmul
    weights take ``dtype`` (default: the compute dtype ``arch.dtype``); the
    layer salts come from the fp32 draws (:class:`Params`)."""
    check_supported(arch)
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(arch.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, nsb, vp = arch.d_model, arch.num_superblocks, arch.padded_vocab
    a, mlp = arch.attn, arch.mlp

    def normal(shape, scale, first=None):
        """N(0, 1) * scale in ``dtype``; ``first`` (shape[0],) fp32, if
        given, receives each row's first fp32 draw."""
        out = torch.empty(shape, dtype=dtype, device=dev)
        row = out[0].numel()
        step = max(1, (1 << 26) // row)     # bounded fp32 temporaries
        for i in range(0, shape[0], step):
            n = min(step, shape[0] - i)
            x = torch.randn((n,) + tuple(shape[1:]), generator=gen,
                            device=dev) * scale
            if first is not None:
                first[i:i + n] = x.reshape(n, -1)[:, 0]
            out[i:i + n] = x
        return out

    def dense(d_in, d_out, first=None, n=nsb):
        return normal((n, d_in, d_out), d_in ** -0.5, first)

    def norm(*lead):
        f32 = dict(dtype=torch.float32, device=dev)
        out = {"scale": torch.ones(lead + (d,), **f32)}
        if arch.norm == "layernorm":
            out["bias"] = torch.zeros(lead + (d,), **f32)
        return out

    def attn_params(first=None, n=nsb):
        return {"wq": dense(d, a.num_heads * a.head_dim, n=n),
                "wk": dense(d, a.num_kv_heads * a.head_dim, n=n),
                "wv": dense(d, a.num_kv_heads * a.head_dim, n=n),
                "wo": dense(a.num_heads * a.head_dim, d, first, n=n)}

    def mlp_params(n=nsb):
        f, moe = mlp.d_ff, mlp.moe
        names = [("w_gate", d, f)] if mlp.kind in ("swiglu", "geglu") else []
        names += [("w_up", d, f), ("w_down", f, d)]
        if moe is None:
            return {nm: dense(i, o, n=n) for nm, i, o in names}
        e = moe.num_experts
        return {"router": normal((n, d, e), 0.02),
                **{nm: normal((n, e, i, o), i ** -0.5)
                   for nm, i, o in names}}

    def attn_block(n, first=None, cross=False):
        """An attention layer's block over ``n`` superblocks: attention,
        its post-norm, cross-attention if ``cross``, the MLP."""
        blk = {"attn_norm": norm(n), "attn": attn_params(first, n)}
        if arch.post_norm:
            blk["attn_post_norm"] = norm(n)
        if cross:
            blk.update(cross_norm=norm(n), cross=attn_params(n=n))
        if mlp is not None:
            blk.update(mlp_norm=norm(n), mlp=mlp_params(n))
            if arch.post_norm:
                blk["mlp_post_norm"] = norm(n)
        return blk

    params = Params({"embed": normal((vp, d), 0.02), "final_norm": norm()})
    if not arch.tie_embeddings:
        params["lm_head"] = normal((d, vp), d ** -0.5)

    def stacked_normal(shape, scale):
        return normal((nsb,) + tuple(shape), scale)

    def stacked_uniform(shape, lo, hi):
        return torch.rand((nsb,) + tuple(shape), generator=gen,
                          device=dev) * (hi - lo) + lo

    wo00 = torch.zeros((nsb, arch.pattern_period), dtype=torch.float32,
                       device=dev)
    params["blocks"] = {}
    for pi, kind in enumerate(arch.layer_pattern):
        if kind == "ssd":
            blk = {"norm": norm(nsb),
                   "ssd": ssd_lib.init_ssd(d, arch.ssm, stacked_normal)}
        elif kind == "rglru":
            blk = {"rglru_norm": norm(nsb),
                   "rglru": rglru_lib.init_rglru(d, arch.rglru,
                                                 stacked_normal,
                                                 stacked_uniform)}
            if mlp is not None:
                blk.update(mlp_norm=norm(nsb), mlp=mlp_params())
        else:
            blk = attn_block(nsb, wo00[:, pi], arch.cross_attention)
        params["blocks"][str(pi)] = blk
    if arch.encoder_layers:
        # the encoder: the pattern's attention blocks over encoder_layers /
        # period superblocks, no cross-attention
        ne = arch.encoder_layers // arch.pattern_period
        params["enc_blocks"] = {str(pi): attn_block(ne)
                                for pi in range(arch.pattern_period)}
        params["enc_final_norm"] = norm()
    params.layer_salt = threefry.float_bits(wo00.reshape(-1))
    return params


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def round_to_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` as ``torch.tensor(value, dtype=dtype)``
    rounds it (to fp32 first, then to nearest even), in host arithmetic: a
    step reads no tensor's value for a constant."""
    f32 = struct.unpack("<f", struct.pack("<f", value))[0]
    if dtype == torch.float32:
        return f32
    if dtype == torch.float16:
        return struct.unpack("<e", struct.pack("<e", f32))[0]
    if dtype != torch.bfloat16:
        raise ValueError(f"no host rounding to {dtype}")
    bits = struct.unpack("<I", struct.pack("<f", f32))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def embed_tokens(params: dict, tokens: torch.Tensor, arch: ArchConfig,
                 frontend_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings in the compute dtype, times the embedding multiplier
    rounded to that dtype first (as the reference multiplies), with
    ``frontend_embeds`` (B, F, D), if given, prepended."""
    x = params["embed"][tokens.long()].to(torch_dtype(arch.dtype))
    if arch.embedding_multiplier != 1.0:
        x = x * round_to_dtype(arch.embedding_multiplier, x.dtype)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return x


def lm_logits(params: dict, x: torch.Tensor, arch: ArchConfig) -> torch.Tensor:
    """fp32 logits over the padded vocab; pad rows masked to -1e30."""
    h = norm_apply(params["final_norm"], x, arch.norm, arch.norm_eps)
    dtype = torch_dtype(arch.dtype)
    w = params["embed"].t() if arch.tie_embeddings else params["lm_head"]
    logits = softcap((h.to(dtype) @ w.to(dtype)).float(), arch.logit_softcap)
    if arch.padded_vocab != arch.vocab_size:
        live = torch.arange(arch.padded_vocab, device=x.device) < arch.vocab_size
        logits = torch.where(live, logits, -1e30)
    return logits


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------


def layer_noise(arch: ArchConfig, batch: int, seq: int,
                generator: Optional[torch.Generator],
                device) -> List[torch.Tensor]:
    """One (B, Hkv, T) tensor of Gumbel uniforms per layer, in layer order,
    all drawn before the layer loop (so a recomputed layer sees the same
    noise)."""
    gen = generator
    if gen is None:                 # the reference falls back to PRNGKey(0)
        gen = torch.Generator(device=device).manual_seed(0)
    shape = (batch, arch.attn.num_kv_heads if arch.attn else 1, seq)
    return [dms_lib.uniform_noise(shape, gen, device=device)
            for _ in range(arch.num_layers)]


def cross_kv(p: dict, enc_out: torch.Tensor, arch: ArchConfig):
    """Cross-attention's K and V, (B, S, Hkv, Dh) each, projected from the
    encoder output with the layer's ``cross`` weights in the compute dtype
    (no RoPE)."""
    dtype, a = torch_dtype(arch.dtype), arch.attn
    b, s = enc_out.shape[:2]
    e = enc_out.to(dtype)
    return tuple((e @ p[w].to(dtype)).reshape(b, s, a.num_kv_heads,
                                              a.head_dim)
                 for w in ("wk", "wv"))


def _apply_block(p: dict, x: torch.Tensor, arch: ArchConfig, kind: str, *,
                 dtype, causal: bool = True,
                 enc_out: Optional[torch.Tensor] = None,
                 **attn_kw) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One layer over the full sequence, as the reference's
    ``_apply_block_full``: an attention layer is pre-norm attention then
    MLP, each with its post-norm when ``arch.post_norm``; an RG-LRU layer
    pre-norm RG-LRU then MLP; an SSD layer pre-norm SSD alone.  ``causal``
    False makes the self-attention bidirectional (the encoder); with
    ``enc_out`` a block that has ``cross`` weights attends over it (pre-norm
    ``cross_norm``, the masked-softmax reference, no RoPE) between the
    self-attention and the MLP.  Returns (x, aux): the attention's aux and
    the MLP's MoE aux."""
    if kind == "ssd":
        s_out, _ = ssd_lib.ssd_forward(
            p["ssd"], norm_apply(p["norm"], x, arch.norm, arch.norm_eps), arch)
        return x + s_out, {}
    if kind == "rglru":
        r_out, _ = rglru_lib.rglru_forward(
            p["rglru"], norm_apply(p["rglru_norm"], x, arch.norm,
                                   arch.norm_eps), arch)
        x, aux = x + r_out, {}
    else:
        acfg = (arch.attn if causal
                else dataclasses.replace(arch.attn, causal=False))
        h = norm_apply(p["attn_norm"], x, arch.norm, arch.norm_eps)
        a_out, aux = attn_lib.full_attention(
            p["attn"], h, acfg, arch,
            layer_window=_layer_window(arch, kind), **attn_kw)
        if arch.post_norm:
            a_out = norm_apply(p["attn_post_norm"], a_out, arch.norm,
                               arch.norm_eps)
        x = x + a_out
        if enc_out is not None and "cross" in p:
            h = norm_apply(p["cross_norm"], x, arch.norm, arch.norm_eps)
            c_out, _ = attn_lib.full_attention(
                p["cross"], h,
                dataclasses.replace(acfg, causal=False, rope="none"), arch,
                positions=attn_kw.get("positions"),
                kv_override=cross_kv(p["cross"], enc_out, arch))
            x = x + c_out
    if arch.mlp is None:
        return x, aux
    h = norm_apply(p["mlp_norm"], x, arch.norm, arch.norm_eps)
    m_out, m_aux = mlp_apply(p["mlp"], h, arch.mlp, dtype)
    if arch.post_norm and kind in _ATTN_KINDS:
        m_out = norm_apply(p["mlp_post_norm"], m_out, arch.norm, arch.norm_eps)
    return x + m_out, {**aux, **m_aux}


def _columns(blocks: Dict[str, Any]) -> Dict[str, List[Tuple]]:
    """Each position's leaves unbound over superblocks, once: a single
    backward node then stacks every layer's gradient of a leaf."""
    return {pi: [leaf.unbind(0) for leaf in tree_leaves(blk)]
            for pi, blk in blocks.items()}


def encode(params: dict, enc_embeds: torch.Tensor, arch: ArchConfig, *,
           use_kernel: bool = False) -> torch.Tensor:
    """The encoder stack over precomputed frame embeddings (B, S, D), as
    the reference's ``encode``: ``enc_blocks`` in the pattern's order,
    bidirectional unless ``arch.encoder_bidirectional`` is False, mode
    ``vanilla`` (no DMS), positions ``0..S-1``, then ``enc_final_norm``.
    ``use_kernel`` runs its self-attention through the flash kernels
    (``causal=False``)."""
    check_supported(arch)
    dtype = torch_dtype(arch.dtype)
    x = enc_embeds.to(dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    blocks = params["enc_blocks"]
    columns = _columns(blocks)
    for sb in range(arch.encoder_layers // arch.pattern_period):
        for pi, kind in enumerate(arch.layer_pattern):
            key = str(pi)
            p = tree_unflatten(blocks[key], [c[sb] for c in columns[key]])
            x, _ = _apply_block(p, x, arch, kind, dtype=dtype,
                                causal=not arch.encoder_bidirectional,
                                mode="vanilla", positions=positions,
                                use_kernel=use_kernel)
    return norm_apply(params["enc_final_norm"], x, arch.norm, arch.norm_eps)


def model_forward(
    params: dict,
    tokens: torch.Tensor,                      # (B, T_text) int
    arch: ArchConfig,
    *,
    mode: str = "vanilla",                     # vanilla | dms_train | dms_eval | dms_phase1
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,   # per layer, dms_train
    positions: Optional[torch.Tensor] = None,
    neuron_scale=0.0,
    use_kernel: bool = False,
    collect_kv: bool = False,
    remat: bool = False,
    frontend_embeds: Optional[torch.Tensor] = None,   # (B, F, D)
    enc_embeds: Optional[torch.Tensor] = None,        # (B, S_enc, D)
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full forward.  Returns (logits (B, T, V_pad) fp32, aux) with aux
    ``alpha_sum`` (0-d fp32 tensor), ``alpha_count`` (float) and
    ``moe_aux_loss`` (0-d fp32) summed over layers, as the reference's
    ``_scan_blocks`` aggregates them.  ``frontend_embeds`` are prepended to
    the token embeddings (T counts them).  An encoder–decoder given
    ``enc_embeds`` runs :func:`encode` first (through the flash kernels
    under ``use_kernel``), its decoder layers cross-attend over the result,
    and aux carries it as ``enc_out``.

    ``dms_train`` draws each layer's Gumbel noise from ``uniforms[layer]``
    (layer order: superblocks, then positions) if given (a test feeds the
    reference's draws), else from ``generator`` (seed 0 when None).
    ``remat`` recomputes each layer in the backward pass
    (:func:`torch.utils.checkpoint.checkpoint`).  ``collect_kv`` adds the
    prefill export ``aux["layer_kv"]``: ``{"0": {"k_rope", "v"[,
    "retained", "alpha_bin"]}, ...}``, one entry per pattern position, each
    leaf stacked over superblocks (nsb, B, Hkv, T, ...), as the
    reference's scan stacks them."""
    check_supported(arch)
    enc_out = None
    if arch.encoder_layers and enc_embeds is not None:
        enc_out = encode(params, enc_embeds, arch, use_kernel=use_kernel)
    x = embed_tokens(params, tokens, arch, frontend_embeds)
    b, t = x.shape[:2]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)
    if mode == "dms_train" and arch.dms.enabled and uniforms is None:
        uniforms = layer_noise(arch, b, t, generator, x.device)
    dtype = torch_dtype(arch.dtype)
    blocks = params["blocks"]
    columns = _columns(blocks)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    a_sum, moe_sum, a_cnt = zero, zero, 0.0
    kv_keys = ("k_rope", "v", "retained", "alpha_bin")
    layer_kv: Dict[str, List[Dict[str, torch.Tensor]]] = {
        str(pi): [] for pi in range(arch.pattern_period)}

    def layer(x, sb, pi, kind, u, enc_out):
        key = str(pi)
        p = tree_unflatten(blocks[key], [c[sb] for c in columns[key]])
        x, aux = _apply_block(
            p, x, arch, kind, dtype=dtype, enc_out=enc_out, mode=mode,
            dms_u=u, positions=positions, neuron_scale=neuron_scale,
            use_kernel=use_kernel, collect_kv=collect_kv)
        if collect_kv:
            layer_kv[key].append({k: aux[k] for k in kv_keys if k in aux})
        return (x, aux.get("alpha_sum", zero), aux.get("moe_aux_loss", zero),
                aux.get("alpha_count", 0.0))

    for i, sb, pi, kind in _layers(arch):
        u = uniforms[i] if uniforms is not None else None
        if remat:
            x, s, m, cnt = torch.utils.checkpoint.checkpoint(
                layer, x, sb, pi, kind, u, enc_out, use_reentrant=False)
        else:
            x, s, m, cnt = layer(x, sb, pi, kind, u, enc_out)
        a_sum, moe_sum, a_cnt = a_sum + s, moe_sum + m, a_cnt + cnt
    logits = lm_logits(params, x, arch)
    out = {"alpha_sum": a_sum, "alpha_count": a_cnt, "moe_aux_loss": moe_sum}
    if enc_out is not None:
        out["enc_out"] = enc_out
    if collect_kv:
        out["layer_kv"] = {key: {k: torch.stack([d[k] for d in kvs])
                                 for k in kvs[0]}
                           for key, kvs in layer_kv.items()}
    return logits, out


# ---------------------------------------------------------------------------
# decode state and lane lifecycle
# ---------------------------------------------------------------------------


def init_decode_state(arch: ArchConfig, batch: int, max_len: int,
                      policy: KVPolicyConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """One cache per pattern position, stacked over superblocks (lane axis
    at position 1).  An attention position's is provisioned through the
    policy registry with its layer kind (``policy.layer_map`` picks its
    policy) and, for a local layer, its window; a paged policy gets one
    pool per layer, stacked too: pages (nsb, NPOOL, block_p, Dh), ref (nsb,
    NPOOL).  A recurrent position holds its raw zero state (the
    reference's ``_init_layer_cache``): no policy, no pages."""
    check_supported(arch)
    dev = resolve_device(device)
    nsb = arch.num_superblocks
    state = {}
    for pi, kind in enumerate(arch.layer_pattern):
        if kind == "ssd":
            one = ssd_lib.init_ssd_state(batch, arch.d_model, arch.ssm,
                                         device=dev)
        elif kind == "rglru":
            one = rglru_lib.init_rglru_state(batch, arch.d_model, arch.rglru,
                                             device=dev)
        else:
            one = policy_lib.init_policy_cache(
                arch, batch, max_len, policy, layer_kind=kind,
                layer_window=_layer_window(arch, kind), device=dev)
        state[str(pi)] = tree_map(
            lambda a: a.unsqueeze(0).expand((nsb,) + a.shape).contiguous(),
            one)
    return state


def state_from_prefill(arch: ArchConfig, policy: KVPolicyConfig,
                       layer_kv: Dict[str, Any], max_len: int
                       ) -> Dict[str, Any]:
    """A decode state built from :func:`model_forward`'s ``layer_kv``: each
    layer's cache from its position's policy's
    :meth:`KVPolicy.prefill_import` (positions ``0..T-1``; a local layer
    with its window), stacked over superblocks as :func:`init_decode_state`
    stacks them.  Every lane sits at position T, ready to decode.

    A recurrent position raises: the reference has no path from a prefill
    to a recurrent state, and a zero state would decode wrongly."""
    for pi, kind in enumerate(arch.layer_pattern):
        if kind not in _ATTN_KINDS:
            raise NotImplementedError(
                f"{arch.name}: no prefill import for the {kind!r} layer at "
                f"pattern position {pi}; serve it through the decode step")
    state = {}
    for pi, kind in enumerate(arch.layer_pattern):
        kv = layer_kv[str(pi)]
        name = policy.kind_for_layer(kind)
        pol = policy_lib.get_policy(name)
        t = kv["k_rope"].shape[3]
        positions = torch.arange(t, dtype=torch.int32,
                                 device=kv["k_rope"].device)
        caches = [pol.prefill_import(
            arch, policy, kv["k_rope"][sb], kv["v"][sb], positions,
            kv["retained"][sb] if "retained" in kv else None,
            kv["alpha_bin"][sb] if "alpha_bin" in kv else None,
            max_len=max_len, layer_window=_layer_window(arch, kind))
            for sb in range(arch.num_superblocks)]
        state[str(pi)] = policy_lib.PolicyCache(
            tree_map(lambda *xs: torch.stack(xs), caches[0], *caches[1:]),
            name)
    return state


def _map_state(fn_cache, fn_leaf, state, *rest):
    """A state (or a slab) with ``fn_cache(policy, cache, *rest caches)``
    applied to every :class:`~repro_torch.core.policy.PolicyCache` (its
    policy's lifecycle hook) and ``fn_leaf(leaf, *rest leaves)`` to every
    leaf of a raw recurrent state, as the reference maps over every
    leaf."""
    def visit(node, *r):
        if isinstance(node, policy_lib.PolicyCache):
            pol = policy_lib.get_policy(node.policy)
            return policy_lib.PolicyCache(
                fn_cache(pol, node.cache, *(x.cache for x in r)), node.policy)
        if isinstance(node, dict):
            return {k: visit(v, *(x[k] for x in r)) for k, v in node.items()}
        return tree_map(fn_leaf, node, *r)

    return visit(state, *rest)


def fork_decode_state(state: Dict[str, Any], width: int) -> Dict[str, Any]:
    """Shared-prefill fork: clone every lane into ``width`` chains."""
    return _map_state(lambda pol, c: pol.fork_cache(c, width, axis=1),
                      lambda a: a.repeat_interleave(width, dim=1), state)


def gather_lanes(state: Dict[str, Any], src) -> Dict[str, Any]:
    """Lane shuffle: new lane ``l`` is a copy of old lane ``src[l]``."""
    src = torch.as_tensor(src)
    return _map_state(
        lambda pol, c: pol.gather_cache(c, src, axis=1),
        lambda a: a.index_select(1, src.to(device=a.device, dtype=torch.long)),
        state)


def reclaim_lanes(state: Dict[str, Any], reset_mask: torch.Tensor,
                  fresh: Dict[str, Any]) -> Dict[str, Any]:
    """Lanes where ``reset_mask`` (B,) is True return to ``fresh``."""
    return _map_state(
        lambda pol, c, init: pol.reclaim_cache(c, reset_mask, init, axis=1),
        lambda a, init: torch.where(reset_mask.to(a.device).reshape(
            (1, -1) + (1,) * (a.dim() - 2)), init, a),
        state, fresh)


def export_lane_state(state: Dict[str, Any], lane: int) -> Dict[str, Any]:
    """One lane's complete decode state as a width-1-lane state of the same
    structure (new tensors; a paged cache densifies its pages, a recurrent
    state is sliced) — the preemption and prefix snapshot."""
    return _map_state(lambda pol, c: pol.export_prefix(c, lane, axis=1),
                      lambda a: a.narrow(1, lane, 1).clone(), state)


def import_lane_state(state: Dict[str, Any], snap: Dict[str, Any],
                      lane: int) -> Dict[str, Any]:
    """Restore an :func:`export_lane_state` snapshot (on any device) into
    the pristine lane ``lane``; the lane continues exactly where the
    snapshot was taken."""
    dev = next(iter(state.values())).length.device
    snap = tree_map(lambda a: a.to(dev), snap)
    # the index is filled on the device: a host-built one would sync
    idx = torch.full((1,), lane, dtype=torch.long, device=dev)
    return _map_state(
        lambda pol, c, s: pol.import_prefix(c, s, lane, axis=1),
        lambda a, s: a.index_copy(1, idx, s.to(a.dtype)), state, snap)


def init_snapshot_slab(snap: Dict[str, Any], slots: int) -> Dict[str, Any]:
    """A zeroed slab for ``slots`` lane snapshots on ``snap``'s device:
    ``snap`` (an :func:`export_lane_state` exemplar, lane axis 1 of width 1)
    with the lane axis widened to ``slots`` — the prefix cache's hot tier,
    written and read by :func:`store_lane_snapshot` and
    :func:`fetch_lane_snapshot` without leaving the device."""
    return tree_map(lambda a: a.new_zeros(a.shape[:1] + (int(slots),)
                                          + a.shape[2:]), snap)


def store_lane_snapshot(slab: Dict[str, Any], snap: Dict[str, Any],
                        slot: int) -> Dict[str, Any]:
    """Write a width-1 snapshot (on any device) into slab slot ``slot``, in
    place: the device half of a deferred export, or a promotion's one
    host-to-device copy.  Dispatches through :meth:`KVPolicy.import_slab`."""
    def leaf(a, s):
        a.narrow(1, slot, 1).copy_(s)
        return a

    return _map_state(lambda pol, c, s: pol.import_slab(c, s, slot, axis=1),
                     leaf, slab, snap)


def fetch_lane_snapshot(slab: Dict[str, Any], slot: int) -> Dict[str, Any]:
    """The snapshot in slab slot ``slot`` as new device tensors: a hot hit
    feeds it to :func:`import_lane_state` device to device.  Dispatches
    through :meth:`KVPolicy.export_slab`."""
    return _map_state(lambda pol, c: pol.export_slab(c, slot, axis=1),
                     lambda a: a.narrow(1, slot, 1).clone(), slab)


def _structure(node: Any) -> str:
    """The tree structure of a state (types, keys, static fields and empty
    nodes) as a string, leaves as ``*``."""
    if isinstance(node, torch.Tensor):
        return "*"
    if node is None:
        return "None"
    if isinstance(node, dict):
        return "{" + ",".join(f"{k}:{_structure(v)}"
                              for k, v in node.items()) + "}"
    if dataclasses.is_dataclass(node):
        fields = []
        for f in dataclasses.fields(node):
            val = getattr(node, f.name)
            fields.append(f"{f.name}={val!r}" if f.metadata.get("static")
                          else f"{f.name}={_structure(val)}")
        return f"{type(node).__name__}(" + ",".join(fields) + ")"
    raise TypeError(f"not a state tree node: {type(node).__name__}")


def lane_state_signature(state: Dict[str, Any]) -> Tuple:
    """Hashable signature of one lane's snapshot of ``state``: its tree
    structure, and each leaf's shape with the lane axis collapsed and its
    dtype.  Snapshots are interchangeable between states of equal
    signatures only; the prefix cache keys its trees by it."""
    return (_structure(state),
            tuple((tuple(a.shape[:1]) + (1,) + tuple(a.shape[2:]),
                   str(a.dtype)) for a in tree_leaves(state)))


def lane_select(mask: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """Per-lane select over two decode states (lane axis at position 1).
    A :class:`~repro_torch.core.block_pool.BlockPool` has no lane axis: its
    mutations already took the lane mask, so ``on_true``'s is kept whole
    (the per-lane page map selects like any other leaf)."""

    def sel(a, b):
        if isinstance(a, BlockPool):
            return a
        return torch.where(mask.reshape((1, -1) + (1,) * (a.dim() - 2)), a, b)

    return tree_map(sel, on_true, on_false,
                    is_leaf=lambda x: isinstance(x, BlockPool))


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------


def decode_step(
    params: dict,
    token: torch.Tensor,              # (B, 1) int
    state: Dict[str, Any],
    arch: ArchConfig,
    pos_t,                            # int or per-lane (B,)
    *,
    use_kernel: bool = False,
    enc_out: Optional[torch.Tensor] = None,      # (B, S_enc, D)
    enc_valid: Optional[torch.Tensor] = None,    # (B, S_enc) bool
    embed_override: Optional[torch.Tensor] = None,   # (B, 1, D)
    active: Optional[torch.Tensor] = None,   # (B,) bool lane mask
) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """One decode step.  Returns (logits (B, V_pad) fp32, state, aux).

    ``state`` is updated in place and returned.  Lanes where ``active`` is
    False keep their state exactly (a recurrent layer's h, conv history and
    length too) and add zero to ``reads_tokens``; their ``live_tokens`` is
    what the step would have left, as the reference reports it.  Layers
    run in the reference's order (superblocks, then positions); each
    attention position's policy prepares the step once for its stacked
    layers, with their salts.

    With ``enc_out`` each decoder attention layer that has ``cross``
    weights cross-attends over it after its self-attention: K/V projected
    from ``enc_out`` in every layer of every step, as the reference does,
    over the slots ``enc_valid`` leaves visible (default all), through the
    decode kernel's dense mode under ``use_kernel``.  Its meters are not
    added to the step's, as the reference discards them.
    ``embed_override`` replaces the token's embedding."""
    check_supported(arch)
    x = (embed_override if embed_override is not None
         else embed_tokens(params, token, arch))
    b = x.shape[0]
    live = torch.zeros((b,), dtype=torch.float32, device=x.device)
    reads = torch.zeros_like(live)
    dtype = torch_dtype(arch.dtype)
    salts = layer_salts(params).reshape(arch.num_superblocks,
                                        arch.pattern_period)
    prepared = {}
    for pi in _attn_positions(arch):
        stacked = state[str(pi)]
        prepared[pi] = policy_lib.get_policy(stacked.policy).prepare_step(
            stacked.cache, {"layer_salt": salts[:, pi], "active": active})
    impls = set()
    for _, sb, pi, kind in _layers(arch):
        p = tree_map(lambda a: a[sb], params["blocks"][str(pi)])  # views
        cache = tree_map(lambda a: a[sb], state[str(pi)])
        if kind not in _ATTN_KINDS:
            x = _recurrent_layer(p, x, cache, arch, kind, active, dtype)
            continue
        h = norm_apply(p["attn_norm"], x, arch.norm, arch.norm_eps)
        a_out, _, aux = attn_lib.decode_attention(
            p["attn"], h, cache, arch.attn, arch,
            layer_window=_layer_window(arch, kind), pos_t=pos_t,
            use_kernel=use_kernel, active=active, layer_salt=salts[sb, pi],
            step_aux=None if prepared[pi] is None else prepared[pi][sb])
        impls.add(aux["attn_impl"])
        if arch.post_norm:
            a_out = norm_apply(p["attn_post_norm"], a_out, arch.norm,
                               arch.norm_eps)
        x = x + a_out
        live = live + aux["live_tokens"]
        reads = reads + aux["reads_tokens"]
        if enc_out is not None and "cross" in p:
            x = x + _cross_decode(p, x, arch, enc_out, enc_valid, pos_t,
                                  use_kernel, impls)
        if arch.mlp is None:
            continue
        h = norm_apply(p["mlp_norm"], x, arch.norm, arch.norm_eps)
        m_out, _ = mlp_apply(p["mlp"], h, arch.mlp, dtype)
        if arch.post_norm:
            m_out = norm_apply(p["mlp_post_norm"], m_out, arch.norm,
                               arch.norm_eps)
        x = x + m_out
    if active is not None:
        reads = reads * active.to(reads.dtype)
    logits = lm_logits(params, x, arch)[:, 0]
    return logits, state, {"live_tokens": live, "reads_tokens": reads,
                           "attn_impl_kernel": int(impls == {"kernel"})}


def _cross_decode(p: dict, x: torch.Tensor, arch: ArchConfig,
                  enc_out: torch.Tensor, enc_valid: Optional[torch.Tensor],
                  pos_t, use_kernel: bool, impls: set) -> torch.Tensor:
    """One decoder layer's cross-attention output for the decode step
    (pre-norm ``cross_norm``); adds its implementation to ``impls``."""
    a = arch.attn
    h = norm_apply(p["cross_norm"], x, arch.norm, arch.norm_eps)
    ek, ev = cross_kv(p["cross"], enc_out, arch)
    b, s = ek.shape[:2]
    valid = (enc_valid if enc_valid is not None else
             torch.ones((b, s), dtype=torch.bool, device=ek.device))
    out, _, aux = attn_lib.decode_attention(
        p["cross"], h, None, dataclasses.replace(a, causal=False, rope="none"),
        arch, pos_t=pos_t, use_kernel=use_kernel,
        cross_kv=(ek.transpose(1, 2), ev.transpose(1, 2),
                  valid[:, None, :].expand(b, a.num_kv_heads, s)))
    impls.add(aux["attn_impl"])
    return out


def _recurrent_layer(p: dict, x: torch.Tensor, cache: Any, arch: ArchConfig,
                     kind: str, active: Optional[torch.Tensor],
                     dtype) -> torch.Tensor:
    """One RG-LRU (then MLP) or SSD layer of the decode step; the layer's
    state ``cache`` (views into the stacked state) takes the new state in
    place for the lanes of ``active`` (None: all)."""
    if kind == "ssd":
        out, new = ssd_lib.ssd_decode_step(
            p["ssd"], norm_apply(p["norm"], x, arch.norm, arch.norm_eps),
            cache, arch)
    else:
        out, new = rglru_lib.rglru_decode_step(
            p["rglru"], norm_apply(p["rglru_norm"], x, arch.norm,
                                   arch.norm_eps), cache, arch)
    for old, val in zip(tree_leaves(cache), tree_leaves(new)):
        old.copy_(val if active is None else
                  torch.where(active.reshape((-1,) + (1,) * (old.dim() - 1)),
                              val.to(old.dtype), old))
    x = x + out
    if kind == "rglru" and arch.mlp is not None:
        m_out, _ = mlp_apply(p["mlp"], norm_apply(p["mlp_norm"], x, arch.norm,
                                                  arch.norm_eps),
                             arch.mlp, dtype)
        x = x + m_out
    return x
