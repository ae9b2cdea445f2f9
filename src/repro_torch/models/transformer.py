"""Dense decoder-only transformer of the port: init, the full-sequence
forward (training), the decode step and the lane lifecycle.

Params keep the reference's layout (``repro.models.transformer``)::

    {"embed": (V_pad, D),
     "blocks": {"0": <every leaf stacked over layers>},
     "final_norm": {"scale": (D,)}, "lm_head": (D, V_pad) unless tied}

For serving, matmul weights are stored in the compute dtype (cast once, at
load or init); for training they are fp32 (``init_model(dtype=float32)``),
as the reference keeps them, and cast at each matmul.  Norm scales stay
fp32.  The tree comes as :class:`Params`, a dict that also carries each
layer's noise salt (:func:`layer_salts`).  The decode state mirrors it:
``{"0": PolicyCache}`` with every cache leaf stacked over layers and the
lane axis at position 1.  The reference scans superblocks with ``jax.lax.scan``; here
a Python loop walks the layers and each layer's cache is a view into the
stacked state, updated in place by the step.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.models.layers import mlp_apply, norm_apply, softcap


def check_supported(arch: ArchConfig) -> None:
    """This slice ports dense decoder-only attention models."""
    if (arch.layer_pattern != ("attn",) or arch.attn is None
            or arch.mlp is None or arch.mlp.moe is not None
            or arch.post_norm or arch.encoder_layers or arch.cross_attention
            or arch.frontend != "none"):
        raise NotImplementedError(
            f"{arch.name}: only dense decoder-only 'attn' models are ported")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


class Params(dict):
    """A params tree (the dict above) that also carries ``layer_salt``:
    (L,) int64, the IEEE bits of each layer's fp32 ``attn.wo[0, 0]``.

    The reference seeds stochastic policies (Keyformer) per layer with those
    bits, taken from its fp32 master weights; a bf16 copy no longer holds
    them (its upcast gives other bits, hence other noise and other tokens),
    so :func:`init_model` and :func:`repro_torch.bridge.params_from_numpy`
    record them before the cast.  It is an attribute, not a key: the tree
    helpers, the optimizer and checkpoints never see it."""

    layer_salt: Optional[torch.Tensor] = None


def layer_salts(params: dict) -> torch.Tensor:
    """(L,) int64 noise salts: the recorded ``layer_salt``, else the bits
    of each stored ``wo[0, 0]`` (exact when the weights are fp32)."""
    salt = getattr(params, "layer_salt", None)
    if salt is None:
        salt = threefry.float_bits(params["blocks"]["0"]["attn"]["wo"][:, 0, 0])
    return salt


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_model(arch: ArchConfig, *, seed: int = 0,
               device: DeviceLike = None,
               dtype: Optional[torch.dtype] = None) -> dict:
    """Random weights with the reference's distributions and scales
    (N(0, 1) · d_in^-0.5 for projections, N(0, 1) · 0.02 for the
    embedding, ones for norm scales), drawn from a seeded
    :class:`torch.Generator` on ``device``.  The draws differ from the
    reference's threefry streams; tests copy reference weights in through
    :func:`repro_torch.bridge.params_from_numpy` instead.  Matmul weights
    take ``dtype`` (default: the compute dtype ``arch.dtype``); the layer
    salts come from the fp32 draws (:class:`Params`)."""
    check_supported(arch)
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(arch.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, nl, vp = arch.d_model, arch.num_layers, arch.padded_vocab
    a, f = arch.attn, arch.mlp.d_ff

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

    def dense(d_in, d_out, first=None):
        return normal((nl, d_in, d_out), d_in ** -0.5, first)

    def ones():
        return torch.ones((nl, d), dtype=torch.float32, device=dev)

    params = Params({
        "embed": normal((vp, d), 0.02),
        "final_norm": {"scale": torch.ones((d,), dtype=torch.float32,
                                           device=dev)},
    })
    if not arch.tie_embeddings:
        params["lm_head"] = normal((d, vp), d ** -0.5)
    wo00 = torch.empty((nl,), dtype=torch.float32, device=dev)
    params["blocks"] = {"0": {
        "attn_norm": {"scale": ones()},
        "attn": {"wq": dense(d, a.num_heads * a.head_dim),
                 "wk": dense(d, a.num_kv_heads * a.head_dim),
                 "wv": dense(d, a.num_kv_heads * a.head_dim),
                 "wo": dense(a.num_heads * a.head_dim, d, wo00)},
        "mlp_norm": {"scale": ones()},
        "mlp": {"w_gate": dense(d, f), "w_up": dense(d, f),
                "w_down": dense(f, d)},
    }}
    params.layer_salt = threefry.float_bits(wo00)
    return params


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params: dict, tokens: torch.Tensor,
                 arch: ArchConfig) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(torch_dtype(arch.dtype))
    if arch.embedding_multiplier != 1.0:
        x = x * arch.embedding_multiplier
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
    """One (B, Hkv, T) tensor of Gumbel uniforms per layer, all drawn before
    the layer loop (so a recomputed layer sees the same noise)."""
    gen = generator
    if gen is None:                 # the reference falls back to PRNGKey(0)
        gen = torch.Generator(device=device).manual_seed(0)
    shape = (batch, arch.attn.num_kv_heads, seq)
    return [dms_lib.uniform_noise(shape, gen, device=device)
            for _ in range(arch.num_layers)]


def model_forward(
    params: dict,
    tokens: torch.Tensor,                      # (B, T) int
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
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full forward.  Returns (logits (B, T, V_pad) fp32, aux) with aux
    ``alpha_sum`` (0-d fp32 tensor), ``alpha_count`` (float) and
    ``moe_aux_loss`` summed over layers, as the reference's
    ``_scan_blocks`` aggregates them.

    ``dms_train`` draws each layer's Gumbel noise from ``uniforms[layer]``
    if given (a test feeds the reference's draws), else from ``generator``
    (seed 0 when None).  ``remat`` recomputes each layer in the backward
    pass (:func:`torch.utils.checkpoint.checkpoint`).  ``collect_kv`` adds
    the prefill export ``aux["layer_kv"]``: ``{"0": {"k_rope", "v"[,
    "retained", "alpha_bin"]}}``, each stacked over layers (L, B, Hkv, T,
    ...), as the reference's scan stacks them."""
    check_supported(arch)
    x = embed_tokens(params, tokens, arch)
    b, t = x.shape[:2]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)
    if mode == "dms_train" and arch.dms.enabled and uniforms is None:
        uniforms = layer_noise(arch, b, t, generator, x.device)
    dtype = torch_dtype(arch.dtype)
    # one unbind per leaf: a single backward node stacks every layer's grad
    blocks = params["blocks"]["0"]
    columns = [leaf.unbind(0) for leaf in tree_leaves(blocks)]
    a_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    a_cnt = 0.0
    kv_keys = ("k_rope", "v", "retained", "alpha_bin")
    layer_kv: List[Dict[str, torch.Tensor]] = []

    def layer(x, i, u):
        p = tree_unflatten(blocks, [c[i] for c in columns])
        h = norm_apply(p["attn_norm"], x, arch.norm, arch.norm_eps)
        a_out, aux = attn_lib.full_attention(
            p["attn"], h, arch.attn, arch, mode=mode, dms_u=u,
            positions=positions, neuron_scale=neuron_scale,
            use_kernel=use_kernel, collect_kv=collect_kv)
        if collect_kv:
            layer_kv.append({k: aux[k] for k in kv_keys if k in aux})
        x = x + a_out
        h = norm_apply(p["mlp_norm"], x, arch.norm, arch.norm_eps)
        m_out, _ = mlp_apply(p["mlp"], h, arch.mlp, dtype)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + m_out, aux.get("alpha_sum", zero), aux.get("alpha_count", 0.0)

    for i in range(arch.num_layers):
        u = uniforms[i] if uniforms is not None else None
        if remat:
            x, s, cnt = torch.utils.checkpoint.checkpoint(
                layer, x, i, u, use_reentrant=False)
        else:
            x, s, cnt = layer(x, i, u)
        a_sum = a_sum + s
        a_cnt += cnt
    logits = lm_logits(params, x, arch)
    out = {"alpha_sum": a_sum, "alpha_count": a_cnt,
           "moe_aux_loss": torch.zeros((), dtype=torch.float32,
                                       device=x.device)}
    if collect_kv:
        out["layer_kv"] = {"0": {k: torch.stack([d[k] for d in layer_kv])
                                 for k in layer_kv[0]}}
    return logits, out


# ---------------------------------------------------------------------------
# decode state and lane lifecycle
# ---------------------------------------------------------------------------


def init_decode_state(arch: ArchConfig, batch: int, max_len: int,
                      policy: KVPolicyConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """One cache per layer, stacked over layers (lane axis at position 1),
    provisioned through the policy registry.  A paged policy gets one pool
    per layer, stacked too: pages (L, NPOOL, block_p, Dh), ref (L, NPOOL)."""
    check_supported(arch)
    dev = resolve_device(device)
    one = policy_lib.init_policy_cache(arch, batch, max_len, policy,
                                       device=dev)
    nl = arch.num_layers
    return {"0": tree_map(
        lambda a: a.unsqueeze(0).expand((nl,) + a.shape).contiguous(), one)}


def state_from_prefill(arch: ArchConfig, policy: KVPolicyConfig,
                       layer_kv: Dict[str, Any], max_len: int
                       ) -> Dict[str, Any]:
    """A decode state built from :func:`model_forward`'s ``layer_kv``: each
    layer's cache from :meth:`KVPolicy.prefill_import` (positions ``0..T-1``),
    stacked over layers as :func:`init_decode_state` stacks them.  Every
    lane sits at position T, ready to decode."""
    kv = layer_kv["0"]
    name = policy.kind_for_layer("attn")
    pol = policy_lib.get_policy(name)
    t = kv["k_rope"].shape[3]
    positions = torch.arange(t, dtype=torch.int32, device=kv["k_rope"].device)
    caches = [pol.prefill_import(
        arch, policy, kv["k_rope"][i], kv["v"][i], positions,
        kv["retained"][i] if "retained" in kv else None,
        kv["alpha_bin"][i] if "alpha_bin" in kv else None, max_len=max_len)
        for i in range(arch.num_layers)]
    return {"0": policy_lib.PolicyCache(
        tree_map(lambda *xs: torch.stack(xs), caches[0], *caches[1:]), name)}


def _map_caches(fn, state: Dict[str, Any], *rest) -> Dict[str, Any]:
    return {key: fn(pc, *(r[key] for r in rest)) for key, pc in state.items()}


def fork_decode_state(state: Dict[str, Any], width: int) -> Dict[str, Any]:
    """Shared-prefill fork: clone every lane into ``width`` chains."""
    return _map_caches(lambda pc: policy_lib.PolicyCache(
        policy_lib.get_policy(pc.policy).fork_cache(pc.cache, width, axis=1),
        pc.policy), state)


def gather_lanes(state: Dict[str, Any], src) -> Dict[str, Any]:
    """Lane shuffle: new lane ``l`` is a copy of old lane ``src[l]``."""
    src = torch.as_tensor(src)
    return _map_caches(lambda pc: policy_lib.PolicyCache(
        policy_lib.get_policy(pc.policy).gather_cache(pc.cache, src, axis=1),
        pc.policy), state)


def reclaim_lanes(state: Dict[str, Any], reset_mask: torch.Tensor,
                  fresh: Dict[str, Any]) -> Dict[str, Any]:
    """Lanes where ``reset_mask`` (B,) is True return to ``fresh``."""
    return _map_caches(lambda pc, init: policy_lib.PolicyCache(
        policy_lib.get_policy(pc.policy).reclaim_cache(
            pc.cache, reset_mask, init.cache, axis=1), pc.policy),
        state, fresh)


def export_lane_state(state: Dict[str, Any], lane: int) -> Dict[str, Any]:
    """One lane's complete decode state as a width-1-lane state of the same
    structure (new tensors; a paged cache densifies its pages) — the
    preemption snapshot."""
    return _map_caches(lambda pc: policy_lib.PolicyCache(
        policy_lib.get_policy(pc.policy).export_prefix(pc.cache, lane, axis=1),
        pc.policy), state)


def import_lane_state(state: Dict[str, Any], snap: Dict[str, Any],
                      lane: int) -> Dict[str, Any]:
    """Restore an :func:`export_lane_state` snapshot (on any device) into
    the pristine lane ``lane``; the lane continues exactly where the
    snapshot was taken."""
    dev = next(iter(state.values())).length.device
    snap = tree_map(lambda a: a.to(dev), snap)
    return _map_caches(lambda pc, s: policy_lib.PolicyCache(
        policy_lib.get_policy(pc.policy).import_prefix(pc.cache, s.cache, lane,
                                                       axis=1), pc.policy),
        state, snap)


def init_snapshot_slab(snap: Dict[str, Any], slots: int) -> Dict[str, Any]:
    """A zeroed slab for ``slots`` lane snapshots on ``snap``'s device:
    ``snap`` (an :func:`export_lane_state` exemplar, lane axis 1 of width 1)
    with the lane axis widened to ``slots`` — the prefix cache's hot tier,
    written and read by :func:`store_lane_snapshot` and
    :func:`fetch_lane_snapshot` without leaving the device."""
    return tree_map(lambda a: a.new_zeros(a.shape[:1] + (int(slots),)
                                          + a.shape[2:]), snap)


def _slab_map(fn_cache, fn_leaf, slab, *rest):
    """``fn_cache(policy, cache, *rest caches)`` on every PolicyCache node of
    a slab, ``fn_leaf`` on any other tensor (a raw snapshot leaf)."""
    def visit(node, *r):
        if isinstance(node, policy_lib.PolicyCache):
            pol = policy_lib.get_policy(node.policy)
            return policy_lib.PolicyCache(
                fn_cache(pol, node.cache, *(x.cache for x in r)), node.policy)
        if isinstance(node, dict):
            return {k: visit(v, *(x[k] for x in r)) for k, v in node.items()}
        return fn_leaf(node, *r)

    return visit(slab, *rest)


def store_lane_snapshot(slab: Dict[str, Any], snap: Dict[str, Any],
                        slot: int) -> Dict[str, Any]:
    """Write a width-1 snapshot (on any device) into slab slot ``slot``, in
    place: the device half of a deferred export, or a promotion's one
    host-to-device copy.  Dispatches through :meth:`KVPolicy.import_slab`."""
    def leaf(a, s):
        a.narrow(1, slot, 1).copy_(s)
        return a

    return _slab_map(lambda pol, c, s: pol.import_slab(c, s, slot, axis=1),
                     leaf, slab, snap)


def fetch_lane_snapshot(slab: Dict[str, Any], slot: int) -> Dict[str, Any]:
    """The snapshot in slab slot ``slot`` as new device tensors: a hot hit
    feeds it to :func:`import_lane_state` device to device.  Dispatches
    through :meth:`KVPolicy.export_slab`."""
    return _slab_map(lambda pol, c: pol.export_slab(c, slot, axis=1),
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
    active: Optional[torch.Tensor] = None,   # (B,) bool lane mask
) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """One decode step.  Returns (logits (B, V_pad) fp32, state, aux).

    ``state`` is updated in place and returned.  Lanes where ``active`` is
    False keep their state exactly and add zero to ``reads_tokens``; their
    ``live_tokens`` is what the step would have left, as the reference
    reports it."""
    check_supported(arch)
    x = embed_tokens(params, token, arch)
    b = x.shape[0]
    live = torch.zeros((b,), dtype=torch.float32, device=x.device)
    reads = torch.zeros_like(live)
    blocks, stacked = params["blocks"]["0"], state["0"]
    dtype = torch_dtype(arch.dtype)
    salt = layer_salts(params)
    pol = policy_lib.get_policy(stacked.policy)
    prepared = pol.prepare_step(stacked.cache, {"layer_salt": salt,
                                                "active": active})
    salts = salt.unbind(0)
    impls = set()
    for i in range(arch.num_layers):
        p = tree_map(lambda a: a[i], blocks)         # views of layer i
        cache = tree_map(lambda a: a[i], stacked)
        h = norm_apply(p["attn_norm"], x, arch.norm, arch.norm_eps)
        a_out, _, aux = attn_lib.decode_attention(
            p["attn"], h, cache, arch.attn, arch, pos_t=pos_t,
            use_kernel=use_kernel, active=active, layer_salt=salts[i],
            step_aux=None if prepared is None else prepared[i])
        impls.add(aux["attn_impl"])
        x = x + a_out
        live = live + aux["live_tokens"]
        reads = reads + aux["reads_tokens"]
        h = norm_apply(p["mlp_norm"], x, arch.norm, arch.norm_eps)
        m_out, _ = mlp_apply(p["mlp"], h, arch.mlp, dtype)
        x = x + m_out
    if active is not None:
        reads = reads * active.to(reads.dtype)
    logits = lm_logits(params, x, arch)[:, 0]
    return logits, state, {"live_tokens": live, "reads_tokens": reads,
                           "attn_impl_kernel": int(impls == {"kernel"})}
