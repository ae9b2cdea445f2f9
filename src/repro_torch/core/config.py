"""Configuration dataclasses of the PyTorch port.

A field-for-field copy of the JAX package's ``repro.core.config`` (the port
imports nothing of that package): the same frozen dataclasses with the same
fields and defaults, so ``dataclasses.asdict`` of a reference config rebuilds
an equal port config (see :func:`repro_torch.bridge.arch_from_dict`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# DMS (the paper's technique)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DMSConfig:
    """Dynamic Memory Sparsification (paper §3)."""

    enabled: bool = True
    window: int = 256              # eviction delay w (sliding window)
    target_cr: float = 8.0         # target compression ratio
    tau: float = 0.3               # Gumbel-sigmoid temperature
    logit_bias: float = -5.0       # b: offset so training starts with alpha ~ 0
    steps_per_cr_unit: int = 100   # CR(t) = 1 + t / steps_per_cr_unit
    immediate_eviction: bool = False   # ablation (Fig. 5): evict at t instead of t+w
    # "borrow" the first neuron of the first query head per group (App. B).
    borrow_neuron: bool = True
    neuron_zeroing_steps: int = 2000   # phase-1 schedule n_t (App. B)


@dataclass(frozen=True)
class KVPolicyConfig:
    """Which KV-cache policy runs at inference time.

    ``kind`` names a policy registered in :mod:`repro_torch.core.policy`.
    ``block_p`` is the KV-block granularity of the flash-decode kernel:
    caches allocate their arenas pre-padded to a ``block_p`` multiple and
    keep compacted live-block tables, so decode reads only live blocks
    (0 disables the tables).  ``paged=True`` backs each cache with a shared
    page pool of ``pool_blocks`` pages (default: the fixed arenas'
    capacity; see :mod:`repro_torch.core.block_pool`).  ``layer_map``
    overrides the policy per layer kind, e.g. ``{"attn_local": "window",
    "attn": "dms"}`` for gemma2's local and global layers; it is stored as
    a sorted tuple of pairs, so the config stays hashable.
    """

    kind: str = "vanilla"
    budget: Optional[int] = None
    cr: float = 1.0
    window: int = 256
    quest_page_size: int = 16
    quest_top_pages: Optional[int] = None
    keyformer_tau: float = 1.0
    block_p: int = 16
    paged: bool = False
    pool_blocks: Optional[int] = None
    layer_map: Optional[Tuple[Tuple[str, str], ...]] = None

    def __post_init__(self):
        if isinstance(self.layer_map, dict):
            object.__setattr__(self, "layer_map",
                               tuple(sorted(self.layer_map.items())))

    def kind_for_layer(self, layer_kind: str) -> str:
        """Resolve the policy name for a layer kind ("attn" / "attn_local")."""
        if self.layer_map:
            for k, v in self.layer_map:
                if k == layer_kind:
                    return v
        return self.kind


# ---------------------------------------------------------------------------
# Attention / MLP / MoE / SSM / recurrent blocks
# ---------------------------------------------------------------------------

RopeKind = Literal["none", "full", "half", "mrope"]


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope: RopeKind = "full"
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    window: Optional[int] = None
    logit_softcap: Optional[float] = None
    causal: bool = True
    qk_norm: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MLPConfig:
    d_ff: int
    kind: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    moe: Optional[MoEConfig] = None


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / SSD."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """Griffin / RecurrentGemma RG-LRU recurrent block."""

    lru_width: Optional[int] = None
    conv_kernel: int = 4
    block_width_multiplier: float = 1.0


# ---------------------------------------------------------------------------
# Architecture
# ---------------------------------------------------------------------------

LayerKind = Literal["attn", "attn_local", "ssd", "rglru"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    num_layers: int
    d_model: int
    vocab_size: int
    attn: Optional[AttentionConfig]
    mlp: Optional[MLPConfig]
    layer_pattern: Tuple[LayerKind, ...] = ("attn",)
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-6
    post_norm: bool = False
    logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    embedding_multiplier: float = 1.0
    encoder_layers: int = 0
    encoder_bidirectional: bool = True
    cross_attention: bool = False
    frontend: Literal["none", "vision_patches", "audio_frames"] = "none"
    frontend_tokens: int = 0
    dms: DMSConfig = field(default_factory=lambda: DMSConfig(enabled=False))
    dtype: str = "bfloat16"
    family: str = "dense"
    sub_quadratic: bool = False

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 128; pad logits are masked
        to -1e30 (see ``models.transformer.lm_logits``)."""
        return (self.vocab_size + 127) // 128 * 128

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_superblocks(self) -> int:
        if self.num_layers % self.pattern_period:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern period {self.pattern_period}")
        return self.num_layers // self.pattern_period

    def scaled_down(
        self,
        num_layers: Optional[int] = None,
        d_model: Optional[int] = None,
        vocab_size: int = 512,
        d_ff: Optional[int] = None,
        num_experts: Optional[int] = None,
    ) -> "ArchConfig":
        """Reduced config of the same family, for CPU smoke tests (the same
        reduction rules as the reference, so smoke configs compare equal)."""
        period = self.pattern_period
        nl = num_layers if num_layers is not None else 2 * period
        nl = max(period, (nl // period) * period)
        dm = d_model if d_model is not None else 64
        new = dataclasses.replace(self, num_layers=nl, d_model=dm,
                                  vocab_size=vocab_size)
        if self.attn is not None:
            nkv = min(self.attn.num_kv_heads, 2)
            nq = max(nkv, (self.attn.num_heads * nkv) // self.attn.num_kv_heads)
            nq = min(nq, 4)
            nq = (nq // nkv) * nkv or nkv
            head_dim = max(8, dm // max(nq, 1))
            head_dim = 16 if head_dim >= 16 else 8
            window = self.attn.window
            if window is not None:
                window = min(window, 16)
            new = dataclasses.replace(
                new, attn=dataclasses.replace(
                    self.attn, num_heads=nq, num_kv_heads=nkv,
                    head_dim=head_dim, window=window))
        if self.mlp is not None:
            moe = self.mlp.moe
            if moe is not None:
                ne = num_experts if num_experts is not None \
                    else min(moe.num_experts, 8)
                moe = dataclasses.replace(moe, num_experts=ne,
                                          top_k=min(moe.top_k, 2))
            new = dataclasses.replace(
                new, mlp=dataclasses.replace(self.mlp, d_ff=d_ff or 4 * dm,
                                             moe=moe))
        if self.ssm is not None:
            new = dataclasses.replace(
                new, ssm=dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                             chunk_size=32))
        if self.rglru is not None:
            new = dataclasses.replace(
                new, rglru=dataclasses.replace(self.rglru, lru_width=dm))
        if self.encoder_layers:
            new = dataclasses.replace(new, encoder_layers=period)
        if self.frontend_tokens:
            new = dataclasses.replace(new, frontend_tokens=4)
        if self.dms.enabled:
            new = dataclasses.replace(
                new, dms=dataclasses.replace(self.dms,
                                             window=min(self.dms.window, 8)))
        return new

    # -- parameter counting (the roofline's MODEL_FLOPS = 6·N·D) -------------

    def param_count(self, active_only: bool = False) -> int:
        n = 0
        embed = self.vocab_size * self.d_model
        n += embed
        if not self.tie_embeddings:
            n += embed
        for kind in _expand_pattern(self.layer_pattern, self.num_layers):
            n += self._layer_params(kind, active_only)
        if self.encoder_layers:
            for kind in _expand_pattern(self.layer_pattern,
                                        self.encoder_layers):
                n += self._layer_params(kind, active_only)
            if self.cross_attention and self.attn is not None:
                a = self.attn
                per_cross = (self.d_model * a.num_heads * a.head_dim * 2
                             + self.d_model * a.num_kv_heads * a.head_dim * 2)
                n += self.num_layers * per_cross   # one per decoder layer
        return n

    def _layer_params(self, kind: str, active_only: bool) -> int:
        d = self.d_model
        n = 0
        if kind in ("attn", "attn_local"):
            a = self.attn
            n += d * a.num_heads * a.head_dim          # Wq
            n += 2 * d * a.num_kv_heads * a.head_dim   # Wk, Wv
            n += a.num_heads * a.head_dim * d          # Wo
            n += self._mlp_params(active_only)
        elif kind == "ssd":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.num_heads(d)
            # in_proj: z, x, B, C, dt
            n += d * (2 * di + 2 * s.n_groups * s.d_state + nh)
            n += di * s.conv_kernel                    # depthwise conv (x path)
            n += 2 * nh                                # A_log, D
            n += di * d                                # out_proj
        elif kind == "rglru":
            r = self.rglru
            w = r.lru_width or d
            n += 2 * d * w + w * d                     # in (x, y branches) + out
            n += w * r.conv_kernel
            n += 2 * w * w          # input and recurrence gates (as counted)
            n += self._mlp_params(active_only)
        return n

    def _mlp_params(self, active_only: bool) -> int:
        if self.mlp is None:
            return 0
        d, f = self.d_model, self.mlp.d_ff
        per_expert = (3 if self.mlp.kind in ("swiglu", "geglu") else 2) * d * f
        if self.mlp.moe is None:
            return per_expert
        moe = self.mlp.moe
        n_experts = moe.top_k if active_only else moe.num_experts
        return n_experts * per_expert + d * moe.num_experts  # + router


def _expand_pattern(pattern: Sequence[str], n: int) -> Sequence[str]:
    return [pattern[i % len(pattern)] for i in range(n)]


# ---------------------------------------------------------------------------
# Input shapes (the shape grid of the dry-run and the roofline)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPE_GRID: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES = {s.name: s for s in SHAPE_GRID}
