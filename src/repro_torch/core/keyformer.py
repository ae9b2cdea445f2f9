"""Keyformer (Adnan et al., 2024): score-based KV eviction with Gumbel noise.

The port of the reference ``repro.core.keyformer``.  Each step the group-
summed attention weights are regularised — ``softmax((log w + Gumbel
noise) / tau)`` over live slots — and accumulated; over budget, the token
with the lowest accumulated score outside a recency window is evicted (as
H2O does with the raw weights).

The noise is drawn bit for bit as the reference draws it, with the port's
own Threefry-2x32 (:mod:`repro_torch.core.threefry`): per lane from a fixed
key folded with the lane's logical step and then with the layer's salt,
``bits(fold_in(fold_in(PRNGKey(0x5EED), length), salt), (H, P))``.  A
Threefry hash is ~150 small ops, which an eager decode step dispatches one
by one, so :meth:`KeyformerPolicy.prepare_step` draws every layer's noise
of a decode step in one batch (the lengths after this step's insert, the
layers' salts); a cache stepped on its own draws its own.  The salt
is a per-layer parameter scalar, the IEEE bits of the fp32 value of the
layer's ``attn.wo[0, 0]`` — of the fp32 master weight, which bf16 serving
weights no longer hold (see :func:`repro_torch.models.transformer.
layer_salts`).  It is the same on the kernel and the reference attention
paths, so the noise never forks on float rounding of activations.  On a
slot-split arena (:mod:`repro_torch.parallel.spmd`) every rank holds the
whole row's slot metadata, so each draws the whole row's noise, as one
rank does, and picks the same victim.

Like the reference, this module plugs in only through ``@register_policy``;
``repro_torch.core.policy`` imports it at the end so that it registers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.core import threefry
from repro_torch.core.baselines import WeightEvictCache, _arena
from repro_torch.core.block_pool import BlockPool
from repro_torch.core.kv_cache import BlockTable
from repro_torch.core.policy import (_WeightEvictPolicy, _budget_tokens,
                                     register_policy, step_meters)

_SCORE_EPS = 1e-9
_NOISE_SEED = 0x5EED  # fixed: decode must be reproducible per (seed, step)


def gumbel_noise(length: torch.Tensor, salt: torch.Tensor,
                 shape) -> torch.Tensor:
    """Standard Gumbel noise of ``length.shape + shape``: for each lane
    (any leading axes) ``bits(fold_in(fold_in(PRNGKey(0x5EED), length),
    salt), shape)`` mapped to a uniform by exact steps, clipped, and
    ``-log(-log(u))`` — the reference's draw, bit for bit up to the logs.
    ``salt`` broadcasts against ``length``."""
    key = threefry.prng_key(_NOISE_SEED, device=length.device)
    key = threefry.fold_in(key, length.to(torch.int64))
    key = threefry.fold_in(key, salt)
    u01 = threefry.bits_to_unit(threefry.random_bits(key, shape))
    u = torch.clamp(u01, _SCORE_EPS, 1.0 - _SCORE_EPS)
    return -torch.log(-torch.log(u))


@dataclass
class KeyformerCache(WeightEvictCache):
    k: torch.Tensor         # (B, H, P, Dh); P padded to a block_p multiple
    v: torch.Tensor
    pos: torch.Tensor       # (B, H, P) int32
    valid: torch.Tensor     # (B, H, P) bool
    score: torch.Tensor     # (B, H, P) fp32 accumulated regularised scores
    length: torch.Tensor    # (B,) int32
    salt: torch.Tensor      # (B,) int64 holding the uint32 layer salt
    blocks: BlockTable
    recent_window: int = field(metadata={"static": True})
    slots: int = field(metadata={"static": True})     # logical arena
    tau: float = field(default=1.0, metadata={"static": True})
    pool: Optional[BlockPool] = None
    phys: Optional[torch.Tensor] = None

    _score = "score"

    @staticmethod
    def init(batch, kv_heads, slots, head_dim, recent_window, tau,
             dtype=torch.bfloat16, block_p: int = 0, paged: bool = False,
             pool_blocks: Optional[int] = None,
             device=None) -> "KeyformerCache":
        leaves = _arena(batch, kv_heads, slots, head_dim, dtype, block_p,
                        paged, pool_blocks, device)
        return KeyformerCache(
            score=torch.zeros(leaves["valid"].shape, dtype=torch.float32,
                              device=device),
            salt=torch.zeros((batch,), dtype=torch.int64, device=device),
            recent_window=recent_window, slots=slots, tau=tau, **leaves)

    def insert(self, k_new, v_new, active=None, salt=None) -> None:
        """As :meth:`WeightEvictCache.insert`, and stash the layer salt
        (a uint32 value as a 0-d or (B,) int64 tensor; None = 0) for this
        step's draw."""
        if salt is None:
            salt = torch.zeros((), dtype=torch.int64, device=self.salt.device)
        salt = torch.as_tensor(salt, dtype=torch.int64).to(
            self.salt.device).expand(self.salt.shape)
        super().insert(k_new, v_new, active, extra={"salt": salt})

    def _victim(self, w, gumbel=None):
        """Regularise with Gumbel noise (drawn here unless given, (B, H,
        P)), accumulate, and evict the lowest accumulated score outside the
        recency window."""
        if gumbel is None:
            gumbel = gumbel_noise(self.length, self.salt, self.valid.shape[1:])
        logits = torch.where(self.valid, torch.log(w + _SCORE_EPS) + gumbel,
                             -torch.inf)
        reg = torch.softmax(logits / self.tau, dim=-1)
        score = self.score + torch.where(self.valid, reg, 0.0)
        return {"score": score}, self._protected_victim(score)


@register_policy("keyformer")
class KeyformerPolicy(_WeightEvictPolicy):
    def init_cache(self, arch, batch, max_len, cfg, *, layer_window, dtype,
                   device):
        a = arch.attn
        budget = _budget_tokens(cfg, max_len)
        return KeyformerCache.init(batch, a.num_kv_heads, budget + 1,
                                   a.head_dim, max(budget // 2, 1),
                                   cfg.keyformer_tau, dtype,
                                   block_p=cfg.block_p, paged=cfg.paged,
                                   pool_blocks=cfg.pool_blocks, device=device)

    def _insert(self, cache, k_new, v_new, aux):
        cache.insert(k_new, v_new, active=aux.get("active"),
                     salt=aux.get("layer_salt"))

    def post_attend(self, cache, weights, active=None, aux=None):
        return cache, step_meters(cache.evict(
            weights, active=active, gumbel=(aux or {}).get("gumbel")))

    def prepare_step(self, stacked, aux):
        """Every layer's noise of this step in one draw: each lane's
        length after the step's insert (for an active lane: its length now
        plus one; an inactive lane's victim is never committed) folded with
        each layer's salt."""
        gumbel = gumbel_noise(stacked.length + 1, aux["layer_salt"][:, None],
                              stacked.valid.shape[-2:])
        return [{"gumbel": g} for g in gumbel.unbind(0)]
