"""Training-free KV-cache baselines of the paper (§2.2): TOVA and H2O.

The port of :class:`TOVACache` and :class:`H2OCache` from the reference
``repro.core.baselines``.  Both keep a budget of tokens in a slot arena of
``budget + 1`` logical slots (room to insert before evicting), padded to a
``block_p`` multiple with an incremental :class:`BlockTable`, and evict by
the current step's attention weights, which the weights-out decode kernel
returns (``AttendSpec.needs_weights``):

* **TOVA** (Oren et al., 2024) evicts the token with the lowest current
  attention weight, summed over the query heads of the group;
* **H2O** (Zhang et al., 2023a) accumulates attention mass and evicts the
  lowest-cumulative token outside a recency window.

A step is two phases around attention: :meth:`insert` puts the new token
into the first free logical slot, and :meth:`evict` (after attention) drops
the victim when the arena holds more than the budget.  Unlike the
reference's pure functions both update the cache **in place**, for active
lanes only, as :meth:`~repro_torch.core.kv_cache.SlotDMSCache.step` does;
:meth:`evict` returns the ``live_tokens`` the reference reports for every
lane, inactive ones included (what the step would have left).  A paged
cache (``paged=True``) writes through its page map and frees the page of a
block that empties, both gated by the lane mask.

``QuestCache`` and ``DMCCache`` are not ported yet (ROADMAP A9).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.core import block_pool
from repro_torch.core.block_pool import BlockPool
from repro_torch.core.kv_cache import (INVALID_POS, BlockTable, _round_up,
                                       commit, event_mask, init_arena,
                                       write_rows)

_I32 = torch.int32


def _arena(batch, kv_heads, slots, head_dim, dtype, block_p, paged,
           pool_blocks, device):
    """The shared leaves of a weight-evicting cache: (k, v, pos, valid,
    length, blocks, pool, phys) for ``slots`` logical slots padded to a
    ``block_p`` multiple."""
    p = _round_up(slots, block_p)
    k, v, pool, phys = init_arena(batch, kv_heads, p, head_dim, dtype,
                                  block_p, paged, pool_blocks, device)
    return dict(
        k=k, v=v,
        pos=torch.full((batch, kv_heads, p), INVALID_POS, dtype=_I32,
                       device=device),
        valid=torch.zeros((batch, kv_heads, p), dtype=torch.bool,
                          device=device),
        length=torch.zeros((batch,), dtype=_I32, device=device),
        blocks=BlockTable.init(batch, kv_heads, p, block_p, device=device),
        pool=pool, phys=phys)


class WeightEvictCache:
    """The insert / evict machinery TOVA, H2O and Keyformer share.  A
    subclass names its per-slot score leaf (``_score``, zeroed where a token
    is inserted or evicted) and its victim rule (:meth:`_victim`)."""

    _score: Optional[str] = None

    @property
    def budget(self) -> int:
        return self.slots - 1   # the arena is budget + 1 (insert, then evict)

    def insert(self, k_new: torch.Tensor, v_new: torch.Tensor,
               active: Optional[torch.Tensor] = None,
               extra: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Put the new token (k_new/v_new: (B, H, 1, Dh) post-RoPE) into the
        first free logical slot, in place, for active lanes (None = all).
        ``extra`` holds further per-lane leaves to set by name."""
        p = self.valid.shape[2]
        ar = torch.arange(p, device=self.valid.device)
        free = ~self.valid & (ar < self.slots)
        slot = free.to(torch.uint8).argmax(dim=2).to(_I32)        # first free
        hit = ar == slot[..., None]
        newly = free.gather(2, slot.long()[..., None])[..., 0]
        meta = dict(pos=torch.where(hit, self.length[:, None, None], self.pos),
                    valid=self.valid | hit, length=self.length + 1)
        if self._score is not None:
            meta[self._score] = torch.where(hit, 0.0, getattr(self, self._score))
        meta.update(extra or {})
        commit(self, meta, self.blocks.insert(slot, newly), active)
        if self.pool is None:
            write_rows(self.k, self.v, slot, k_new, v_new, active)
        else:
            act = event_mask(active, slot.shape, device=slot.device)
            block_pool.token_write(self.pool, self.phys, slot[..., None],
                                   k_new, v_new, act[..., None])

    def evict(self, attn_weights: torch.Tensor,
              active: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
        """Evict one token per (lane, head) that holds more than the budget,
        by the (B, H, P) group-summed post-softmax weights of this step, in
        place for active lanes.  Returns the (B,) ``live_tokens`` (mean over
        heads) every lane would hold after the step, as the reference
        reports it: it inserts into and evicts from inactive lanes too and
        rolls them back afterwards (``lane_select``), so an inactive lane
        counts the token this step would have inserted.  ``kw`` goes to the
        victim rule."""
        valid = self.valid
        n = valid.sum(dim=2)
        if active is not None:
            ar = torch.arange(valid.shape[2], device=valid.device)
            room = (~valid & (ar < self.slots)).any(dim=2)
            n = n + (~active[:, None] & room)
        over = n > self.budget
        meta, victim = self._victim(attn_weights.float(), **kw)
        hit = ((torch.arange(valid.shape[2], device=valid.device)
                == victim[..., None]) & over[..., None])
        blocks, dead = self.blocks.evict_ex(victim, over)
        meta.update(pos=torch.where(hit, INVALID_POS, self.pos),
                    valid=valid & ~hit)
        if self._score is not None:
            meta[self._score] = torch.where(hit, 0.0, meta[self._score])
        commit(self, meta, blocks, active)
        if self.pool is not None:
            act = event_mask(active, victim.shape, device=victim.device)
            block_pool.free_block(self.pool, self.phys, victim, dead & act)
        return (n - over.to(n.dtype)).float().mean(dim=-1)

    def _victim(self, w: torch.Tensor):
        """(new score leaves by name, victim slot (B, H) int32)."""
        raise NotImplementedError

    def _protected_victim(self, score: torch.Tensor) -> torch.Tensor:
        """The lowest ``score`` outside the recency window (the newest
        ``recent_window`` positions), or the oldest token when every live
        token is recent (H2O, Keyformer)."""
        recent = self.pos >= (self.length - self.recent_window)[:, None, None]
        cand = torch.where(self.valid & ~recent, score, torch.inf)
        any_evictable = torch.isfinite(cand).any(dim=2)
        oldest = torch.where(self.valid, self.pos, INVALID_POS).argmin(dim=2)
        return torch.where(any_evictable, cand.argmin(dim=2),
                           oldest).to(_I32)

    # -- views ----------------------------------------------------------------

    def block_spec(self):
        return self.blocks.spec()

    def valid_mask(self) -> torch.Tensor:
        return self.valid

    def positions(self) -> torch.Tensor:
        return self.pos

    def retained_tokens(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)


@dataclass
class TOVACache(WeightEvictCache):
    k: torch.Tensor         # (B, H, P, Dh); P padded to a block_p multiple
    v: torch.Tensor
    pos: torch.Tensor       # (B, H, P) int32
    valid: torch.Tensor     # (B, H, P) bool
    length: torch.Tensor    # (B,) int32
    blocks: BlockTable
    slots: int = field(metadata={"static": True})     # logical arena
    pool: Optional[BlockPool] = None
    phys: Optional[torch.Tensor] = None               # (B, H, NB), -1 unmapped

    @staticmethod
    def init(batch, kv_heads, slots, head_dim, dtype=torch.bfloat16,
             block_p: int = 0, paged: bool = False,
             pool_blocks: Optional[int] = None, device=None) -> "TOVACache":
        return TOVACache(slots=slots, **_arena(
            batch, kv_heads, slots, head_dim, dtype, block_p, paged,
            pool_blocks, device))

    def _victim(self, w):
        """TOVA: the live token with the lowest current weight."""
        scores = torch.where(self.valid, w, torch.inf)
        return {}, scores.argmin(dim=2).to(_I32)


@dataclass
class H2OCache(WeightEvictCache):
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    valid: torch.Tensor
    acc: torch.Tensor       # (B, H, P) fp32 cumulative attention mass
    length: torch.Tensor
    blocks: BlockTable
    recent_window: int = field(metadata={"static": True})
    slots: int = field(metadata={"static": True})
    pool: Optional[BlockPool] = None
    phys: Optional[torch.Tensor] = None

    _score = "acc"

    @staticmethod
    def init(batch, kv_heads, slots, head_dim, recent_window=None,
             dtype=torch.bfloat16, block_p: int = 0, paged: bool = False,
             pool_blocks: Optional[int] = None, device=None) -> "H2OCache":
        leaves = _arena(batch, kv_heads, slots, head_dim, dtype, block_p,
                        paged, pool_blocks, device)
        rw = recent_window if recent_window is not None else slots // 2
        return H2OCache(acc=torch.zeros(leaves["valid"].shape,
                                        dtype=torch.float32, device=device),
                        recent_window=rw, slots=slots, **leaves)

    def _victim(self, w):
        """H2O: accumulate the mass, evict the lowest outside the window."""
        acc = self.acc + torch.where(self.valid, w, 0.0)
        return {"acc": acc}, self._protected_victim(acc)
