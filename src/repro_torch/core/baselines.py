"""KV-cache baselines of the paper (§2.2): TOVA, H2O, Quest and DMC.

The port of :class:`TOVACache`, :class:`H2OCache`, :class:`QuestCache` and
:class:`DMCCache` from the reference ``repro.core.baselines``.  TOVA and
H2O keep a budget of tokens in a slot arena of
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

* **Quest** (Tang et al., 2024) keeps the full cache with each page's
  per-channel key minimum and maximum, and reads only the ``top_pages``
  pages whose upper-bound score is highest: it cuts reads, not memory;
* **DMC** (Nawrot et al., 2024) merges a token into the newest entry by a
  running weighted average when its α is 1 and appends it otherwise, over
  fp32 accumulators.

Quest's and DMC's steps too update in place, for active lanes only, and
return the counts every lane would hold after the step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.core import block_pool
from repro_torch.core.block_pool import BlockPool
from repro_torch.core.kv_cache import (INVALID_POS, BlockTable, _round_up,
                                       commit, event_mask, init_arena,
                                       prefix_block_spec, write_rows)

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



# ---------------------------------------------------------------------------
# Quest
# ---------------------------------------------------------------------------


@dataclass
class QuestCache:
    """The full cache plus each page's per-channel key minimum and maximum;
    pages are ``page_size`` contiguous slots.  Reads per step are at most
    ``top_pages * page_size`` a head (what Quest saves); the footprint is
    the full arena.  Paged, the pool's page is Quest's page, so the
    selected-page table indexes pool pages directly."""

    k: torch.Tensor         # (B, H, S, Dh); zero-width when paged
    v: torch.Tensor
    kmin: torch.Tensor      # (B, H, S / page_size, Dh) fp32
    kmax: torch.Tensor
    length: torch.Tensor    # (B,) int32
    page_size: int = field(metadata={"static": True})
    top_pages: int = field(metadata={"static": True})
    pool: Optional[BlockPool] = None
    phys: Optional[torch.Tensor] = None               # (B, H, NP), -1 unmapped

    @staticmethod
    def init(batch, kv_heads, max_len, head_dim, page_size, top_pages,
             dtype=torch.bfloat16, paged: bool = False,
             pool_blocks: Optional[int] = None, device=None) -> "QuestCache":
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} is not a multiple of the "
                             f"page size {page_size}")
        k, v, pool, phys = init_arena(batch, kv_heads, max_len, head_dim,
                                      dtype, page_size, paged, pool_blocks,
                                      device)
        shape = (batch, kv_heads, max_len // page_size, head_dim)
        return QuestCache(
            k=k, v=v,
            kmin=torch.full(shape, torch.inf, dtype=torch.float32,
                            device=device),
            kmax=torch.full(shape, -torch.inf, dtype=torch.float32,
                            device=device),
            length=torch.zeros((batch,), dtype=_I32, device=device),
            page_size=page_size, top_pages=top_pages, pool=pool, phys=phys)

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Write ``k_new``/``v_new`` (B, H, 1, Dh) at each lane's length and
        fold the key into its page's minimum and maximum, in place, for
        active lanes.  Returns the (B,) length every lane would have."""
        t = self.length.clone()              # the commit advances the leaf
        b, h, n_pages = self.kmin.shape[:3]
        s = self.k.shape[2]
        if self.pool is None:
            # the reference's dynamic_update_slice clamps the offset
            write_rows(self.k, self.v,
                       torch.clamp(t, max=s - 1)[:, None].expand(b, h),
                       k_new, v_new, active)
        else:
            block_pool.token_write(
                self.pool, self.phys, t[:, None, None].expand(b, h, 1),
                k_new, v_new, event_mask(active, (b, h, 1), device=t.device))
        page = t // self.page_size
        kf = k_new[..., 0, :].float()[..., None, :]
        hit = (torch.arange(n_pages, device=t.device)
               == page[:, None])[:, None, :, None]
        commit(self, dict(
            kmin=torch.where(hit, torch.minimum(self.kmin, kf), self.kmin),
            kmax=torch.where(hit, torch.maximum(self.kmax, kf), self.kmax),
            length=t + 1), None, active)
        return t + 1

    def select_pages(self, q: torch.Tensor) -> torch.Tensor:
        """Upper-bound page scores (Quest §2.2), sum_d max(q_d kmin_d, q_d
        kmax_d), for the (B, H, Dh) group-pooled query -> the (B, H, NP)
        bool mask of the live pages scoring at least the ``top_pages``-th
        best (ties select more).  An unwritten page scores NaN (0 · ±inf)
        and is masked to -inf by the live-page mask."""
        qf = q.float()[..., None, :]
        ub = torch.maximum(qf * self.kmin, qf * self.kmax).sum(dim=-1)
        n_pages = self.kmin.shape[2]
        live = ((torch.arange(n_pages, device=ub.device) * self.page_size)
                < self.length[:, None])                       # (B, NP)
        ub = torch.where(live[:, None], ub, -torch.inf)
        thresh = torch.topk(ub, min(self.top_pages, n_pages),
                            dim=-1).values[..., -1:]
        return (ub >= thresh) & live[:, None]

    def token_mask_from_pages(self, page_mask: torch.Tensor) -> torch.Tensor:
        """(B, H, S): the written slots of the selected pages."""
        s = self.k.shape[2]
        idx = torch.arange(s, device=page_mask.device)
        tok = page_mask[..., idx // self.page_size]
        return tok & (idx < self.length[:, None, None])

    def block_table_from_pages(self, page_mask: torch.Tensor):
        """The selected pages as a decode block table: ``(tbl (B, H, NP)
        int32, n (B, H) int32)``, selected page ids first in ascending
        order.  Full width, since ties can select more than
        ``top_pages``."""
        tbl = torch.argsort((~page_mask).to(torch.int8), dim=-1,
                            stable=True).to(_I32)
        return tbl, page_mask.sum(dim=-1).to(_I32)

    # the views take any leading axes (a stacked state's layers)

    def valid_mask(self) -> torch.Tensor:
        """Lazy (..., B, 1, S) length-prefix occupancy."""
        s = self.k.shape[-2]
        return (torch.arange(s, device=self.length.device)
                < self.length[..., None, None])

    def positions(self) -> torch.Tensor:
        return torch.arange(self.k.shape[-2], dtype=_I32,
                            device=self.length.device).expand(
                                self.k.shape[:-1])

    def retained_tokens(self, length: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """(..., B, H): the written tokens — the whole cache stays (Quest's
        trade-off).  ``length`` (..., B) overrides the cache's."""
        length = self.length if length is None else length
        written = torch.clamp(length, max=self.k.shape[-2])
        return written[..., None].expand(self.k.shape[:-2])

    def reads_per_step(self, length: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """(B,): the slots a step reads, ``min(live pages, top_pages)``
        whole pages.  ``length`` (B,) overrides the cache's."""
        length = self.length if length is None else length
        pages = torch.clamp(-(-length // self.page_size), max=self.top_pages)
        return pages * self.page_size


# ---------------------------------------------------------------------------
# DMC (append or merge)
# ---------------------------------------------------------------------------


@dataclass
class DMCCache:
    """Dynamic Memory Compression's inference cache: α = 1 merges (k, v)
    into the newest entry by a weighted average with running weight ``z``,
    α = 0 appends a new entry.  Occupancy is the prefix ``[0, count)``, so
    the block table is derived, not stored.  The accumulators are fp32, on
    fixed arenas and in the pool alike."""

    k: torch.Tensor         # (B, H, P, Dh) fp32; P padded to block_p
    v: torch.Tensor
    z: torch.Tensor         # (B, H, P) fp32 accumulation weights
    count: torch.Tensor     # (B, H) int32 live entries
    length: torch.Tensor    # (B,) int32
    pos: torch.Tensor       # (B, H, P) int32 newest contribution's position
    block_p: int = field(default=0, metadata={"static": True})
    pool: Optional[BlockPool] = None                  # fp32 pages
    phys: Optional[torch.Tensor] = None               # (B, H, NB), -1 unmapped

    @staticmethod
    def init(batch, kv_heads, num_slots, head_dim, block_p: int = 0,
             paged: bool = False, pool_blocks: Optional[int] = None,
             device=None) -> "DMCCache":
        p = _round_up(num_slots, block_p)
        k, v, pool, phys = init_arena(batch, kv_heads, p, head_dim,
                                      torch.float32, block_p, paged,
                                      pool_blocks, device)
        bh = (batch, kv_heads)
        return DMCCache(
            k=k, v=v,
            z=torch.zeros(bh + (p,), dtype=torch.float32, device=device),
            count=torch.zeros(bh, dtype=_I32, device=device),
            length=torch.zeros((batch,), dtype=_I32, device=device),
            pos=torch.zeros(bh + (p,), dtype=_I32, device=device),
            block_p=block_p, pool=pool, phys=phys)

    def block_spec(self):
        """The prefix table over ``count``: ``(tbl (B, H, NB), n (B, H),
        block_p)``, or ``(None, None, 0)`` when tables are off."""
        b, h, p = self.z.shape
        tbl, n = prefix_block_spec(self.count.reshape(-1), p, self.block_p, 1)
        if tbl is None:
            return None, None, 0
        return tbl.reshape(b, h, -1), n.reshape(b, h), self.block_p

    def step(self, k_new: torch.Tensor, v_new: torch.Tensor,
             alpha: torch.Tensor, omega: Optional[torch.Tensor] = None,
             active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Merge or append one token per (lane, head), in place, for active
        lanes.  ``alpha`` (B, H) bool is the merge decision, ``omega`` an
        optional (B, H) weight (1).  Only the target row is read and
        written, with the reference's dense formula at that slot (the same
        op order, so the same bits); a full arena (target ``P``) drops the
        write, as the reference's dense update does.  Returns the (B, H)
        ``count`` every lane would hold."""
        b, h, p = self.z.shape
        if omega is None:
            omega = torch.ones((b, h), dtype=torch.float32,
                               device=self.z.device)
        kf = k_new[..., 0, :].float()
        vf = v_new[..., 0, :].float()
        merge = alpha & (self.count > 0)
        tgt = torch.where(merge, torch.clamp(self.count - 1, min=0),
                          self.count)
        tgt_c = torch.clamp(tgt, max=p - 1)
        z_old = torch.where(merge, self.z.gather(2, tgt_c.long()[..., None])
                            [..., 0], 0.0)
        z_new = z_old + omega
        if self.pool is None:
            bi = torch.arange(b, device=tgt.device)[:, None].expand(b, h)
            hi = torch.arange(h, device=tgt.device)[None, :].expand(b, h)
            k_old = self.k[bi, hi, tgt_c.long()]
            v_old = self.v[bi, hi, tgt_c.long()]
        else:
            k_old = block_pool.gather_rows(self.pool.k, self.phys, tgt,
                                           self.block_p)
            v_old = block_pool.gather_rows(self.pool.v, self.phys, tgt,
                                           self.block_p)
        k_row = ((torch.where(merge[..., None], k_old, 0.0) * z_old[..., None]
                  + kf * omega[..., None]) / z_new[..., None])
        v_row = ((torch.where(merge[..., None], v_old, 0.0) * z_old[..., None]
                  + vf * omega[..., None]) / z_new[..., None])
        write = event_mask(active, (b, h), device=tgt.device) & (tgt < p)
        if self.pool is None:
            write_rows(self.k, self.v, tgt_c, k_row[..., None, :],
                       v_row[..., None, :], write)
        else:
            block_pool.token_write(self.pool, self.phys, tgt[..., None],
                                   k_row[..., None, :], v_row[..., None, :],
                                   write[..., None])
        hit = torch.arange(p, device=tgt.device) == tgt[..., None]
        count = torch.where(merge, self.count, self.count + 1)
        # a merged entry is as recent as its newest contribution
        commit(self, dict(
            z=torch.where(hit, z_new[..., None], self.z), count=count,
            length=self.length + 1,
            pos=torch.where(hit, self.length[:, None, None], self.pos)),
            None, active)
        return count

    def valid_mask(self) -> torch.Tensor:
        p = self.z.shape[-1]
        return torch.arange(p, device=self.count.device) < self.count[..., None]

    def positions(self) -> torch.Tensor:
        return self.pos

    def retained_tokens(self) -> torch.Tensor:
        return self.count
