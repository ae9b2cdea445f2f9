"""KV caches of the port: vanilla, masked DMS and slot-compacted DMS, and
the block table.

* :class:`VanillaCache` — dense append-only arena of the full length; its
  live slots are a length prefix, so its block table is derived
  (:func:`prefix_block_spec`), not stored.
* :class:`MaskedDMSCache` — the full-length arena with a ``retained``
  bitmap: the reference's correctness oracle for DMS.  An evicted slot
  stays in its block, which leaves the table only when its last retained
  slot goes.
* :class:`SlotDMSCache` — the paper's production cache (§3.3): ``P << S``
  slots per (lane, kv head), a free-list ring allocator, and a pending
  ring that executes each eviction decision ``w`` steps late (delayed
  eviction).  With ``dms_active=False`` it is a plain ring buffer whose
  overflow recycling does the windowing (``window``, vanilla's local
  layers).

Keys are stored post-RoPE.  :class:`BlockTable` is the compacted list of
live ``block_p``-sized blocks the flash-decode kernel loops over.

Layout as in the reference ``repro.core.kv_cache``: ``k, v``: (B, Hkv, P,
Dh); per-slot metadata (B, Hkv, P); ``length`` per lane (B,).  Decode
states stack these over layers (lane axis at position 1).

Unlike the reference's pure functions, every cache's step updates the
cache **in place** (it may be a per-layer view of a stacked state): the
new token's K/V row is written by index, one row per (lane, head), and
only for active lanes, so a step never reads or rewrites the whole arena.
The metadata of every lane is advanced first, as the reference does before
its ``lane_select``, then committed only for active lanes — the resulting
state equals the reference's leaf for leaf.  Each step returns the
retained-token count every lane would hold, inactive ones included: the
count the reference reports before it freezes them.

A **paged** cache (``KVPolicyConfig(paged=True)``) keeps its K/V bytes in a
shared :class:`~repro_torch.core.block_pool.BlockPool` addressed through a
per-(lane, head) page map ``phys``; its own ``k``/``v`` are zero-width
(B, H, P, 0) placeholders, as in the reference, so every shape-derived
invariant keeps working.  Its step frees the pages of blocks that died and
writes the new token through the page map, both gated by the lane mask:
the pool has no lane axis, so nothing can roll an inactive lane's pool
event back.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.core import block_pool
from repro_torch.core.block_pool import BlockPool

INVALID_POS = torch.iinfo(torch.int32).max
_I32 = torch.int32


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m if m else x


def _lane_where(active: Optional[torch.Tensor], new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    if active is None:
        return new
    return torch.where(active.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)


def commit(cache, meta: Dict[str, torch.Tensor],
           blocks: Optional["BlockTable"],
           active: Optional[torch.Tensor]) -> None:
    """Write a step's new per-lane leaves (``meta`` by field name) and block
    table (None: the cache keeps none) into ``cache`` in place, for active
    lanes only (None = all)."""
    for name, val in meta.items():
        cur = getattr(cache, name)
        cur.copy_(_lane_where(active, val, cur))
    if blocks is not None and not cache.blocks._off():
        for name in ("count", "tbl", "pos", "n"):
            cur = getattr(cache.blocks, name)
            cur.copy_(_lane_where(active, getattr(blocks, name), cur))


# ---------------------------------------------------------------------------
# Slot-sharded arenas (multi-device decode)
# ---------------------------------------------------------------------------

#: (offset, total, gather) while a decode step runs on one slot shard of
#: its arenas (:mod:`repro_torch.parallel.spmd`): the local arena holds
#: slots ``[offset, offset + P_local)`` of ``total``; the slot metadata is
#: whole; ``gather`` sums a zero-padded (..., total) tensor over the shards.
_ARENA_SHARD: contextvars.ContextVar[
    Optional[Tuple[int, int, Optional[Callable]]]] = \
    contextvars.ContextVar("arena_shard", default=None)


@contextlib.contextmanager
def arena_shard(offset: int, total: int,
                gather: Optional[Callable] = None) -> Iterator[None]:
    """Within the block, arenas are slot shards: slot indices stay global,
    :func:`write_rows` and :func:`update_rows` touch only the rows whose
    slot this shard owns, :func:`arena_slots` gives the whole arena's slot
    count, and :func:`whole_slots` assembles per-slot values of the shards
    through ``gather`` (a sum over the shards: an all-reduce)."""
    tok = _ARENA_SHARD.set((int(offset), int(total), gather))
    try:
        yield
    finally:
        _ARENA_SHARD.reset(tok)


def whole_slots(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., P_local), a value for each slot of this shard, as (...,
    P) over the whole arena: each shard's values in its own slots, zeros
    elsewhere, summed over the shards, so each slot holds exactly its
    owner's value.  Outside :func:`arena_shard` (or already whole) ``x``
    itself."""
    shard = _ARENA_SHARD.get()
    if shard is None or x.shape[-1] == shard[1]:
        return x
    offset, total, gather = shard
    if gather is None:
        raise ValueError("whole_slots: this slot shard has no gather")
    full = x.new_zeros(x.shape[:-1] + (total,))
    full.narrow(-1, offset, x.shape[-1]).copy_(x)
    return gather(full)


def arena_slots(arena: torch.Tensor) -> int:
    """Slot count of the whole arena of which ``arena`` (.., P, Dh) is the
    local part (its own count outside :func:`arena_shard`)."""
    shard = _ARENA_SHARD.get()
    return arena.shape[-2] if shard is None else shard[1]


def write_rows(k_arena: torch.Tensor, v_arena: torch.Tensor,
               slot: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
               active: Optional[torch.Tensor]) -> None:
    """Scatter K/V rows into their slots of a fixed arena (B, H, P, Dh), in
    place: ``slot`` (B, H) takes one row per (lane, head), ``k_new``/
    ``v_new`` (B, H, 1, Dh); ``slot`` (B, H, T) takes T rows, (B, H, T,
    Dh).  Where ``active`` ((B,) lanes or (B, H) rows; None = all) is False
    the rows it already holds are rewritten."""
    si = (slot if slot.dim() == 3 else slot[..., None]).long()
    b, h, t = si.shape
    bi = torch.arange(b, device=si.device)[:, None, None].expand(b, h, t)
    hi = torch.arange(h, device=si.device)[None, :, None].expand(b, h, t)
    if active is not None:
        active = (active if active.dim() == 2 else active[:, None])[
            ..., None, None]
    shard = _ARENA_SHARD.get()
    if shard is not None:           # a slot shard: only the owner writes
        local = si - shard[0]
        own = ((local >= 0) & (local < k_arena.shape[2]))[..., None]
        si = local.clamp(0, k_arena.shape[2] - 1)
        active = own if active is None else active & own
    for arena, new in ((k_arena, k_new), (v_arena, v_new)):
        rows = new.to(arena.dtype)
        if active is not None:
            rows = torch.where(active, rows, arena[bi, hi, si])
        arena[bi, hi, si] = rows


def update_rows(k_arena: torch.Tensor, v_arena: torch.Tensor,
                slot: torch.Tensor, fn: Callable,
                active: Optional[torch.Tensor]) -> None:
    """Read-modify-write one row per (lane, head) of a fixed arena (B, H,
    P, Dh), in place: ``fn(k_old, v_old)`` (each (B, H, Dh), the rows at
    ``slot`` (B, H)) gives the new rows, written through :func:`write_rows`
    where ``active`` ((B, H); None = all).  On a slot shard a row is read
    and written only by the shard that owns it: elsewhere ``fn`` sees zeros
    and its result is dropped."""
    si = slot.long()
    b, h = si.shape
    shard = _ARENA_SHARD.get()
    local = si if shard is None else si - shard[0]
    own = (local >= 0) & (local < k_arena.shape[2])
    idx = local.clamp(0, k_arena.shape[2] - 1)
    bi = torch.arange(b, device=si.device)[:, None].expand(b, h)
    hi = torch.arange(h, device=si.device)[None, :].expand(b, h)
    k_old, v_old = k_arena[bi, hi, idx], v_arena[bi, hi, idx]
    if shard is not None:
        k_old = torch.where(own[..., None], k_old, 0.0)
        v_old = torch.where(own[..., None], v_old, 0.0)
    k_row, v_row = fn(k_old, v_old)
    write_rows(k_arena, v_arena, slot, k_row[..., None, :],
               v_row[..., None, :], active)


# ---------------------------------------------------------------------------
# Block tables: compacted live-block indices for the flash-decode kernel
# ---------------------------------------------------------------------------


@dataclass
class BlockTable:
    """Per-(lane, kv-head) compacted index table of *live* KV blocks.

    Maintained incrementally by :meth:`insert` / :meth:`evict` (O(NB) per
    slot event, never an O(P) pass on the step path).  The table is an
    unordered compacted list — eviction swaps the last entry into the hole.
    Invariant: ``{tbl[..., :n]}`` is the set of blocks with a live slot and
    ``count`` the per-block live-slot population.  ``block_p == 0`` turns
    the machinery off (zero-width arrays, updates are no-ops).

    :meth:`insert` and :meth:`evict` are functional (new tensors, as in the
    reference); :meth:`SlotDMSCache.step` commits their result in place."""

    count: torch.Tensor   # (B, H, NB) int32 — live slots per block
    tbl: torch.Tensor     # (B, H, NB) int32 — live block ids, first n entries
    pos: torch.Tensor     # (B, H, NB) int32 — block id -> index in tbl, or -1
    n: torch.Tensor       # (B, H) int32 — number of live blocks
    block_p: int = field(default=0, metadata={"static": True})

    @staticmethod
    def init(batch: int, kv_heads: int, num_slots: int, block_p: int,
             device=None) -> "BlockTable":
        nb = num_slots // block_p if block_p else 0
        shape = (batch, kv_heads, nb)
        return BlockTable(
            count=torch.zeros(shape, dtype=_I32, device=device),
            tbl=torch.zeros(shape, dtype=_I32, device=device),
            pos=torch.full(shape, -1, dtype=_I32, device=device),
            n=torch.zeros((batch, kv_heads), dtype=_I32, device=device),
            block_p=block_p)

    def spec(self):
        """``(block_tbl, block_n, block_p)`` for the kernel, or
        ``(None, None, 0)`` when tables are off."""
        if not self.block_p:
            return None, None, 0
        return self.tbl, self.n, self.block_p

    @staticmethod
    def from_valid(valid: torch.Tensor, block_p: int) -> "BlockTable":
        """The canonical table of a ``valid`` bitmap (live ids ascending) —
        the test oracle, never the step path."""
        b, h, p = valid.shape
        if not block_p:
            return BlockTable.init(b, h, 0, 0, device=valid.device)
        nb = p // block_p
        count = valid.reshape(b, h, nb, block_p).sum(dim=-1).to(_I32)
        live = count > 0
        tbl = torch.argsort((~live).to(torch.int8), dim=-1, stable=True).to(_I32)
        rank = torch.cumsum(live.to(_I32), dim=-1).to(_I32) - 1
        return BlockTable(count=count, tbl=tbl,
                          pos=torch.where(live, rank, -1),
                          n=live.sum(dim=-1).to(_I32), block_p=block_p)

    # -- O(NB) one-hot helpers ------------------------------------------------

    @staticmethod
    def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return arr.gather(2, idx.long()[..., None])[..., 0]

    @staticmethod
    def _put(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        nb = arr.shape[2]
        hit = ((torch.arange(nb, device=arr.device) == idx[..., None])
               & mask[..., None])
        return torch.where(hit, val[..., None], arr)

    def _off(self) -> bool:
        return not self.block_p or self.count.shape[2] == 0

    def insert(self, slot: torch.Tensor, mask: torch.Tensor) -> "BlockTable":
        """A slot turned live where ``mask`` (B, H) is True."""
        if self._off():
            return self
        nb = self.count.shape[2]
        blk = torch.clamp(slot // self.block_p, 0, nb - 1)
        cnt = self._take(self.count, blk)
        new_live = mask & (cnt == 0)
        return dataclasses.replace(
            self,
            count=self._put(self.count, blk, cnt + 1, mask),
            tbl=self._put(self.tbl, torch.clamp(self.n, max=nb - 1), blk,
                          new_live),
            pos=self._put(self.pos, blk, self.n, new_live),
            n=self.n + new_live.to(_I32))

    def evict(self, slot: torch.Tensor, mask: torch.Tensor) -> "BlockTable":
        """A slot turned dead.  When its block empties the block leaves the
        table: the last entry swaps into its place."""
        return self.evict_ex(slot, mask)[0]

    def evict_ex(self, slot: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple["BlockTable", torch.Tensor]:
        """:meth:`evict` plus the (B, H) mask of blocks that turned dead —
        what frees a page in the paged pool."""
        if self._off():
            return self, torch.zeros_like(mask)
        nb = self.count.shape[2]
        blk = torch.clamp(slot // self.block_p, 0, nb - 1)
        cnt_after = self._take(self.count, blk) - 1
        dead = mask & (cnt_after == 0)
        hole = torch.clamp(self._take(self.pos, blk), 0, nb - 1)
        last_blk = self._take(self.tbl, torch.clamp(self.n - 1, 0, nb - 1))
        pos = self._put(self.pos, last_blk, hole, dead)
        pos = self._put(pos, blk, torch.full_like(blk, -1), dead)
        return dataclasses.replace(
            self,
            count=self._put(self.count, blk, cnt_after, mask),
            tbl=self._put(self.tbl, hole, last_blk, dead),
            pos=pos,
            n=self.n - dead.to(_I32)), dead


def prefix_block_spec(length: torch.Tensor, num_slots: int, block_p: int,
                      kv_heads: int):
    """The block table of prefix-shaped occupancy (vanilla): the live slots
    of a lane are ``[0, length)``, so its table is the first ``ceil(length
    / block_p)`` block ids.  ``length``: (..., B) with any leading axes.
    Returns ``(tbl (..., B, H, NB) int32, n (..., B, H) int32)``, both
    contiguous (the kernel takes no stride-0 operand), or ``(None, None)``
    when tables are off."""
    if not block_p:
        return None, None
    nb = num_slots // block_p
    lead = tuple(length.shape) + (kv_heads,)
    n = -(-torch.clamp(length, max=num_slots) // block_p)
    n = n[..., None].expand(lead).to(_I32).contiguous()
    tbl = torch.arange(nb, dtype=_I32, device=length.device)
    return tbl.expand(lead + (nb,)).contiguous(), n


# ---------------------------------------------------------------------------
# Paged-pool plumbing
# ---------------------------------------------------------------------------


def init_paged(batch: int, kv_heads: int, padded_slots: int, head_dim: int,
               block_p: int, dtype, pool_blocks: Optional[int], device=None
               ) -> Tuple[BlockPool, torch.Tensor, torch.Tensor]:
    """(pool, phys, zero-width arena) of a paged cache; the pool defaults to
    one page per (lane, head, block), the fixed arenas' capacity."""
    if not block_p:
        raise ValueError("paged KV cache requires block_p > 0")
    nb = padded_slots // block_p
    pool = BlockPool.init(pool_blocks or batch * kv_heads * nb, block_p,
                          head_dim, dtype, device=device)
    phys = torch.full((batch, kv_heads, nb), -1, dtype=_I32, device=device)
    zero = torch.zeros((batch, kv_heads, padded_slots, 0), dtype=dtype,
                       device=device)
    return pool, phys, zero


def init_arena(batch: int, kv_heads: int, slots: int, head_dim: int, dtype,
               block_p: int, paged: bool, pool_blocks: Optional[int],
               device=None):
    """(k, v, pool, phys) of a cache's (B, H, slots, Dh) K/V arena: zeroed
    tensors, or with ``paged`` zero-width placeholders over a fresh pool
    (:func:`init_paged`; pool and phys are None otherwise)."""
    if paged:
        pool, phys, z = init_paged(batch, kv_heads, slots, head_dim, block_p,
                                   dtype, pool_blocks, device=device)
        return z, z, pool, phys
    k = torch.zeros((batch, kv_heads, slots, head_dim), dtype=dtype,
                    device=device)
    return k, torch.zeros_like(k), None, None


def event_mask(active: Optional[torch.Tensor], shape,
               device=None) -> torch.Tensor:
    """The scheduler's lane mask (B,) broadcast over an event shape (B, H[,
    T]); None = every lane.  Pool mutations are gated on it."""
    if active is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return active.reshape((-1,) + (1,) * (len(shape) - 1)).expand(shape)


def cache_block_p(cache) -> int:
    """The kernel block granularity of a cache (its stored field or its
    block table's)."""
    bp = getattr(cache, "block_p", None)
    if bp is None and hasattr(cache, "blocks"):
        bp = cache.blocks.block_p
    return bp or 0


def pack_dense(cache, pool_blocks: Optional[int] = None):
    """A fixed-arena cache converted to its pooled twin: a page for every
    block with a live slot, filled from the arena; dead blocks get none.
    Attention over either is the same (unmapped blocks are masked)."""
    bp = cache_block_p(cache)
    if not bp:
        raise ValueError("pack_dense requires block_p > 0")
    b, h, p, dh = cache.k.shape
    nb = p // bp
    pool = BlockPool.init(pool_blocks or b * h * nb, bp, dh, cache.k.dtype,
                          device=cache.k.device)
    valid = cache.valid_mask().expand(b, h, p)
    need = valid.reshape(b, h, nb, bp).any(dim=-1).reshape(-1)
    pool, page, ok = block_pool.alloc(pool, need)
    phys = torch.where(need & ok, page, -1).reshape(b, h, nb)
    dst = torch.where(need & ok, page, pool.num_blocks).long()
    pool.k_buf[dst] = cache.k.reshape(b * h * nb, bp, dh)
    pool.v_buf[dst] = cache.v.reshape(b * h * nb, bp, dh)
    return dataclasses.replace(cache, k=cache.k[..., :0], v=cache.v[..., :0],
                               pool=pool, phys=phys)


# ---------------------------------------------------------------------------
# Vanilla (dense, append-only) cache
# ---------------------------------------------------------------------------


@dataclass
class VanillaCache:
    """Dense append-only arena, (B, H, S, Dh) with S padded to a
    ``block_p`` multiple.  Occupancy is the prefix ``[0, length)``, so no
    table is stored: :func:`prefix_block_spec` derives it (once a step, in
    ``VanillaPolicy.prepare_step``).  ``block_p == 0`` is
    the exact legacy arena (the kernel's dense mode)."""

    k: torch.Tensor              # (B, H, S, Dh); zero-width when paged
    v: torch.Tensor
    length: torch.Tensor         # (B,) int32 — tokens written, per lane
    block_p: int = field(default=0, metadata={"static": True})
    pool: Optional[BlockPool] = None
    phys: Optional[torch.Tensor] = None  # paged: (B, H, NB) int32, -1 = unmapped

    @staticmethod
    def init(batch: int, kv_heads: int, max_len: int, head_dim: int,
             dtype=torch.bfloat16, block_p: int = 0, paged: bool = False,
             pool_blocks: Optional[int] = None, device=None) -> "VanillaCache":
        k, v, pool, phys = init_arena(batch, kv_heads,
                                      _round_up(max_len, block_p), head_dim,
                                      dtype, block_p, paged, pool_blocks,
                                      device)
        return VanillaCache(k=k, v=v,
                            length=torch.zeros((batch,), dtype=_I32,
                                               device=device),
                            block_p=block_p, pool=pool, phys=phys)

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Write ``k_new``/``v_new`` (B, H, T, Dh) at ``[length, length +
        T)`` of each lane, in place, for active lanes only; returns the
        (B, H) count every lane would hold after it (``length + T``).  As
        in the reference the write start is clamped so that the T rows fit
        the arena."""
        b, h, t = k_new.shape[:3]
        s = arena_slots(self.k)
        start = torch.clamp(self.length, 0, max(s - t, 0))
        slot = start[:, None, None] + torch.arange(t, device=start.device)
        slot = slot.expand(b, h, t)
        if self.pool is None:
            write_rows(self.k, self.v, slot, k_new, v_new, active)
        else:
            block_pool.token_write(self.pool, self.phys, slot, k_new, v_new,
                                   event_mask(active, (b, h, t),
                                              device=slot.device))
        new_len = self.length + t
        self.length.copy_(_lane_where(active, new_len, self.length))
        return new_len[:, None].expand(b, h)

    # -- views ----------------------------------------------------------------

    def valid_mask(self) -> torch.Tensor:
        """Lazy (..., B, 1, S): the consumer broadcasts it over heads."""
        s = arena_slots(self.k)
        return (torch.arange(s, device=self.length.device)
                < self.length[..., None, None])

    def positions(self) -> torch.Tensor:
        s = arena_slots(self.k)
        return torch.arange(s, dtype=_I32, device=self.length.device)[None, None]

    def retained_tokens(self) -> torch.Tensor:
        return self.length[..., None].expand(self.k.shape[:-2])


# ---------------------------------------------------------------------------
# Masked DMS cache (the reference's correctness oracle)
# ---------------------------------------------------------------------------


@dataclass
class MaskedDMSCache:
    """Full-length arena with a ``retained`` bitmap: token ``t`` lives at
    slot ``t``; the decision recorded with it executes at step ``t + w``,
    clearing its bit.  The incremental :class:`BlockTable` drops a block
    when its last retained slot goes."""

    k: torch.Tensor              # (B, H, S, Dh); zero-width when paged
    v: torch.Tensor
    retained: torch.Tensor       # (B, H, S) bool — False once evicted
    alpha: torch.Tensor          # (B, H, S) bool — recorded decisions
    length: torch.Tensor         # (B,) int32
    blocks: BlockTable
    window: int = field(metadata={"static": True})
    pool: Optional[BlockPool] = None
    phys: Optional[torch.Tensor] = None  # paged: (B, H, NB) int32, -1 = unmapped

    @staticmethod
    def init(batch: int, kv_heads: int, max_len: int, head_dim: int,
             window: int, dtype=torch.bfloat16, block_p: int = 0,
             paged: bool = False, pool_blocks: Optional[int] = None,
             device=None) -> "MaskedDMSCache":
        s = _round_up(max_len, block_p)
        k, v, pool, phys = init_arena(batch, kv_heads, s, head_dim, dtype,
                                      block_p, paged, pool_blocks, device)
        f = torch.zeros((batch, kv_heads, s), dtype=torch.bool, device=device)
        return MaskedDMSCache(
            k=k, v=v, retained=f, alpha=f.clone(),
            length=torch.zeros((batch,), dtype=_I32, device=device),
            blocks=BlockTable.init(batch, kv_heads, s, block_p, device=device),
            window=window, pool=pool, phys=phys)

    def step(self, k_new: torch.Tensor, v_new: torch.Tensor,
             alpha_new: torch.Tensor,
             active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Append one token per (lane, head) at slot ``length`` and execute
        the eviction of token ``length - w``, in place, for active lanes
        only.  Returns the (B, H) retained count every lane would hold."""
        t = self.length.clone()              # the commit advances the leaf
        b, h, s = self.retained.shape
        idx = torch.arange(s, device=t.device)
        at_t = idx == t[:, None, None]                       # (B, 1, S)
        retained = self.retained | at_t
        alpha = torch.where(at_t, alpha_new[..., None], self.alpha)
        j = t - self.window
        evict_now = ((idx == j[:, None, None]) & alpha
                     & (j >= 0)[:, None, None])
        retained = retained & ~evict_now
        ins = (t < s)[:, None].expand(b, h)
        blocks = self.blocks.insert(t[:, None].expand(b, h), ins)
        blocks, dead = blocks.evict_ex(j[:, None].expand(b, h),
                                       evict_now.any(dim=2))
        count = (retained & (idx < (t + 1)[:, None, None])).sum(dim=-1)
        commit(self, dict(retained=retained, alpha=alpha, length=t + 1),
               blocks, active)
        if self.pool is None:
            write = ins[:, 0] if active is None else ins[:, 0] & active
            write_rows(self.k, self.v,
                       torch.clamp(t, max=s - 1)[:, None].expand(b, h),
                       k_new, v_new, write)
            return count
        act = event_mask(active, (b, h), device=t.device)
        block_pool.token_write(self.pool, self.phys,
                               t[:, None, None].expand(b, h, 1), k_new, v_new,
                               (ins & act)[..., None])
        block_pool.free_block(self.pool, self.phys,
                              torch.clamp(j, 0, s - 1)[:, None].expand(b, h),
                              dead & act)
        return count

    # -- views ----------------------------------------------------------------

    def block_spec(self):
        return self.blocks.spec()

    def valid_mask(self) -> torch.Tensor:
        s = self.retained.shape[-1]
        written = (torch.arange(s, device=self.length.device)
                   < self.length[..., None, None])
        return self.retained & written

    def positions(self) -> torch.Tensor:
        s = self.retained.shape[-1]
        pos = torch.arange(s, dtype=_I32, device=self.length.device)
        return pos.expand(self.retained.shape)

    def retained_tokens(self) -> torch.Tensor:
        return self.valid_mask().sum(dim=-1)


# ---------------------------------------------------------------------------
# Slot-compacted DMS cache
# ---------------------------------------------------------------------------

@dataclass
class SlotDMSCache:
    """Physically compacted cache: P slots per (lane, kv head).

    If the arena overflows (the model under-evicts against the provisioned
    CR) the allocator recycles the oldest live slot (the lowest position;
    ties go to the lowest slot, as the reference's ``argmin``) and flags
    ``overflowed``.  ``dms_active=False`` marks a cache whose α is never
    predicted: a plain ring buffer, windowed by that recycling."""

    k: torch.Tensor             # (B, H, P, Dh) post-RoPE; P padded to block_p
    v: torch.Tensor             # (B, H, P, Dh)
    pos: torch.Tensor           # (B, H, P) int32 — logical position; INVALID_POS = empty
    valid: torch.Tensor         # (B, H, P) bool
    free_ring: torch.Tensor     # (B, H, P) int32 — circular buffer of free slot ids
    free_head: torch.Tensor     # (B, H) int32
    free_count: torch.Tensor    # (B, H) int32
    pending_slot: torch.Tensor  # (B, H, w) int32
    pending_alpha: torch.Tensor  # (B, H, w) bool
    length: torch.Tensor        # (B,) int32 — logical tokens written, per lane
    overflowed: torch.Tensor    # (B, H) bool
    blocks: BlockTable          # incremental live-block table (flash-decode)
    window: int = field(metadata={"static": True})
    #: logical arena capacity (the physical extent of ``k`` may be padded)
    slots: int = field(metadata={"static": True})
    dms_active: bool = field(default=True, metadata={"static": True})
    pool: Optional[BlockPool] = None     # paged: the shared page arena
    phys: Optional[torch.Tensor] = None  # paged: (B, H, NB) int32, -1 = unmapped

    @staticmethod
    def init(batch: int, kv_heads: int, num_slots: int, head_dim: int,
             window: int, dtype=torch.bfloat16, dms_active: bool = True,
             block_p: int = 0, paged: bool = False,
             pool_blocks: Optional[int] = None,
             device=None) -> "SlotDMSCache":
        p = _round_up(num_slots, block_p)
        bh = (batch, kv_heads)
        ring = torch.arange(p, dtype=_I32, device=device) % num_slots
        k, v, pool, phys = init_arena(batch, kv_heads, p, head_dim, dtype,
                                      block_p, paged, pool_blocks, device)
        return SlotDMSCache(
            k=k, v=v,
            pos=torch.full(bh + (p,), INVALID_POS, dtype=_I32, device=device),
            valid=torch.zeros(bh + (p,), dtype=torch.bool, device=device),
            free_ring=ring.expand(bh + (p,)).contiguous(),
            free_head=torch.zeros(bh, dtype=_I32, device=device),
            free_count=torch.full(bh, num_slots, dtype=_I32, device=device),
            pending_slot=torch.full(bh + (window,), -1, dtype=_I32,
                                    device=device),
            pending_alpha=torch.zeros(bh + (window,), dtype=torch.bool,
                                      device=device),
            length=torch.zeros((batch,), dtype=_I32, device=device),
            overflowed=torch.zeros(bh, dtype=torch.bool, device=device),
            blocks=BlockTable.init(batch, kv_heads, p, block_p, device=device),
            window=window, slots=num_slots, dms_active=dms_active,
            pool=pool, phys=phys)

    @staticmethod
    def provision_slots(seq_len: int, cr: float, window: int) -> int:
        """P = S / CR + w + slack — the arena size for a target CR."""
        return int(seq_len / cr) + window + 16

    # -- the step -------------------------------------------------------------

    def _advance(self, alpha_new: torch.Tensor):
        """New metadata of every lane after one step: execute the eviction
        decided ``w`` steps ago, pop a slot, record the new token.  Returns
        (metadata by field name, block table, the slot (B, H) written, the
        evicted slot (B, H), the mask of blocks that eviction emptied)."""
        t = self.length
        w = self.window
        b, h, p = self.valid.shape
        p_idx = torch.arange(p, device=t.device)

        # execute the pending decision of ring slot t mod w
        ring_idx = (t % w).long()[:, None, None].expand(b, h, 1)
        slot = self.pending_slot.gather(2, ring_idx)[..., 0]
        alpha = self.pending_alpha.gather(2, ring_idx)[..., 0]
        slot_c = torch.clamp(slot, 0, p - 1)
        was_valid = self.valid.gather(2, slot_c.long()[..., None])[..., 0]
        do_evict = (t >= w)[:, None] & alpha & (slot >= 0) & was_valid
        hit = (p_idx == slot_c[..., None]) & do_evict[..., None]
        valid = self.valid & ~hit
        pos = torch.where(hit, INVALID_POS, self.pos)
        ring_len = self.free_ring.shape[2]
        tail = (self.free_head + self.free_count) % ring_len
        free_ring = torch.where((p_idx == tail[..., None]) & do_evict[..., None],
                                slot_c[..., None], self.free_ring)
        free_count = self.free_count + do_evict.to(_I32)
        blocks, dead = self.blocks.evict_ex(slot_c, do_evict)

        # allocate: the free ring's head, or recycle the oldest live slot
        have_free = free_count > 0
        head_slot = free_ring.gather(2, self.free_head.long()[..., None])[..., 0]
        oldest = torch.where(valid, pos, INVALID_POS).argmin(dim=2).to(_I32)
        slot = torch.where(have_free, head_slot, oldest)
        free_head = torch.where(have_free, (self.free_head + 1) % ring_len,
                                self.free_head)
        free_count = torch.where(have_free, free_count - 1, free_count)
        overflowed = self.overflowed | ~have_free

        # write the new token's metadata; recycling a live slot is no insert
        hit = p_idx == slot[..., None]
        was_valid = valid.gather(2, slot.long()[..., None])[..., 0]
        blocks = blocks.insert(slot, ~was_valid)
        pos = torch.where(hit, t[:, None, None], pos)
        valid = valid | hit
        ring_hit = (torch.arange(w, device=t.device)
                    == (t % w)[:, None, None])                    # (B, 1, w)
        pending_slot = torch.where(ring_hit, slot[..., None], self.pending_slot)
        pending_alpha = torch.where(ring_hit, alpha_new[..., None],
                                    self.pending_alpha)
        meta = dict(pos=pos, valid=valid, free_ring=free_ring,
                    free_head=free_head, free_count=free_count,
                    pending_slot=pending_slot, pending_alpha=pending_alpha,
                    length=t + 1, overflowed=overflowed)
        return meta, blocks, slot, slot_c, dead

    def step(self, k_new: torch.Tensor, v_new: torch.Tensor,
             alpha_new: torch.Tensor,
             active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Append one token per (lane, head) and execute delayed evictions,
        in place.  ``k_new``/``v_new``: (B, H, 1, Dh) post-RoPE;
        ``alpha_new``: (B, H) bool; ``active``: (B,) bool, None = all lanes.
        Inactive lanes are left exactly as they were.

        Returns the (B, H) retained-token count every lane *would* hold
        after the step — the count the reference's metrics report, which it
        takes before freezing inactive lanes."""
        meta, blocks, slot, evicted, dead = self._advance(alpha_new)
        retained = meta["valid"].sum(dim=-1)
        commit(self, meta, blocks, active)
        if self.pool is None:
            write_rows(self.k, self.v, slot, k_new, v_new, active)
            return retained
        act = event_mask(active, slot.shape, device=slot.device)
        block_pool.free_block(self.pool, self.phys, evicted, dead & act)
        block_pool.token_write(self.pool, self.phys, slot[..., None], k_new,
                               v_new, act[..., None])
        return retained

    # -- views ----------------------------------------------------------------

    def block_spec(self):
        return self.blocks.spec()

    def valid_mask(self) -> torch.Tensor:
        return self.valid

    def positions(self) -> torch.Tensor:
        return self.pos

    def retained_tokens(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)

    @staticmethod
    def from_prefill(k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor, retained: torch.Tensor,
                     window: int, num_slots: int,
                     alpha_bin: Optional[torch.Tensor] = None,
                     block_p: int = 0) -> "SlotDMSCache":
        """A compacted cache built from a dense prefill: ``k``/``v`` (B, H,
        T, Dh) post-RoPE, ``retained`` (B, H, T) bool, ``positions`` (T,).
        Retained tokens fill the first slots in position order; with
        ``alpha_bin`` (B, H, T) the tokens still inside the delay window
        enter the pending ring, so their evictions execute on schedule."""
        b, h, t, d = k.shape
        dev = k.device
        p = _round_up(num_slots, block_p)
        pos_full = positions.to(_I32).expand(b, h, t)
        order = torch.argsort(torch.where(retained, pos_full, INVALID_POS),
                              dim=2, stable=True)
        idx = (order[..., :p] if t >= p
               else torch.nn.functional.pad(order, (0, p - t)))
        n_keep = torch.clamp(retained.sum(dim=2), max=num_slots)    # (B, H)
        slot_ids = torch.arange(p, device=dev)
        live = slot_ids < n_keep[..., None]                         # (B, H, P)

        def gather(x):
            g = x.gather(2, idx[..., None].expand(b, h, p, d))
            return torch.where(live[..., None], g, torch.zeros((), dtype=x.dtype,
                                                               device=dev))

        ring = torch.full((b, h, window), -1, dtype=_I32, device=dev)
        ring_alpha = torch.zeros((b, h, window), dtype=torch.bool, device=dev)
        if alpha_bin is not None:
            # tokens (t - 1 - w, t) have decisions not yet executed; each is
            # retained, and its slot is its rank among the retained
            js = torch.arange(max(0, t - window), t, device=dev)
            rank = torch.cumsum(retained.to(_I32), dim=2) - 1
            ring[..., js % window] = rank[..., js].to(_I32)
            ring_alpha[..., js % window] = alpha_bin[..., js]
        return SlotDMSCache(
            k=gather(k), v=gather(v),
            pos=torch.where(live, pos_full.gather(2, idx), INVALID_POS),
            valid=live,
            free_ring=((n_keep[..., None] + slot_ids) % num_slots).to(_I32),
            free_head=torch.zeros((b, h), dtype=_I32, device=dev),
            free_count=(num_slots - n_keep).to(_I32),
            pending_slot=ring, pending_alpha=ring_alpha,
            length=torch.full((b,), t, dtype=_I32, device=dev),
            overflowed=torch.zeros((b, h), dtype=torch.bool, device=dev),
            blocks=BlockTable.from_valid(live, block_p),
            window=window, slots=num_slots)
