"""Paged KV block pool: on-demand lane arenas with copy-on-write fork.

The port of the reference ``repro.core.block_pool``.  Fixed per-lane arenas
hold a lane's provisioned ``ceil(max_len / CR) + window`` slots from
admission to EOS; the pool holds only the blocks a lane has live.

* :class:`BlockPool` holds one cache instance's page arena (``k``/``v``:
  (NPOOL, block_p, Dh)), a refcount vector (``ref == 0`` is the free list)
  and observability counters.
* Each cache keeps a page map ``phys``: (B, H, NB) int32, ``-1`` =
  unmapped.  Logical slot ``s`` of block ``b = s // block_p`` lives at pool
  page ``phys[lane, head, b]``.
* A page is allocated on the first write to an unmapped block
  (:func:`token_write`), freed when the cache's block table reports the
  block dead (:func:`free_block`), and reclaimed wholesale at EOS
  (:func:`recount` after the per-lane reset).
* A fork is copy-on-write: refcounts are recounted from the gathered page
  map and no page moves; the first divergent write to a page with
  ``ref > 1`` copies that one page.

Unlike the reference's pure functions, :func:`alloc`, :func:`token_write`
and :func:`free_block` update the pool and the page map **in place** (they
may be per-layer views of a stacked decode state) and return them.  JAX's
``.at[...].set(..., mode="drop")`` has no safe twin on CUDA, where an
out-of-range index is a device-side assert, so every update is masked
without one: refcount updates add zero where the mask is off, page-map
updates select the old value, and page writes that must not land go to a
dump page that the storage keeps after the last public page (``k_buf`` is
(NPOOL + 1, block_p, Dh); ``k`` is its first NPOOL pages, the reference's
shape).  No update reads a value back to the host or takes a shape from
the data, so a step stays free of host syncs.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

_I32 = torch.int32


@dataclass
class BlockPool:
    """Shared page arena + free list (``ref == 0``) + counters.

    One pool backs every lane and kv head of one cache instance (one per
    layer, stacked over layers in a decode state).  ``ref[p]`` is the
    number of (lane, head, block) map entries that point at page ``p``;
    CoW sharing after a fork is ``ref > 1``."""

    k_buf: torch.Tensor         # (NPOOL + 1, block_p, Dh): pages, dump page
    v_buf: torch.Tensor         # (NPOOL + 1, block_p, Dh)
    ref: torch.Tensor           # (NPOOL,) int32 — 0 = free page
    cow_copies: torch.Tensor    # () int32 — pages copied by divergent writes
    alloc_events: torch.Tensor  # () int32 — successful page allocations
    high_water: torch.Tensor    # () int32 — most pages allocated at once
    exhausted: torch.Tensor     # () bool — an allocation ever failed
    block_p: int = field(default=0, metadata={"static": True})

    @staticmethod
    def init(num_blocks: int, block_p: int, head_dim: int,
             dtype=torch.bfloat16, device=None) -> "BlockPool":
        def zero(dt):
            return torch.zeros((), dtype=dt, device=device)

        return BlockPool(
            k_buf=torch.zeros((num_blocks + 1, block_p, head_dim), dtype=dtype,
                              device=device),
            v_buf=torch.zeros((num_blocks + 1, block_p, head_dim), dtype=dtype,
                              device=device),
            ref=torch.zeros((num_blocks,), dtype=_I32, device=device),
            cow_copies=zero(_I32), alloc_events=zero(_I32),
            high_water=zero(_I32), exhausted=zero(torch.bool),
            block_p=block_p)

    @property
    def k(self) -> torch.Tensor:
        """The pages, (..., NPOOL, block_p, Dh) — a view without the dump."""
        return self.k_buf[..., :-1, :, :]

    @property
    def v(self) -> torch.Tensor:
        return self.v_buf[..., :-1, :, :]

    @property
    def num_blocks(self) -> int:
        return self.ref.shape[-1]


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------


def alloc(pool: BlockPool, need: torch.Tensor
          ) -> Tuple[BlockPool, torch.Tensor, torch.Tensor]:
    """Grab one free page per True entry of ``need`` (M,), in place.

    Lowest-free-id-first order, as the reference.  Returns ``(pool, page,
    ok)``; where ``ok`` is False the pool was exhausted and the caller must
    drop the write (``exhausted`` latches; no other lane's page is
    touched)."""
    npool = pool.num_blocks
    free = pool.ref == 0
    n_free = free.sum()
    order = torch.argsort((~free).to(torch.int8), stable=True)   # free first
    rank = torch.cumsum(need.to(_I32), dim=0) - 1
    ok = need & (rank < n_free)
    page = order[rank.clamp(0, npool - 1)].to(_I32)
    pool.ref.index_add_(0, page.long(), ok.to(_I32))
    used = npool - (pool.ref == 0).sum()
    pool.alloc_events.add_(ok.sum().to(_I32))
    pool.high_water.copy_(torch.maximum(pool.high_water, used.to(_I32)))
    pool.exhausted.logical_or_((need & ~ok).any())
    return pool, page, ok


def clear_flags(pool: BlockPool) -> BlockPool:
    """Un-latch ``exhausted`` once the scheduler has failed the requests a
    dropped write could have touched (in place)."""
    pool.exhausted.zero_()
    return pool


def recount(phys: torch.Tensor, num_blocks: int) -> torch.Tensor:
    """``ref`` recomputed as each page's multiplicity in ``phys`` (..., B,
    H, NB) with any leading axes -> (..., NPOOL) int32.  What whole-lane
    lifecycle ops (fork, gather, reclaim, import) use: a CoW refcount
    reaches zero exactly when the last mapping goes."""
    lead = phys.shape[:-3]
    flat = phys.reshape(lead + (-1,))
    ids = torch.arange(num_blocks, dtype=_I32, device=phys.device)
    return (flat[..., None] == ids).to(_I32).sum(dim=-2).to(_I32)


def set_refcounts(pool: BlockPool, phys: torch.Tensor) -> BlockPool:
    """A pool with ``ref = recount(phys)`` (a new tensor); the pages are
    shared with ``pool``, so no page moves."""
    return dataclasses.replace(pool, ref=recount(phys, pool.num_blocks))


# ---------------------------------------------------------------------------
# Write path (alloc-on-first-write + copy-on-write)
# ---------------------------------------------------------------------------


def _one_hot(idx: torch.Tensor, n: int, mask: torch.Tensor) -> torch.Tensor:
    """(…, n) bool: position ``idx`` where ``mask``."""
    return ((torch.arange(n, device=idx.device) == idx[..., None])
            & mask[..., None])


def token_write(pool: BlockPool, phys: torch.Tensor, slot: torch.Tensor,
                k_rows: torch.Tensor, v_rows: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[BlockPool, torch.Tensor]:
    """Write token rows at logical ``slot`` through the page map, in place.

    ``slot``/``mask``: (B, H, T); ``k_rows``/``v_rows``: (B, H, T, Dh).  Per
    masked event the target block is mapped on demand: the first write to
    an unmapped block allocates a page, a write to a CoW-shared page copies
    it first.  Exhaustion drops every write to the failed block (it is
    poisoned for this call) and latches ``pool.exhausted``; shared pages
    are never corrupted."""
    b, h, t = slot.shape
    nb = phys.shape[-1]
    bp = pool.block_p
    npool = pool.num_blocks
    blk = torch.clamp(slot // bp, 0, nb - 1)
    off = torch.clamp(slot - blk * bp, 0, bp - 1)
    cur = phys.gather(2, blk.long())                      # mapped page

    # only the first masked event of each block within a (lane, head)
    # decides alloc/CoW; later events of that block follow the new map
    same = blk[..., :, None] == blk[..., None, :]          # (B, H, T, T)
    earlier = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                    device=slot.device), -1)
    dup = (same & earlier & mask[..., None, :]).any(dim=-1)
    first = mask & ~dup

    ref_cur = pool.ref[cur.clamp(0, npool - 1).long()]
    need_alloc = first & (cur < 0)
    need_cow = first & (cur >= 0) & (ref_cur > 1)
    need = need_alloc | need_cow
    pool, page, ok = alloc(pool, need.reshape(-1))

    # CoW: copy the shared page into the fresh one, drop one ref
    cowf = need_cow.reshape(-1) & ok
    src = cur.reshape(-1).clamp(0, npool - 1).long()
    dst = torch.where(cowf, page, npool).long()            # npool = dump
    pool.k_buf[dst] = pool.k_buf[src]
    pool.v_buf[dst] = pool.v_buf[src]
    pool.ref.index_add_(0, src, -cowf.to(_I32))
    pool.cow_copies.add_(cowf.sum().to(_I32))

    # remap: first events with a fresh page point their block at it (at
    # most one such event per (lane, head, block))
    apply = (need.reshape(-1) & ok).reshape(b, h, t)
    hit = _one_hot(blk, nb, apply)                         # (B, H, T, NB)
    fresh = (hit.to(_I32) * page.reshape(b, h, t, 1)).sum(dim=2)
    phys.copy_(torch.where(hit.any(dim=2), fresh.to(phys.dtype), phys))

    # a failed allocation poisons its block: every event on it drops
    failed = (need.reshape(-1) & ~ok).reshape(b, h, t)
    bad = _one_hot(blk, nb, failed).any(dim=2).gather(2, blk.long())

    tgt = phys.gather(2, blk.long())
    wmask = mask & (tgt >= 0) & ~bad
    wt = torch.where(wmask, tgt, npool).reshape(-1).long()
    offf = off.reshape(-1).long()
    dh = k_rows.shape[-1]
    pool.k_buf[wt, offf] = k_rows.reshape(-1, dh).to(pool.k_buf.dtype)
    pool.v_buf[wt, offf] = v_rows.reshape(-1, dh).to(pool.v_buf.dtype)
    return pool, phys


def free_block(pool: BlockPool, phys: torch.Tensor, slot: torch.Tensor,
               mask: torch.Tensor) -> Tuple[BlockPool, torch.Tensor]:
    """Unmap the block holding ``slot`` (B, H) where ``mask``, in place:
    fired when the block table reports the block's last live slot gone.
    The page's refcount drops; it is free once its last sharer lets go."""
    nb = phys.shape[-1]
    npool = pool.num_blocks
    blk = torch.clamp(slot // pool.block_p, 0, nb - 1)
    cur = phys.gather(2, blk.long()[..., None])[..., 0]
    apply = mask & (cur >= 0)
    pool.ref.index_add_(0, cur.clamp(0, npool - 1).reshape(-1).long(),
                        -apply.reshape(-1).to(_I32))
    phys.masked_fill_(_one_hot(blk, nb, apply), -1)
    return pool, phys


# ---------------------------------------------------------------------------
# Read path
# ---------------------------------------------------------------------------


def _page_gather(pages: torch.Tensor, phys: torch.Tensor) -> torch.Tensor:
    """pages (..., NPOOL, bp, Dh) [leading axes as phys'] and phys (..., B,
    H, NB) -> (..., B, H, NB * bp, Dh); unmapped blocks read as zero."""
    lead = phys.shape[:-3]
    b, h, nb = phys.shape[-3:]
    npool, bp, dh = pages.shape[-3:]
    n = math.prod(lead)
    idx = phys.clamp(0, npool - 1).long().reshape(n, b * h * nb)
    rows = torch.arange(n, device=phys.device)[:, None]
    got = pages.reshape(n, npool, bp, dh)[rows, idx]       # (n, BHNB, bp, Dh)
    got = torch.where((phys >= 0).reshape(n, -1)[..., None, None], got,
                      torch.zeros((), dtype=got.dtype, device=got.device))
    return got.reshape(lead + (b, h, nb * bp, dh))


def dense_kv(pool: BlockPool, phys: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A lane-major dense (..., B, H, P, Dh) view of the pages (unmapped
    blocks read as zero).  The reference attention path and the densifying
    export read it; the kernel path never builds it."""
    return _page_gather(pool.k, phys), _page_gather(pool.v, phys)


def gather_rows(pages: torch.Tensor, phys: torch.Tensor, slot: torch.Tensor,
                block_p: int) -> torch.Tensor:
    """One token row per (lane, head) through the page map: ``pages``
    (NPOOL, block_p, Dh), ``slot`` (B, H) -> (B, H, Dh).  Unmapped slots
    read as zero (DMC's merge target before its first write)."""
    nb = phys.shape[-1]
    npool = pages.shape[0]
    blk = torch.clamp(slot // block_p, 0, nb - 1)
    off = torch.clamp(slot - blk * block_p, 0, block_p - 1)
    page = phys.gather(2, blk.long()[..., None])[..., 0]
    rows = pages[page.clamp(0, npool - 1).long(), off.long()]
    return torch.where((page >= 0)[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


def translate_table(phys: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """A logical block table (B, H, NB_tbl) mapped to pool page ids through
    ``phys``.  Stale entries past a row's ``n`` may come out -1; the kernel
    never dereferences them."""
    nb = phys.shape[-1]
    return phys.gather(2, tbl.clamp(0, nb - 1).long())


# ---------------------------------------------------------------------------
# Observability
# ---------------------------------------------------------------------------


def stats(pool: BlockPool, phys: torch.Tensor,
          live_tokens: Optional[torch.Tensor] = None) -> dict:
    """Host-side pool counters (any leading layer axes).  Reads the device.

    ``fragmentation``: the share of mapped slot capacity that holds no live
    token (padded-vs-packed waste inside allocated pages)."""
    ref = pool.ref.cpu().numpy()
    physv = phys.cpu().numpy()
    nsb = int(np.prod(ref.shape[:-1])) if ref.ndim > 1 else 1
    allocated = int((ref > 0).sum())
    total = int(ref.size)
    mapped_entries = int((physv >= 0).sum())
    out = {
        "pool_blocks": total,
        "allocated_blocks": allocated,
        "free_blocks": total - allocated,
        "shared_blocks": int((ref > 1).sum()),
        "mapped_entries": mapped_entries,
        "cow_copies": int(pool.cow_copies.sum()),
        "alloc_events": int(pool.alloc_events.sum()),
        "high_water_blocks": int(pool.high_water.sum()),
        "exhausted": bool(pool.exhausted.any()),
        "superblocks": nsb,
    }
    if live_tokens is not None:
        live = float(live_tokens.sum())
        cap = float(mapped_entries * pool.block_p)
        out["live_tokens"] = int(live)
        out["fragmentation"] = 1.0 - live / cap if cap else 0.0
    return out
