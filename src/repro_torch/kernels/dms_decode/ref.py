"""Plain PyTorch version of the block-table flash-decode kernel.

It computes the kernel's function on the kernel's flattened operands: each
(lane, kv head) row attends over the visible slots of the blocks listed in
``block_tbl[row, :block_n[row]]`` only, in fp32, and a row with no listed
block (or no visible slot in them) gives zeros.  Like the kernel it gathers
the listed blocks and touches nothing else, so unlisted blocks may hold any
bytes, NaN included.  That is what the CUDA kernel (``csrc/dms_decode.cu``)
computes and what ``chip_smoke.py`` holds it against on the card; the CPU
tests run it in the kernel's place.

Two layouts, as the kernel's two modes: :func:`dms_decode_plain` reads each
row's own arena (fixed arenas); :func:`dms_decode_plain_shared` reads pages
of one shared pool (the paged pool), with ``valid`` already in table order.
Both gather the listed blocks in table order and share the arithmetic, so
the same logical contents give the same bits in either layout.
:func:`dms_decode_plain_weights` is the kernel's weights-out mode in either
layout: the output and the four raw outputs the kernel writes.
:func:`dms_decode_plain_split` does the same arithmetic the way the kernel
orders it: each row's listed entries cut into contiguous splits, each split
attended on its own, the splits combined by their log-sum-exp statistics.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _attend_listed(q: torch.Tensor, kl: torch.Tensor, vl: torch.Tensor,
                   live: torch.Tensor, logit_cap: Optional[float]
                   ) -> torch.Tensor:
    """q (BH, G, Dh); kl, vl (BH, L, Dh), the listed blocks' slots in table
    order; live (BH, L) bool.  Returns (BH, G, Dh) in q's dtype."""
    dh = q.shape[-1]
    live = live[:, None, :]                                        # (BH,1,L)
    kl = torch.where(live[:, 0, :, None], kl.float(), 0.0)
    vl = torch.where(live[:, 0, :, None], vl.float(), 0.0)
    s = torch.einsum("hgd,hpd->hgp", q.float(), kl) * (dh ** -0.5)
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True) if s.shape[-1] else s.sum(-1, keepdim=True)
    p_ = torch.where(live, torch.exp(s - m), 0.0)
    l = p_.sum(dim=-1, keepdim=True)
    out = torch.einsum("hgp,hpd->hgd", p_, vl)
    return (out / torch.where(l > 0, l, 1.0)).to(q.dtype)


def _listed(block_n: torch.Tensor, nbt: int, block_p: int) -> torch.Tensor:
    """(BH, NBt * block_p) bool: the slot lies in one of the first n entries."""
    entry = (torch.arange(nbt, device=block_n.device)[None, :]
             < block_n[:, None])
    return entry.repeat_interleave(block_p, dim=1)


def _listed_fixed(k, v, valid, block_tbl, block_n, block_p):
    """Fixed arenas: (K, V, live) of the listed blocks' slots in table
    order, (BH, NB_tbl * block_p, ...)."""
    bh, p, _ = k.shape
    nb, nbt = p // block_p, block_tbl.shape[1]
    idx = block_tbl.long().clamp(0, max(nb - 1, 0))              # (BH, NBt)

    def gather(x):                                   # (BH, P, ...) -> listed
        blocks = x.reshape((bh, nb, block_p) + x.shape[2:])
        ix = idx.reshape((bh, nbt) + (1,) * (blocks.dim() - 2))
        got = blocks.gather(1, ix.expand((bh, nbt) + blocks.shape[2:]))
        return got.reshape((bh, nbt * block_p) + x.shape[2:])

    live = gather(valid != 0) & _listed(block_n, nbt, block_p)
    return gather(k), gather(v), live


def _listed_shared(k, v, valid, block_tbl, block_n, block_p):
    """The shared pool: the listed pages' slots in table order."""
    bh, nbt = block_tbl.shape
    dh = k.shape[-1]
    npool = k.shape[1] // block_p
    idx = block_tbl.long().clamp(0, max(npool - 1, 0)).reshape(-1)

    def gather(x):
        return x.reshape(npool, block_p, dh)[idx].reshape(bh, nbt * block_p, dh)

    live = (valid != 0) & _listed(block_n, nbt, block_p)
    return gather(k), gather(v), live


def dms_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, block_tbl: torch.Tensor,
                     block_n: torch.Tensor, block_p: int,
                     logit_cap: Optional[float] = None) -> torch.Tensor:
    """q: (BH, G, Dh); k, v: (BH, P, Dh) with P a ``block_p`` multiple;
    valid: (BH, P) (``!= 0`` is live); block_tbl: (BH, NB_tbl) int;
    block_n: (BH,) int.  Returns (BH, G, Dh) in q's dtype."""
    return _attend_listed(q, *_listed_fixed(k, v, valid, block_tbl, block_n,
                                            block_p), logit_cap)


def dms_decode_plain_shared(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            valid: torch.Tensor, block_tbl: torch.Tensor,
                            block_n: torch.Tensor, block_p: int,
                            logit_cap: Optional[float] = None) -> torch.Tensor:
    """The shared-pool layout.  q: (BH, G, Dh); k, v: (1, NPOOL * block_p,
    Dh), one page arena for every row; valid: (BH, NB_tbl * block_p) in
    table order; block_tbl: (BH, NB_tbl) pool page ids; block_n: (BH,).
    Only the listed pages are gathered."""
    return _attend_listed(q, *_listed_shared(k, v, valid, block_tbl, block_n,
                                             block_p), logit_cap)


def dms_decode_plain_weights(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor,
                             block_tbl: torch.Tensor, block_n: torch.Tensor,
                             block_p: int, logit_cap: Optional[float] = None,
                             shared_kv: bool = False):
    """The weights-out mode, in the layout ``shared_kv`` names (operands as
    :func:`dms_decode_plain` or :func:`dms_decode_plain_shared`).  Returns
    ``(out, w_blk, m_blk, m_out, l_out)``: ``w_blk`` (BH, NB_tbl, G,
    block_p) fp32 holds each listed entry's ``exp(s - m_blk)`` (0 on dead
    slots), ``m_blk`` (BH, NB_tbl, G) the running max after that entry (a
    running max in table order: :func:`torch.cummax` of the entries'
    maxima), ``m_out``/``l_out`` (BH, G) the final max and denominator.
    The kernel leaves entries ``>= n`` unwritten; here they hold 0 and
    ``NEG_INF``."""
    listed = _listed_shared if shared_kv else _listed_fixed
    kl, vl, live = listed(k, v, valid, block_tbl, block_n, block_p)
    out = _attend_listed(q, kl, vl, live, logit_cap)
    bh, g, dh = q.shape
    nbt = block_tbl.shape[1]
    s = torch.einsum("hgd,hpd->hgp", q.float(),
                     torch.where(live[..., None], kl.float(), 0.0)) * dh ** -0.5
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    live4 = live.reshape(bh, 1, nbt, block_p)
    s4 = torch.where(live4, s.reshape(bh, g, nbt, block_p), NEG_INF)
    if nbt:
        m_blk = torch.cummax(s4.amax(dim=-1), dim=-1).values      # (BH, G, NBt)
    else:
        m_blk = s4.sum(dim=-1)
    w = torch.where(live4, torch.exp(s4 - m_blk[..., None]), 0.0)
    m_out = (m_blk[..., -1] if nbt
             else torch.full((bh, g), NEG_INF, device=q.device))
    l_out = torch.where(live4, torch.exp(s4 - m_out[..., None, None]),
                        0.0).sum(dim=(-1, -2))
    entry = (torch.arange(nbt, device=block_n.device)[None, :]
             < block_n[:, None])[:, None, :]                      # (BH, 1, NBt)
    m_blk = torch.where(entry, m_blk, NEG_INF)
    return (out, w.permute(0, 2, 1, 3).contiguous(),
            m_blk.permute(0, 2, 1).contiguous(), m_out, l_out)


def dms_decode_plain_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid: torch.Tensor, block_tbl: torch.Tensor,
                           block_n: torch.Tensor, block_p: int,
                           logit_cap: Optional[float] = None,
                           shared_kv: bool = False, splits: int = 1,
                           need_weights: bool = False):
    """The kernel's split of the table, in plain PyTorch (operands as
    :func:`dms_decode_plain_weights`).  Row r's listed entries ``[0, n)``
    are cut into ``splits`` contiguous ranges, ``[s n // S, (s + 1) n //
    S)`` for split s (empty where n < S).  Each split attends over its range
    with its own max ``m_s`` and denominator ``l_s`` (-1e30 and 0 when it
    sees no slot); the output is ``sum_s acc_s e^(m_s - m) / sum_s l_s
    e^(m_s - m)`` with ``m = max_s m_s``, summed in split order.

    With ``need_weights`` returns ``(out, w_blk, m_blk, m_out, l_out)`` as
    the weights-out mode does: each split first weighs its entries against
    its own running max m~_i, then an entry with m~_i below ``M_<s``, the
    largest max of the splits before it, takes ``m_blk = M_<s`` and ``w_blk
    *= exp(m~_i - M_<s)`` — the running max in table order, as unsplit."""
    listed = _listed_shared if shared_kv else _listed_fixed
    kl, vl, live = listed(k, v, valid, block_tbl, block_n, block_p)
    bh, g, dh = q.shape
    nbt = block_tbl.shape[1]
    kl = torch.where(live[..., None], kl.float(), 0.0)
    vl = torch.where(live[..., None], vl.float(), 0.0)
    s = torch.einsum("hgd,hpd->hgp", q.float(), kl) * dh ** -0.5
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    s = torch.where(live[:, None, :], s, NEG_INF)
    count = block_n.long().clamp(0, nbt)[:, None]                    # (BH, 1)
    entry = torch.arange(nbt, device=q.device)[None, :]
    stats, w_blk, m_blk = [], None, None
    if need_weights:
        w_blk = torch.zeros((bh, g, nbt, block_p), device=q.device)
        m_blk = torch.full((bh, g, nbt), NEG_INF, device=q.device)
    m_before = torch.full((bh, g), NEG_INF, device=q.device)       # M_<s
    for sp in range(splits):
        mine = (entry >= sp * count // splits) & (entry < (sp + 1) * count // splits)
        slot = live & mine.repeat_interleave(block_p, dim=1)         # (BH, L)
        ss = torch.where(slot[:, None, :], s, NEG_INF)
        m_s = ss.amax(-1) if nbt else torch.full((bh, g), NEG_INF, device=q.device)
        p_ = torch.where(slot[:, None, :], torch.exp(ss - m_s[..., None]), 0.0)
        stats.append((m_s, p_.sum(-1), torch.einsum("hgp,hpd->hgd", p_, vl)))
        if need_weights and nbt:
            s4 = ss.reshape(bh, g, nbt, block_p)
            m_loc = torch.cummax(s4.amax(-1), dim=-1).values          # m~_i
            w = torch.where(slot.reshape(bh, 1, nbt, block_p),
                            torch.exp(s4 - m_loc[..., None]), 0.0)
            low = m_loc < m_before[..., None]
            m_run = torch.where(low, m_before[..., None], m_loc)
            w = torch.where(low[..., None],
                            w * torch.exp(m_loc - m_run)[..., None], w)
            w_blk = torch.where(mine[:, None, :, None], w, w_blk)
            m_blk = torch.where(mine[:, None, :], m_run, m_blk)
        m_before = torch.maximum(m_before, m_s)
    m = stats[0][0]
    for m_s, _, _ in stats[1:]:
        m = torch.maximum(m, m_s)
    l_sum = torch.zeros_like(m)
    acc = torch.zeros((bh, g, dh), device=q.device)
    for m_s, l_s, acc_s in stats:
        f = torch.exp(m_s - m)
        l_sum = l_sum + l_s * f
        acc = acc + acc_s * f[..., None]
    out = (acc / torch.where(l_sum > 0, l_sum, 1.0)[..., None]).to(q.dtype)
    if not need_weights:
        return out
    return (out, w_blk.permute(0, 2, 1, 3).contiguous(),
            m_blk.permute(0, 2, 1).contiguous(), m, l_sum)
