"""Plain PyTorch version of the block-table flash-decode kernel.

It computes the kernel's function on the kernel's flattened operands: each
(lane, kv head) row attends over the visible slots of the blocks listed in
``block_tbl[row, :block_n[row]]`` only, in fp32, and a row with no listed
block (or no visible slot in them) gives zeros.  Like the kernel it gathers
the listed blocks and touches nothing else, so unlisted blocks may hold any
bytes, NaN included.  That is what the CUDA kernel (``csrc/dms_decode.cu``)
computes and what ``chip_smoke.py`` holds it against on the card; the CPU
tests run it in the kernel's place.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def dms_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, block_tbl: torch.Tensor,
                     block_n: torch.Tensor, block_p: int,
                     logit_cap: Optional[float] = None) -> torch.Tensor:
    """q: (BH, G, Dh); k, v: (BH, P, Dh) with P a ``block_p`` multiple;
    valid: (BH, P) (``!= 0`` is live); block_tbl: (BH, NB_tbl) int;
    block_n: (BH,) int.  Returns (BH, G, Dh) in q's dtype."""
    bh, p, dh = k.shape
    nb, nbt = p // block_p, block_tbl.shape[1]
    idx = block_tbl.long().clamp(0, max(nb - 1, 0))              # (BH, NBt)
    entry = (torch.arange(nbt, device=k.device)[None, :]
             < block_n[:, None])                                 # (BH, NBt)

    def gather(x):                                   # (BH, P, ...) -> listed
        blocks = x.reshape((bh, nb, block_p) + x.shape[2:])
        ix = idx.reshape((bh, nbt) + (1,) * (blocks.dim() - 2))
        got = blocks.gather(1, ix.expand((bh, nbt) + blocks.shape[2:]))
        return got.reshape((bh, nbt * block_p) + x.shape[2:])

    live = (gather(valid != 0)
            & entry.repeat_interleave(block_p, dim=1))[:, None, :]  # (BH,1,L)
    kl = torch.where(live[:, 0, :, None], gather(k).float(), 0.0)
    vl = torch.where(live[:, 0, :, None], gather(v).float(), 0.0)
    s = torch.einsum("hgd,hpd->hgp", q.float(), kl) * (dh ** -0.5)
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True) if s.shape[-1] else s.sum(-1, keepdim=True)
    p_ = torch.where(live, torch.exp(s - m), 0.0)
    l = p_.sum(dim=-1, keepdim=True)
    out = torch.einsum("hgp,hpd->hgd", p_, vl)
    return (out / torch.where(l > 0, l, 1.0)).to(q.dtype)
