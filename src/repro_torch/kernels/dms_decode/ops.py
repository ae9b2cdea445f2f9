"""Wrapper of the block-table flash-decode kernel (inference only).

Two call modes, as in the reference ``repro.kernels.dms_decode.ops``:

* **Block-table mode** (``block_tbl``/``block_n``/``block_p`` given — what
  the policies' :class:`~repro_torch.core.policy.AttendSpec` supplies): the
  arena is allocated pre-padded to a ``block_p`` multiple in the kernel's
  per-(lane, kv-head) layout, so the wrapper only reshapes — no copy, no pad,
  no cast.  Traffic scales with live blocks.
  With ``pool_k``/``pool_v``/``phys`` also given (a paged cache, see
  :mod:`repro_torch.core.block_pool`) the kernel runs in **shared-pool
  mode**: K/V come from the one page arena, the logical table is translated
  to page ids through ``phys`` (one (B, Hkv, NB_tbl) int32 gather) and
  ``valid`` is gathered into table order (bool rows).  No page is copied and
  nothing is padded; the dense per-lane view is never built.
* **Legacy dense mode** (no table — direct kernel tests on arbitrary
  shapes): a table covering every block that holds a visible slot is derived
  from ``valid`` and the arena is padded to a block multiple.  Traffic then
  scales with arena capacity.

``need_weights=True`` (either mode, either layout) also returns the
group-summed post-softmax weights (B, Hkv, P) fp32 that TOVA, H2O and
Keyformer evict by.  As in the reference the kernel emits raw per-entry
outputs in table order (weights-out mode) and this wrapper rescales them,
sums the G heads and scatters them to logical arena rows
(:func:`table_weights_to_arena`).

**Slot-shard mode** (:func:`dms_decode_shard`, a fixed arena whose slot
axis is split across ranks): the arena is the rank's shard ``[slot_lo,
slot_lo + P_local)``, the table the whole row's (global block ids, blocks
need not align with the shard), and the kernel reads only the listed slots
inside the shard.  It returns the shard's output with its max and
denominator, which the ranks combine, and with ``need_weights`` the raw
weights-out outputs, which :func:`table_weights_to_arena` scatters to the
shard's slots under the combined statistics.

CUDA tensors go to the hand-written kernel (``csrc/dms_decode.cu``) or the
call raises; CPU tensors go to the plain version (:mod:`.ref`).  Nothing
else picks the path.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dms_decode.ref import (dms_decode_plain,
                                                dms_decode_plain_shard,
                                                dms_decode_plain_shared,
                                                dms_decode_plain_weights)

DEFAULT_BLOCK_P = 128
MAX_G, MAX_DH, MAX_BLOCK_P = 16, 256, 128
#: the most splits (thread blocks of one cluster) of a row's table
MAX_SPLITS = 16
SOURCE = Path(__file__).resolve().parent / "csrc" / "dms_decode.cu"

#: kernel launches since the last reset (the CPU path never counts), in
#: fixed-arena mode, in shared-pool mode, in weights-out mode (either
#: layout; counted here only), and in slot-shard mode (with or without
#: weights; counted here only)
launches = 0
shared_launches = 0
weights_launches = 0
shard_launches = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.dms_decode_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 11 + [i32] * 6 + [ctypes.c_float, i32,
                                                ctypes.c_float, i32, i32, i32,
                                                i32, ptr]
        fn.restype = i32
        lib.dms_decode_stages.argtypes = [i32] * 6
        lib.dms_decode_stages.restype = i32
    return lib


def build() -> None:
    """Compile and load the kernel now (``chip_smoke.py`` times this)."""
    _library()


def splits(nb_tbl: int, bh: int, sms: int) -> int:
    """The thread blocks (one cluster) the kernel gives each row's table of
    capacity ``nb_tbl`` when ``bh`` rows share a card of ``sms`` SMs: as
    many as fill the SMs, ``sms // bh``, at most ``MAX_SPLITS`` and
    ``nb_tbl`` (a split takes at least one entry), at least 1.  From shapes
    alone, never from ``block_n``, so a step stays free of host syncs;
    non-increasing in B*Hkv."""
    return max(1, min(MAX_SPLITS, nb_tbl, sms // max(bh, 1)))


_SMS: dict = {}


def sm_count(device) -> int:
    """The SM count of a CUDA ``device`` (asked once)."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def launch_splits(qf: torch.Tensor, nb_tbl: int) -> int:
    """:func:`splits` for a launch on ``qf`` (BH, G, Dh) on its card."""
    return splits(nb_tbl, qf.shape[0], sm_count(qf.device))


def stages(g: int, dh: int, block_p: int, nb_tbl: int, nsplit: int) -> int:
    """The kernel's ring depth at a shape (asked of the built kernel), out
    of slot-shard mode."""
    return int(_library().dms_decode_stages(g, dh, block_p, nb_tbl, nsplit,
                                            0))


def modeled_hbm_bytes(block_n: torch.Tensor, block_p: int, head_dim: int,
                      k_dtype: torch.dtype, v_dtype: torch.dtype) -> int:
    """K/V bytes the kernel reads for one decode step: ``sum(n)`` listed
    blocks × block bytes (reads a host copy of ``block_n``)."""
    per_slot = head_dim * (torch.empty((), dtype=k_dtype).element_size()
                           + torch.empty((), dtype=v_dtype).element_size())
    return int(block_n.sum().item()) * block_p * per_slot


def _launch(qf, kf, vf, valf, tblf, nf, block_p, logit_cap, shared_kv,
            need_weights=False, nsplit=None, slot_lo=None):
    """The kernel on CUDA tensors of the flattened layout; raises on what it
    does not take.  With ``need_weights`` returns the five outputs of the
    weights-out mode.  ``nsplit`` overrides :func:`launch_splits` (a sweep
    of the split count).  ``slot_lo`` (an int) is the slot-shard mode:
    returns ``(out, m, l)``, or the five weights-out outputs."""
    global launches, shared_launches, weights_launches, shard_launches
    shard = slot_lo is not None
    if shard and (shared_kv or slot_lo < 0):
        raise ValueError("dms_decode kernel: a slot shard is a fixed arena "
                         f"at a slot offset >= 0, got slot_lo={slot_lo}, "
                         f"shared_kv={shared_kv}")
    bh, g, dh = qf.shape
    p = kf.shape[1]
    if not (1 <= g <= MAX_G and 8 <= dh <= MAX_DH and dh % 8 == 0):
        raise ValueError(f"dms_decode kernel takes G <= {MAX_G} and Dh a "
                         f"multiple of 8 up to {MAX_DH}; got G={g}, Dh={dh}")
    if not 1 <= block_p <= MAX_BLOCK_P:
        raise ValueError(f"dms_decode kernel takes block_p <= {MAX_BLOCK_P}, "
                         f"got {block_p}")
    for name, t, dt in (("q", qf, torch.bfloat16), ("k", kf, torch.bfloat16),
                        ("v", vf, torch.bfloat16), ("block_tbl", tblf, torch.int32),
                        ("block_n", nf, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"dms_decode kernel: {name} must be {dt}, got {t.dtype}")
    if valf.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"dms_decode kernel: valid must be bool or uint8, "
                        f"got {valf.dtype}")
    for name, t in (("q", qf), ("k", kf), ("v", vf), ("valid", valf),
                    ("block_tbl", tblf), ("block_n", nf)):
        if not t.is_contiguous():
            raise ValueError(f"dms_decode kernel: {name} must be contiguous")
        if t.device != qf.device:
            raise ValueError(f"dms_decode kernel: {name} on {t.device}, "
                             f"q on {qf.device}")
    if qf.data_ptr() % 16 or kf.data_ptr() % 16 or vf.data_ptr() % 16:
        raise ValueError("dms_decode kernel: q/k/v must be 16-byte aligned")
    out = torch.empty_like(qf)
    nbt = tblf.shape[1]
    f32 = dict(dtype=torch.float32, device=qf.device)
    # entries >= n (and, on a shard, entries whose block lies outside it)
    # stay unwritten: the wrapper never trusts them
    w = ((torch.empty((bh, nbt, g, block_p), **f32),
          torch.empty((bh, nbt, g), **f32)) if need_weights else ())
    stats = ((torch.empty((bh, g), **f32), torch.empty((bh, g), **f32))
             if need_weights or shard else ())
    res = (out,) + w + stats if stats else out
    if bh == 0:
        return res
    lib = _library()
    ptrs = ([t.data_ptr() for t in w] or [None, None]) + (
        [t.data_ptr() for t in stats] or [None, None])
    if nsplit is None:
        nsplit = launch_splits(qf, nbt)
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream(qf.device).cuda_stream
        err = lib.dms_decode_fwd(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), valf.data_ptr(),
            tblf.data_ptr(), nf.data_ptr(), out.data_ptr(), *ptrs,
            bh, g, dh, p, nbt, block_p, float(dh ** -0.5),
            int(logit_cap is not None),
            float(logit_cap if logit_cap is not None else 0.0),
            int(shared_kv), int(shard), int(slot_lo or 0), int(nsplit), stream)
    if err != 0:
        raise RuntimeError(f"dms_decode kernel launch failed: CUDA error {err}")
    if shard:
        shard_launches += 1
    elif need_weights:
        weights_launches += 1
    elif shared_kv:
        shared_launches += 1
    else:
        launches += 1
    return res


def decode_rows(qf, kf, vf, valf, tblf, nf, block_p: int,
                logit_cap: Optional[float] = None,
                shared_kv: bool = False, need_weights: bool = False,
                slot_lo: Optional[int] = None):
    """The kernel's own interface: q (BH, G, Dh); block_tbl (BH, NB_tbl)
    int32; block_n (BH,) int32 -> (BH, G, Dh).  Fixed-arena mode: k, v (BH,
    P, Dh), valid (BH, P), table entries index the row's own arena.
    ``shared_kv``: k, v (1, NPOOL * block_p, Dh), one page arena for every
    row, valid (BH, NB_tbl * block_p) in table order, table entries are
    page ids.  ``need_weights``: the weights-out mode, returning ``(out,
    w_blk, m_blk, m_out, l_out)`` (see
    :func:`~repro_torch.kernels.dms_decode.ref.dms_decode_plain_weights`;
    the kernel leaves entries ``>= n`` of ``w_blk``/``m_blk`` unwritten).
    ``slot_lo``: the slot-shard mode, k, v (BH, P_local, Dh) and valid (BH,
    P_local) the shard ``[slot_lo, slot_lo + P_local)`` of each row, table
    entries global block ids; returns ``(out, m, l)`` (see
    :func:`~repro_torch.kernels.dms_decode.ref.dms_decode_plain_shard`), or
    with ``need_weights`` the five weights-out outputs.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if qf.is_cuda:
        return _launch(qf, kf, vf, valf, tblf, nf, block_p, logit_cap,
                       shared_kv, need_weights, slot_lo=slot_lo)
    if qf.device.type == "cpu":
        if slot_lo is not None:
            if shared_kv:
                raise ValueError("dms_decode: a slot shard is a fixed arena")
            return dms_decode_plain_shard(qf, kf, vf, valf, tblf, nf, block_p,
                                          slot_lo, logit_cap, need_weights)
        if need_weights:
            return dms_decode_plain_weights(qf, kf, vf, valf, tblf, nf,
                                            block_p, logit_cap, shared_kv)
        plain = dms_decode_plain_shared if shared_kv else dms_decode_plain
        return plain(qf, kf, vf, valf, tblf, nf, block_p, logit_cap)
    raise ValueError(f"dms_decode: unsupported device {qf.device}")


def table_weights_to_arena(w_blk: torch.Tensor, m_blk: torch.Tensor,
                           m_out: torch.Tensor, l_out: torch.Tensor,
                           block_n: torch.Tensor, ltbl: torch.Tensor,
                           nb_arena: int, slot_lo: Optional[int] = None,
                           p_local: Optional[int] = None) -> torch.Tensor:
    """The weights-out mode's raw outputs -> group-summed softmax weights
    per logical arena slot, (BH, nb_arena * block_p) fp32.

    Each listed entry's ``exp(s - m_blk)`` is rescaled by ``exp(min(m_blk -
    m_out, 0)) / l_out`` (per query head: the G heads of a group have their
    own statistics) and summed over G, then scattered to its logical block
    ``ltbl[row, i]``.  Entries ``>= n`` may hold anything, NaN included:
    they are replaced with ``torch.where`` (never multiplied by 0) and
    scattered to a dump row past the arena that is sliced off — CUDA has no
    ``mode="drop"``.  A row with ``l_out == 0`` (n = 0, or every listed slot
    hidden) gives zeros; the reference attention path gives a uniform row
    there (docs/kernels.md, "edge case").

    On a slot shard (``slot_lo``, ``p_local``: the slot-shard mode's raw
    outputs) ``m_out``/``l_out`` are the statistics combined over the
    shards, the rows are the shard's ``p_local`` slots, (BH, p_local), and
    each listed slot lands at its global slot less ``slot_lo``; the slots
    of a block outside the shard (unwritten entries) and those of a
    straddling block that lie outside it are dropped."""
    bh, nbt, g, bp = w_blk.shape
    row_live = (torch.arange(nbt, device=ltbl.device)[None, :]
                < block_n[:, None])                                # (BH, NBt)
    if slot_lo is not None:
        lo = ltbl.long() * bp - slot_lo                            # (BH, NBt)
        row_live = row_live & (lo < p_local) & (lo + bp > 0)
    l_safe = torch.where(l_out <= 0.0, 1.0, l_out)                  # (BH, G)
    corr = (torch.exp(torch.clamp(m_blk - m_out[:, None, :], max=0.0))
            / l_safe[:, None, :])                                   # (BH, NBt, G)
    w_tbl = (w_blk * corr[..., None]).sum(dim=2)                    # (BH, NBt, bp)
    w_tbl = torch.where(row_live[..., None], w_tbl, 0.0)
    if slot_lo is not None:
        slot = lo[..., None] + torch.arange(bp, device=lo.device)   # (BH, NBt, bp)
        own = row_live[..., None] & (slot >= 0) & (slot < p_local)
        w_slots = torch.zeros((bh, p_local + 1), dtype=torch.float32,
                              device=w_blk.device)
        w_slots.scatter_(1, torch.where(own, slot, p_local).reshape(bh, -1),
                         torch.where(own, w_tbl, 0.0).reshape(bh, -1))
        return w_slots[:, :p_local]
    rows = torch.where(row_live, ltbl.long().clamp(0, nb_arena - 1), nb_arena)
    w_arena = torch.zeros((bh, nb_arena + 1, bp), dtype=torch.float32,
                          device=w_blk.device)
    w_arena.scatter_(1, rows[..., None].expand(-1, -1, bp), w_tbl)
    return w_arena[:, :nb_arena].reshape(bh, nb_arena * bp)


def dms_decode_attention(
    q: torch.Tensor,                 # (B, 1, Hq, Dh)
    k: Optional[torch.Tensor],       # (B, Hkv, P, Dh); None with a pool
    v: Optional[torch.Tensor],
    valid: torch.Tensor,             # (B, Hkv, P) bool
    *,
    block_tbl: Optional[torch.Tensor] = None,   # (B, Hkv, NB) int32
    block_n: Optional[torch.Tensor] = None,     # (B, Hkv) int32
    block_p: Optional[int] = None,
    logit_cap: Optional[float] = None,
    pool_k: Optional[torch.Tensor] = None,      # (NPOOL, block_p, Dh) pages
    pool_v: Optional[torch.Tensor] = None,
    phys: Optional[torch.Tensor] = None,        # (B, Hkv, NB) page map, -1 free
    need_weights: bool = False,
):
    """One decode token's attention over a slot arena, or over the pages of
    a shared pool -> (B, 1, Hq, Dh); with ``need_weights``, ``(out,
    weights)`` where ``weights`` (B, Hkv, P) fp32 are the post-softmax
    weights summed over each group's G query heads (exactly 0 on every slot
    that is not visible)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, Hq, Dh), got {tuple(q.shape)}")
    b, _, hq, dh = q.shape
    shared = pool_k is not None
    if shared:
        if valid.dim() != 3 or valid.shape[0] != b:
            raise ValueError(f"valid must be (B, Hkv, P), got "
                             f"{tuple(valid.shape)}")
        hkv, p = valid.shape[1], valid.shape[2]
    else:
        if k is None or k.dim() != 4 or k.shape[0] != b or k.shape[3] != dh \
                or v is None or v.shape != k.shape:
            raise ValueError("k/v must be (B, Hkv, P, Dh) matching q; got "
                             f"{None if k is None else tuple(k.shape)}, "
                             f"{None if v is None else tuple(v.shape)}")
        hkv, p = k.shape[1], k.shape[2]
        if valid.shape != k.shape[:3]:
            raise ValueError(f"valid must be {tuple(k.shape[:3])}, got "
                             f"{tuple(valid.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    g = hq // hkv

    if block_tbl is not None:
        if not block_p or p % block_p:
            raise ValueError(
                f"arena extent {p} not a multiple of block_p {block_p}; "
                "caches must allocate pre-padded (KVPolicyConfig.block_p)")
        if block_tbl.shape[:2] != (b, hkv) or block_n.shape != (b, hkv):
            raise ValueError("block_tbl must be (B, Hkv, NB) and block_n (B, Hkv)")
        bp = block_p
        nf = block_n.reshape(b * hkv)
        if shared:
            npool = pool_k.shape[0]
            if pool_k.shape[1:] != (bp, dh) or pool_v.shape != pool_k.shape:
                raise ValueError(f"pool pages must be (NPOOL, {bp}, {dh}), got "
                                 f"{tuple(pool_k.shape)}, {tuple(pool_v.shape)}")
            if phys is None or phys.shape != (b, hkv, p // bp):
                raise ValueError(f"phys must be {(b, hkv, p // bp)}")
            # logical block ids -> page ids (the twin of
            # core.block_pool.translate_table, inlined so kernels import no
            # core); a stale tail entry may map to -1 and is clamped, the
            # kernel never reads past n
            tbl_c = block_tbl.clamp(0, p // bp - 1).long()
            tblf = (phys.gather(2, tbl_c).clamp(0, npool - 1)
                    .to(torch.int32).reshape(b * hkv, -1))
            kf = pool_k.reshape(1, npool * bp, dh)
            vf = pool_v.reshape(1, npool * bp, dh)
            valf = (valid.reshape(b, hkv, p // bp, bp)
                    .gather(2, tbl_c[..., None].expand(-1, -1, -1, bp))
                    .reshape(b * hkv, -1))
        else:
            kf, vf = k.reshape(b * hkv, p, dh), v.reshape(b * hkv, p, dh)
            valf = valid.reshape(b * hkv, p)
            tblf = block_tbl.reshape(b * hkv, -1)
        ltbl = block_tbl.reshape(b * hkv, -1)   # logical ids: weights' rows
        p_arena = p
    elif shared:
        raise ValueError("a shared pool needs block_tbl/block_n/block_p")
    else:
        # legacy dense mode: a written-blocks table derived from `valid`
        bp = min(block_p or DEFAULT_BLOCK_P, _round_up(p, 8))
        pp = _round_up(p, bp)
        pad = (0, 0, 0, pp - p)
        kf = torch.nn.functional.pad(k.reshape(b * hkv, p, dh), pad)
        vf = torch.nn.functional.pad(v.reshape(b * hkv, p, dh), pad)
        valf = torch.nn.functional.pad(valid.reshape(b * hkv, p), (0, pp - p))
        blk_live = (valf.reshape(b * hkv, pp // bp, bp) != 0).any(dim=-1)
        tblf = torch.argsort((~blk_live).to(torch.int8), dim=-1,
                             stable=True).to(torch.int32)
        nf = blk_live.sum(dim=-1).to(torch.int32)
        ltbl, p_arena = tblf, pp

    qf = q[:, 0].reshape(b * hkv, g, dh)
    if not need_weights:
        out = decode_rows(qf, kf, vf, valf, tblf, nf, bp, logit_cap,
                          shared_kv=shared)
        return out.reshape(b, 1, hq, dh)
    out, w_blk, m_blk, m_out, l_out = decode_rows(
        qf, kf, vf, valf, tblf, nf, bp, logit_cap, shared_kv=shared,
        need_weights=True)
    weights = table_weights_to_arena(w_blk, m_blk, m_out, l_out, nf, ltbl,
                                     p_arena // bp)
    return (out.reshape(b, 1, hq, dh),
            weights.reshape(b, hkv, p_arena)[:, :, :p])


def dms_decode_shard(
    q: torch.Tensor,                 # (B, 1, Hq, Dh)
    k: torch.Tensor,                 # (B, Hkv, P_local, Dh): the shard
    v: torch.Tensor,
    valid: torch.Tensor,             # (B, Hkv, P_local) bool
    *,
    block_tbl: torch.Tensor,         # (B, Hkv, NB) int32, global block ids
    block_n: torch.Tensor,           # (B, Hkv) int32
    block_p: int,
    slot_lo: int,
    logit_cap: Optional[float] = None,
    need_weights: bool = False,
):
    """One decode token's attention over one slot shard ``[slot_lo, slot_lo
    + P_local)`` of a fixed arena whose slot axis is split across ranks.
    Returns ``(out, m, l, weights)``: ``out`` (B, 1, Hq, Dh) normalised over
    the shard's listed visible slots, ``m`` and ``l`` (B, Hkv, G) fp32 its
    max and denominator (-1e30 and 0 where the shard holds none), and, with
    ``need_weights``, ``weights(m_all, l_all)``, which gives the shard's
    (B, Hkv, P_local) group-summed weights under the statistics ``m_all``
    and ``l_all`` (B, Hkv, G) combined over every shard (else None)."""
    b, _, hq, dh = q.shape
    hkv, p_loc = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, p_loc, dh) or v.shape != k.shape \
            or valid.shape != k.shape[:3]:
        raise ValueError("k/v must be (B, Hkv, P_local, Dh) matching q and "
                         f"valid (B, Hkv, P_local); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(valid.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if not block_p or block_tbl.shape[:2] != (b, hkv) \
            or block_n.shape != (b, hkv):
        raise ValueError("a slot shard needs block_p and a block table "
                         "(B, Hkv, NB) with block_n (B, Hkv)")
    g = hq // hkv
    qf = q[:, 0].reshape(b * hkv, g, dh)
    kf, vf = k.reshape(b * hkv, p_loc, dh), v.reshape(b * hkv, p_loc, dh)
    valf = valid.reshape(b * hkv, p_loc)
    tblf = block_tbl.reshape(b * hkv, -1)
    nf = block_n.reshape(b * hkv)
    res = decode_rows(qf, kf, vf, valf, tblf, nf, block_p, logit_cap,
                      need_weights=need_weights, slot_lo=slot_lo)
    out, m, l = (res[0], res[3], res[4]) if need_weights else res
    weights = None
    if need_weights:
        w_blk, m_blk = res[1], res[2]

        def weights(m_all, l_all):
            w = table_weights_to_arena(
                w_blk, m_blk, m_all.reshape(b * hkv, g),
                l_all.reshape(b * hkv, g), nf, tblf, 0, slot_lo=slot_lo,
                p_local=p_loc)
            return w.reshape(b, hkv, p_loc)

    return (out.reshape(b, 1, hq, dh), m.reshape(b, hkv, g),
            l.reshape(b, hkv, g), weights)
