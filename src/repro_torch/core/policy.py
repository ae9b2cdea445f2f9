"""Pluggable KV cache policies: the ``KVPolicy`` registry of the port.

The same contract as the reference ``repro.core.policy``: every policy owns
its cache's lifecycle (``init_cache``, ``decode_update``, ``fork_cache``,
``gather_cache``, ``reclaim_cache``, ``export_prefix``, ``import_prefix``,
``import_slab``, ``export_slab``, ``metrics``, ``peak_bytes``) and the
model dispatches only through the registry, keyed by the name a
:class:`PolicyCache` carries.  This port registers the reference's nine:
``vanilla`` (the uncompressed baseline; local layers get a ring buffer),
``window`` (StreamingLLM's sliding window), ``dms``, ``dms_masked`` (DMS on
a full-length arena: the correctness oracle), ``tova``, ``h2o``,
``keyformer``, ``quest`` (page-sparse reads over a full cache) and ``dmc``
(append-or-merge).  ``vanilla`` and ``dms`` also build a cache from a dense
prefill (``prefill_import``); the others raise there, as in the reference.
``tova``, ``h2o`` and ``keyformer`` evict by the step's attention weights:
their :class:`AttendSpec` asks for them (``needs_weights``) and
:meth:`KVPolicy.post_attend` takes them.

Lane lifecycle operations are functional and return new tensors, so lanes
forked or gathered from one source never share storage; ``decode_update``
updates the cache in place (see :meth:`SlotDMSCache.step`).  A paged
cache's :class:`~repro_torch.core.block_pool.BlockPool` is the exception:
it has no lane axis and is shared by every lane, so lifecycle operations
recount its refcounts from the new page map and move no page (a fork is
copy-on-write), and an import writes the pages it allocates in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core import block_pool, kv_cache
from repro_torch.core.baselines import (DMCCache, H2OCache, QuestCache,
                                       TOVACache)
from repro_torch.core.config import ArchConfig, KVPolicyConfig
from repro_torch.core.kv_cache import (MaskedDMSCache, SlotDMSCache,
                                       VanillaCache, _round_up, pack_dense,
                                       prefix_block_spec)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import torch_dtype

# ---------------------------------------------------------------------------
# wire types
# ---------------------------------------------------------------------------


@dataclass
class AttendSpec:
    """What one decode step's attention reads.

    ``k``/``v``: (B, Hkv, P, Dh); ``visible``: (B, Hkv, P) bool;
    ``positions``: per-slot logical positions (for local-window masking) or
    None.  ``needs_weights`` asks attention for the group-summed
    post-softmax weights, which go to :meth:`KVPolicy.post_attend`.
    ``block_tbl`` (B, Hkv, NB) int32 lists each row's live
    ``block_p``-sized blocks in its first ``block_n`` (B, Hkv) entries — the
    block-table contract with the flash-decode kernel; every visible slot
    lies in a listed block.  ``block_p == 0`` means no table.

    A paged cache gives ``pool`` and ``phys`` (B, Hkv, NB) instead of
    ``k``/``v``: the kernel streams the pool's pages (``pool_k``/``pool_v``)
    through the page map, and only the reference path gathers the dense
    view, through :meth:`kv`.  (The reference builds that view always and
    lets XLA delete it under the kernel; eager PyTorch deletes nothing, and
    the gather would read the whole pool in every layer of every step.)"""

    k: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    visible: torch.Tensor
    positions: Optional[torch.Tensor] = None
    needs_weights: bool = False
    block_tbl: Optional[torch.Tensor] = None
    block_n: Optional[torch.Tensor] = None
    block_p: int = 0
    pool: Optional[block_pool.BlockPool] = None
    phys: Optional[torch.Tensor] = None

    @property
    def pool_k(self) -> Optional[torch.Tensor]:
        return None if self.pool is None else self.pool.k

    @property
    def pool_v(self) -> Optional[torch.Tensor]:
        return None if self.pool is None else self.pool.v

    def kv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dense (B, Hkv, P, Dh) K/V, gathered from the pool if paged."""
        if self.pool is None:
            return self.k, self.v
        return block_pool.dense_kv(self.pool, self.phys)


@dataclass
class PolicyCache:
    """A cache state bound to its policy by name (a static field)."""

    cache: Any
    policy: str = field(default="vanilla", metadata={"static": True})

    @property
    def length(self) -> torch.Tensor:
        return self.cache.length


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, "KVPolicy"] = {}


def register_policy(name: str) -> Callable[[type], type]:
    """Class decorator: instantiate and register a :class:`KVPolicy`."""

    def deco(cls: type) -> type:
        if name in _REGISTRY:
            raise ValueError(f"KV policy {name!r} already registered "
                             f"(by {type(_REGISTRY[name]).__name__})")
        pol = cls()
        pol.name = name
        _REGISTRY[name] = pol
        return cls

    return deco


def get_policy(name: str) -> "KVPolicy":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown KV policy {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def init_policy_cache(arch: ArchConfig, batch: int, max_len: int,
                      cfg: KVPolicyConfig, *, layer_kind: str = "attn",
                      layer_window: Optional[int] = None, dtype=None,
                      device=None) -> PolicyCache:
    """Provision one attention layer's cache through the registry."""
    name = cfg.kind_for_layer(layer_kind)
    pol = get_policy(name)
    dtype = dtype or torch_dtype(arch.dtype)
    inner = pol.init_cache(arch, batch, max_len, cfg,
                           layer_window=layer_window, dtype=dtype,
                           device=device)
    return PolicyCache(cache=inner, policy=name)


def iter_policy_caches(tree: Any) -> Iterator[PolicyCache]:
    """Every :class:`PolicyCache` node of a decode state."""
    if isinstance(tree, PolicyCache):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from iter_policy_caches(v)


def map_pooled_caches(state: Any, fn: Callable[[int, Any], Any]) -> Any:
    """A decode state with ``fn(pooled_idx, cache)`` applied to every pooled
    cache (others pass through).  ``pooled_idx`` counts pooled caches in
    :func:`iter_policy_caches` order, the order of the scheduler's pool
    descriptors and the fault injector's ghost ledgers."""
    counter = [0]

    def visit(node):
        if isinstance(node, PolicyCache):
            if getattr(node.cache, "pool", None) is None:
                return node
            idx = counter[0]
            counter[0] += 1
            return PolicyCache(fn(idx, node.cache), node.policy)
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        return node

    return visit(state)


def state_peak_bytes(state: Any) -> int:
    """Physical KV arena bytes of a decode state (shape-derived)."""
    return sum(get_policy(pc.policy).peak_bytes(pc.cache)
               for pc in iter_policy_caches(state))


def state_pool_stats(state: Any) -> Optional[Dict[str, Any]]:
    """Paged-pool counters summed over every pooled cache of a decode state
    (reads the device), or None when nothing is paged.  ``live_tokens``
    comes from each cache's block table counts (a vanilla cache keeps no
    table: its retained tokens), so ``fragmentation`` is the share of
    mapped page capacity that holds no live token."""
    out: Optional[Dict[str, Any]] = None
    mapped_cap = 0
    for pc in iter_policy_caches(state):
        pool = getattr(pc.cache, "pool", None)
        if pool is None:
            continue
        blocks = getattr(pc.cache, "blocks", None)
        live = (pc.cache.retained_tokens() if blocks is None
                else blocks.count)
        s = block_pool.stats(pool, pc.cache.phys, live_tokens=live)
        mapped_cap += s["mapped_entries"] * pool.block_p
        if out is None:
            out = dict(s)
            out["pools"] = 1
        else:
            for key in ("pool_blocks", "allocated_blocks", "free_blocks",
                        "shared_blocks", "cow_copies", "alloc_events",
                        "high_water_blocks", "superblocks", "mapped_entries",
                        "live_tokens"):
                out[key] += s[key]
            out["exhausted"] = out["exhausted"] or s["exhausted"]
            out["pools"] += 1
    if out is not None:
        out["fragmentation"] = (1.0 - out["live_tokens"] / mapped_cap
                                if mapped_cap else 0.0)
    return out


def _nbytes(a: torch.Tensor) -> int:
    return a.numel() * a.element_size()


def _budget_tokens(cfg: KVPolicyConfig, max_len: int) -> int:
    return cfg.budget or max(int(max_len / cfg.cr), 1)


def step_meters(live: torch.Tensor,
                reads: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """A step's budget meters, (B,) fp32 each: ``live_tokens`` and
    ``reads_tokens`` (``live`` where the policy reads every live token)."""
    return {"live_tokens": live,
            "reads_tokens": live if reads is None else reads}


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------


class KVPolicy:
    """Base contract.  Subclass, implement the lifecycle, decorate with
    ``@register_policy("name")``."""

    name: str = ""
    #: "none" — never sees eviction decisions; "dms" — binarised DMS α
    #: when ``arch.dms.enabled``; "always" — the binarised α of the borrowed
    #: neuron whether or not DMS is enabled (DMC's merge decision)
    alpha_mode: str = "none"

    def init_cache(self, arch: ArchConfig, batch: int, max_len: int,
                   cfg: KVPolicyConfig, *, layer_window: Optional[int],
                   dtype, device) -> Any:
        raise NotImplementedError

    def decode_update(self, cache: Any, q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, aux: Dict[str, Any]
                      ) -> Tuple[Any, AttendSpec,
                                 Optional[Dict[str, torch.Tensor]]]:
        """Absorb one token (in place) and describe what attention reads.

        q: (B, 1, Hq, Dh) post-RoPE; k_new/v_new: (B, Hkv, 1, Dh) post-RoPE;
        aux carries ``alpha_bin`` ((B, Hkv) bool or None), ``pos_t``,
        ``attn_cfg``, ``arch``, ``dtype`` and ``active``.  Returns (cache,
        spec, meters): ``meters`` is :func:`step_meters` of the step, the
        ``live_tokens`` and ``reads_tokens`` the reference's metrics
        report — counted for every lane, inactive ones included, before
        they are frozen.  A policy whose spec ``needs_weights`` returns
        None there: its counts exist only after :meth:`post_attend`."""
        raise NotImplementedError

    def post_attend(self, cache: Any, weights: torch.Tensor,
                    active: Optional[torch.Tensor] = None,
                    aux: Optional[Dict[str, Any]] = None
                    ) -> Tuple[Any, Dict[str, torch.Tensor]]:
        """Second phase when ``AttendSpec.needs_weights``: ``weights`` (B,
        Hkv, P) fp32 is the post-softmax distribution summed over each
        group's query heads.  Updates the cache in place for the lanes of
        ``active`` (None = all) and returns (cache, meters) with ``meters``
        as :meth:`decode_update` describes them.  ``aux`` is the step's
        aux, as :meth:`decode_update` got it."""
        m = self.metrics(cache)
        return cache, step_meters(m["live_tokens"], m["reads_tokens"])

    def prepare_step(self, stacked: Any, aux: Dict[str, Any]
                     ) -> Optional[List[Dict[str, Any]]]:
        """Once per decode step, before the layer loop: per-layer entries
        for the aux of :meth:`decode_update` and :meth:`post_attend`,
        computed for every layer at once from the stacked cache (leaves
        (L, B, ...)); ``aux`` carries ``layer_salt`` (L,) and the step's
        ``active`` lane mask (B,) or None.  One batched
        computation in place of one per layer: the step is host-bound, so
        what counts is the number of ops dispatched.  None (the default):
        nothing to prepare."""
        return None

    # -- lane lifecycle (continuous batching / hyperscale fork) --------------

    def fork_cache(self, cache: Any, width: int, *, axis: int = 0) -> Any:
        """Clone every lane into ``width`` adjacent lanes (new storage).  A
        paged cache forks copy-on-write: its page map tiles, refcounts are
        recounted, and no page moves."""
        return _per_lane(lambda a: a.repeat_interleave(width, dim=axis), cache)

    def gather_cache(self, cache: Any, src: torch.Tensor, *,
                     axis: int = 0) -> Any:
        """Lane shuffle: new lane ``l`` is a copy of old lane ``src[l]``.
        Paged: duplicated lanes become CoW sharers of their pages, dropped
        lanes' pages return to the free list."""
        idx = src.to(device=_device_of(cache), dtype=torch.long)
        return _per_lane(lambda a: a.index_select(axis, idx), cache)

    def reclaim_cache(self, cache: Any, reset_mask: torch.Tensor, fresh: Any,
                      *, axis: int = 0) -> Any:
        """Lanes where ``reset_mask`` (B,) is True return to ``fresh``.
        Paged: the lanes' page maps reset to -1 and their pages return to
        the free list once no CoW sharer maps them; the pool's counters are
        kept."""

        def sel(cur, init):
            m = reset_mask.reshape((1,) * axis + (-1,)
                                   + (1,) * (cur.dim() - axis - 1))
            return torch.where(m.to(cur.device), init, cur)

        return _per_lane(sel, cache, fresh)

    # -- prefix lifecycle (preemption snapshots) ------------------------------

    def export_prefix(self, cache: Any, lane: int, *, axis: int = 0) -> Any:
        """One lane's complete state, as a width-1-lane cache of the same
        structure (new tensors): everything needed to continue decoding.
        A paged cache densifies: the lane's pages are gathered into
        fixed-arena-shaped ``k``/``v`` and ``pool``/``phys`` are None, so a
        snapshot has one format whatever the layout."""

        def take(a):
            return a.narrow(axis, lane, 1).clone()

        pool = getattr(cache, "pool", None)
        if pool is None:
            return tree_map(take, cache)
        k, v = block_pool.dense_kv(pool, cache.phys.narrow(axis, lane, 1))
        snap = tree_map(take, dataclasses.replace(cache, pool=None, phys=None))
        return dataclasses.replace(snap, k=k, v=v)

    def import_prefix(self, cache: Any, snap: Any, lane: int, *,
                      axis: int = 0) -> Any:
        """Restore an :meth:`export_prefix` snapshot into lane ``lane``,
        which must be pristine; every per-lane leaf comes back new.  Paged:
        a page is allocated for every block with a live slot and filled
        from the snapshot, and the lane's page map and the refcounts are
        rebuilt.  Exhaustion drops the affected blocks (they read as
        zeros, masked) and latches ``pool.exhausted``."""
        pool = getattr(cache, "pool", None)
        if pool is None:
            return _put_lane(cache, snap, lane, axis)
        body = _put_lane(
            dataclasses.replace(cache, pool=None, phys=None),
            dataclasses.replace(snap, k=snap.k[..., :0], v=snap.v[..., :0]),
            lane, axis)
        phys = cache.phys.clone()
        valid = snap.valid_mask()
        for ix in ([()] if axis == 0 else [(i,) for i in range(phys.shape[0])]):
            _import_pages(tree_map(lambda a: a[ix], pool), phys[ix],
                          snap.k[ix], snap.v[ix], valid[ix], lane)
        return dataclasses.replace(body, pool=block_pool.set_refcounts(pool, phys),
                                   phys=phys)

    def import_slab(self, slab: Any, snap: Any, slot: int, *,
                    axis: int = 0) -> Any:
        """Write a width-1 :meth:`export_prefix` snapshot into storage slot
        ``slot`` of a snapshot slab (``slots`` stacked snapshots, see
        :func:`repro_torch.models.transformer.init_snapshot_slab`), in
        place; a snapshot on another device is copied over.  A policy whose
        snapshot is not a width-1-lane tree overrides this pair with the
        prefix pair."""
        for d, s in zip(tree_leaves(slab), tree_leaves(snap)):
            d.narrow(axis, slot, 1).copy_(s)
        return slab

    def export_slab(self, slab: Any, slot: int, *, axis: int = 0) -> Any:
        """The snapshot in slab slot ``slot``, as new tensors on the slab's
        device (a hot hit's import reads it device to device)."""
        return tree_map(lambda d: d.narrow(axis, slot, 1).clone(), slab)

    def prefill_import(self, arch: ArchConfig, cfg: KVPolicyConfig,
                       k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor,
                       retained: Optional[torch.Tensor],
                       alpha_bin: Optional[torch.Tensor], *, max_len: int,
                       layer_window: Optional[int] = None, dtype=None) -> Any:
        """A cache built from a dense prefill's outputs: ``k``/``v`` (B,
        Hkv, T, Dh) post-RoPE, as ``make_prefill_step``'s ``layer_kv`` gives
        them.  The engine prefills through the decode step; this is for a
        caller that runs the full forward and imports the result.  Policies
        without an import path raise."""
        raise NotImplementedError(f"{self.name}: no prefill import path")

    # -- accounting ----------------------------------------------------------

    def metrics(self, cache: Any) -> Dict[str, Any]:
        """``live_tokens``/``reads_tokens`` (B,) fp32 (mean over kv heads)
        and ``peak_bytes`` (physical arena bytes)."""
        live = cache.retained_tokens().float().mean(dim=-1)
        return {"live_tokens": live, "reads_tokens": live,
                "peak_bytes": self.peak_bytes(cache)}

    def peak_bytes(self, cache: Any) -> int:
        pool = getattr(cache, "pool", None)
        if pool is not None:       # the footprint is the pool's pages
            return _nbytes(pool.k) + _nbytes(pool.v)
        return _nbytes(cache.k) + _nbytes(cache.v)


def _device_of(cache: Any) -> torch.device:
    return cache.length.device


def _per_lane(fn, cache, *rest):
    """``fn`` over every per-lane leaf (and the matching leaves of ``rest``);
    a paged cache keeps its pool and gets refcounts recounted from the new
    page map."""
    pool = getattr(cache, "pool", None)
    if pool is None:
        return tree_map(fn, cache, *rest)
    body = tree_map(fn, *(dataclasses.replace(c, pool=None)
                          for c in (cache,) + rest))
    return dataclasses.replace(body,
                               pool=block_pool.set_refcounts(pool, body.phys))


def _put_lane(cache, snap, lane: int, axis: int):
    """``cache`` with lane ``lane`` of every leaf replaced by ``snap``'s.
    The index is filled on the device: a host-built one would be a
    host-to-device copy, which syncs the stream."""
    idx = torch.full((1,), lane, dtype=torch.long, device=_device_of(cache))
    return tree_map(lambda a, s: a.index_copy(axis, idx, s.to(a.dtype)),
                    cache, snap)


def _import_pages(pool, phys, k, v, valid, lane: int) -> None:
    """One layer's import into a pristine lane: allocate a page for each of
    the snapshot's blocks that holds a live slot and fill it (in place)."""
    _, h, nb = phys.shape
    bp = pool.block_p
    p, dh = k.shape[2], k.shape[3]
    need = valid.expand(1, h, p).reshape(h, nb, bp).any(dim=-1).reshape(-1)
    pool, page, ok = block_pool.alloc(pool, need)
    got = need & ok
    dst = torch.where(got, page, pool.num_blocks).long()
    pool.k_buf[dst] = k.reshape(h * nb, bp, dh).to(pool.k_buf.dtype)
    pool.v_buf[dst] = v.reshape(h * nb, bp, dh).to(pool.v_buf.dtype)
    phys[lane] = torch.where(got, page, -1).reshape(h, nb)


def _attend_spec(cache, **kw) -> AttendSpec:
    """The AttendSpec of a cache, with its live-block table when it keeps
    one; a paged cache hands over its pool and page map instead of K/V."""
    tbl, n, bp = cache.block_spec()
    pool = getattr(cache, "pool", None)
    if pool is not None:
        return AttendSpec(None, None, cache.valid_mask(), cache.positions(),
                          block_tbl=tbl, block_n=n, block_p=bp, pool=pool,
                          phys=cache.phys, **kw)
    return AttendSpec(cache.k, cache.v, cache.valid_mask(), cache.positions(),
                      block_tbl=tbl, block_n=n, block_p=bp, **kw)


class _SlotRingMixin:
    """Shared decode path for caches that step one token with an α
    (``dms``, ``dms_masked``, ``window``, vanilla's local layers)."""

    @staticmethod
    def _slot_update(cache, k_new, v_new, aux):
        cfg = aux["attn_cfg"]
        alpha = aux.get("alpha_bin")
        if alpha is None:
            alpha = torch.zeros((k_new.shape[0], cfg.num_kv_heads),
                                dtype=torch.bool, device=k_new.device)
        retained = cache.step(k_new, v_new, alpha, active=aux.get("active"))
        return cache, _attend_spec(cache), step_meters(
            retained.float().mean(dim=-1))


@register_policy("vanilla")
class VanillaPolicy(_SlotRingMixin, KVPolicy):
    """Dense append-only cache; a local-attention layer gets a ring buffer
    (overflow recycling is its sliding window), so its memory stays
    O(window)."""

    def init_cache(self, arch, batch, max_len, cfg, *, layer_window, dtype,
                   device):
        a = arch.attn
        if layer_window is not None:
            eff_len = min(max_len, layer_window + 1)
            return SlotDMSCache.init(batch, a.num_kv_heads, eff_len,
                                     a.head_dim, max(arch.dms.window, 1),
                                     dtype, dms_active=False,
                                     block_p=cfg.block_p, paged=cfg.paged,
                                     pool_blocks=cfg.pool_blocks,
                                     device=device)
        return VanillaCache.init(batch, a.num_kv_heads, max_len, a.head_dim,
                                 dtype, block_p=cfg.block_p, paged=cfg.paged,
                                 pool_blocks=cfg.pool_blocks, device=device)

    def prepare_step(self, stacked, aux):
        """The attention operands of the step, built once and given to
        every layer: the prefix table (B, H, NB) int32, its ``n`` (B, H) and
        its (B, H, S) mask, all contiguous, for the lengths the step leaves
        (``length + 1`` on active lanes).  Every layer advances with the
        same ``active``, so layer 0's length is every layer's.  The
        reference's mask is a lazy (B, 1, S) broadcast and its table a
        stride-0 one; the kernel takes neither."""
        if not isinstance(stacked, VanillaCache):
            return None
        length = stacked.length[0]                            # (B,)
        act = aux.get("active")
        new_len = length + (1 if act is None else act.to(length.dtype))
        h, s = stacked.k.shape[-3], kv_cache.arena_slots(stacked.k)
        vis = (torch.arange(s, device=length.device)
               < new_len[:, None, None]).expand(length.shape[0], h, s)
        tbl, n = prefix_block_spec(new_len, s, stacked.block_p, h)
        return [{"prefix": (vis.contiguous(), tbl, n)}] * stacked.length.shape[0]

    def decode_update(self, cache, q, k_new, v_new, aux):
        """``aux["prefix"]``: this layer's entry of :meth:`prepare_step`."""
        if not isinstance(cache, VanillaCache):
            return self._slot_update(cache, k_new, v_new, aux)
        retained = cache.append(k_new, v_new, active=aux.get("active"))
        vis, tbl, n = aux["prefix"]
        kw = dict(block_tbl=tbl, block_n=n, block_p=cache.block_p)
        if cache.pool is None:
            spec = AttendSpec(cache.k, cache.v, vis, cache.positions(), **kw)
        else:
            spec = AttendSpec(None, None, vis, cache.positions(),
                              pool=cache.pool, phys=cache.phys, **kw)
        return cache, spec, step_meters(retained.float().mean(dim=-1))

    def prefill_import(self, arch, cfg, k, v, positions, retained, alpha_bin,
                       *, max_len, layer_window=None, dtype=None):
        if layer_window is not None:
            raise NotImplementedError("vanilla: no local-window import path")
        a = arch.attn
        cache = VanillaCache.init(k.shape[0], a.num_kv_heads, max_len,
                                  a.head_dim, dtype or torch_dtype(arch.dtype),
                                  block_p=cfg.block_p, paged=cfg.paged,
                                  pool_blocks=cfg.pool_blocks, device=k.device)
        cache.append(k, v)
        return cache


@register_policy("window")
class WindowPolicy(_SlotRingMixin, KVPolicy):
    """StreamingLLM-style sliding window: a ring of ``budget + 1`` slots
    whose overflow recycling drops the oldest token."""

    def init_cache(self, arch, batch, max_len, cfg, *, layer_window, dtype,
                   device):
        a = arch.attn
        budget = _budget_tokens(cfg, max_len)
        return SlotDMSCache.init(batch, a.num_kv_heads, budget + 1,
                                 a.head_dim, max(arch.dms.window, 1), dtype,
                                 dms_active=False, block_p=cfg.block_p,
                                 paged=cfg.paged, pool_blocks=cfg.pool_blocks,
                                 device=device)

    def decode_update(self, cache, q, k_new, v_new, aux):
        return self._slot_update(cache, k_new, v_new, aux)


@register_policy("dms")
class DMSPolicy(_SlotRingMixin, KVPolicy):
    """The paper's policy: slot-compacted arena, delayed eviction (§3.3)."""

    alpha_mode = "dms"

    def init_cache(self, arch, batch, max_len, cfg, *, layer_window, dtype,
                   device):
        a = arch.attn
        eff_len = (min(max_len, layer_window + 1) if layer_window is not None
                   else max_len)
        slots = SlotDMSCache.provision_slots(eff_len, cfg.cr, arch.dms.window)
        return SlotDMSCache.init(batch, a.num_kv_heads, min(slots, eff_len + 1),
                                 a.head_dim, arch.dms.window, dtype,
                                 block_p=cfg.block_p, paged=cfg.paged,
                                 pool_blocks=cfg.pool_blocks, device=device)

    def decode_update(self, cache, q, k_new, v_new, aux):
        return self._slot_update(cache, k_new, v_new, aux)

    def prefill_import(self, arch, cfg, k, v, positions, retained, alpha_bin,
                       *, max_len, layer_window=None, dtype=None):
        """The compacted arena :meth:`init_cache` provisions, filled by
        :meth:`SlotDMSCache.from_prefill`; paged, its pooled twin."""
        eff_len = (min(max_len, layer_window + 1) if layer_window is not None
                   else max_len)
        slots = SlotDMSCache.provision_slots(eff_len, cfg.cr, arch.dms.window)
        cache = SlotDMSCache.from_prefill(
            k, v, positions, retained, arch.dms.window,
            min(slots, eff_len + 1), alpha_bin=alpha_bin, block_p=cfg.block_p)
        if cfg.paged:
            cache = pack_dense(cache, cfg.pool_blocks)
        return cache


@register_policy("dms_masked")
class MaskedDMSPolicy(_SlotRingMixin, KVPolicy):
    """DMS on a full-length arena with a retained bitmap: the correctness
    oracle of the slot-compacted ``dms``."""

    alpha_mode = "dms"

    def init_cache(self, arch, batch, max_len, cfg, *, layer_window, dtype,
                   device):
        a = arch.attn
        return MaskedDMSCache.init(batch, a.num_kv_heads, max_len, a.head_dim,
                                   arch.dms.window, dtype,
                                   block_p=cfg.block_p, paged=cfg.paged,
                                   pool_blocks=cfg.pool_blocks, device=device)

    def decode_update(self, cache, q, k_new, v_new, aux):
        return self._slot_update(cache, k_new, v_new, aux)


class _WeightEvictPolicy(KVPolicy):
    """Insert, attend, evict: the shape of the weight-driven policies."""

    def decode_update(self, cache, q, k_new, v_new, aux):
        self._insert(cache, k_new, v_new, aux)
        return cache, _attend_spec(cache, needs_weights=True), None

    def _insert(self, cache, k_new, v_new, aux):
        cache.insert(k_new, v_new, active=aux.get("active"))

    def post_attend(self, cache, weights, active=None, aux=None):
        return cache, step_meters(cache.evict(weights, active=active))


@register_policy("tova")
class TOVAPolicy(_WeightEvictPolicy):
    def init_cache(self, arch, batch, max_len, cfg, *, layer_window, dtype,
                   device):
        a = arch.attn
        budget = _budget_tokens(cfg, max_len)
        return TOVACache.init(batch, a.num_kv_heads, budget + 1, a.head_dim,
                              dtype, block_p=cfg.block_p, paged=cfg.paged,
                              pool_blocks=cfg.pool_blocks, device=device)


@register_policy("h2o")
class H2OPolicy(_WeightEvictPolicy):
    def init_cache(self, arch, batch, max_len, cfg, *, layer_window, dtype,
                   device):
        a = arch.attn
        budget = _budget_tokens(cfg, max_len)
        return H2OCache.init(batch, a.num_kv_heads, budget + 1, a.head_dim,
                             max(budget // 2, 1), dtype, block_p=cfg.block_p,
                             paged=cfg.paged, pool_blocks=cfg.pool_blocks,
                             device=device)


@register_policy("quest")
class QuestPolicy(KVPolicy):
    """Page-sparse reads over a full cache: the policy whose two budget axes
    diverge — ``reads_tokens`` shrinks, ``live_tokens`` does not.  The
    top-k page selection is the decode kernel's block table, so the kernel
    reads only the selected pages (paged: straight from the pool, whose
    page is Quest's page)."""

    def init_cache(self, arch, batch, max_len, cfg, *, layer_window, dtype,
                   device):
        a = arch.attn
        ps = cfg.quest_page_size
        ml = _round_up(max_len, ps)
        top = cfg.quest_top_pages or max(int(ml / cfg.cr) // ps, 1)
        return QuestCache.init(batch, a.num_kv_heads, ml, a.head_dim, ps, top,
                               dtype, paged=cfg.paged,
                               pool_blocks=cfg.pool_blocks, device=device)

    def decode_update(self, cache, q, k_new, v_new, aux):
        new_len = cache.append(k_new, v_new, active=aux.get("active"))
        return (cache, self.attend_spec(cache, q, aux["attn_cfg"]),
                self._meters(cache, new_len))

    @staticmethod
    def attend_spec(cache, q, cfg) -> AttendSpec:
        """The step's operands: the pages selected for the group-pooled
        query ``q`` (B, 1, Hq, Dh) as the token mask and the block table
        (``block_p`` = the page size); paged, the pool's pages."""
        b = q.shape[0]
        q_pool = q[:, 0].reshape(b, cfg.num_kv_heads, cfg.q_per_kv,
                                 cfg.head_dim).mean(dim=2)
        pages = cache.select_pages(q_pool)
        tbl, n = cache.block_table_from_pages(pages)
        kw = dict(block_tbl=tbl, block_n=n, block_p=cache.page_size)
        vis = cache.token_mask_from_pages(pages)
        if cache.pool is None:
            return AttendSpec(cache.k, cache.v, vis, cache.positions(), **kw)
        return AttendSpec(None, None, vis, cache.positions(), pool=cache.pool,
                          phys=cache.phys, **kw)

    @staticmethod
    def _meters(cache, length=None):
        live = cache.retained_tokens(length).float().mean(dim=-1)
        return step_meters(live, cache.reads_per_step(length).float())

    def metrics(self, cache):
        return dict(self._meters(cache), peak_bytes=self.peak_bytes(cache))

    def peak_bytes(self, cache):
        return super().peak_bytes(cache) + _nbytes(cache.kmin) + _nbytes(
            cache.kmax)


@register_policy("dmc")
class DMCPolicy(KVPolicy):
    """Dynamic Memory Compression: α = 1 merges into the newest entry.  The
    kernel reads the fp32 accumulators cast to the model dtype, a dense cast
    of the whole arena a layer a step, as in the reference; paged, the
    whole pool (every page and the dump page) is cast a layer a step, and
    the kernel streams the listed pages through the page map in shared-pool
    mode, as for every other paged policy."""

    alpha_mode = "always"

    def init_cache(self, arch, batch, max_len, cfg, *, layer_window, dtype,
                   device):
        a = arch.attn
        return DMCCache.init(batch, a.num_kv_heads, int(max_len / cfg.cr) + 16,
                             a.head_dim, block_p=cfg.block_p, paged=cfg.paged,
                             pool_blocks=cfg.pool_blocks, device=device)

    def decode_update(self, cache, q, k_new, v_new, aux):
        alpha = aux.get("alpha_bin")
        if alpha is None:
            alpha = torch.zeros(cache.count.shape, dtype=torch.bool,
                                device=cache.count.device)
        count = cache.step(k_new, v_new, alpha, active=aux.get("active"))
        return (cache, self.attend_spec(cache, aux["dtype"]),
                step_meters(count.float().mean(dim=-1)))

    @staticmethod
    def attend_spec(cache, dtype) -> AttendSpec:
        """The step's operands: the prefix table over ``count`` and the
        accumulators cast to ``dtype`` (paged: the whole pool cast, read
        through the page map, for the same values as a dense view: the
        table lists written blocks only, which are mapped, and a write an
        exhausted pool dropped fails its request).  The pool-sized cast
        still reads every page and writes a copy, a layer a step."""
        tbl, n, bp = cache.block_spec()
        if cache.pool is None:
            return AttendSpec(cache.k.to(dtype), cache.v.to(dtype),
                              cache.valid_mask(), cache.positions(),
                              block_tbl=tbl, block_n=n, block_p=bp)
        pool = dataclasses.replace(cache.pool,
                                   k_buf=cache.pool.k_buf.to(dtype),
                                   v_buf=cache.pool.v_buf.to(dtype))
        return AttendSpec(None, None, cache.valid_mask(), cache.positions(),
                          block_tbl=tbl, block_n=n, block_p=bp, pool=pool,
                          phys=cache.phys)


# policies that live in their own modules register themselves on import
from repro_torch.core import keyformer as _keyformer  # noqa: E402,F401
