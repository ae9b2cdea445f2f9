"""Pluggable KV cache policies: the ``KVPolicy`` registry of the port.

The same contract as the reference ``repro.core.policy``: every policy owns
its cache's lifecycle (``init_cache``, ``decode_update``, ``fork_cache``,
``gather_cache``, ``reclaim_cache``, ``metrics``, ``peak_bytes``) and the
model dispatches only through the registry, keyed by the name a
:class:`PolicyCache` carries.  This slice registers ``dms``; the other
reference policies are queued in ROADMAP.md.

Lane lifecycle operations are functional and return new tensors, so lanes
forked or gathered from one source never share storage; ``decode_update``
updates the cache in place (see :meth:`SlotDMSCache.step`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.core.config import ArchConfig, KVPolicyConfig
from repro_torch.core.kv_cache import SlotDMSCache
from repro_torch.core.tree import tree_map
from repro_torch.device import torch_dtype

# ---------------------------------------------------------------------------
# wire types
# ---------------------------------------------------------------------------


@dataclass
class AttendSpec:
    """What one decode step's attention reads.

    ``k``/``v``: (B, Hkv, P, Dh); ``visible``: (B, Hkv, P) bool;
    ``positions``: per-slot logical positions (for local-window masking) or
    None.  ``block_tbl`` (B, Hkv, NB) int32 lists each row's live
    ``block_p``-sized blocks in its first ``block_n`` (B, Hkv) entries — the
    block-table contract with the flash-decode kernel; every visible slot
    lies in a listed block.  ``block_p == 0`` means no table."""

    k: torch.Tensor
    v: torch.Tensor
    visible: torch.Tensor
    positions: Optional[torch.Tensor] = None
    block_tbl: Optional[torch.Tensor] = None
    block_n: Optional[torch.Tensor] = None
    block_p: int = 0


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


def init_policy_cache(arch: ArchConfig, batch: int, max_len: int,
                      cfg: KVPolicyConfig, *, layer_kind: str = "attn",
                      layer_window: Optional[int] = None, dtype=None,
                      device=None) -> PolicyCache:
    """Provision one attention layer's cache through the registry."""
    if cfg.paged:
        raise NotImplementedError("the paged KV pool is not ported yet")
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


def state_peak_bytes(state: Any) -> int:
    """Physical KV arena bytes of a decode state (shape-derived)."""
    return sum(get_policy(pc.policy).peak_bytes(pc.cache)
               for pc in iter_policy_caches(state))


def _nbytes(a: torch.Tensor) -> int:
    return a.numel() * a.element_size()


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------


class KVPolicy:
    """Base contract.  Subclass, implement the lifecycle, decorate with
    ``@register_policy("name")``."""

    name: str = ""
    #: "none" — never sees eviction decisions; "dms" — binarised DMS α
    #: when ``arch.dms.enabled``
    alpha_mode: str = "none"

    def init_cache(self, arch: ArchConfig, batch: int, max_len: int,
                   cfg: KVPolicyConfig, *, layer_window: Optional[int],
                   dtype, device) -> Any:
        raise NotImplementedError

    def decode_update(self, cache: Any, q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, aux: Dict[str, Any]
                      ) -> Tuple[Any, AttendSpec, torch.Tensor]:
        """Absorb one token (in place) and describe what attention reads.

        q: (B, 1, Hq, Dh) post-RoPE; k_new/v_new: (B, Hkv, 1, Dh) post-RoPE;
        aux carries ``alpha_bin`` ((B, Hkv) bool or None), ``pos_t``,
        ``attn_cfg``, ``arch``, ``dtype`` and ``active``.  Returns (cache,
        spec, live): ``live`` (B,) is the step's ``live_tokens`` metric as
        the reference reports it — counted for every lane, inactive ones
        included, before they are frozen."""
        raise NotImplementedError

    # -- lane lifecycle (continuous batching / hyperscale fork) --------------

    def fork_cache(self, cache: Any, width: int, *, axis: int = 0) -> Any:
        """Clone every lane into ``width`` adjacent lanes (new storage)."""
        return tree_map(lambda a: a.repeat_interleave(width, dim=axis), cache)

    def gather_cache(self, cache: Any, src: torch.Tensor, *,
                     axis: int = 0) -> Any:
        """Lane shuffle: new lane ``l`` is a copy of old lane ``src[l]``."""
        idx = src.to(device=_device_of(cache), dtype=torch.long)
        return tree_map(lambda a: a.index_select(axis, idx), cache)

    def reclaim_cache(self, cache: Any, reset_mask: torch.Tensor, fresh: Any,
                      *, axis: int = 0) -> Any:
        """Lanes where ``reset_mask`` (B,) is True return to ``fresh``."""

        def sel(cur, init):
            m = reset_mask.reshape((1,) * axis + (-1,)
                                   + (1,) * (cur.dim() - axis - 1))
            return torch.where(m.to(cur.device), init, cur)

        return tree_map(sel, cache, fresh)

    # -- accounting ----------------------------------------------------------

    def metrics(self, cache: Any) -> Dict[str, Any]:
        """``live_tokens``/``reads_tokens`` (B,) fp32 (mean over kv heads)
        and ``peak_bytes`` (physical arena bytes)."""
        live = cache.retained_tokens().float().mean(dim=-1)
        return {"live_tokens": live, "reads_tokens": live,
                "peak_bytes": self.peak_bytes(cache)}

    def peak_bytes(self, cache: Any) -> int:
        return _nbytes(cache.k) + _nbytes(cache.v)


def _device_of(cache: Any) -> torch.device:
    return cache.length.device


def _attend_spec(cache) -> AttendSpec:
    """The AttendSpec of a cache, with its live-block table when it keeps one."""
    tbl, n, bp = cache.block_spec()
    return AttendSpec(cache.k, cache.v, cache.valid_mask(), cache.positions(),
                      block_tbl=tbl, block_n=n, block_p=bp)


class _SlotRingMixin:
    """Shared decode path for slot-arena caches."""

    @staticmethod
    def _slot_update(cache, k_new, v_new, aux):
        cfg = aux["attn_cfg"]
        alpha = aux.get("alpha_bin")
        if alpha is None:
            alpha = torch.zeros((k_new.shape[0], cfg.num_kv_heads),
                                dtype=torch.bool, device=k_new.device)
        retained = cache.step(k_new, v_new, alpha, active=aux.get("active"))
        return cache, _attend_spec(cache), retained.float().mean(dim=-1)


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
                                 block_p=cfg.block_p, device=device)

    def decode_update(self, cache, q, k_new, v_new, aux):
        return self._slot_update(cache, k_new, v_new, aux)
