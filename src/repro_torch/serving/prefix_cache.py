"""Cross-request radix prefix cache of the port: reuse compressed KV across
the request stream (the reference ``repro.serving.prefix_cache``).

A host-side **radix tree over prompt token ids** maps prefixes to lane
snapshots taken at token boundaries
(:func:`repro_torch.models.transformer.export_lane_state`, through
:meth:`KVPolicy.export_prefix`).  A snapshot is the policy's *complete*
lane state — compacted arenas, free lists, pending eviction rings, score
accumulators — because for an evicting policy the state after L tokens is
not a truncation of the state after T > L tokens.  Importing a cached
L-token snapshot and prefilling only the suffix therefore gives the tokens
and the state of a cold full prefill.

Storage has two tiers:

* **Hot** — one pre-allocated **device slab** per signature holding the K
  most recently used snapshots (K = device budget / entry bytes, at most
  ``max_hot_slots``).  An insert copies the lane's freshly exported device
  snapshot into a slot device to device (the export is *deferred*: nothing
  reaches the host), and a hot hit hands the slot's contents back as device
  tensors for the lane import: zero host↔device snapshot bytes.
* **Cold** — the host LRU of CPU tensors.  A hot entry pushed out of the
  slab is *demoted*: only then is it copied to the host (its one
  device-to-host copy).  A cold hit *promotes* it back into a slot (one
  host-to-device copy).

Every tier transition is counted (``h2d_bytes``, ``d2h_bytes``,
``d2d_bytes``; boundary-logits rows read on the host on ``aux_sync_bytes``),
so a claim of zero copies on the hot path is read from counters.  An
inserted snapshot comes from the engine's device (the CPU, when the
engine runs there), so a tier transition is counted by where it moves an
entry, whatever the device.

``export_policy="second-miss"`` exports a boundary only once two lookups
asked for it, so a prompt nobody shares exports nothing; ``export_stride``
offers only every Nth prefill-chunk boundary (the full prompt's always).
An LRU byte budget bounds the cold tier (a snapshot too large for every
tier is refused and the stream falls back to cold prefill); one tree and
one slab per shape signature
(:func:`~repro_torch.models.transformer.lane_state_signature`) keeps
snapshots of different arenas apart.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import transformer as tfm

EXPORT_POLICIES = ("always", "second-miss")

#: miss records are token runs hanging off the tree; past this many recorded
#: tokens per signature they reset (forgetting only delays future exports)
MISS_RECORD_TOKENS = 1 << 16


def snapshot_nbytes(snapshot: Any) -> int:
    """Bytes of a snapshot tree (or a logits row), from shapes alone (no
    copy, no sync)."""
    return sum(a.numel() * a.element_size() for a in tree_leaves(snapshot))


def to_host(tree: Any) -> Any:
    """Device -> host: every leaf copied to a CPU tensor of its own.  The
    serving loop's one snapshot copy to the host: a hot entry's demotion,
    a cold-tier insert, a preemption snapshot."""
    return tree_map(lambda a: a.to("cpu", copy=True), tree)


@dataclass
class PrefixHit:
    """A lookup's result: the deepest cached boundary on the prompt's path.
    ``snapshot`` is device tensors for a hot hit (import them directly:
    zero host bytes) and host tensors for a cold one (the import pays one
    host-to-device copy)."""

    length: int                   # prefix tokens covered
    snapshot: Any                 # width-1-lane state tree
    logits: Any                   # (V,) logits predicting token ``length``
    reads_cum: float              # cold-prefill reads_tokens of this prefix
    tier: str = "cold"


@dataclass(eq=False)          # identity hash: entries key the LRU dicts
class _Entry:
    signature: Tuple
    reads_cum: float
    nbytes: int                   # snapshot + logits bytes
    snap_nbytes: int              # snapshot bytes alone (slab traffic)
    tier: str = "cold"            # "hot" (a slab slot) | "cold" (host tensors)
    slot: int = -1
    snapshot: Any = None          # host tree when cold, None when hot
    logits: Any = None            # device row while hot, host when cold


class _Node:
    __slots__ = ("edge", "children", "entry", "parent", "misses")

    def __init__(self, edge: np.ndarray, parent: Optional["_Node"] = None):
        self.edge = edge                       # tokens from parent to here
        self.children: Dict[int, _Node] = {}   # keyed by first edge token
        self.entry: Optional[_Entry] = None
        self.parent = parent                   # None only at the root
        self.misses = 0                        # lookups that wanted past here


def _common_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


class _HotTier:
    """One signature's device slab of K snapshot slots (written and read by
    :func:`~repro_torch.models.transformer.store_lane_snapshot` and
    :func:`~repro_torch.models.transformer.fetch_lane_snapshot`)."""

    __slots__ = ("slab", "free", "used")

    def __init__(self, exemplar_snap: Any, slots: int):
        self.slab = tfm.init_snapshot_slab(exemplar_snap, slots)
        self.free: List[int] = list(range(slots))
        # hot-entry recency, least recent first (the demotion order)
        self.used: "collections.OrderedDict[_Entry, int]" = \
            collections.OrderedDict()


class PrefixCache:
    """Radix tree of lane snapshots: a device-slab hot tier over a host LRU
    cold tier, under separate byte budgets.  Owned by the
    :class:`~repro_torch.serving.engine.Engine`, so it outlives each
    scheduler: every served prompt seeds reuse for later traffic.  Not
    thread-safe (the scheduler is single-threaded host code)."""

    def __init__(self, capacity_bytes: int, device_capacity_bytes: int = 0,
                 export_policy: str = "always", max_hot_slots: int = 32,
                 export_stride: int = 1):
        if export_policy not in EXPORT_POLICIES:
            raise ValueError(f"export_policy {export_policy!r} not in "
                             f"{EXPORT_POLICIES}")
        if export_stride < 1:
            raise ValueError(f"export_stride must be >= 1, got {export_stride}")
        self.capacity_bytes = int(capacity_bytes)
        self.device_capacity_bytes = int(device_capacity_bytes)
        self.export_policy = export_policy
        self.export_stride = int(export_stride)
        self.max_hot_slots = int(max_hot_slots)
        self._roots: Dict[Tuple, _Node] = {}   # one tree per signature
        self._hot: Dict[Tuple, Optional[_HotTier]] = {}   # None: can't fit
        self._device_bytes = 0                 # slab bytes allocated
        # one recency order over hot and cold entries, least recent first;
        # maps entry -> node so eviction is O(1).  Budget eviction skips hot
        # entries; demotion follows each slab's own order
        self._lru: "collections.OrderedDict[_Entry, _Node]" = \
            collections.OrderedDict()
        self.total_bytes = 0                   # cold (host) bytes only
        self._miss_tokens: Dict[Tuple, int] = {}
        self.lookups = self.hits = self.hot_hits = 0
        self.hit_tokens = self.lookup_tokens = 0
        self.inserts = self.hot_inserts = self.insert_rejects = 0
        self.evictions = self.promotions = self.demotions = 0
        self.h2d_bytes = 0          # promotions, cold hits shipped up
        self.d2h_bytes = 0          # demotions, cold-tier inserts
        self.d2d_bytes = 0          # slab stores and fetches
        self.aux_sync_bytes = 0     # logits rows read on the host

    # -- public ------------------------------------------------------------

    def _walk(self, signature: Tuple, tokens: np.ndarray
              ) -> Iterator[Tuple[int, _Node]]:
        """(depth, node) for every node whose path is a prefix of
        ``tokens``: the one radix descent every read shares."""
        node = self._roots.get(signature)
        depth = 0
        while node is not None:
            yield depth, node
            rest = tokens[depth:]
            if len(rest) == 0:
                return
            child = node.children.get(int(rest[0]))
            if child is None or _common_len(child.edge, rest) < len(child.edge):
                return
            node = child
            depth += len(child.edge)

    def lookup(self, signature: Tuple, prompt: np.ndarray
               ) -> Optional[PrefixHit]:
        """The deepest cached boundary along ``prompt`` (never past its
        end; a whole-prompt hit's logits stand in for prefill), with its
        recency refreshed.  Under ``second-miss`` the prompt's path is
        recorded as a miss for :meth:`want_export`.  A hot hit returns the
        slot's contents on the device; a cold hit is promoted into the slab
        when one exists (one host-to-device copy)."""
        prompt = np.asarray(prompt)
        self.lookups += 1
        self.lookup_tokens += len(prompt)
        best = None
        for depth, node in self._walk(signature, prompt):
            if node.entry is not None and depth > 0:
                best = (depth, node.entry)
        if self.export_policy == "second-miss" and (
                best is None or best[0] < len(prompt)):
            self._record_miss(signature, prompt)
        if best is None:
            return None
        depth, entry = best
        self._lru.move_to_end(entry)
        self.hits += 1
        self.hit_tokens += depth
        if entry.tier == "cold":
            self._promote(entry)
        if entry.tier == "hot":
            hot = self._hot[signature]
            hot.used.move_to_end(entry)
            self.hot_hits += 1
            snap = tfm.fetch_lane_snapshot(hot.slab, entry.slot)
            self.d2d_bytes += entry.snap_nbytes
            if depth == len(prompt):
                # the caller reads the boundary row to sample token 0
                self.aux_sync_bytes += snapshot_nbytes(entry.logits)
            return PrefixHit(length=depth, snapshot=snap, logits=entry.logits,
                             reads_cum=entry.reads_cum, tier="hot")
        self.h2d_bytes += entry.snap_nbytes     # the import ships it up
        return PrefixHit(length=depth, snapshot=entry.snapshot,
                         logits=entry.logits, reads_cum=entry.reads_cum,
                         tier="cold")

    def covered(self, signature: Tuple, tokens: np.ndarray) -> int:
        """The deepest cached boundary along ``tokens``, touching neither
        stats nor recency."""
        best = 0
        for depth, node in self._walk(signature, np.asarray(tokens)):
            if node.entry is not None:
                best = depth
        return best

    def can_store(self, nbytes: int) -> bool:
        """Could a snapshot of ``nbytes`` fit either tier at all?"""
        return nbytes <= max(self.capacity_bytes, self.device_capacity_bytes)

    def want_export(self, signature: Tuple, tokens: np.ndarray,
                    chunk_index: Optional[int] = None,
                    final: bool = False) -> bool:
        """Should the boundary ``len(tokens)`` be exported?  With
        ``export_stride`` N > 1 only every Nth chunk boundary
        (``chunk_index``, 1-based) is offered, and the ``final`` full-prompt
        one always.  Then one descent: not if the boundary is cached; under
        ``second-miss`` only if two lookups asked for it (the asking lookup
        itself counts one)."""
        if (self.export_stride > 1 and not final and chunk_index is not None
                and chunk_index % self.export_stride != 0):
            return False
        node, exact = self._descend_to(signature, np.asarray(tokens))
        if exact and node.entry is not None:
            return False
        if self.export_policy == "always":
            return True
        return node is not None and node.misses >= 2

    def insert(self, signature: Tuple, tokens: np.ndarray, snapshot: Any,
               logits: Any, reads_cum: float) -> bool:
        """Store ``snapshot`` for the boundary ``len(tokens)``.  With a hot
        tier a device snapshot goes into the slab as it is (no host copy
        until a demotion); otherwise it is copied to the host now.  A
        boundary already cached is left alone (False); a snapshot larger
        than every tier is refused (False); cold entries past the budget
        are evicted least recently used first."""
        tokens = np.asarray(tokens, np.int32)
        if len(tokens) == 0:
            return False
        snap_nb = snapshot_nbytes(snapshot)
        nbytes = snap_nb + snapshot_nbytes(logits)
        hot = self._ensure_hot(signature, snapshot, nbytes)
        if hot is None and nbytes > self.capacity_bytes:
            self.insert_rejects += 1
            return False
        node = self._node_for(signature, tokens)
        if node.entry is not None:
            return False                   # first writer wins
        entry = _Entry(signature=signature, reads_cum=float(reads_cum),
                       nbytes=nbytes, snap_nbytes=snap_nb)
        if hot is not None:
            # attach the entry before taking a slot: a full slab demotes its
            # LRU entry, whose eviction prunes dead paths, and the new node
            # must not look dead
            entry.tier, entry.logits = "hot", logits
            node.entry = entry
            self._lru[entry] = node
            slot = self._acquire_slot(signature, hot)
            hot.slab = tfm.store_lane_snapshot(hot.slab, snapshot, slot)
            self.d2d_bytes += snap_nb
            entry.slot = slot
            hot.used[entry] = slot
            self.hot_inserts += 1
            self.inserts += 1
            return True
        self.d2h_bytes += snap_nb
        entry.snapshot = to_host(snapshot)
        entry.logits = to_host(logits)
        self.total_bytes += nbytes
        node.entry = entry
        self._lru[entry] = node
        self.inserts += 1
        self._evict_to_fit(keep=entry)
        return True

    def touch(self, signature: Tuple, tokens: np.ndarray) -> None:
        """Refresh the recency of every boundary along ``tokens`` (a
        finishing request offers its prompt's chain back as recently
        useful)."""
        for _, node in self._walk(signature, np.asarray(tokens)):
            if node.entry is not None:
                self._lru.move_to_end(node.entry)
                if node.entry.tier == "hot":
                    self._hot[node.entry.signature].used.move_to_end(node.entry)

    def stats(self) -> Dict[str, Any]:
        hot_entries = sum(len(h.used) for h in self._hot.values()
                          if h is not None)
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hot_hits": self.hot_hits,
            "hit_rate": self.hits / max(self.lookups, 1),
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "token_hit_rate": self.hit_tokens / max(self.lookup_tokens, 1),
            "inserts": self.inserts,
            "hot_inserts": self.hot_inserts,
            "insert_rejects": self.insert_rejects,
            "evictions": self.evictions,
            "promotions": self.promotions,
            "demotions": self.demotions,
            "entries": len(self._lru),
            "hot_entries": hot_entries,
            "bytes": self.total_bytes,
            "capacity_bytes": self.capacity_bytes,
            "device_bytes": self._device_bytes,
            "device_capacity_bytes": self.device_capacity_bytes,
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "d2d_bytes": self.d2d_bytes,
            "aux_sync_bytes": self.aux_sync_bytes,
        }

    def traffic(self) -> Dict[str, int]:
        """The byte-traffic counters alone."""
        return {"h2d_bytes": self.h2d_bytes, "d2h_bytes": self.d2h_bytes,
                "d2d_bytes": self.d2d_bytes,
                "aux_sync_bytes": self.aux_sync_bytes}

    # -- hot tier ----------------------------------------------------------

    def _ensure_hot(self, signature: Tuple, snapshot: Any,
                    entry_nb: int) -> Optional[_HotTier]:
        """The signature's slab, allocated at first use with K slots of
        ``entry_nb`` (snapshot + logits row, both device-resident while hot)
        from the remaining device budget, at most ``max_hot_slots``.  None
        when not one slot fits: everything then rides the cold tier."""
        if signature in self._hot:
            return self._hot[signature]
        slots = 0
        if entry_nb > 0:
            slots = min((self.device_capacity_bytes - self._device_bytes)
                        // entry_nb, self.max_hot_slots)
        if slots <= 0:
            self._hot[signature] = None
            return None
        tier = _HotTier(snapshot, int(slots))
        self._hot[signature] = tier
        self._device_bytes += int(slots) * entry_nb
        return tier

    def _acquire_slot(self, signature: Tuple, hot: _HotTier) -> int:
        """A free slot, demoting the slab's least recently used entry if
        it is full."""
        if hot.free:
            return hot.free.pop()
        victim = next(iter(hot.used))
        self._demote(victim, self._lru[victim])
        return hot.free.pop()

    def _promote(self, entry: _Entry) -> None:
        """Cold hit -> hot: copy the host snapshot into a slot (one
        host-to-device copy)."""
        hot = self._hot.get(entry.signature)
        if hot is None:
            return
        slot = self._acquire_slot(entry.signature, hot)
        hot.slab = tfm.store_lane_snapshot(hot.slab, entry.snapshot, slot)
        self.h2d_bytes += entry.snap_nbytes
        self.total_bytes -= entry.nbytes       # leaves the host tier
        entry.tier, entry.slot, entry.snapshot = "hot", slot, None
        hot.used[entry] = slot
        hot.used.move_to_end(entry)
        self.promotions += 1

    def _demote(self, entry: _Entry, node: _Node) -> None:
        """Hot -> cold: copy the slot's snapshot to the host (the deferred
        export's one device-to-host copy); an entry larger than the host
        budget is dropped."""
        hot = self._hot[entry.signature]
        entry.snapshot = to_host(tfm.fetch_lane_snapshot(hot.slab, entry.slot))
        self.d2h_bytes += entry.snap_nbytes
        self.aux_sync_bytes += snapshot_nbytes(entry.logits)
        entry.logits = to_host(entry.logits)
        hot.free.append(entry.slot)
        del hot.used[entry]
        entry.tier, entry.slot = "cold", -1
        self.total_bytes += entry.nbytes
        self.demotions += 1
        if entry.nbytes > self.capacity_bytes:
            self._drop(entry, node)
        else:
            self._evict_to_fit()

    # -- internals ----------------------------------------------------------

    def _descend_to(self, signature: Tuple, tokens: np.ndarray
                    ) -> Tuple[Optional[_Node], bool]:
        """(node covering position ``len(tokens)`` or None, whether the
        position is the node itself rather than inside its edge)."""
        node = self._roots.get(signature)
        if node is None:
            return None, False
        depth, n = 0, len(tokens)
        while depth < n:
            rest = tokens[depth:]
            child = node.children.get(int(rest[0]))
            if child is None:
                return None, False
            m = _common_len(child.edge, rest)
            if m < len(child.edge):
                if depth + m == n:             # ends inside the edge
                    return child, False
                return None, False             # diverges inside the edge
            node = child
            depth += len(child.edge)
        return node, True

    def _record_miss(self, signature: Tuple, prompt: np.ndarray) -> None:
        """Write a missed prompt's path into the tree (ghost nodes hold no
        snapshot) and bump ``misses`` along it; past
        :data:`MISS_RECORD_TOKENS` the signature's history resets."""
        used = self._miss_tokens.get(signature, 0)
        if used > MISS_RECORD_TOKENS:
            self._reset_misses(signature)
            used = 0
        self._miss_tokens[signature] = used + len(prompt)
        self._node_for(signature, np.asarray(prompt, np.int32),
                       bump_misses=True)

    def _reset_misses(self, signature: Tuple) -> None:
        """Zero every miss count and prune ghost-only chains."""
        root = self._roots.get(signature)
        if root is None:
            return
        stack, order = [root], []
        while stack:
            node = stack.pop()
            node.misses = 0
            order.append(node)
            stack.extend(node.children.values())
        for node in reversed(order):
            self._prune_path(node)
        self._miss_tokens[signature] = 0

    def _node_for(self, signature: Tuple, tokens: np.ndarray,
                  bump_misses: bool = False) -> _Node:
        """Walk, extend or split the tree so that ``tokens`` ends at a node
        (one descent, also insert's coverage probe); with ``bump_misses``
        each node on the path counts one more asking lookup (a split's new
        node inherits the count of the paths through it)."""
        root = self._roots.setdefault(signature,
                                      _Node(np.empty((0,), np.int32)))
        node, depth = root, 0
        if bump_misses:
            root.misses += 1
        while depth < len(tokens):
            rest = tokens[depth:]
            child = node.children.get(int(rest[0]))
            if child is None:
                child = _Node(np.array(rest, np.int32), parent=node)
                node.children[int(rest[0])] = child
                if bump_misses:
                    child.misses += 1
                return child
            m = _common_len(child.edge, rest)
            if m < len(child.edge):
                mid = _Node(np.array(child.edge[:m], np.int32), parent=node)
                mid.misses = child.misses
                child.edge = np.array(child.edge[m:], np.int32)
                mid.children[int(child.edge[0])] = child
                child.parent = mid
                node.children[int(rest[0])] = mid
                child = mid
            node = child
            depth += m
            if bump_misses:
                node.misses += 1
        return node

    def _drop(self, entry: _Entry, node: _Node) -> None:
        """Remove a cold entry and prune its dead path."""
        del self._lru[entry]
        node.entry = None
        self.total_bytes -= entry.nbytes
        self.evictions += 1
        self._prune_path(node)

    def _evict_to_fit(self, keep: Optional[_Entry] = None) -> None:
        """Evict least recently used cold entries until the host budget
        holds (hot entries live in the slab's own budget)."""
        while self.total_bytes > self.capacity_bytes:
            victim = None
            for entry in self._lru:
                if entry.tier == "cold" and entry is not keep:
                    victim = entry
                    break
            if victim is None:
                break
            self._drop(victim, self._lru[victim])

    def _prune_path(self, node: _Node) -> None:
        """Drop entry-less, childless nodes walking up from ``node``; nodes
        with live miss records and the root stay."""
        while (node.parent is not None and node.entry is None
               and not node.children and node.misses == 0):
            parent = node.parent
            del parent.children[int(node.edge[0])]
            node.parent = None
            node = parent
