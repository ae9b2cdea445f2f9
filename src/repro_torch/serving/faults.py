"""Deterministic fault injection for the serving stack (the chaos harness).

The port of the reference ``repro.serving.faults``.  A :class:`FaultPlan`
hurts a live serving trace at chosen ticks:

* ``pool_shrink`` — reserve free pages in every paged pool (as if a
  co-tenant took them), optionally released at a later tick.  The
  reservations are *ghost refs*: refcount bumps on pages no lane maps,
  kept in a host ledger so conservation stays checkable as
  ``ref == recount(phys) + ghost``.
* ``cow_storm`` — ghost-share every page one lane maps, so that lane's next
  writes all take the copy-on-write path.
* ``nan_logits`` — NaN one lane's logits for one chunk (the tripwire).
* ``stall`` — jump the scheduler clock forward (deadlines, backoff).
* ``preempt`` — force-preempt whatever request owns a lane.

A plan is a list of :class:`Fault` records; :meth:`FaultPlan.random` draws
one from a seed with numpy in the reference's order, so a seeded plan
replays the same faults in both packages.  The reference wraps the
injector's device readbacks in ``sanctioned("fault-inject")`` tags for its
JAX host-sync auditor; the port has no auditor yet (ROADMAP A13) and drops
them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import policy as policy_lib

KINDS = ("pool_shrink", "cow_storm", "nan_logits", "stall", "preempt")


@dataclass(frozen=True)
class Fault:
    """One scheduled injury.  It fires once, at the first tick boundary
    where ``scheduler.ticks >= tick``.  ``lane`` targets ``nan_logits``,
    ``cow_storm`` and ``preempt`` (modulo ``num_lanes``); ``blocks`` sizes
    ``pool_shrink`` (free pages per pool layer); ``duration`` sizes
    ``stall``; ``release`` is the tick a shrink's or storm's ghost refs go
    back."""

    kind: str
    tick: int
    lane: int = 0
    blocks: int = 0
    duration: int = 0
    release: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")


class FaultPlan:
    """A schedule of :class:`Fault` records plus the host ledger of ghost
    refs.  The scheduler calls :meth:`on_tick` once per tick (before
    admission), :meth:`poison` once per chunk, and :meth:`reapply` after
    every lifecycle op that recounted ``ref`` from the page maps."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: List[Fault] = sorted(faults, key=lambda f: f.tick)
        self._fired = [False] * len(self.faults)
        #: pooled_idx -> int32 ghost refcounts shaped like that pool's ``ref``
        self.ghosts: Dict[int, np.ndarray] = {}
        self._releases: List[Tuple[int, Dict[int, np.ndarray]]] = []
        self.log: List[Tuple[int, str]] = []

    # -- construction -------------------------------------------------------

    @staticmethod
    def random(seed: int, *, lanes: int, horizon: int = 12,
               max_faults: int = 3, paged: bool = True,
               arrivals: Optional[Sequence[int]] = None) -> "FaultPlan":
        """A seeded plan of 1..max_faults faults over the first ``horizon``
        ticks (pool faults only for paged states).  With ``arrivals`` each
        fault tick is drawn near a sampled arrival instead."""
        rng = np.random.default_rng(seed)
        kinds = list(KINDS) if paged else ["nan_logits", "stall", "preempt"]
        arr = None
        if arrivals is not None and len(arrivals):
            arr = np.sort(np.asarray(arrivals, np.int64))
            horizon = max(horizon, int(arr.max()) + 2)

        def draw_tick() -> int:
            if arr is None:
                return int(rng.integers(1, horizon))
            base = int(arr[int(rng.integers(len(arr)))])
            return max(1, base + int(rng.integers(0, 3)))

        faults = []
        for _ in range(int(rng.integers(1, max_faults + 1))):
            kind = kinds[int(rng.integers(len(kinds)))]
            tick = draw_tick()
            if kind == "pool_shrink":
                release = (tick + int(rng.integers(2, horizon))
                           if rng.random() < 0.5 else None)
                faults.append(Fault(kind, tick,
                                    blocks=int(rng.integers(1, 5)),
                                    release=release))
            elif kind == "cow_storm":
                faults.append(Fault(kind, tick,
                                    lane=int(rng.integers(lanes)),
                                    release=tick + int(rng.integers(2, 6))))
            elif kind == "stall":
                faults.append(Fault(kind, tick,
                                    duration=int(rng.integers(1, 4))))
            else:
                faults.append(Fault(kind, tick,
                                    lane=int(rng.integers(lanes))))
        return FaultPlan(faults)

    # -- ledger queries ------------------------------------------------------

    def has_ghosts(self) -> bool:
        return any(int(g.sum()) > 0 for g in self.ghosts.values())

    def can_unblock(self) -> bool:
        """True while a later injector action could free pool pages: a
        pending release, or an unfired fault that schedules one."""
        if self._releases:
            return True
        return any(f.release is not None and not self._fired[i]
                   for i, f in enumerate(self.faults))

    # -- scheduler hooks -----------------------------------------------------

    def on_tick(self, sched, results) -> None:
        """Fire every due fault (``nan_logits`` waits for :meth:`poison`;
        ``preempt`` waits until its lane is owned)."""
        for rel in list(self._releases):
            tick, deltas = rel
            if tick <= sched.ticks:
                self._releases.remove(rel)
                self._bump(sched, deltas, sign=-1)
                for i, d in deltas.items():
                    self.ghosts[i] = self.ghosts[i] - d
                self.log.append((sched.ticks, "release ghost refs"))
        for i, f in enumerate(self.faults):
            if self._fired[i] or f.tick > sched.ticks \
                    or f.kind == "nan_logits":
                continue
            if f.kind == "preempt":
                lane = f.lane % sched.num_lanes
                victim = sched.owner[lane]
                if victim is None:
                    continue
                self._fired[i] = True
                self.log.append((sched.ticks, f"force-preempt lane {lane}"))
                sched._preempt(victim, results)
            elif f.kind == "stall":
                self._fired[i] = True
                self.log.append((sched.ticks, f"stall {f.duration} ticks"))
                sched.ticks += f.duration
            elif f.kind == "pool_shrink":
                self._fired[i] = True
                self._shrink(sched, f)
            elif f.kind == "cow_storm":
                self._fired[i] = True
                self._storm(sched, f)

    def poison(self, tick: int, num_lanes: int) -> Optional[np.ndarray]:
        """The (B,) NaN mask for the chunk dispatched at ``tick``, or None
        when no ``nan_logits`` fault is due."""
        out = None
        for i, f in enumerate(self.faults):
            if self._fired[i] or f.kind != "nan_logits" or f.tick > tick:
                continue
            self._fired[i] = True
            if out is None:
                out = np.zeros((num_lanes,), bool)
            out[f.lane % num_lanes] = True
            self.log.append((tick, f"nan logits lane {f.lane % num_lanes}"))
        return out

    def reapply(self, state):
        """Add the ghost refs back after an op that recounted ``ref``."""
        return self._with_refs(state, self.ghosts, sign=1)

    # -- injectors -----------------------------------------------------------

    @staticmethod
    def _with_refs(state, deltas: Dict[int, np.ndarray], sign: int):
        def fn(idx, cache):
            d = deltas.get(idx)
            if d is None or not int(np.abs(d).sum()):
                return cache
            pool = cache.pool
            pool.ref.add_(sign * torch.from_numpy(d).to(pool.ref))
            return cache
        return policy_lib.map_pooled_caches(state, fn)

    @staticmethod
    def _pooled_host(sched, want_phys: bool):
        """Host copies of every pooled cache's (ref[, phys])."""
        out = []
        for pc in policy_lib.iter_policy_caches(sched.state):
            pool = getattr(pc.cache, "pool", None)
            if pool is None:
                continue
            phys = pc.cache.phys.cpu().numpy() if want_phys else None
            out.append((pool.ref.cpu().numpy(), phys))
        return out

    def _bump(self, sched, deltas: Dict[int, np.ndarray], sign: int) -> None:
        sched.state = self._with_refs(sched.state, deltas, sign)

    def _charge(self, sched, f: Fault, deltas: Dict[int, np.ndarray],
                what: str) -> None:
        if not deltas:
            self.log.append((sched.ticks, f"{what}: nothing to grab"))
            return
        self._bump(sched, deltas, sign=+1)
        for i, d in deltas.items():
            self.ghosts[i] = self.ghosts.get(i, np.zeros_like(d)) + d
        if f.release is not None:
            self._releases.append((f.release, deltas))
        self.log.append((sched.ticks, what))

    def _shrink(self, sched, f: Fault) -> None:
        """Reserve up to ``f.blocks`` free pages in every pool layer."""
        deltas: Dict[int, np.ndarray] = {}
        for idx, (ref, _) in enumerate(self._pooled_host(sched, False)):
            flat = ref.reshape(-1, ref.shape[-1])
            grab = np.zeros_like(flat)
            for row in range(flat.shape[0]):
                free = np.flatnonzero(flat[row] == 0)[:f.blocks]
                grab[row, free] = 1
            if grab.any():
                deltas[idx] = grab.reshape(ref.shape).astype(ref.dtype)
        self._charge(sched, f, deltas, f"pool_shrink {f.blocks} pages/row")

    def _storm(self, sched, f: Fault) -> None:
        """Ghost-share every page one lane maps, so its next writes CoW."""
        deltas: Dict[int, np.ndarray] = {}
        for idx, (ref, phys) in enumerate(self._pooled_host(sched, True)):
            lane = f.lane % phys.shape[-3]
            flat_ref = np.zeros_like(ref).reshape(-1, ref.shape[-1])
            lane_map = phys[..., lane, :, :].reshape(flat_ref.shape[0], -1)
            for row in range(flat_ref.shape[0]):
                mapped = lane_map[row][lane_map[row] >= 0]
                ids, cnt = np.unique(mapped, return_counts=True)
                flat_ref[row, ids] += cnt.astype(flat_ref.dtype)
            add = flat_ref.reshape(ref.shape)
            if add.any():
                deltas[idx] = add
        self._charge(sched, f, deltas, f"cow_storm lane {f.lane}")
