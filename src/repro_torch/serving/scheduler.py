"""Continuous-batching scheduler of the port: admission, chunked prefill,
shared-prefill fork, decode, EOS/budget finish and lane reclaim over a fixed
arena of batch *lanes* — the core lifecycle of the reference
``repro.serving.scheduler``.

* **Lanes.**  The decode state is provisioned once for ``num_lanes`` rows;
  each lane sits at its own position and is switched on or off per step by
  the ``active`` mask of :func:`~repro_torch.models.transformer.decode_step`.
* **Chunked prefill.**  Prompts are teacher-forced through the *decode*
  step, ``chunk`` tokens per tick, so every eviction happens mid-prompt
  exactly as in a per-token loop; decoding lanes keep decoding in the same
  chunk.
* **Shared-prefill fork.**  A width-W request prefills once in one lane and
  is then copied into W-1 reserved lanes (:func:`gather_lanes`).
* **Finish and reclaim.**  A chain that emits EOS or exhausts its budget
  goes inactive at once (zero further reads); a finished request's lanes
  are reset to the pristine state for the next admission.
* **Metering.**  Each request owns a prefill and a decode
  :class:`BudgetMeter`, fed only by its own lanes.
* **Numeric tripwire.**  A request whose lane produces a non-finite logit
  ends with status ``failed`` and its lanes are reclaimed.
* **Paged pool admission.**  With a paged policy, admission also reserves
  each request's worst-case pool pages (scaled down by ``oversub``), so
  lanes are admitted against the bytes compressed chains really hold.
* **Preemption and failure semantics.**  With ``oversub > 1`` (or a fault
  plan, :mod:`repro_torch.serving.faults`) the pool can come under
  pressure.  Before each chunk the scheduler checks that the active set's
  worst-case demand fits; while it does not, it preempts the youngest
  request: every lane's state goes to host memory, its lanes and pages are
  freed, and it requeues with exponential backoff; on re-admission it
  resumes exactly where it stopped, with no prompt re-prefill.  A pool that
  latched ``exhausted`` inside a chunk fails every request that stepped in
  it; a request past its deadline times out.  Every request ends ``ok``
  (``preempt_count`` says how often it was preempted), ``failed`` or
  ``timeout``.

* **Cross-request prefix reuse.**  With a
  :class:`~repro_torch.serving.prefix_cache.PrefixCache` attached,
  admission looks up the longest cached prefix of the prompt, imports its
  snapshot into the lane (device to device when it sits in the cache's hot
  tier) and prefills only the suffix; prefill offers a snapshot at the
  chunk boundaries the cache's export policy asks for (stored in the device
  slab when there is one, with no host copy); a finished request refreshes
  its prompt's chain.  A hit covering the whole prompt skips prefill: the
  cached boundary logits give token 0.  The reads a hit avoided go on the
  prefill meter's ``kv_reads_saved``, so ``kv_reads`` stays what was paid.
  Under pool pressure a paged hit whose pages the pool cannot take
  prefills cold instead, as in the reference, and is counted
  (``prefix_import_degrades``, reported by :meth:`Scheduler.prefix_stats`).
* **SLO and overload control.**  With an :class:`SLOSpec` attached, every
  result carries TTFT (arrival to first token, in ticks) and TPOT (decode
  ticks per later token), and overload runs a ladder: **throttle** a
  width-W request to ``min_width`` chains (flagged ``degraded``; tokens
  equal a solo run at that width) with ``cooldown_ticks`` of hysteresis;
  **shed** a queued request that provably cannot meet its deadline or TTFT
  even if admitted now (status ``rejected``, no prefill read); **reject**
  at the door the newest arrivals past ``max_queue``; then preempt, then
  fail.  Every projection is host arithmetic over admission descriptors
  and the radix tree's read-only probe.  :meth:`Scheduler.slo_stats`
  reports goodput, TTFT/TPOT percentiles and queue and lane timelines.
* **Sampling.**  Greedy at temperature 0; above it, the reference's
  Threefry stream exactly (:mod:`repro_torch.core.threefry`): the chunk
  step splits its key once per step and draws ``categorical(sub, logits /
  temperature)`` over the padded vocabulary; the first token of each chain
  comes from a second key, split once per request.  Both keys live on the
  device.

The host reads the device once per chunk (the reference's "tick-boundary"
sync); inside a chunk every per-lane decision stays on the device, and so
do a hot prefix hit's import, the deferred export's store into the slab and
the exported boundary logits row; a whole-prompt hit reads its logits row
once, at admission.  The pool's pages are read back only when pressure is
possible (``oversub > 1`` or faults), so sound admission adds no sync.
Every such transfer runs under the reference's
:func:`~repro_torch.analysis.hostsync.sanctioned` tags, which the host-sync
tripwire allows: ``tick-boundary`` (the chunk's inputs up and its outputs
back, the lane masks of a fork or reclaim, a whole-prompt hit's logits
row, the first tokens), ``pool-pressure`` (the free-page readback),
``preempt-snapshot`` (a preempted lane's state down and back up) and
``prefix-demote`` (a cold prefix hit's snapshot up).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.hostsync import sanctioned
from repro_torch.core import block_pool
from repro_torch.core import policy as policy_lib
from repro_torch.core import threefry
from repro_torch.core.hyperscale import BudgetMeter
from repro_torch.core.tree import tree_map
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serving import prefix_cache as prefix_cache_lib
from repro_torch.serving.prefix_cache import PrefixCache


@dataclass
class Request:
    """One request: a prompt and a generation budget.  ``width`` > 1 asks
    for W hyper-scaling chains sharing one prefill; ``eos_id`` enables early
    exit; ``arrival`` delays admission to that tick.  ``deadline`` bounds
    arrival-to-finish in ticks (past it the request times out, queued or
    active); ``max_preempts`` bounds how often it may be preempted before
    it fails."""

    uid: int
    prompt: np.ndarray            # (T0,) int32
    max_new: int
    width: int = 1
    eos_id: Optional[int] = None
    arrival: int = 0
    deadline: Optional[int] = None
    max_preempts: int = 3


@dataclass(frozen=True)
class SLOSpec:
    """Latency SLO and overload-control knobs (``Scheduler(slo=)``).

    ``ttft_ticks`` bounds arrival to first token, ``tpot_ticks`` decode
    ticks per later token (None: unconstrained for goodput).
    ``max_queue`` bounds the backlog of arrived, unadmitted requests:
    arrivals past it are ``rejected`` at the door (checked every tick, so a
    preloaded trace's future arrivals do not count).  ``shed`` rejects a
    queued request that provably cannot meet its deadline or TTFT even if
    admitted now.  ``degrade_width`` lets admission serve a width-W request
    at ``min_width`` under lane or pool pressure, and ``cooldown_ticks`` of
    hysteresis keep that throttle on after the pressure goes."""

    ttft_ticks: Optional[int] = None
    tpot_ticks: Optional[float] = None
    max_queue: Optional[int] = None
    shed: bool = True
    degrade_width: bool = True
    min_width: int = 1
    cooldown_ticks: int = 4


@dataclass
class RequestResult:
    """``status``: ``ok`` (after ``preempt_count`` preemptions, if any),
    ``failed``, ``timeout`` or ``rejected`` (bounced at the door or shed
    while queued: it never took a lane).  ``ttft_ticks`` is arrival to
    first token (-1: none sampled), ``tpot_ticks`` decode ticks per token
    after the first (0.0 for one token); ``degraded`` marks a request the
    ladder served at fewer chains, whose ``tokens`` has the served width's
    rows."""

    uid: int
    tokens: np.ndarray            # (W, max_new) int32, padded after EOS
    lengths: np.ndarray           # (W,) generated tokens per chain (incl. EOS)
    meter: BudgetMeter            # prefill + decode, sequential merge
    prefill_meter: BudgetMeter
    decode_meter: BudgetMeter
    admitted_tick: int = 0
    finished_tick: int = 0
    status: str = "ok"
    preempt_count: int = 0
    latency_ticks: int = 0        # arrival -> finished, queueing included
    first_token_tick: int = -1
    ttft_ticks: int = -1
    tpot_ticks: float = 0.0
    degraded: bool = False


class _ReqState:
    def __init__(self, req: Request):
        self.req = req
        self.lanes: List[int] = []
        self.width = req.width                 # served width (the ladder cuts)
        self.consumed = 0                      # prompt tokens prefilled
        self.prefill_chunks = 0                # chunks prefilled (export stride)
        self.hold_logits: Optional[np.ndarray] = None
        self.chains: List[List[int]] = [[] for _ in range(req.width)]
        self.chain_done = [False] * req.width
        self.prefill_meter = BudgetMeter()
        self.decode_meter = BudgetMeter()
        self.admitted_tick = -1                # -1 = never admitted
        self.first_token_tick = -1             # -1 = no token sampled
        self.status = "ok"
        self.preempt_count = 0
        self.resume_at = 0                     # backoff: earliest re-admission
        # preemption snapshot: per-lane host states + host lane scalars
        self.snaps: Optional[List[Any]] = None
        self.saved: Optional[Dict[str, np.ndarray]] = None

    @property
    def done(self) -> bool:
        return bool(self.lanes) and all(self.chain_done)

    def ready(self, tick: int) -> bool:
        return self.req.arrival <= tick and self.resume_at <= tick

    def degrade(self, width: int) -> None:
        """Throttle to ``width`` chains (at admission: no chain holds
        anything yet)."""
        self.width = width
        self.chains = [[] for _ in range(width)]
        self.chain_done = [False] * width

    def result(self, peak_bytes: float, finished_tick: int) -> RequestResult:
        w, m = self.width, self.req.max_new
        toks = np.zeros((w, m), np.int32)       # padded with 0 after EOS
        lens = np.zeros((w,), np.int32)
        for c, chain in enumerate(self.chains):
            lens[c] = len(chain)
            toks[c, :len(chain)] = chain
        for meter in (self.prefill_meter, self.decode_meter):
            meter.observe_peak_bytes(peak_bytes)
        ft = self.first_token_tick
        gen = int(lens.max()) if w else 0
        tpot = ((finished_tick - ft) / (gen - 1)
                if ft >= 0 and gen > 1 else 0.0)
        return RequestResult(
            uid=self.req.uid, tokens=toks, lengths=lens,
            meter=self.prefill_meter.merge_sequential(self.decode_meter),
            prefill_meter=self.prefill_meter, decode_meter=self.decode_meter,
            admitted_tick=self.admitted_tick, finished_tick=finished_tick,
            status=self.status, preempt_count=self.preempt_count,
            latency_ticks=max(0, finished_tick - self.req.arrival),
            first_token_tick=ft,
            ttft_ticks=ft - self.req.arrival if ft >= 0 else -1,
            tpot_ticks=float(tpot), degraded=self.width < self.req.width)


def sample(key: Optional[threefry.Key], logits: torch.Tensor,
           temperature: float) -> torch.Tensor:
    """The next token of each row of ``logits`` (B, V_pad) fp32: the
    argmax at temperature 0, else ``categorical(key, logits /
    temperature)``.  The division is by a device tensor: CUDA divides by a
    host scalar as a product with its reciprocal, which may round another
    way than the reference's division."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    temp = torch.full((), temperature, dtype=logits.dtype,
                      device=logits.device)
    return threefry.categorical(key, logits / temp)


def make_chunk_fn(arch, *, use_kernel: bool = False,
                  temperature: float = 0.0) -> Callable:
    """The mixed prefill/decode chunk step: one call advances every active
    lane ``chunk`` steps — prefill lanes teacher-force ``feed`` tokens,
    decode lanes sample (see :func:`sample`), finished and idle lanes stay
    frozen.  The returned function counts the decode steps it ran in
    ``.steps``."""

    def chunk_fn(params, state, feed, feed_valid, cur_tok, pos, decoding,
                 finished, lane_eos, budget_left, rng, poison=None):
        # feed/feed_valid: (B, C); every other lane tensor: (B,).  ``rng``
        # is the sampling key, split once per step (prefill-only steps
        # too) and returned advanced; at temperature 0 it is passed
        # through.  ``poison`` (B,) bool NaNs those lanes' logits for the
        # whole chunk (the fault injector's tripwire test); None leaves the
        # logits alone
        b, c = feed.shape
        emit_cnt = torch.zeros_like(cur_tok)
        last_logits = torch.zeros((b, arch.padded_vocab), dtype=torch.float32,
                                  device=feed.device)
        bad = torch.zeros_like(finished)     # an active lane saw a non-finite logit
        ys = []
        for t in range(c):
            prefill_now = feed_valid[:, t] & ~decoding & ~finished
            decode_now = decoding & ~finished & (emit_cnt < budget_left)
            active = prefill_now | decode_now
            token = torch.where(prefill_now, feed[:, t], cur_tok)[:, None]
            sub = None
            if temperature > 0.0:
                rng, sub = threefry.split(rng)
            logits, state, aux = tfm.decode_step(
                params, token, state, arch, pos, use_kernel=use_kernel,
                active=active)
            if poison is not None:
                logits = torch.where(poison[:, None], float("nan"), logits)
            bad = bad | (active & ~torch.isfinite(logits).all(dim=-1))
            nxt = sample(sub, logits, temperature).to(torch.int32)
            emitted = torch.where(decode_now, nxt, -1)
            cur_tok = torch.where(decode_now, nxt, cur_tok)
            finished = finished | (decode_now & (lane_eos >= 0)
                                   & (nxt == lane_eos))
            emit_cnt = emit_cnt + decode_now.to(torch.int32)
            pos = pos + active.to(torch.int32)
            last_logits = torch.where(active[:, None], logits, last_logits)
            ys.append((emitted, aux["live_tokens"], aux["reads_tokens"], active))
        emitted, live, reads, act = (torch.stack(col) for col in zip(*ys))
        chunk_fn.steps += c
        return (state, cur_tok, pos, finished, emit_cnt, rng, last_logits,
                emitted, live, reads, act, bad)     # stacked ys: (C, B)

    chunk_fn.steps = 0
    chunk_fn.temperature = temperature
    return chunk_fn


class Scheduler:
    """Drives one lane arena to completion over a queue of requests, one
    ``chunk_fn`` call (see :func:`make_chunk_fn`) per tick.  Built by
    :meth:`repro_torch.serving.engine.Engine.scheduler`.

    ``on_pressure``: "preempt" (evict and resume) or "ignore" (no pressure
    relief and no exhaustion backstop: dropped writes go unreported, kept
    only to show that failure mode).  ``oversub`` >= 1 admits against
    1/oversub of worst-case pool demand; preemption absorbs what then
    materialises.  ``faults`` attaches a
    :class:`~repro_torch.serving.faults.FaultPlan`, ``prefix_cache`` a
    :class:`~repro_torch.serving.prefix_cache.PrefixCache` and ``slo`` an
    :class:`SLOSpec`.  ``seed`` seeds the sampling keys, as the
    reference's: the chunk step's ``PRNGKey(seed)`` and the first tokens'
    ``PRNGKey(seed ^ 0x5EED0)``."""

    def __init__(self, arch, params, policy, chunk_fn: Callable, *,
                 num_lanes: int, max_len: int, chunk: int = 8,
                 device: DeviceLike = None, faults=None,
                 on_pressure: str = "preempt", oversub: float = 1.0,
                 seed: int = 0, prefix_cache: Optional[PrefixCache] = None,
                 slo: Optional[SLOSpec] = None):
        if on_pressure not in ("preempt", "ignore"):
            raise ValueError(f"on_pressure must be 'preempt' or 'ignore', "
                             f"got {on_pressure!r}")
        if oversub < 1.0:
            raise ValueError("oversub < 1 would reserve more than worst-case "
                             "demand; shrink pool_blocks instead")
        if slo is not None and slo.min_width < 1:
            raise ValueError("SLOSpec.min_width must be >= 1")
        self.arch, self.params, self.policy = arch, params, policy
        self.num_lanes, self.max_len, self.chunk = num_lanes, max_len, chunk
        self.device = resolve_device(device)
        self._chunk_fn = chunk_fn
        self.temperature = chunk_fn.temperature
        self.rng = threefry.prng_key(seed, device=self.device)
        self._host_rng = threefry.prng_key(seed ^ 0x5EED0, device=self.device)
        self.faults = faults
        self.on_pressure = on_pressure
        self.oversub = float(oversub)
        self.slo = slo
        self.prefix_cache = prefix_cache
        self.preemptions = self.resumes = 0
        self.failures = self.timeouts = self.completed = 0
        self.rejected = 0              # bounced at the door (max_queue)
        self.shed = 0                  # shed while queued (also rejected)
        self.degraded = 0              # admitted at reduced width
        # prefix hits imported as a cold prefill: the pool could not take
        # the boundary's pages (the reference's one degrade, counted here)
        self.prefix_import_degrades = 0
        self.offered = 0               # every submit() that passed its checks
        # every retired result and per-tick samples, for slo_stats
        self._finished: List[RequestResult] = []
        self._timeline: Dict[str, List[int]] = {"queue_depth": [],
                                                "active_lanes": []}
        self._hot_until = -1           # throttle hysteresis: degrade before it
        self.state = tfm.init_decode_state(arch, num_lanes, max_len, policy,
                                           device=self.device)
        self.signature = tfm.lane_state_signature(self.state)
        self._snap_nb: Optional[int] = None
        self._fresh = tfm.init_decode_state(arch, num_lanes, max_len, policy,
                                            device=self.device)
        self.peak_bytes = float(policy_lib.state_peak_bytes(self.state))
        # (kv_heads, arena_blocks, block_p, pool_blocks) per pooled cache:
        # what a lane's worst-case pool footprint is computed from
        self._pool_descs: List[Tuple[int, int, int, int]] = []
        for pc in policy_lib.iter_policy_caches(self.state):
            pool = getattr(pc.cache, "pool", None)
            if pool is not None:
                phys = pc.cache.phys                  # (L, B, H, NB)
                self._pool_descs.append(
                    (int(phys.shape[-2]), int(phys.shape[-1]),
                     int(pool.block_p), int(pool.num_blocks)))

        b = num_lanes
        self.pos = np.zeros((b,), np.int32)
        self.cur_tok = np.zeros((b,), np.int32)
        self.decoding = np.zeros((b,), bool)
        self.finished = np.zeros((b,), bool)
        self.lane_eos = np.full((b,), -1, np.int32)
        self.owner: List[Optional[_ReqState]] = [None] * b
        self.chain_of = np.zeros((b,), np.int32)
        self.queue: List[_ReqState] = []
        self.active_reqs: List[_ReqState] = []
        self.ticks = 0
        self.steps = 0

    # -- public ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.width > self.num_lanes:
            raise ValueError(f"request width {req.width} > num_lanes "
                             f"{self.num_lanes}")
        if len(req.prompt) == 0:
            raise ValueError("empty prompt: nothing to sample from")
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError("prompt + max_new exceeds scheduler max_len")
        # a request whose worst-case demand exceeds the pool could never be
        # admitted, and alone could exhaust it; rejecting it here keeps the
        # invariant preemption relies on: one active request alone fits
        demand = self._lane_pool_demand(len(req.prompt) + req.max_new)
        for i, d in enumerate(demand):
            if req.width * d > self._pool_descs[i][3]:
                raise ValueError(
                    f"request {req.uid}: worst-case pool demand "
                    f"{req.width * d} blocks exceeds pool {i} capacity "
                    f"{self._pool_descs[i][3]} — unservable at any load")
        self.offered += 1
        self.queue.append(_ReqState(req))

    def pool_stats(self) -> Optional[Dict[str, Any]]:
        """Paged-pool counters over every pooled cache (reads the device;
        None when nothing is paged), with :meth:`lifecycle_stats` under
        ``"lifecycle"``."""
        out = policy_lib.state_pool_stats(self.state)
        if out is not None:
            out["lifecycle"] = self.lifecycle_stats()
        return out

    def lifecycle_stats(self) -> Dict[str, int]:
        """How requests left: ``preemptions`` counts evictions, ``resumes``
        snapshot re-admissions; ``completed``/``failures``/``timeouts``
        count finished requests by status; ``rejected`` counts door
        bounces and ``shed`` queue sheds (both end ``rejected``);
        ``degraded`` counts admissions at reduced width."""
        return {"preemptions": self.preemptions, "resumes": self.resumes,
                "completed": self.completed, "failures": self.failures,
                "timeouts": self.timeouts, "rejected": self.rejected,
                "shed": self.shed, "degraded": self.degraded}

    def prefix_stats(self) -> Optional[Dict[str, Any]]:
        """The prefix cache's :meth:`~PrefixCache.stats` with
        ``import_degrades``, the hits this scheduler prefilled cold because
        the pool could not take their pages; None with no cache."""
        if self.prefix_cache is None:
            return None
        return dict(self.prefix_cache.stats(),
                    import_degrades=self.prefix_import_degrades)

    def slo_stats(self) -> Dict[str, Any]:
        """Goodput, TTFT/TPOT percentiles, statuses and the queue and lane
        timelines over every result retired so far
        (:func:`compute_slo_stats`), with :meth:`lifecycle_stats`."""
        out = compute_slo_stats(self._finished, self.slo,
                                offered=self.offered,
                                timeline=self._timeline,
                                num_lanes=self.num_lanes)
        out["lifecycle"] = self.lifecycle_stats()
        return out

    @property
    def _snap_nbytes(self) -> int:
        """Bytes of one prefix-cache entry of this arena: a lane snapshot
        and its fp32 logits row (taken once, from lane 0's export)."""
        if self._snap_nb is None:
            self._snap_nb = (prefix_cache_lib.snapshot_nbytes(
                tfm.export_lane_state(self.state, 0))
                + int(self.arch.padded_vocab) * 4)
        return self._snap_nb

    def run(self) -> List[RequestResult]:
        """Run the queue to completion; results in completion order.  Every
        iteration advances the clock or retires a request, and a queue that
        can never be admitted again is failed out (:meth:`_starved`)."""
        results: List[RequestResult] = []
        while self.queue or self.active_reqs:
            if self.faults is not None:
                self.faults.on_tick(self, results)
            self._expire_queued(results)
            self._bound_queue(results)
            self._shed_queued(results)
            # fork before admitting: freed lanes reach held requests first
            self._fork_ready()
            self._admit()
            self._fork_ready()
            if not any(o is not None for o in self.owner):
                if not self.queue and not self.active_reqs:
                    break
                if self._starved():
                    self._fail_starved(results)
                    continue
                self._record_timeline()
                self.ticks += 1        # future arrivals or backoff: time passes
                continue
            self._tick(results)
        return results

    # -- lifecycle stages --------------------------------------------------

    def _idle_lanes(self) -> List[int]:
        return [lane for lane in range(self.num_lanes) if self.owner[lane] is None]

    def _lane_pool_demand(self, tokens: int) -> List[int]:
        """Worst-case pool blocks one chain of a ``tokens``-token request can
        hold, per pooled cache: ``H * min(ceil(T / bp), NB)``.  Empty when
        nothing is paged."""
        return [h * min(-(-tokens // bp), nb)
                for (h, nb, bp, _) in self._pool_descs]

    def _reserved_demand(self, tokens: int, width: int) -> List[int]:
        """Blocks admission reserves for a request: the width-W worst case
        over ``oversub`` (1 = sound: the pool can never exhaust)."""
        return [math.ceil(width * d / self.oversub)
                for d in self._lane_pool_demand(tokens)]

    def _pool_fits(self, tokens: int, width: int) -> bool:
        """Would admitting this request keep reserved demand within every
        pool?  Host arithmetic only."""
        if not self._pool_descs:
            return True
        reserved = self._reserved_demand(tokens, width)
        for r in self.active_reqs:
            d = self._reserved_demand(len(r.req.prompt) + r.req.max_new,
                                      r.width)
            reserved = [a + b for a, b in zip(reserved, d)]
        return all(reserved[i] <= self._pool_descs[i][3]
                   for i in range(len(reserved)))

    def _admit(self) -> None:
        """FIFO with skip-scan.  A width-W request takes one prefill lane now
        and reserves W-1 fork lanes (``sum(width)`` over admitted requests
        never exceeds ``num_lanes``), so a held fork can never starve.  A
        paged state also reserves pool blocks (:meth:`_pool_fits`).  A
        preempted request re-admits once its backoff expires and, when
        pressure is possible, only if the free pages cover its full demand
        (else it would land straight back under pressure).  The width is
        :meth:`_effective_width` (the ladder's throttle), and a fresh
        admission imports its longest cached prefix."""
        while True:
            idle = self._idle_lanes()
            if not idle:
                break
            reserved = sum(r.width - len(r.lanes) for r in self.active_reqs)
            avail = len(idle) - reserved
            free = None                  # lazy free-page readback
            nxt, nxt_w = None, 0
            for r in self.queue:
                if not r.ready(self.ticks):
                    continue
                w = self._effective_width(r)
                if w > avail or not self._pool_fits(
                        len(r.req.prompt) + r.req.max_new, w):
                    continue
                if r.snaps is not None and self._pool_descs \
                        and self._pressure_possible():
                    if free is None:
                        free = self._free_blocks()
                    need = self._lane_pool_demand(
                        len(r.req.prompt) + r.req.max_new)
                    if any(free[i] < len(r.snaps) * need[i]
                           for i in range(len(need))):
                        continue         # wait for pages
                nxt, nxt_w = r, w
                break
            if nxt is None:
                break
            self.queue.remove(nxt)
            if nxt.snaps is not None:
                self._resume(nxt, idle)
                continue
            if nxt_w < nxt.width:
                # the throttle rung: reduced width beats a preemption storm;
                # hysteresis keeps admission from flapping back
                nxt.degrade(nxt_w)
                self.degraded += 1
                self._hot_until = max(self._hot_until,
                                      self.ticks + self.slo.cooldown_ticks)
            lane = idle.pop(0)
            self.owner[lane] = nxt
            self.chain_of[lane] = 0
            nxt.lanes = [lane]
            nxt.admitted_tick = self.ticks
            self.active_reqs.append(nxt)
            self.pos[lane] = 0
            self.decoding[lane] = False
            self.finished[lane] = False
            self.lane_eos[lane] = -1 if nxt.req.eos_id is None else nxt.req.eos_id
            self._import_prefix(nxt, lane)

    # -- SLO and overload control (the degradation ladder) -------------------

    def _effective_width(self, r: _ReqState) -> int:
        """The width ``r`` would be admitted at now: full, unless the SLO
        enables width degradation and either the throttle window is hot or
        the pool fits the request only at ``min_width``.  A resumed request
        keeps its snapshot's width."""
        w = r.width
        if r.snaps is not None or self.slo is None \
                or not self.slo.degrade_width:
            return w
        lo = min(w, max(1, self.slo.min_width))
        if lo == w:
            return w
        if self._throttled():
            return lo
        tokens = len(r.req.prompt) + r.req.max_new
        if self._pool_descs and not self._pool_fits(tokens, w) \
                and self._pool_fits(tokens, lo):
            return lo                 # degrade instead of waiting to preempt
        return w

    def _throttled(self) -> bool:
        """Is the throttle window hot?  Overload is a ready backlog (arrived,
        unadmitted lane demand) larger than the whole arena; seeing it arms
        ``cooldown_ticks`` of hysteresis.  Active lanes do not count: one
        wide request and one arrival is a queue, not overload."""
        if self.ticks < self._hot_until:
            return True
        backlog = sum(q.width for q in self.queue if q.ready(self.ticks))
        if backlog > self.num_lanes:
            self._hot_until = self.ticks + self.slo.cooldown_ticks
            return True
        return False

    def _min_prefill_ticks(self, r: _ReqState) -> int:
        """Prefill ticks if admitted now, at best: the suffix after the
        longest cached prefix (the tree's read-only probe), in chunks."""
        plen = len(r.req.prompt)
        cached = 0
        if self.prefix_cache is not None:
            cached = min(plen, self.prefix_cache.covered(self.signature,
                                                         r.req.prompt))
        return -(-(plen - cached) // self.chunk)

    def _min_service_ticks(self, r: _ReqState) -> int:
        """A lower bound on admission-to-completion ticks: the best prefill
        plus the fewest decode ticks any outcome allows (one token when an
        EOS may end it, else ``max_new``)."""
        gen = 1 if r.req.eos_id is not None else r.req.max_new
        return self._min_prefill_ticks(r) + max(-(-(gen - 1) // self.chunk), 1)

    def _bound_queue(self, results: List[RequestResult]) -> None:
        """Backpressure: when the arrived, never-admitted backlog exceeds
        ``max_queue``, the newest arrivals leave ``rejected``.  Preempted
        requests count towards the depth but are never bounced."""
        slo = self.slo
        if slo is None or slo.max_queue is None:
            return
        arrived = [r for r in self.queue if r.req.arrival <= self.ticks]
        fresh = [r for r in arrived if r.admitted_tick == -1]
        over = len(arrived) - slo.max_queue
        for r in sorted(fresh, key=lambda r: (r.req.arrival, r.req.uid),
                        reverse=True)[:max(0, over)]:
            self.queue.remove(r)
            r.status = "rejected"
            self.rejected += 1
            self._finish(r, results, 0.0)

    def _shed_queued(self, results: List[RequestResult]) -> None:
        """The shed rung: a queued request that cannot meet its deadline
        (or the TTFT SLO) even if admitted now leaves ``rejected`` before it
        reads anything.  Preempted requests are exempt."""
        slo = self.slo
        if slo is None or not slo.shed:
            return
        for r in list(self.queue):
            if r.admitted_tick != -1 or r.req.arrival > self.ticks:
                continue
            arr, dl = r.req.arrival, r.req.deadline
            doomed = (dl is not None and
                      self.ticks + self._min_service_ticks(r) > arr + dl)
            if not doomed and slo.ttft_ticks is not None:
                doomed = (self.ticks + self._min_prefill_ticks(r)
                          > arr + slo.ttft_ticks)
            if doomed:
                self.queue.remove(r)
                r.status = "rejected"
                self.shed += 1
                self._finish(r, results, 0.0)

    def _finish(self, r: _ReqState, results: List[RequestResult],
                peak_bytes: float) -> None:
        """Retire a request: its result goes to the caller and to the
        ledger :meth:`slo_stats` reads."""
        res = r.result(peak_bytes, self.ticks)
        results.append(res)
        self._finished.append(res)

    def _record_timeline(self) -> None:
        self._timeline["queue_depth"].append(len(self.queue))
        self._timeline["active_lanes"].append(
            sum(o is not None for o in self.owner))

    # -- preemption, failure semantics, pool pressure ------------------------

    def _pressure_possible(self) -> bool:
        """Sound admission (``oversub == 1``) without a fault plan bounds
        real demand by reserved demand, so the pool cannot exhaust and no
        pressure check or page readback runs."""
        return self.faults is not None or self.oversub > 1.0

    def _free_blocks(self) -> List[int]:
        """Free pages per pooled cache, in its scarcest layer (each layer's
        pool allocates on its own).  Reads the device: a
        ``sanctioned("pool-pressure")`` readback, taken only when
        :meth:`_pressure_possible`."""
        out = []
        with sanctioned("pool-pressure"):
            for pc in policy_lib.iter_policy_caches(self.state):
                pool = getattr(pc.cache, "pool", None)
                if pool is not None:
                    ref = pool.ref.reshape(-1, pool.num_blocks)
                    out.append(int((ref == 0).sum(dim=-1).min()))
        return out

    def _ghost_rows(self) -> List[int]:
        """Injector-held ghost pages per pooled cache, worst layer (zeros
        without a fault plan)."""
        out = [0] * len(self._pool_descs)
        if self.faults is None:
            return out
        for i in range(len(out)):
            g = self.faults.ghosts.get(i)
            if g is not None:
                out[i] = int(g.reshape(-1, g.shape[-1]).sum(axis=-1).max())
        return out

    def _relieve_pressure(self, results: List[RequestResult]) -> None:
        """While the active set's worst-case demand plus ghost pages does not
        fit the pool, preempt the youngest request (latest admission, then
        highest uid).  Exact: a request never maps more pages than its
        worst case, so a set that fits can never exhaust the pool in a
        chunk.  Host arithmetic only."""
        ghost = self._ghost_rows()
        while self.active_reqs:
            total = [0] * len(self._pool_descs)
            for r in self.active_reqs:
                d = self._lane_pool_demand(len(r.req.prompt) + r.req.max_new)
                w = max(len(r.lanes), r.width)
                total = [a + w * b for a, b in zip(total, d)]
            if all(total[i] + ghost[i] <= self._pool_descs[i][3]
                   for i in range(len(total))):
                return
            victim = max(self.active_reqs,
                         key=lambda r: (r.admitted_tick, r.req.uid))
            self._preempt(victim, results)

    def _preempt(self, r: _ReqState, results: List[RequestResult]) -> None:
        """Evict ``r`` without corrupting it: every lane's decode state goes
        to host memory, its lanes and pages are freed, and it requeues with
        exponential backoff; past ``max_preempts`` it fails instead."""
        r.preempt_count += 1
        self.preemptions += 1
        if self.slo is not None:
            # the strongest overload signal: follow-on admissions degrade
            self._hot_until = max(self._hot_until,
                                  self.ticks + self.slo.cooldown_ticks)
        lanes = list(r.lanes)
        give_up = r.preempt_count > r.req.max_preempts
        if not give_up:
            r.snaps = [prefix_cache_lib.to_host(
                tfm.export_lane_state(self.state, lane),
                tag="preempt-snapshot") for lane in lanes]
            r.saved = {
                "pos": self.pos[lanes].copy(),
                "cur_tok": self.cur_tok[lanes].copy(),
                "decoding": self.decoding[lanes].copy(),
                "finished": self.finished[lanes].copy(),
                "lane_eos": self.lane_eos[lanes].copy(),
            }
        self.active_reqs.remove(r)
        self._release_lanes(r, lanes)
        if give_up:
            r.status = "failed"
            self.failures += 1
            self._finish(r, results, self._req_peak(len(lanes)))
        else:
            r.resume_at = self.ticks + (1 << (r.preempt_count - 1))
            self.queue.append(r)

    def _resume(self, r: _ReqState, idle: List[int]) -> None:
        """Re-admit a preempted request: each lane's snapshot goes into a
        pristine lane and the host lane scalars are restored, so it
        continues where it stopped with no prompt re-prefill."""
        lanes = idle[:len(r.snaps)]
        for j, lane in enumerate(lanes):
            with sanctioned("preempt-snapshot"):       # the snapshot goes up
                snap = tree_map(lambda a: a.to(self.device), r.snaps[j])
            self.state = tfm.import_lane_state(self.state, snap, lane)
            self._reapply_ghosts()
            self.owner[lane] = r
            self.chain_of[lane] = j
            for key in ("pos", "cur_tok", "decoding", "finished", "lane_eos"):
                getattr(self, key)[lane] = r.saved[key][j]
        r.lanes = list(lanes)
        r.snaps = r.saved = None
        self.active_reqs.append(r)
        self.resumes += 1

    def _retire(self, r: _ReqState, status: str,
                results: List[RequestResult]) -> None:
        """Terminal non-ok transition: lanes and pages reclaimed, counted,
        result emitted."""
        r.status = status
        if status == "timeout":
            self.timeouts += 1
        else:
            self.failures += 1
        self.active_reqs.remove(r)
        lanes = list(r.lanes)
        self._release_lanes(r, lanes)
        self._finish(r, results, self._req_peak(len(lanes)))

    def _release_lanes(self, r: _ReqState, lanes: List[int]) -> None:
        reclaim = np.zeros((self.num_lanes,), bool)
        for lane in lanes:
            self.owner[lane] = None
            reclaim[lane] = True
            self.decoding[lane] = False
            self.finished[lane] = False
            self.pos[lane] = 0
            self.cur_tok[lane] = 0
            self.lane_eos[lane] = -1
        r.lanes = []
        self._reset(reclaim)

    def _reapply_ghosts(self) -> None:
        # gather, reclaim and import recount ``ref`` from the page maps,
        # which drops the injector's ghost refs: add them back
        if self.faults is not None and self.faults.has_ghosts():
            self.state = self.faults.reapply(self.state)

    def _expire_queued(self, results: List[RequestResult]) -> None:
        """Requests still waiting past their deadline time out without
        taking a lane.  A deadline ``dl`` grants the ticks ``[arrival,
        arrival + dl]``: strict ``>`` here and in :meth:`_tick`."""
        for r in list(self.queue):
            dl = r.req.deadline
            if dl is not None and self.ticks - r.req.arrival > dl:
                self.queue.remove(r)
                r.status = "timeout"
                self.timeouts += 1
                self._finish(r, results, 0.0)

    def _starved(self) -> bool:
        """All lanes idle, every queued request ready, none admitted, and no
        pending fault release could free the pages they wait for."""
        if any(not r.ready(self.ticks) for r in self.queue):
            return False
        return not (self.faults is not None and self.faults.can_unblock())

    def _fail_starved(self, results: List[RequestResult]) -> None:
        for r in list(self.queue):
            self.queue.remove(r)
            r.status = "failed"
            self.failures += 1
            self._finish(r, results, 0.0)

    def _import_prefix(self, r: _ReqState, lane: int) -> None:
        """Longest-cached-prefix import: the lane resumes at boundary L and
        prefill feeds only ``prompt[L:]``.  A hot hit's snapshot is already
        on the device; a cold hit's is shipped up by the import (and
        promoted).  The reads it avoided go on the prefill meter's saved
        axis; a whole-prompt hit skips prefill, its cached logits standing
        in for the last prefill step's (read on the host once, here).  A
        paged import allocates all of the boundary's pages at once: when
        pressure is possible and the free pages do not cover them, the
        request takes a cold prefill instead, counted in
        ``prefix_import_degrades`` (the cache still counts the hit)."""
        if self.prefix_cache is None:
            return
        hit = self.prefix_cache.lookup(self.signature, r.req.prompt)
        if hit is None:
            return
        if self._pool_descs and self._pressure_possible():
            free = self._free_blocks()
            need = self._lane_pool_demand(hit.length)
            if any(free[i] < need[i] for i in range(len(need))):
                self.prefix_import_degrades += 1
                return
        snap = hit.snapshot
        if hit.tier == "cold":
            with sanctioned("prefix-demote"):   # the cold tier's one upload
                snap = tree_map(lambda a: a.to(self.device), snap)
        self.state = tfm.import_lane_state(self.state, snap, lane)
        self._reapply_ghosts()
        self.pos[lane] = hit.length
        r.consumed = hit.length
        r.prefill_meter.observe_saved_reads(hit.reads_cum)
        if hit.length == len(r.req.prompt):
            with sanctioned("tick-boundary"):   # once per admission
                r.hold_logits = hit.logits.cpu().numpy().copy()

    def _want_prefix_export(self, r: _ReqState) -> bool:
        """Host checks only (no cache, a snapshot too large for any tier,
        an off-stride boundary, a cached boundary, no earlier asker under
        ``second-miss``): a skipped export costs no device work."""
        if self.prefix_cache is None:
            return False
        if not self.prefix_cache.can_store(self._snap_nbytes):
            return False
        return self.prefix_cache.want_export(
            self.signature, r.req.prompt[:r.consumed],
            chunk_index=r.prefill_chunks,
            final=r.consumed == len(r.req.prompt))

    def _export_prefix(self, r: _ReqState, lane: int,
                       logits: torch.Tensor) -> None:
        """Offer the boundary ``prompt[:consumed]`` to the tree: the lane's
        snapshot (on the device) and its logits row (on the device, a copy
        of its own).  ``reads_cum`` is what a cold prefill of the prefix
        reads: the request's paid prefill reads plus what its own import
        saved."""
        snap = tfm.export_lane_state(self.state, lane)
        reads_cum = r.prefill_meter.kv_reads_saved + r.prefill_meter.kv_reads
        self.prefix_cache.insert(self.signature, r.req.prompt[:r.consumed],
                                 snap, logits.clone(), reads_cum)

    def _fork_ready(self) -> None:
        """hold -> decode: fork prefilled lanes into W chains, sample token 0."""
        for r in list(self.active_reqs):
            if r.hold_logits is None or len(r.lanes) == r.width:
                continue
            need = r.width - 1
            idle = self._idle_lanes()
            if len(idle) < need:
                continue
            src = np.arange(self.num_lanes, dtype=np.int64)
            for lane in idle[:need]:
                src[lane] = r.lanes[0]
                self.owner[lane] = r
                self.chain_of[lane] = len(r.lanes)
                r.lanes.append(lane)
            with sanctioned("tick-boundary"):
                src_dev = torch.from_numpy(src).to(self.device)
            self.state = tfm.gather_lanes(self.state, src_dev)
            self._reapply_ghosts()
            self.pos[r.lanes] = self.pos[r.lanes[0]]
            self.lane_eos[r.lanes] = self.lane_eos[r.lanes[0]]
            self._start_decode(r)
        for r in list(self.active_reqs):      # width-1 fast path
            if r.hold_logits is not None and len(r.lanes) == r.width \
                    and not self.decoding[r.lanes].any():
                self._start_decode(r)

    def _start_decode(self, r: _ReqState) -> None:
        """Sample each chain's first token from the shared prefill logits:
        greedy, every chain takes the argmax (first index on ties); above
        temperature 0, one draw of W rows from a key split off once per
        request (one host read per request, not per step)."""
        w = len(r.lanes)
        if self.temperature > 0.0:
            self._host_rng, sub = threefry.split(self._host_rng)
            with sanctioned("tick-boundary"):
                logits = torch.from_numpy(r.hold_logits).to(self.device)
            first = sample(sub, logits[None].expand(w, -1), self.temperature)
            with sanctioned("tick-boundary"):  # once per request, not per step
                first = first.cpu().numpy().astype(np.int32)
        else:
            first = np.full((w,), np.argmax(r.hold_logits), np.int32)
        if r.first_token_tick < 0:
            r.first_token_tick = self.ticks    # TTFT endpoint
        r.decode_meter.observe_step([0.0], new_tokens=w,
                                    reads_tokens_per_layer=[0.0])
        for c, lane in enumerate(r.lanes):
            tok = int(first[c])
            r.chains[c].append(tok)
            self.cur_tok[lane] = tok
            self.decoding[lane] = True
            if (r.req.eos_id is not None and tok == r.req.eos_id) \
                    or len(r.chains[c]) >= r.req.max_new:
                self.finished[lane] = True
        r.hold_logits = None

    def _tick(self, results: List[RequestResult]) -> None:
        self._record_timeline()
        # pressure relief before dispatch: a snapshot taken after a dropped
        # write would not be exact, so the margin check runs at the boundary
        if self.on_pressure == "preempt" and self._pool_descs \
                and self._pressure_possible():
            self._relieve_pressure(results)
            if not self.active_reqs:
                self.ticks += 1        # everything evicted: time still passes
                return
        b, c = self.num_lanes, self.chunk
        feed = np.zeros((b, c), np.int32)
        feed_valid = np.zeros((b, c), bool)
        budget_left = np.zeros((b,), np.int32)
        prefill_take: Dict[int, int] = {}
        for lane in range(b):
            r = self.owner[lane]
            if r is None:
                continue
            if self.decoding[lane]:
                budget_left[lane] = r.req.max_new - len(
                    r.chains[self.chain_of[lane]])
            elif r.hold_logits is None and lane == r.lanes[0]:
                take = min(c, len(r.req.prompt) - r.consumed)
                if take > 0:
                    feed[lane, :take] = r.req.prompt[r.consumed:r.consumed + take]
                    feed_valid[lane, :take] = True
                    prefill_take[lane] = take
        poison = (self.faults.poison(self.ticks, b)
                  if self.faults is not None else None)

        dev = self.device
        with sanctioned("tick-boundary"):      # the chunk's inputs go up
            ins = [torch.from_numpy(a).to(dev) for a in (
                feed, feed_valid, self.cur_tok, self.pos, self.decoding,
                self.finished, self.lane_eos, budget_left)]
            pois = None if poison is None else torch.from_numpy(poison).to(dev)
        out = self._chunk_fn(self.params, self.state, *ins, self.rng, pois)
        (self.state, cur_tok, pos, finished, _, self.rng, last_logits,
         emitted, live, reads, act, bad) = out
        # the scheduler's ONE sanctioned host sync: once per chunk, never
        # per step (the host-sync tripwire of repro_torch.analysis enforces
        # this).  The failure tripwires ride the same boundary: the chunk's
        # bad-logit mask and the pool's exhausted latch
        with sanctioned("tick-boundary"):
            self.cur_tok = cur_tok.cpu().numpy().copy()
            self.pos = pos.cpu().numpy().copy()
            self.finished = finished.cpu().numpy().copy()
            emitted = emitted.cpu().numpy()             # (C, B)
            live = live.cpu().numpy()
            reads = reads.cpu().numpy()
            act = act.cpu().numpy()
            bad = bad.cpu().numpy()
            exhausted = (self._pools_exhausted()
                         if self._pool_descs and self.on_pressure != "ignore"
                         else False)
        self.ticks += 1
        self.steps += c

        # failure semantics, decided before anything is collected: a doomed
        # request keeps nothing from this chunk
        doomed: Dict[int, Tuple[_ReqState, str]] = {}
        if exhausted:
            # a write was dropped inside the chunk and cannot be attributed:
            # every request that stepped in it fails
            for r in self.active_reqs:
                if any(act[:, lane].any() for lane in r.lanes):
                    doomed[id(r)] = (r, "failed")
            self._clear_pool_flags()
        for lane in range(b):
            r = self.owner[lane]
            if r is not None and bad[lane]:      # non-finite logits
                doomed[id(r)] = (r, "failed")

        # per-request, per-step metering from the request's own lanes only
        for r in self.active_reqs:
            lanes = r.lanes
            meter = (r.decode_meter if self.decoding[lanes[0]]
                     else r.prefill_meter)
            for t in range(c):
                if not act[t, lanes].any():
                    continue
                meter.observe_step(
                    [float(live[t, lanes].sum())],
                    new_tokens=int((emitted[t, lanes] >= 0).sum()),
                    reads_tokens_per_layer=[float(reads[t, lanes].sum())])

        # prefill completion -> hold (token 0 is sampled at the next fork)
        ll = None
        for lane, take in prefill_take.items():
            r = self.owner[lane]
            if id(r) in doomed:
                continue
            r.consumed += take
            r.prefill_chunks += 1
            if r.consumed == len(r.req.prompt):
                if ll is None:
                    with sanctioned("tick-boundary"):   # prefill completion
                        ll = last_logits.cpu().numpy()
                r.hold_logits = ll[lane].copy()
            if self._want_prefix_export(r):
                # deferred: the snapshot and its logits row stay on the device
                self._export_prefix(r, lane, last_logits[lane])

        # collect emitted tokens; EOS / budget exhaustion finishes chains
        for lane in range(b):
            r = self.owner[lane]
            if r is None or not self.decoding[lane] or id(r) in doomed:
                continue
            chain = r.chains[self.chain_of[lane]]
            for t in range(c):
                tok = emitted[t, lane]
                if tok >= 0:
                    chain.append(int(tok))
            if self.finished[lane] or len(chain) >= r.req.max_new:
                r.chain_done[self.chain_of[lane]] = True
                self.finished[lane] = True

        # reclaim the lanes of completed requests
        done = [r for r in self.active_reqs if r.done and id(r) not in doomed]
        if done:
            reclaim = np.zeros((b,), bool)
            for r in done:
                self.active_reqs.remove(r)
                self.completed += 1
                if self.prefix_cache is not None:
                    # the finished prompt's chain is recently useful again
                    self.prefix_cache.touch(self.signature, r.req.prompt)
                self._finish(r, results, self._req_peak(len(r.lanes)))
                for lane in r.lanes:
                    self.owner[lane] = None
                    reclaim[lane] = True
                    self.decoding[lane] = False
                    self.finished[lane] = False
                    self.pos[lane] = 0
            self._reset(reclaim)

        # deadlines: completion above wins a tie; anything still active past
        # its deadline times out now
        for r in list(self.active_reqs):
            dl = r.req.deadline
            if dl is not None and self.ticks - r.req.arrival > dl:
                doomed.setdefault(id(r), (r, "timeout"))
        for r, status in doomed.values():
            self._retire(r, status, results)

    def _pools_exhausted(self) -> bool:
        return any(bool(pc.cache.pool.exhausted.any())
                   for pc in policy_lib.iter_policy_caches(self.state)
                   if getattr(pc.cache, "pool", None) is not None)

    def _clear_pool_flags(self) -> None:
        """Un-latch ``exhausted`` once the backstop has failed the requests:
        left set, it would condemn every later request."""
        for pc in policy_lib.iter_policy_caches(self.state):
            if getattr(pc.cache, "pool", None) is not None:
                block_pool.clear_flags(pc.cache.pool)

    def _req_peak(self, n_lanes: int) -> float:
        return self.peak_bytes * n_lanes / self.num_lanes

    def _reset(self, mask: np.ndarray) -> None:
        with sanctioned("tick-boundary"):
            mask_dev = torch.from_numpy(mask).to(self.device)
        self.state = tfm.reclaim_lanes(self.state, mask_dev, self._fresh)
        self._reapply_ghosts()



# -- SLO accounting (Scheduler.slo_stats and the overload trace) -------------


def slo_attained(res: RequestResult, slo: Optional[SLOSpec]) -> bool:
    """Did the request land inside ``slo``?  ``ok`` is necessary, and with
    no SLO sufficient.  A pure function of the result, so an uncontrolled
    run can be measured against the same SLO."""
    if res.status != "ok":
        return False
    if slo is None:
        return True
    if slo.ttft_ticks is not None and not (
            0 <= res.ttft_ticks <= slo.ttft_ticks):
        return False
    if slo.tpot_ticks is not None and res.tpot_ticks > slo.tpot_ticks:
        return False
    return True


def _pctiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": -1.0, "p90": -1.0, "max": -1.0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)), "max": float(a.max())}


def compute_slo_stats(results: List[RequestResult],
                      slo: Optional[SLOSpec] = None, *,
                      offered: Optional[int] = None,
                      timeline: Optional[Dict[str, List[int]]] = None,
                      num_lanes: Optional[int] = None) -> Dict[str, Any]:
    """Goodput and latency over retired results.  Goodput is the share of
    ``offered`` requests (default: ``len(results)``) that finished ``ok``
    within ``slo``: rejected, shed, timed-out and failed requests all count
    against it, which is why shedding hopeless work can raise it."""
    offered = len(results) if offered is None else int(offered)
    by_status: Dict[str, int] = {}
    for r in results:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    ok = [r for r in results if r.status == "ok"]
    within = sum(1 for r in results if slo_attained(r, slo))
    out: Dict[str, Any] = {
        "offered": offered,
        "finished": len(results),
        "statuses": by_status,
        "ok": len(ok),
        "ok_within_slo": int(within),
        "goodput": within / offered if offered else 0.0,
        "degraded": sum(1 for r in results if r.degraded),
        "ttft": _pctiles([float(r.ttft_ticks) for r in ok
                          if r.ttft_ticks >= 0]),
        "tpot": _pctiles([float(r.tpot_ticks) for r in ok
                          if r.ttft_ticks >= 0]),
    }
    if timeline is not None:
        qd = timeline.get("queue_depth", [])
        al = timeline.get("active_lanes", [])
        out["queue_depth"] = {"mean": float(np.mean(qd)) if qd else 0.0,
                              "max": int(max(qd)) if qd else 0}
        out["lane_util"] = (float(np.mean(al)) / num_lanes
                            if al and num_lanes else 0.0)
    return out
