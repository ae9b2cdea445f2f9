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

The host reads the device once per chunk (the reference's "tick-boundary"
sync); inside a chunk every per-lane decision stays on the device.
Greedy sampling only in this slice; prefix caching, the paged pool,
preemption, faults and the SLO ladder are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import policy as policy_lib
from repro_torch.core.hyperscale import BudgetMeter
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm


@dataclass
class Request:
    """One request: a prompt and a generation budget.  ``width`` > 1 asks
    for W hyper-scaling chains sharing one prefill; ``eos_id`` enables early
    exit; ``arrival`` delays admission to that tick."""

    uid: int
    prompt: np.ndarray            # (T0,) int32
    max_new: int
    width: int = 1
    eos_id: Optional[int] = None
    arrival: int = 0


@dataclass
class RequestResult:
    uid: int
    tokens: np.ndarray            # (W, max_new) int32, padded after EOS
    lengths: np.ndarray           # (W,) generated tokens per chain (incl. EOS)
    meter: BudgetMeter            # prefill + decode, sequential merge
    prefill_meter: BudgetMeter
    decode_meter: BudgetMeter
    admitted_tick: int = 0
    finished_tick: int = 0
    status: str = "ok"


class _ReqState:
    def __init__(self, req: Request):
        self.req = req
        self.lanes: List[int] = []
        self.width = req.width
        self.consumed = 0                      # prompt tokens prefilled
        self.hold_logits: Optional[np.ndarray] = None
        self.chains: List[List[int]] = [[] for _ in range(req.width)]
        self.chain_done = [False] * req.width
        self.prefill_meter = BudgetMeter()
        self.decode_meter = BudgetMeter()
        self.admitted_tick = -1
        self.status = "ok"

    @property
    def done(self) -> bool:
        return bool(self.lanes) and all(self.chain_done)

    def ready(self, tick: int) -> bool:
        return self.req.arrival <= tick

    def result(self, peak_bytes: float, finished_tick: int) -> RequestResult:
        w, m = self.width, self.req.max_new
        toks = np.zeros((w, m), np.int32)       # padded with 0 after EOS
        lens = np.zeros((w,), np.int32)
        for c, chain in enumerate(self.chains):
            lens[c] = len(chain)
            toks[c, :len(chain)] = chain
        for meter in (self.prefill_meter, self.decode_meter):
            meter.observe_peak_bytes(peak_bytes)
        return RequestResult(
            uid=self.req.uid, tokens=toks, lengths=lens,
            meter=self.prefill_meter.merge_sequential(self.decode_meter),
            prefill_meter=self.prefill_meter, decode_meter=self.decode_meter,
            admitted_tick=self.admitted_tick, finished_tick=finished_tick,
            status=self.status)


def make_chunk_fn(arch, *, use_kernel: bool = False,
                  temperature: float = 0.0) -> Callable:
    """The mixed prefill/decode chunk step: one call advances every active
    lane ``chunk`` steps — prefill lanes teacher-force ``feed`` tokens,
    decode lanes sample greedily, finished and idle lanes stay frozen.
    The returned function counts the decode steps it ran in ``.steps``."""
    if temperature > 0.0:
        raise NotImplementedError(
            "sampling with temperature > 0 is not ported yet (the reference "
            "draws from jax.random threefry)")

    def chunk_fn(params, state, feed, feed_valid, cur_tok, pos, decoding,
                 finished, lane_eos, budget_left):
        # feed/feed_valid: (B, C); every other lane tensor: (B,)
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
            logits, state, aux = tfm.decode_step(
                params, token, state, arch, pos, use_kernel=use_kernel,
                active=active)
            bad = bad | (active & ~torch.isfinite(logits).all(dim=-1))
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
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
        return (state, cur_tok, pos, finished, emit_cnt, last_logits,
                emitted, live, reads, act, bad)     # stacked ys: (C, B)

    chunk_fn.steps = 0
    return chunk_fn


class Scheduler:
    """Drives one lane arena to completion over a queue of requests, one
    ``chunk_fn`` call (see :func:`make_chunk_fn`) per tick.  Built by
    :meth:`repro_torch.serving.engine.Engine.scheduler`."""

    def __init__(self, arch, params, policy, chunk_fn: Callable, *,
                 num_lanes: int, max_len: int, chunk: int = 8,
                 device: DeviceLike = None):
        self.arch, self.params, self.policy = arch, params, policy
        self.num_lanes, self.max_len, self.chunk = num_lanes, max_len, chunk
        self.device = resolve_device(device)
        self._chunk_fn = chunk_fn
        self.state = tfm.init_decode_state(arch, num_lanes, max_len, policy,
                                           device=self.device)
        self._fresh = tfm.init_decode_state(arch, num_lanes, max_len, policy,
                                            device=self.device)
        self.peak_bytes = float(policy_lib.state_peak_bytes(self.state))

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
        self.queue.append(_ReqState(req))

    def run(self) -> List[RequestResult]:
        """Run the queue to completion; results in completion order."""
        results: List[RequestResult] = []
        while self.queue or self.active_reqs:
            # fork before admitting: freed lanes reach held requests first
            self._fork_ready()
            self._admit()
            self._fork_ready()
            if not any(o is not None for o in self.owner):
                self.ticks += 1        # nothing admitted yet: future arrivals
                continue
            self._tick(results)
        return results

    # -- lifecycle stages --------------------------------------------------

    def _idle_lanes(self) -> List[int]:
        return [lane for lane in range(self.num_lanes) if self.owner[lane] is None]

    def _admit(self) -> None:
        """FIFO with skip-scan.  A width-W request takes one prefill lane now
        and reserves W-1 fork lanes (``sum(width)`` over admitted requests
        never exceeds ``num_lanes``), so a held fork can never starve."""
        while True:
            idle = self._idle_lanes()
            if not idle:
                break
            reserved = sum(r.width - len(r.lanes) for r in self.active_reqs)
            avail = len(idle) - reserved
            nxt = next((r for r in self.queue
                        if r.ready(self.ticks) and r.width <= avail), None)
            if nxt is None:
                break
            self.queue.remove(nxt)
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
            self.state = tfm.gather_lanes(self.state, torch.from_numpy(src))
            self.pos[r.lanes] = self.pos[r.lanes[0]]
            self.lane_eos[r.lanes] = self.lane_eos[r.lanes[0]]
            self._start_decode(r)
        for r in list(self.active_reqs):      # width-1 fast path
            if r.hold_logits is not None and len(r.lanes) == r.width \
                    and not self.decoding[r.lanes].any():
                self._start_decode(r)

    def _start_decode(self, r: _ReqState) -> None:
        """Sample each chain's first token from the shared prefill logits
        (greedy: every chain takes the argmax, first index on ties)."""
        w = len(r.lanes)
        first = int(np.argmax(r.hold_logits))
        r.decode_meter.observe_step([0.0], new_tokens=w,
                                    reads_tokens_per_layer=[0.0])
        for c, lane in enumerate(r.lanes):
            r.chains[c].append(first)
            self.cur_tok[lane] = first
            self.decoding[lane] = True
            if (r.req.eos_id is not None and first == r.req.eos_id) \
                    or len(r.chains[c]) >= r.req.max_new:
                self.finished[lane] = True
        r.hold_logits = None

    def _tick(self, results: List[RequestResult]) -> None:
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

        dev = self.device
        out = self._chunk_fn(
            self.params, self.state, torch.from_numpy(feed).to(dev),
            torch.from_numpy(feed_valid).to(dev),
            torch.from_numpy(self.cur_tok).to(dev),
            torch.from_numpy(self.pos).to(dev),
            torch.from_numpy(self.decoding).to(dev),
            torch.from_numpy(self.finished).to(dev),
            torch.from_numpy(self.lane_eos).to(dev),
            torch.from_numpy(budget_left).to(dev))
        (self.state, cur_tok, pos, finished, _, last_logits,
         emitted, live, reads, act, bad) = out
        # the one host sync of the chunk
        self.cur_tok = cur_tok.cpu().numpy().copy()
        self.pos = pos.cpu().numpy().copy()
        self.finished = finished.cpu().numpy().copy()
        emitted = emitted.cpu().numpy()             # (C, B)
        live = live.cpu().numpy()
        reads = reads.cpu().numpy()
        act = act.cpu().numpy()
        bad = bad.cpu().numpy()
        self.ticks += 1
        self.steps += c
        # numeric tripwire: a request whose lane produced a non-finite logit
        # fails and keeps nothing from this chunk
        doomed = {id(self.owner[lane]): self.owner[lane] for lane in range(b)
                  if self.owner[lane] is not None and bad[lane]}

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
            if r.consumed == len(r.req.prompt):
                if ll is None:
                    ll = last_logits.cpu().numpy()
                r.hold_logits = ll[lane].copy()

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
        for r in doomed.values():
            r.status = "failed"
        done += list(doomed.values())
        if done:
            reclaim = np.zeros((b,), bool)
            for r in done:
                self.active_reqs.remove(r)
                results.append(r.result(self._req_peak(len(r.lanes)),
                                        self.ticks))
                for lane in r.lanes:
                    self.owner[lane] = None
                    reclaim[lane] = True
                    self.decoding[lane] = False
                    self.finished[lane] = False
                    self.pos[lane] = 0
            self._reset(reclaim)

    def _req_peak(self, n_lanes: int) -> float:
        return self.peak_bytes * n_lanes / self.num_lanes

    def _reset(self, mask: np.ndarray) -> None:
        self.state = tfm.reclaim_lanes(
            self.state, torch.from_numpy(mask).to(self.device), self._fresh)
