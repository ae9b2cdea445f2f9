"""Seeded, deterministic request traces for the serving stack of the port
(the reference ``repro.serving.workload``, numpy only).

* **Poisson arrivals** — memoryless open-loop traffic at a target rate
  (requests per scheduler tick).
* **Bursty (on/off) arrivals** — Poisson at ``rate`` inside ``on_ticks``
  windows, silence for ``off_ticks`` between them: the overload shape the
  scheduler's SLO ladder is built for.
* **Multi-turn sessions** — each turn's prompt extends the previous turn's
  whole context, so a session hits its own prefix in the radix prefix
  cache.
* **Mixed lengths and width-W requests** — prompt and output lengths drawn
  per request from closed ranges, the hyper-scaling width from a weighted
  choice.

Each generator call drives one ``np.random.default_rng(seed)`` stream: the
same seed gives the same :class:`~repro_torch.serving.scheduler.Request`
list (uids, arrivals, prompts, lengths, widths) as the reference's,
sorted by arrival.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.scheduler import Request


@dataclass(frozen=True)
class WorkloadSpec:
    """Per-request shape distribution (arrival processes are separate).

    ``prompt_len`` / ``max_new`` are inclusive ``(lo, hi)`` ranges;
    ``max_new`` draws are additionally clamped so every request satisfies
    ``prompt_len + max_new <= max_len`` (the scheduler's submit contract).
    ``widths`` is the hyper-scaling width choice set, weighted by
    ``width_weights`` (uniform when None).  Prompt tokens are drawn from
    ``[3, vocab)`` — clear of pad(0), the synthetic "="(1) marker, and any
    small reserved ids — and never contain ``eos_id``."""

    vocab: int
    max_len: int
    prompt_len: Tuple[int, int] = (4, 12)
    max_new: Tuple[int, int] = (2, 6)
    widths: Tuple[int, ...] = (1,)
    width_weights: Optional[Tuple[float, ...]] = None
    eos_id: Optional[int] = None
    deadline: Optional[int] = None

    def __post_init__(self):
        if self.prompt_len[0] < 1 or self.prompt_len[0] > self.prompt_len[1]:
            raise ValueError(f"bad prompt_len range {self.prompt_len}")
        if self.max_new[0] < 1 or self.max_new[0] > self.max_new[1]:
            raise ValueError(f"bad max_new range {self.max_new}")
        if self.prompt_len[1] + self.max_new[0] > self.max_len:
            raise ValueError(
                f"prompt_len hi {self.prompt_len[1]} + max_new lo "
                f"{self.max_new[0]} exceeds max_len {self.max_len}: "
                "some draws could never be submitted")
        if self.width_weights is not None \
                and len(self.width_weights) != len(self.widths):
            raise ValueError("width_weights length != widths length")


# -- arrival processes -------------------------------------------------------


def poisson_arrivals(seed: int, n: int, rate: float) -> np.ndarray:
    """``n`` sorted integer arrival ticks, exponential inter-arrivals at
    ``rate`` requests/tick (open-loop Poisson process)."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.floor(np.cumsum(gaps)).astype(np.int64)


def burst_arrivals(seed: int, n: int, *, rate: float, on_ticks: int,
                   off_ticks: int) -> np.ndarray:
    """On/off-modulated Poisson: arrivals land only inside ``on_ticks``-long
    busy windows separated by ``off_ticks`` of silence.  Drawn by running a
    Poisson process over *busy time* and re-mapping each arrival into its
    on-window (so the within-burst rate is exactly ``rate``)."""
    if on_ticks < 1 or off_ticks < 0:
        raise ValueError("need on_ticks >= 1, off_ticks >= 0")
    busy = poisson_arrivals(seed, n, rate)
    cycle, ooff = np.divmod(busy, on_ticks)
    return (cycle * (on_ticks + off_ticks) + ooff).astype(np.int64)


# -- request synthesis -------------------------------------------------------


def _draw_prompt(rng: np.random.Generator, spec: WorkloadSpec,
                 length: int) -> np.ndarray:
    toks = rng.integers(3, spec.vocab, size=(length,)).astype(np.int32)
    if spec.eos_id is not None and 3 <= spec.eos_id < spec.vocab:
        toks[toks == spec.eos_id] = 2      # prompts never contain EOS
    return toks


def _draw_width(rng: np.random.Generator, spec: WorkloadSpec) -> int:
    if len(spec.widths) == 1:
        return int(spec.widths[0])
    p = None
    if spec.width_weights is not None:
        w = np.asarray(spec.width_weights, np.float64)
        p = w / w.sum()
    return int(rng.choice(np.asarray(spec.widths), p=p))


def requests_from_arrivals(seed: int, arrivals: Sequence[int],
                           spec: WorkloadSpec, *,
                           uid_base: int = 0) -> List[Request]:
    """Flesh out arrival ticks into full ``Request``\\ s: per-request prompt
    length, prompt tokens, output budget, and width, all from one seeded
    stream.  uids are sequential in arrival order."""
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    for i, arr in enumerate(np.sort(np.asarray(arrivals, np.int64))):
        plen = int(rng.integers(spec.prompt_len[0], spec.prompt_len[1] + 1))
        hi = min(spec.max_new[1], spec.max_len - plen)
        mnew = int(rng.integers(spec.max_new[0], hi + 1))
        out.append(Request(
            uid=uid_base + i, prompt=_draw_prompt(rng, spec, plen),
            max_new=mnew, width=_draw_width(rng, spec),
            eos_id=spec.eos_id, arrival=int(arr), deadline=spec.deadline))
    return out


def poisson_trace(seed: int, n: int, *, rate: float,
                  spec: WorkloadSpec) -> List[Request]:
    """Poisson arrivals + per-request shapes from one seed."""
    return requests_from_arrivals(
        seed ^ 0xA11CE, poisson_arrivals(seed, n, rate), spec)


def burst_trace(seed: int, n: int, *, rate: float, on_ticks: int,
                off_ticks: int, spec: WorkloadSpec) -> List[Request]:
    """Bursty on/off arrivals + per-request shapes from one seed — the
    2× overload shape ``benchmarks/slo_harness.py`` calibrates against."""
    return requests_from_arrivals(
        seed ^ 0xA11CE,
        burst_arrivals(seed, n, rate=rate, on_ticks=on_ticks,
                       off_ticks=off_ticks), spec)


def multi_turn_trace(seed: int, *, sessions: int, turns: int,
                     spec: WorkloadSpec, session_rate: float = 0.25,
                     think_ticks: int = 4) -> List[Request]:
    """Multi-turn chat sessions that re-hit their own prefixes.

    Each session opens at a Poisson arrival; turn ``k``'s prompt is turn
    ``k-1``'s prompt, plus a simulated assistant reply (``max_new`` tokens —
    the context grows the way a real chat transcript does), plus a fresh
    user message.  Later turns therefore share their whole history as a
    radix-cache prefix.  A session stops early when its next turn could no
    longer fit ``max_len``; turns are spaced ``think_ticks`` apart (plus
    jitter).  uids are sequential in arrival order across all sessions."""
    if sessions < 1 or turns < 1:
        raise ValueError("need sessions >= 1 and turns >= 1")
    rng = np.random.default_rng(seed ^ 0x5E55)
    opens = poisson_arrivals(seed, sessions, session_rate)
    drafts = []                      # (arrival, prompt, max_new, width)
    for s in range(sessions):
        plen = int(rng.integers(spec.prompt_len[0], spec.prompt_len[1] + 1))
        prompt = _draw_prompt(rng, spec, plen)
        arr = int(opens[s])
        for _ in range(turns):
            hi = min(spec.max_new[1], spec.max_len - len(prompt))
            if hi < spec.max_new[0]:
                break                # context full: session ends early
            mnew = int(rng.integers(spec.max_new[0], hi + 1))
            drafts.append((arr, prompt, mnew, _draw_width(rng, spec)))
            # next turn extends the full context: prior prompt + the
            # assistant's reply + a fresh user message
            reply = _draw_prompt(rng, spec, mnew)
            user = _draw_prompt(
                rng, spec,
                int(rng.integers(spec.prompt_len[0], spec.prompt_len[1] + 1)))
            prompt = np.concatenate([prompt, reply, user])
            arr += think_ticks + int(rng.integers(0, 3))
    drafts.sort(key=lambda d: d[0])
    return [Request(uid=i, prompt=p, max_new=m, width=w, eos_id=spec.eos_id,
                    arrival=a, deadline=spec.deadline)
            for i, (a, p, m, w) in enumerate(drafts)]


def trace_summary(reqs: Sequence[Request]) -> Dict[str, float]:
    """Offered-load accounting for calibrating over/under-load: total
    tokens the trace asks for and the tick span it asks them over."""
    if not reqs:
        return {"requests": 0, "span_ticks": 0, "prompt_tokens": 0,
                "max_new_tokens": 0, "mean_width": 0.0,
                "offered_tokens_per_tick": 0.0}
    span = max(r.arrival for r in reqs) - min(r.arrival for r in reqs) + 1
    prompt_toks = sum(len(r.prompt) for r in reqs)
    gen_toks = sum(r.max_new * r.width for r in reqs)
    return {
        "requests": len(reqs),
        "span_ticks": int(span),
        "prompt_tokens": int(prompt_toks),
        "max_new_tokens": int(gen_toks),
        "mean_width": float(np.mean([r.width for r in reqs])),
        "offered_tokens_per_tick": float((prompt_toks + gen_toks) / span),
    }
