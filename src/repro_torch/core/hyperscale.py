"""Inference-time hyper-scaling bookkeeping (paper §2.1, §5.1), numpy only.

A scaling configuration is an ``L-W-CR`` tuple: max sequence length L,
number of parallel reasoning chains W, compression ratio CR.  The two budget
metrics the paper plots against accuracy are metered by :class:`BudgetMeter`:

* **KV cache token reads** — Σ over decode steps of the live cache items
  attended to (summed over layers, averaged over kv heads).
* **Peak tokens in memory** — max over time of the total live cache size.

The port's own copy of the reference's ``repro.core.hyperscale`` (numpy
only), so that meters compare equal field by field: the meter, the
closed-form budget (:func:`analytic_budget`), answer aggregation (majority
vote, pass@all, exact match) and the scaling grid's Pareto utilities.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ScalingConfig:
    """One L-W-CR point.  ``eos_id`` enables EOS-driven early exit (None =
    decode the full budget, the paper's fixed-L accounting)."""

    max_len: int
    width: int
    cr: float = 1.0
    eos_id: Optional[int] = None

    @property
    def label(self) -> str:
        return f"{self.max_len // 1024}-{self.width}-{self.cr:g}"


@dataclass
class BudgetMeter:
    """Accumulates the paper's two budget metrics during generation:
    ``kv_reads`` integrates ``reads_tokens`` over steps, ``peak_tokens``
    tracks the max of ``live_tokens``."""

    kv_reads: float = 0.0
    kv_reads_saved: float = 0.0   # prefill reads avoided via prefix-cache hits
    peak_tokens: float = 0.0
    peak_bytes: float = 0.0       # physical arena bytes (static per state)
    steps: int = 0
    generated_tokens: int = 0

    def observe_step(self, live_tokens_per_layer: Sequence[float],
                     new_tokens: int = 1,
                     reads_tokens_per_layer: Optional[Sequence[float]] = None):
        """``reads_tokens_per_layer`` defaults to live (the dense-read case)."""
        live = float(np.sum(live_tokens_per_layer))
        reads = (live if reads_tokens_per_layer is None
                 else float(np.sum(reads_tokens_per_layer)))
        self.kv_reads += reads
        self.peak_tokens = max(self.peak_tokens, live)
        self.steps += 1
        self.generated_tokens += new_tokens

    def observe_peak_bytes(self, nbytes: float):
        self.peak_bytes = max(self.peak_bytes, float(nbytes))

    def merge(self, other: "BudgetMeter") -> "BudgetMeter":
        """Concurrent merge: co-resident lanes, so peak memory adds."""
        return BudgetMeter(
            kv_reads=self.kv_reads + other.kv_reads,
            kv_reads_saved=self.kv_reads_saved + other.kv_reads_saved,
            peak_tokens=self.peak_tokens + other.peak_tokens,
            peak_bytes=self.peak_bytes + other.peak_bytes,
            steps=max(self.steps, other.steps),
            generated_tokens=self.generated_tokens + other.generated_tokens,
        )

    def merge_sequential(self, other: "BudgetMeter") -> "BudgetMeter":
        """Sequential merge: ``other`` ran after self on the same lanes
        (prefill then decode), so peak memory is the max, reads add."""
        return BudgetMeter(
            kv_reads=self.kv_reads + other.kv_reads,
            kv_reads_saved=self.kv_reads_saved + other.kv_reads_saved,
            peak_tokens=max(self.peak_tokens, other.peak_tokens),
            peak_bytes=max(self.peak_bytes, other.peak_bytes),
            steps=self.steps + other.steps,
            generated_tokens=self.generated_tokens + other.generated_tokens,
        )


def analytic_budget(seq_len: int, width: int, cr: float, num_layers: int,
                    window: int = 0) -> Tuple[float, float]:
    """Closed-form (kv_reads, peak_tokens), summed over W chains and L
    layers, for a model that hits its target CR exactly: after t tokens it
    holds ``t`` up to the window, then ``window + (t - window) / CR``."""
    t = np.arange(1, seq_len + 1, dtype=np.float64)
    live = np.where(t <= window, t, window + (t - window) / cr)
    reads = float(live.sum()) * num_layers * width
    peak = float(live[-1]) * num_layers * width
    return reads, peak


# ---------------------------------------------------------------------------
# answer aggregation
# ---------------------------------------------------------------------------


def majority_vote(answers: Sequence[Optional[str]]) -> Optional[str]:
    votes = [a for a in answers if a is not None]
    if not votes:
        return None
    return collections.Counter(votes).most_common(1)[0][0]


def pass_at_all(per_chain_pass: Sequence[bool]) -> bool:
    return any(per_chain_pass)


def exact_match_accuracy(predictions: Sequence[Optional[str]],
                         targets: Sequence[str]) -> float:
    hits = sum(1 for p, t in zip(predictions, targets)
               if p is not None and p == t)
    return hits / max(len(targets), 1)


# ---------------------------------------------------------------------------
# scaling grid / Pareto utilities
# ---------------------------------------------------------------------------


def default_grid(base_len: int = 1024,
                 crs: Sequence[float] = (1.0,)) -> List[ScalingConfig]:
    return [ScalingConfig(base_len * l_mult, w, cr)
            for cr in crs for l_mult in (1, 2, 4) for w in (1, 2, 4, 8)]


def pareto_frontier(points: Sequence[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """(budget, accuracy) points -> the frontier sorted by budget (each
    point more accurate than every cheaper one)."""
    frontier: List[Tuple[float, float]] = []
    best = -np.inf
    for b, a in sorted(points):
        if a > best:
            frontier.append((b, a))
            best = a
    return frontier


def frontier_margin(a: Sequence[Tuple[float, float]],
                    b: Sequence[Tuple[float, float]]) -> float:
    """Mean accuracy gap of frontier ``a`` over ``b`` on their shared
    budget interval (paper Appendix E): linear interpolation at 128 points
    of a log-budget axis.  Disjoint intervals: ``a``'s best point against
    ``b``'s cheapest if ``a`` lies wholly below ``b`` in budget, else
    NaN."""
    if not a or not b:
        return float("nan")
    lo = max(a[0][0], b[0][0])
    hi = min(a[-1][0], b[-1][0])
    if hi <= lo:
        if a[-1][0] <= b[0][0]:
            return a[-1][1] - b[0][1]
        return float("nan")
    xs = np.exp(np.linspace(np.log(lo), np.log(hi), 128))

    def interp(front, x):
        return np.interp(x, np.array([p[0] for p in front]),
                         np.array([p[1] for p in front]))

    return float(np.mean(interp(a, xs) - interp(b, xs)))
