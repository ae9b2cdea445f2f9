"""Inference-time hyper-scaling bookkeeping (paper §2.1, §5.1), numpy only.

A scaling configuration is an ``L-W-CR`` tuple: max sequence length L,
number of parallel reasoning chains W, compression ratio CR.  The two budget
metrics the paper plots against accuracy are metered by :class:`BudgetMeter`:

* **KV cache token reads** — Σ over decode steps of the live cache items
  attended to (summed over layers, averaged over kv heads).
* **Peak tokens in memory** — max over time of the total live cache size.

A copy of the reference's ``repro.core.hyperscale`` subset the serving path
needs, so that meters compare equal field by field.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class ScalingConfig:
    """One L-W-CR point.  ``eos_id`` enables EOS-driven early exit (None =
    decode the full budget, the paper's fixed-L accounting)."""

    max_len: int
    width: int
    cr: float = 1.0
    eos_id: Optional[int] = None


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


def majority_vote(answers: Sequence[Optional[str]]) -> Optional[str]:
    votes = [a for a in answers if a is not None]
    if not votes:
        return None
    return collections.Counter(votes).most_common(1)[0][0]
