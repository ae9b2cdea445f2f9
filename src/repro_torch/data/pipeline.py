"""Deterministic, index-based, shardable data pipeline (numpy only).

A copy of the reference's ``repro.data.pipeline``: the port imports nothing
of that package, and the same ``(seed, step)`` gives the same batch in both.

Every batch is a pure function of ``(seed, step, shard)`` — no iterator
state.  This is the straggler/fault-tolerance story: any worker can
recompute any shard of any step after a restart (no data-loader checkpoint
needed), and elastic re-sharding is just a different ``num_shards``.

Two sources:
* synthetic LM streams with controllable structure (used by tests, examples,
  and the retrofit benchmarks — see :mod:`repro.data.tasks` for reasoning
  tasks with verifiable answers), and
* a memory-mapped token-file source for real corpora.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic_lm"        # synthetic_lm | copy_task | token_file
    accum_steps: int = 1
    token_file: Optional[str] = None
    # synthetic stream structure: local n-gram correlations so models can
    # actually learn something (loss decreases)
    ngram_order: int = 3


def _rng_for(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard, 0xD5]))


def _synthetic_tokens(cfg: DataConfig, rng: np.random.Generator,
                      batch: int) -> np.ndarray:
    """Markov stream: token_t depends on token_{t-1} through a fixed mixing
    permutation, with noise — learnable but non-trivial."""
    v = cfg.vocab_size
    perm_rng = np.random.default_rng(cfg.seed + 1)
    perm = perm_rng.permutation(v)
    toks = np.empty((batch, cfg.seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, v, size=batch)
    noise = rng.random((batch, cfg.seq_len))
    rand_tok = rng.integers(0, v, size=(batch, cfg.seq_len))
    for t in range(1, cfg.seq_len + 1):
        follow = perm[toks[:, t - 1]]
        toks[:, t] = np.where(noise[:, t - 1] < 0.75, follow, rand_tok[:, t - 1])
    return toks


def _copy_tokens(cfg: DataConfig, rng: np.random.Generator, batch: int) -> np.ndarray:
    """needle/copy structure: first half random, second half repeats it —
    exercises long-range retrieval (the NIAH-style stress for DMS)."""
    v = cfg.vocab_size
    half = (cfg.seq_len + 1) // 2
    first = rng.integers(2, v, size=(batch, half))
    toks = np.concatenate([first, first], axis=1)[:, :cfg.seq_len + 1]
    return toks.astype(np.int32)


def make_batch(cfg: DataConfig, step: int, shard: int = 0,
               num_shards: int = 1) -> Dict[str, np.ndarray]:
    """Global batch for ``step`` (or one shard of it)."""
    assert cfg.global_batch % num_shards == 0
    b = cfg.global_batch // num_shards
    rng = _rng_for(cfg, step, shard)
    if cfg.kind == "copy_task":
        toks = _copy_tokens(cfg, rng, b)
    elif cfg.kind == "token_file" and cfg.token_file:
        data = np.memmap(cfg.token_file, dtype=np.int32, mode="r")
        n_windows = (len(data) - 1) // cfg.seq_len
        idx = rng.integers(0, n_windows, size=b)
        toks = np.stack([data[i * cfg.seq_len:(i + 1) * cfg.seq_len + 1]
                         for i in idx]).astype(np.int32)
    else:
        toks = _synthetic_tokens(cfg, rng, b)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.accum_steps > 1:
        k = cfg.accum_steps
        batch = {n: a.reshape(k, b // k, *a.shape[1:]) for n, a in batch.items()}
    return batch


def batch_iterator(cfg: DataConfig, start_step: int = 0, shard: int = 0,
                   num_shards: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, step, shard, num_shards)
        step += 1
