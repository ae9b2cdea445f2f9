"""Synthetic reasoning tasks with verifiable answers: the accuracy side of
the hyper-scaling comparison (stand-ins for AIME/GPQA/LiveCodeBench, which
need trained checkpoints).

The port's own copy of the reference's ``repro.data.tasks`` (numpy only),
so that both packages draw the same problems from the same seed.  Each
task emits (prompt tokens, answer token); a model solves it by generating
after the prompt:

* ``chain_arith`` — mod-K addition chains: answer = (sum of operands) mod
  K.  Sampling W parallel chains and majority voting improves accuracy
  (parallel scaling, paper §5.1).
* ``needle`` — retrieve a token planted earlier in context (NIAH-like,
  §5.2): stresses exactly what aggressive KV eviction can break.
* ``var_track`` — variable-chain tracking (RULER VT-like, §5.2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

SEP, EQ, PAD = 0, 1, 2  # reserved token ids
FIRST_SYM = 3


@dataclass(frozen=True)
class TaskConfig:
    kind: str = "chain_arith"   # chain_arith | needle | var_track
    vocab_size: int = 64
    prompt_len: int = 48
    chain_len: int = 6          # reasoning "depth" knob
    modulus: int = 10
    seed: int = 0


def sample_problem(cfg: TaskConfig, rng: np.random.Generator) -> Tuple[np.ndarray, int]:
    v = cfg.vocab_size
    if cfg.kind == "needle":
        needle_pos = rng.integers(1, cfg.prompt_len - 4)
        key = rng.integers(FIRST_SYM, v)
        toks = rng.integers(FIRST_SYM, v, size=cfg.prompt_len)
        toks[needle_pos] = key
        toks[needle_pos - 1] = SEP          # marker before the needle
        toks[-2] = SEP                      # query marker
        toks[-1] = EQ
        return toks.astype(np.int32), int(key)
    if cfg.kind == "var_track":
        # chain: x0 = c; x1 = x0; ...; query final variable's value
        n_vars = cfg.chain_len
        names = rng.choice(np.arange(FIRST_SYM, FIRST_SYM + 20), n_vars, replace=False)
        value = rng.integers(FIRST_SYM + 20, min(v, FIRST_SYM + 20 + cfg.modulus))
        toks: List[int] = []
        toks += [int(names[0]), EQ, int(value), SEP]
        for i in range(1, n_vars):
            toks += [int(names[i]), EQ, int(names[i - 1]), SEP]
        toks += [int(names[-1]), EQ]
        arr = np.full(cfg.prompt_len, PAD, np.int32)
        arr[-len(toks):] = toks[-cfg.prompt_len:]
        return arr, int(value)
    # chain_arith
    ops = rng.integers(0, cfg.modulus, size=cfg.chain_len)
    ans = int(ops.sum() % cfg.modulus)
    toks: List[int] = []
    for o in ops:
        toks += [FIRST_SYM + int(o), SEP]
    toks += [EQ]
    arr = np.full(cfg.prompt_len, PAD, np.int32)
    arr[-len(toks):] = toks[-cfg.prompt_len:]
    return arr, FIRST_SYM + ans


def answer_token(cfg: TaskConfig, ans: int) -> int:
    return ans


def make_eval_set(cfg: TaskConfig, n: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(cfg.seed + 1234)
    prompts = np.stack([sample_problem(cfg, rng)[0] for _ in range(n)])
    rng = np.random.default_rng(cfg.seed + 1234)
    answers = np.array([sample_problem(cfg, rng)[1] for _ in range(n)], np.int32)
    return prompts, answers


def make_train_batch(cfg: TaskConfig, step: int, batch: int
                     ) -> Dict[str, np.ndarray]:
    """Supervised next-token data: prompt followed by the answer token."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    toks = np.empty((batch, cfg.prompt_len + 1), np.int32)
    for i in range(batch):
        p, a = sample_problem(cfg, rng)
        toks[i, :-1] = p
        toks[i, -1] = a
    x = toks[:, :-1]
    y = toks[:, 1:]
    mask = np.zeros_like(y, np.float32)
    mask[:, -1] = 1.0                       # loss on the answer position only
    return {"tokens": x, "labels": y, "loss_mask": mask}
