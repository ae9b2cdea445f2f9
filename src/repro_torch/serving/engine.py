"""Serving engine of the port: scheduler-driven continuous batching over
DMS-compressed slot arenas, the shared-prefill hyperscale fork, and exact
budget metering (the reference ``repro.serving.engine``).

A request asks for W parallel chains of up to L tokens at compression CR;
the engine provisions slot arenas of ``P ≈ L/CR + w`` per kv head (or, with
``KVPolicyConfig(paged=True)``, a shared page pool that lanes draw blocks
from as they write them), decodes with the compressed cache through the
block-table flash-decode kernel, and reports the paper's two budget metrics
(KV reads, peak tokens) measured from the real cache state.
:func:`evaluate_hyperscale` scores one L-W-CR point of the paper's
accuracy-versus-budget comparison over an eval set.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.config import ArchConfig, KVPolicyConfig
from repro_torch.core.hyperscale import (BudgetMeter, ScalingConfig,
                                         majority_vote)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.scheduler import (Request, RequestResult, Scheduler,
                                           make_chunk_fn)


@dataclass
class GenerationResult:
    tokens: np.ndarray            # (W, L_gen)
    meter: BudgetMeter
    requests: List[RequestResult] = field(default_factory=list)


class Engine:
    """Single-device engine.  ``params`` must already live on ``device``
    (``init_model`` or ``bridge.params_from_numpy`` with the same device).
    ``use_kernel=True`` attends through the hand-written CUDA kernel on the
    card and through its plain version on the CPU."""

    def __init__(self, arch: ArchConfig, params, policy: KVPolicyConfig,
                 use_kernel: bool = True, temperature: float = 0.0,
                 chunk: int = 8, device: DeviceLike = None):
        self.device = resolve_device(device)
        embed = params["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(f"params live on {embed.device}, the engine runs "
                             f"on {self.device}")
        self.arch = arch
        self.params = params
        self.policy = policy
        self.use_kernel = use_kernel
        self.temperature = temperature
        self.chunk = chunk
        # shared by every scheduler of this engine; counts decode steps
        self.chunk_fn = make_chunk_fn(arch, use_kernel=use_kernel,
                                      temperature=temperature)

    def scheduler(self, num_lanes: int, max_len: int, *, seed: int = 0,
                  chunk: Optional[int] = None, faults: Any = None,
                  on_pressure: str = "preempt",
                  oversub: float = 1.0) -> Scheduler:
        """A lane arena bound to this engine's chunk step.  ``seed`` seeds
        its sampling keys; ``faults`` attaches a
        :class:`~repro_torch.serving.faults.FaultPlan`; ``on_pressure`` and
        ``oversub`` configure the preemption layer (see
        :class:`Scheduler`)."""
        return Scheduler(self.arch, self.params, self.policy, self.chunk_fn,
                         num_lanes=num_lanes, max_len=max_len,
                         chunk=chunk or self.chunk, device=self.device,
                         faults=faults, on_pressure=on_pressure,
                         oversub=oversub, seed=seed)

    def generate(self, prompts: np.ndarray, max_new: int, seed: int = 0,
                 eos_id: Optional[int] = None) -> GenerationResult:
        """prompts: (B, T0) int32 — B requests served concurrently, one lane
        each.  Output rows are padded with ``eos_id`` (or 0) past each
        chain's end."""
        b, t0 = prompts.shape
        sched = self.scheduler(b, t0 + max_new, seed=seed)
        for i in range(b):
            sched.submit(Request(uid=i, prompt=np.asarray(prompts[i]),
                                 max_new=max_new, eos_id=eos_id))
        results = {r.uid: r for r in sched.run()}
        pad = eos_id if eos_id is not None else 0
        tokens = np.stack([
            _pad_chain(results[i].tokens[0], results[i].lengths[0], max_new, pad)
            for i in range(b)])
        meter = BudgetMeter()
        for i in range(b):            # concurrent requests: co-resident lanes
            meter = meter.merge(results[i].meter)
        return GenerationResult(tokens=tokens, meter=meter,
                                requests=[results[i] for i in range(b)])

    def hyperscale_generate(self, prompt: np.ndarray, cfg: ScalingConfig,
                            seed: int = 0) -> GenerationResult:
        """One problem, W parallel chains: the prompt prefills once and the
        cache forks into W chains (prefill reads W× lower than W prefills)."""
        max_new = cfg.max_len - int(prompt.shape[0])
        sched = self.scheduler(cfg.width, cfg.max_len, seed=seed)
        sched.submit(Request(uid=0, prompt=np.asarray(prompt), max_new=max_new,
                             width=cfg.width, eos_id=cfg.eos_id))
        res = sched.run()[0]
        return GenerationResult(tokens=res.tokens, meter=res.meter,
                                requests=[res])


def _pad_chain(chain: np.ndarray, length: int, max_new: int,
               pad: int) -> np.ndarray:
    out = np.full((max_new,), pad, np.int32)
    out[:length] = chain[:length]
    return out


def answer_from_chain(chain: np.ndarray, eq_token: int = 1) -> Optional[int]:
    """The answer token of a chain: the token right after the last
    ``eq_token`` ("="), else the chain's first token."""
    chain = np.asarray(chain)
    if len(chain) == 0:
        return None
    eq_pos = np.where(chain[:-1] == eq_token)[0]
    if len(eq_pos):
        return int(chain[eq_pos[-1] + 1])
    return int(chain[0])


def evaluate_hyperscale(engine: Engine, prompts: np.ndarray,
                        answers: np.ndarray, cfg: ScalingConfig,
                        seed: int = 0, eq_token: int = 1) -> Dict[str, Any]:
    """Accuracy and budget over an eval set for one L-W-CR point: problem
    ``i`` runs its W chains with seed ``seed + i`` and answers by majority
    vote over the chains; the meters are averaged over problems."""
    meter = BudgetMeter()
    hits = 0
    for i in range(len(prompts)):
        res = engine.hyperscale_generate(prompts[i], cfg, seed=seed + i)
        votes = [answer_from_chain(res.tokens[w], eq_token=eq_token)
                 for w in range(cfg.width)]
        pred = majority_vote([str(v) for v in votes if v is not None])
        hits += int(pred is not None and int(pred) == int(answers[i]))
        meter = meter.merge(res.meter)
    n = max(len(prompts), 1)
    return {
        "accuracy": hits / n,
        "kv_reads": meter.kv_reads / n,
        "peak_tokens": meter.peak_tokens / n,
        "peak_bytes": meter.peak_bytes / n,
        "config": cfg.label,
    }
