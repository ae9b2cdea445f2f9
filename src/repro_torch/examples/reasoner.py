"""The trained chain-arithmetic reasoner of the hyper-scaling demo: the
reference's recipe (``benchmarks/pareto.py::_trained_reasoner``) step for
step on the port.

The smoke ``qwen-r1-1.5b`` at vocab 64 (2 layers, d 64, 4/2 heads of Dh
16) learns ``chain_arith`` (prompts of 32 tokens, chains of 5) by
supervised pretraining with attention vanilla, then is DMS-retrofitted by
logit distillation from a frozen copy of itself (paper §4), so that its own
learned α decides evictions when it serves.

Each stage is a generator of (params, metrics) a step
(:func:`pretrain_steps`, :func:`retrofit_steps`; the params are updated in
place); :func:`trained_reasoner` runs both to their ends.  On the card the
attention of every training step (the teacher's forward too) goes through
the port's flash kernels unless ``use_kernel=False``.

The port's init and its Gumbel noise come from torch generators, not the
reference's threefry streams, so without ``params=`` and ``uniforms_fn=``
this is the reference's recipe under other random draws.  The tests hand
in the reference's initial weights and its per-layer uniforms.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.configs import get_smoke
from repro_torch.core.config import ArchConfig, DMSConfig
from repro_torch.core.tree import tree_map
from repro_torch.data import tasks
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw

BATCH = 32
PRETRAIN_OPT = dict(lr=2e-3, warmup_steps=20)
RETROFIT_OPT = dict(lr=1e-3, warmup_steps=10)
RETROFIT_SEED = 10_000          # the retrofit's batches: steps 10 000 + s

UniformsFn = Callable[[int], Sequence[torch.Tensor]]


def reasoner_config(steps: int = 260, window: int = 4, target_cr: float = 4.0,
                    seed: int = 0) -> Tuple[ArchConfig, tasks.TaskConfig]:
    """The retrofit's arch (DMS on, its CR ramp over ``steps // 8`` steps a
    unit, at least 5) and the task."""
    arch = dataclasses.replace(
        get_smoke("qwen-r1-1.5b"), vocab_size=64,
        dms=DMSConfig(enabled=True, window=window, target_cr=target_cr,
                      steps_per_cr_unit=max(steps // 8, 5)))
    task = tasks.TaskConfig(kind="chain_arith", vocab_size=64, prompt_len=32,
                            chain_len=5, seed=seed)
    return arch, task


def pretrain_arch(arch: ArchConfig) -> ArchConfig:
    """The supervised stage's arch: DMS off."""
    return dataclasses.replace(arch, dms=DMSConfig(enabled=False))


def _batch(task: tasks.TaskConfig, step: int,
           device) -> Dict[str, torch.Tensor]:
    """``make_train_batch``'s tokens and labels only: the reference drops
    its ``loss_mask``, so the loss covers every position."""
    b = tasks.make_train_batch(task, step, BATCH)
    return {k: torch.from_numpy(b[k]).to(device) for k in ("tokens", "labels")}


def pretrain_steps(arch: ArchConfig, task: tasks.TaskConfig, params: Any,
                   steps: int, *, use_kernel: bool = False
                   ) -> Iterator[Tuple[Any, Dict[str, torch.Tensor]]]:
    """``steps`` LM train steps of the DMS-off ``arch`` on batches 0, 1, ...
    (AdamW at lr 2e-3, 20 warmup steps, cosine over ``steps``)."""
    device = params["embed"].device
    opt = adamw.init(params)
    step_fn = steps_lib.make_train_step(
        arch, adamw.AdamWConfig(total_steps=steps, **PRETRAIN_OPT),
        use_kernel=use_kernel)
    for s in range(steps):
        params, opt, m = step_fn(params, opt, _batch(task, s, device), s)
        yield params, m


def retrofit_steps(arch: ArchConfig, task: tasks.TaskConfig, params: Any,
                   steps: int, *, use_kernel: bool = False,
                   uniforms_fn: Optional[UniformsFn] = None
                   ) -> Iterator[Tuple[Any, Dict[str, torch.Tensor]]]:
    """``steps`` DMS retrofit steps from ``params``, distilled from a frozen
    copy of them, on batches 10 000, 10 001, ... (a fresh AdamW at lr 1e-3,
    10 warmup steps, cosine over ``steps``).  ``uniforms_fn(step)`` gives
    a step's per-layer Gumbel uniforms; by default the step draws its own."""
    device = params["embed"].device
    teacher = tree_map(torch.clone, params)
    opt = adamw.init(params)
    step_fn = steps_lib.make_retrofit_step(
        arch, adamw.AdamWConfig(total_steps=steps, **RETROFIT_OPT),
        use_kernel=use_kernel)
    for s in range(steps):
        uniforms = uniforms_fn(s) if uniforms_fn is not None else None
        params, opt, m = step_fn(params, teacher, opt,
                                 _batch(task, RETROFIT_SEED + s, device), s,
                                 uniforms=uniforms)
        yield params, m


def _history(metrics: List[Dict[str, torch.Tensor]], device
             ) -> List[Dict[str, float]]:
    """Per-step metrics as floats, read to the host once for the stage."""
    if not metrics:
        return []
    keys = list(metrics[0])
    rows = torch.stack([torch.stack([
        torch.as_tensor(m[k], device=device).float() for k in keys])
        for m in metrics])
    return [dict(zip(keys, row)) for row in rows.tolist()]


def trained_reasoner(steps: int = 260, window: int = 4,
                     target_cr: float = 4.0, seed: int = 0, *,
                     device: DeviceLike = None,
                     use_kernel: Optional[bool] = None,
                     params: Optional[Any] = None,
                     uniforms_fn: Optional[UniformsFn] = None):
    """Pretrain ``steps`` steps, then retrofit ``steps // 2``.  Returns
    ``(arch, params, task, alpha_mean of the last retrofit step, history)``
    with ``history = {"pretrain": [...], "retrofit": [...]}``, each step's
    metrics as floats.  ``params`` (fp32, on ``device``) replaces the
    seeded init; ``use_kernel`` defaults to on for the card."""
    dev = resolve_device(device)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    arch, task = reasoner_config(steps, window, target_cr, seed)
    base = pretrain_arch(arch)
    if params is None:
        params = tfm.init_model(base, seed=seed, device=dev,
                                dtype=torch.float32)
    pre, ret = [], []
    for params, m in pretrain_steps(base, task, params, steps,
                                    use_kernel=use_kernel):
        pre.append(m)
    for params, m in retrofit_steps(arch, task, params, steps // 2,
                                    use_kernel=use_kernel,
                                    uniforms_fn=uniforms_fn):
        ret.append(m)
    history = {"pretrain": _history(pre, dev), "retrofit": _history(ret, dev)}
    alpha = history["retrofit"][-1]["alpha_mean"] if ret else 0.0
    return arch, params, task, alpha, history
