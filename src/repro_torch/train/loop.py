"""Training loop with fault tolerance: auto-resume, async checkpoints,
preemption handling, deterministic data, and the two-phase DMS retrofit —
the reference's ``repro.train.loop`` on the port's eager steps.
"""
from __future__ import annotations

import signal
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.config import ArchConfig
from repro_torch.core.tree import tree_map
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw


@dataclass
class TrainConfig:
    total_steps: int = 200
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_last: int = 2
    seed: int = 0
    retrofit: bool = False           # DMS retrofit (distill from vanilla self)
    phase1_steps: int = 0            # borrowed-neuron zeroing prologue
    accum_steps: int = 1
    use_kernel: bool = False
    remat: bool = False


class PreemptionGuard:
    """SIGTERM → checkpoint-now-and-exit (cluster preemption style)."""

    def __init__(self):
        self.requested = False
        try:
            signal.signal(signal.SIGTERM, self._handler)
        except ValueError:
            pass  # non-main thread (tests)

    def _handler(self, *_):
        self.requested = True


def train(arch: ArchConfig, data_cfg: DataConfig, cfg: TrainConfig,
          opt_cfg: Optional[adamw.AdamWConfig] = None,
          params: Optional[Any] = None,
          log_fn: Optional[Callable[[Dict], None]] = None,
          device: DeviceLike = None) -> Dict[str, Any]:
    """Returns {params, opt_state, history, resumed_from, teacher}.

    Params are fp32 (``init_model(dtype=float32)`` from ``cfg.seed``
    unless given) and are updated in place.  Runs on the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        lr=1e-3, warmup_steps=20, total_steps=cfg.total_steps)
    if params is None:
        params = tfm.init_model(arch, seed=cfg.seed, device=dev,
                                dtype=torch.float32)
    opt_state = adamw.init(params)
    teacher = None
    if cfg.retrofit:
        teacher = tree_map(torch.clone, params)
        step_fn = steps_lib.make_retrofit_step(
            arch, opt_cfg, remat=cfg.remat, use_kernel=cfg.use_kernel)
        phase1_fn = steps_lib.make_retrofit_step(
            arch, opt_cfg, remat=cfg.remat, use_kernel=cfg.use_kernel,
            phase1=True)
    else:
        step_fn = steps_lib.make_train_step(
            arch, opt_cfg, dms_train=arch.dms.enabled, remat=cfg.remat,
            use_kernel=cfg.use_kernel, accum_steps=cfg.accum_steps)

    mgr = CheckpointManager(cfg.ckpt_dir, keep_last=cfg.keep_last) \
        if cfg.ckpt_dir else None
    start = 0
    resumed_from = None
    if mgr is not None and mgr.latest_step() is not None:
        (params, opt_state), start, _ = mgr.restore((params, opt_state))
        resumed_from = start

    guard = PreemptionGuard()
    history = []
    for step in range(start, cfg.total_steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in make_batch(data_cfg, step).items()}
        if cfg.retrofit:
            fn = phase1_fn if step < cfg.phase1_steps else step_fn
            params, opt_state, metrics = fn(params, teacher, opt_state,
                                            batch, step)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            history.append(m)
            if log_fn:
                log_fn(m)
        want_ckpt = mgr is not None and (
            (step + 1) % cfg.ckpt_every == 0 or guard.requested
            or step == cfg.total_steps - 1)
        if want_ckpt:
            mgr.save(step + 1, (params, opt_state), blocking=False)
        if guard.requested:
            if mgr:
                mgr.wait()
            break
    if mgr:
        mgr.wait()
    return {"params": params, "opt_state": opt_state, "history": history,
            "resumed_from": resumed_from, "teacher": teacher}
