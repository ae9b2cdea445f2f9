"""AdamW with fp32 moments (and an fp32 master copy when the params are not
fp32) and global-norm clipping, over the port's params dicts — the
reference's ``repro.optim.adamw`` without an optimizer library.

Unlike the reference's pure functions, :func:`apply_updates` updates the
params, moments and master in place (it returns them too): at full width a
second copy of 1.5B fp32 params and moments would cost 18 GB.  With fp32
params the master copy would equal the params, so :func:`init` keeps none
and the update writes the params directly, which gives the same numbers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32, on the CPU
    mu: Any                     # first moment (fp32)
    nu: Any                     # second moment (fp32)
    master: Any                 # fp32 master copy of params, or None


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> float:
    """Linear warmup + cosine decay."""
    step = float(step)
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init(params: Any, keep_master: bool = True) -> AdamWState:
    """Zero moments; a master copy only if some param is not fp32."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    need = keep_master and any(p.dtype != torch.float32
                               for p in tree_leaves(params))
    master = tree_map(lambda p: p.float().clone(), params) if need else None
    return AdamWState(torch.zeros((), dtype=torch.int32), zeros,
                      tree_map(torch.clone, zeros), master)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32) ** 2
          for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: AdamWState,
                  cfg: AdamWConfig
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place; returns (params, state, {grad_norm, lr})."""
    step = int(state.step) + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    lr = schedule(cfg, step)
    c1 = 1 - b1 ** step
    c2 = 1 - b2 ** step
    master = state.master if state.master is not None else params

    for g, m, v, p32, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                               tree_leaves(state.nu), tree_leaves(master),
                               tree_leaves(params)):
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (m / c1).div_(torch.sqrt(v / c2).add_(cfg.eps))
        p32.sub_(u.add_(p32, alpha=cfg.weight_decay).mul_(lr))
        if p is not p32:
            p.copy_(p32)
    new_state = AdamWState(torch.tensor(step, dtype=torch.int32), state.mu,
                           state.nu, state.master)
    return params, new_state, {"grad_norm": gnorm,
                               "lr": torch.tensor(lr, dtype=torch.float32)}
