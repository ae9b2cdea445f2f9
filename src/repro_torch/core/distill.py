"""Retrofitting losses: logit distillation + DMS auxiliary loss (paper §3.2, §4).

The paper retrofits via logit distillation (Hinton et al., 2015): the vanilla
LLM is the teacher, the DMS model the student;  L = L_D + L_aux.
Pad-vocab logits are -1e30 (``models.transformer.lm_logits``), never -inf,
so both log-softmaxes stay finite there and the KL adds zero for them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import dms as dms_lib
from repro_torch.core.config import DMSConfig
from repro_torch.parallel import spmd


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean()
    mask = mask.float()
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def kl_logit_distillation(student_logits: torch.Tensor,
                          teacher_logits: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          temperature: float = 1.0) -> torch.Tensor:
    """KL(teacher || student) averaged over unmasked positions.

    logits: (B, T, V); mask: (B, T) with 1 = count this position.  The
    teacher side carries no gradient."""
    t = temperature
    sp = torch.log_softmax(student_logits.float() / t, dim=-1)
    with torch.no_grad():
        tp = torch.log_softmax(teacher_logits.float() / t, dim=-1)
        pt = torch.exp(tp)
    kl = (pt * (tp - sp)).sum(dim=-1) * (t * t)                    # (B, T)
    return _masked_mean(kl, mask)


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy, ``logsumexp - logit[label]``.  The label's
    logit is gathered, which gives the reference's one-hot contraction's
    values without a (B, T, V) bool tensor (over vocab-sharded DTensor
    logits, vocab-parallel: :func:`repro_torch.parallel.spmd.
    logsumexp_and_pick`).  logits: (B, T, V)."""
    lse, label_logit = spmd.logsumexp_and_pick(logits.float(), labels)
    return _masked_mean(lse - label_logit, mask)


def retrofit_loss(student_logits: torch.Tensor,
                  teacher_logits: Optional[torch.Tensor],
                  labels: torch.Tensor, alpha_sum: torch.Tensor, alpha_count,
                  step, dms_cfg: DMSConfig,
                  mask: Optional[torch.Tensor] = None,
                  distill_weight: float = 1.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full retrofit objective  L = L_D + L_aux  (+ CE fallback without a
    teacher).  Returns (loss, metrics dict of 0-d tensors)."""
    if teacher_logits is not None:
        l_main = kl_logit_distillation(student_logits, teacher_logits,
                                       mask) * distill_weight
    else:
        l_main = lm_cross_entropy(student_logits, labels, mask)
    alpha_sum = torch.as_tensor(alpha_sum, dtype=torch.float32,
                                device=l_main.device)
    l_aux = dms_lib.aux_compression_loss(alpha_sum, alpha_count, step, dms_cfg)
    loss = l_main + l_aux
    count = torch.as_tensor(alpha_count, dtype=torch.float32,
                            device=l_main.device)
    metrics = {
        "loss": loss,
        "loss_main": l_main,
        "loss_aux": l_aux,
        "alpha_mean": alpha_sum / torch.clamp(count, min=1.0),
        "target_alpha": dms_lib.target_alpha(step, dms_cfg),
        "cr_schedule": dms_lib.cr_schedule(step, dms_cfg),
    }
    return loss, metrics
