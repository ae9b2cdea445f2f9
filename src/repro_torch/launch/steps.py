"""Steps: the LM train step, the DMS retrofit step, the prefill step and
the serve step.

The reference's ``repro.launch.steps`` (``make_train_step``,
``make_retrofit_step``, ``make_prefill_step``, ``make_serve_step``)
without ``jit``: each step
runs eagerly; the training steps take the gradient with
:func:`torch.autograd.grad` over the params' leaves and update params and
optimizer state in place (:mod:`repro_torch.optim.adamw`).

Gumbel noise: the reference folds the step into a fixed key (17 for the
train step, 23 for the retrofit step) and splits it per layer.  Here a
fresh :class:`torch.Generator` is seeded from the same pair, so a step
draws the same noise whenever it is run again; or the caller hands the
per-layer uniforms in (``uniforms=``), as the parity tests do with the
reference's own draws.

Every full-forward step passes the batch's ``frontend_embeds`` (prepended
patch embeddings) and ``enc_embeds`` (an encoder–decoder's frame
embeddings) to ``model_forward``, when the batch has them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import distill as distill_lib
from repro_torch.core import dms as dms_lib
from repro_torch.core.config import ArchConfig
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw


def step_generator(key: int, step: int, device) -> torch.Generator:
    """The noise stream of (``key``, ``step``)."""
    return torch.Generator(device=device).manual_seed((key << 32) + int(step))


def _grads(loss_fn, params: Dict[str, Any]):
    """(value, aux, grads tree) of ``loss_fn(params) -> (loss, aux)``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = loss_fn(params)
        flat = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), aux, tree_unflatten(params, flat)


def make_train_step(arch: ArchConfig, opt_cfg: adamw.AdamWConfig, *,
                    dms_train: bool = False, remat: bool = True,
                    use_kernel: bool = False, accum_steps: int = 1):
    """LM training step: CE (+ DMS aux), grads, AdamW.

    ``accum_steps > 1`` expects microbatched inputs (K, B/K, ...) and
    accumulates fp32 grads over the K microbatches, each with the same
    noise, as the reference's scan does.  Returns
    ``train_step(params, opt_state, batch, step, uniforms=None) ->
    (params, opt_state, metrics)``."""
    mode = "dms_train" if (dms_train and arch.dms.enabled) else "vanilla"

    def loss_fn(p, batch, uniforms, step):
        logits, aux = tfm.model_forward(
            p, batch["tokens"], arch, mode=mode, uniforms=uniforms,
            generator=step_generator(17, step, batch["tokens"].device),
            remat=remat, use_kernel=use_kernel,
            frontend_embeds=batch.get("frontend_embeds"),
            enc_embeds=batch.get("enc_embeds"))
        ce = distill_lib.lm_cross_entropy(logits, batch["labels"])
        loss = ce + aux["moe_aux_loss"]
        if mode == "dms_train":
            loss = loss + dms_lib.aux_compression_loss(
                aux["alpha_sum"], aux["alpha_count"], step, arch.dms)
        return loss, (ce.detach(), aux["alpha_sum"].detach(),
                      aux["alpha_count"])

    def train_step(params, opt_state, batch, step: int,
                   uniforms: Optional[Sequence[torch.Tensor]] = None):
        if accum_steps == 1:
            loss, (ce, a_sum, a_cnt), grads = _grads(
                lambda p: loss_fn(p, batch, uniforms, step), params)
        else:
            grads, loss, ce, a_sum, a_cnt = None, 0.0, 0.0, 0.0, 0.0
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in batch.items()}
                l, (c, s, n), g = _grads(
                    lambda p: loss_fn(p, mb, uniforms, step), params)
                grads = g if grads is None else tree_map(
                    lambda a, b: a.float() + b.float(), grads, g)
                loss, ce, a_sum, a_cnt = loss + l, ce + c, a_sum + s, a_cnt + n
            grads = tree_map(lambda a: a / accum_steps, grads)
            loss, ce = loss / accum_steps, ce / accum_steps
        params, opt_state, om = adamw.apply_updates(params, grads, opt_state,
                                                    opt_cfg)
        metrics = {"loss": loss, "ce": ce, **om}
        if mode == "dms_train":
            metrics["alpha_mean"] = a_sum / max(a_cnt, 1.0)
        return params, opt_state, metrics

    return train_step


def retrofit_loss_and_grads(
    arch: ArchConfig, params, teacher, batch, step: int, *,
    use_kernel: bool = False, phase1: bool = False, remat: bool = False,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, Any]]:
    """The retrofit objective's (loss, metrics, grads) at ``params``: logit
    distillation from the frozen vanilla teacher + the one-sided L1
    compression loss (§3.2, §4); ``phase1`` runs the borrowed-neuron zeroing
    schedule (App. B) instead of the DMS mask."""
    tokens = batch["tokens"]
    inputs = dict(frontend_embeds=batch.get("frontend_embeds"),
                  enc_embeds=batch.get("enc_embeds"))
    with torch.no_grad():
        teacher_logits, _ = tfm.model_forward(
            teacher, tokens, arch, mode="vanilla", use_kernel=use_kernel,
            **inputs)

    def loss_fn(p):
        if phase1:
            scale = min(max(1.0 - step / arch.dms.neuron_zeroing_steps, 0.0),
                        1.0)
            logits, aux = tfm.model_forward(
                p, tokens, arch, mode="dms_phase1", neuron_scale=scale,
                remat=remat, use_kernel=use_kernel, **inputs)
            a_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            a_cnt = 1.0
        else:
            logits, aux = tfm.model_forward(
                p, tokens, arch, mode="dms_train", uniforms=uniforms,
                generator=step_generator(23, step, tokens.device),
                remat=remat, use_kernel=use_kernel, **inputs)
            a_sum, a_cnt = aux["alpha_sum"], aux["alpha_count"]
        loss, metrics = distill_lib.retrofit_loss(
            logits, teacher_logits, batch["labels"], a_sum, a_cnt, step,
            arch.dms)
        return loss + aux["moe_aux_loss"], metrics

    loss, metrics, grads = _grads(loss_fn, params)
    return loss, {k: v.detach() for k, v in metrics.items()}, grads


def make_retrofit_step(arch: ArchConfig, opt_cfg: adamw.AdamWConfig, *,
                       remat: bool = True, use_kernel: bool = False,
                       phase1: bool = False):
    """Paper-faithful DMS retrofit step.  Returns ``retrofit_step(params,
    teacher_params, opt_state, batch, step, uniforms=None) -> (params,
    opt_state, metrics)``; the teacher's logits carry no gradient."""

    def retrofit_step(params, teacher_params, opt_state, batch, step: int,
                      uniforms: Optional[List[torch.Tensor]] = None):
        _, metrics, grads = retrofit_loss_and_grads(
            arch, params, teacher_params, batch, step, use_kernel=use_kernel,
            phase1=phase1, remat=remat, uniforms=uniforms)
        params, opt_state, om = adamw.apply_updates(params, grads, opt_state,
                                                    opt_cfg)
        return params, opt_state, {**metrics, **om}

    return retrofit_step


def make_prefill_step(arch: ArchConfig, *, dms: bool = False,
                      use_kernel: bool = False):
    """Prefill: the full forward (``dms_eval`` when ``dms`` and DMS is on,
    else ``vanilla``), returning the last position's logits (B, V_pad) fp32
    and the per-layer KV (``model_forward``'s ``layer_kv``), which
    :meth:`~repro_torch.core.policy.KVPolicy.prefill_import` turns into a
    cache.  ``use_kernel`` attends through the flash kernel's forward.  It
    runs under :func:`torch.inference_mode`, so the kernel's autograd
    Function saves nothing for a backward."""
    mode = "dms_eval" if (dms and arch.dms.enabled) else "vanilla"

    def prefill_step(params, batch):
        with torch.inference_mode():
            logits, aux = tfm.model_forward(
                params, batch["tokens"], arch, mode=mode, collect_kv=True,
                use_kernel=use_kernel,
                frontend_embeds=batch.get("frontend_embeds"),
                enc_embeds=batch.get("enc_embeds"))
        return logits[:, -1], aux["layer_kv"]

    return prefill_step


def make_serve_step(arch: ArchConfig, *, use_kernel: bool = False):
    """One decode step: ``serve_step(params, state, batch) -> (logits (B,
    V_pad) fp32, state, meters)`` with ``batch["token"]`` (B, 1),
    ``batch["pos"]`` and, for an encoder–decoder, ``batch["enc_out"]``
    (:func:`~repro_torch.models.transformer.encode`'s output).  The meters are both axes of the
    policies' ``metrics()`` contract, ``live_tokens`` and ``reads_tokens``
    (B,), so a caller meters KV reads and peak memory without knowing the
    policy.  The state is updated in place."""

    def serve_step(params, state, batch):
        logits, state, aux = tfm.decode_step(
            params, batch["token"], state, arch, batch["pos"],
            use_kernel=use_kernel, enc_out=batch.get("enc_out"))
        return logits, state, {"live_tokens": aux["live_tokens"],
                               "reads_tokens": aux["reads_tokens"]}

    return serve_step
