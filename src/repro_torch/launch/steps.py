"""Steps: the LM train step, the DMS retrofit step, the prefill step and
the serve step, and the input specs the dry-run places on a mesh.

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
embeddings) to ``model_forward``, when the batch has them, and its
``attn_impl`` (``"chunked"`` on the dry-run's fake tensors).

The specs (:func:`params_spec`, :func:`opt_state_spec`,
:func:`train_input_specs`, :func:`prefill_input_specs`,
:func:`decode_input_specs`) are the reference's ``jax.eval_shape`` trees:
fake tensors (:class:`torch._subclasses.fake_tensor.FakeTensorMode`) of
the same leaf paths, shapes and dtypes, on the CPU, with no weight drawn
and nothing allocated.  They are made in the caller's active fake mode, or
else in one shared mode (:func:`fake_mode`), so trees from two calls mix.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import distill as distill_lib
from repro_torch.core import dms as dms_lib
from repro_torch.core.config import ArchConfig, KVPolicyConfig, ShapeConfig
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.device import torch_dtype
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.parallel import spmd


# enc-dec shape convention: the encoder's frames are capped at 4K; the
# decoder carries the cell's full sequence length
ENC_LEN_CAP = 4096

_FAKE_MODE = None


def fake_mode():
    """The active :class:`FakeTensorMode`, else the module's shared one."""
    global _FAKE_MODE
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = active_fake_mode()
    if mode is None:
        if _FAKE_MODE is None:
            _FAKE_MODE = FakeTensorMode(allow_non_fake_inputs=True)
        mode = _FAKE_MODE
    return mode


def _frontend_split(arch: ArchConfig, seq_len: int) -> Tuple[int, int]:
    """(frontend_tokens, text_tokens) summing to seq_len."""
    if arch.frontend == "vision_patches" and arch.frontend_tokens:
        f = min(arch.frontend_tokens, seq_len // 2)
        return f, seq_len - f
    return 0, seq_len


def enc_len_for(arch: ArchConfig, seq_len: int) -> int:
    return min(ENC_LEN_CAP, seq_len) if arch.encoder_layers else 0


def _empty(shape, dtype) -> torch.Tensor:
    with fake_mode():
        return torch.empty(shape, dtype=dtype)


def train_input_specs(arch: ArchConfig, shape: ShapeConfig,
                      accum_steps: int = 1) -> Dict[str, Any]:
    """With ``accum_steps > 1`` the inputs are microbatched, (K, B/K, ...),
    and the train step loops over K, accumulating grads."""
    b, s = shape.global_batch, shape.seq_len
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps}")
    f, t_text = _frontend_split(arch, s)
    lead = (accum_steps, b // accum_steps) if accum_steps > 1 else (b,)
    dt = torch_dtype(arch.dtype)
    specs = {"tokens": _empty(lead + (t_text,), torch.int32),
             "labels": _empty(lead + (s,), torch.int32)}
    if f:
        specs["frontend_embeds"] = _empty(lead + (f, arch.d_model), dt)
    e = enc_len_for(arch, s)
    if e:
        specs["enc_embeds"] = _empty(lead + (e, arch.d_model), dt)
    return specs


def prefill_input_specs(arch: ArchConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    specs = train_input_specs(arch, shape)
    specs.pop("labels")
    return specs


def decode_input_specs(arch: ArchConfig, shape: ShapeConfig,
                       policy: KVPolicyConfig) -> Dict[str, Any]:
    """The serve step's batch and its decode state (``"cache"``), made for
    ``shape.global_batch`` lanes of ``shape.seq_len`` tokens."""
    b, s = shape.global_batch, shape.seq_len
    with fake_mode():
        cache = tfm.init_decode_state(arch, b, s, policy, device="cpu")
    specs: Dict[str, Any] = {
        "token": _empty((b, 1), torch.int32),
        # per-lane positions: production decode is continuous-batched
        "pos": _empty((b,), torch.int32),
        "cache": cache,
    }
    e = enc_len_for(arch, s)
    if e:
        specs["enc_out"] = _empty((b, e, arch.d_model), torch_dtype(arch.dtype))
    return specs


def params_spec(arch: ArchConfig, dtype: Optional[str] = None) -> Any:
    """The params tree: the reference's fp32 leaves, or every leaf in
    ``dtype`` when given."""
    with fake_mode():
        params = tfm.init_model(arch, device="cpu", dtype=torch.float32)
        if dtype is not None:
            dt = torch_dtype(dtype)
            cast = tfm.Params(tree_map(lambda x: x.to(dt), params))
            cast.layer_salt = params.layer_salt     # the fp32 draws' salts
            params = cast
    return params


def opt_state_spec(params: Any) -> adamw.AdamWState:
    """AdamW's state for ``params`` (with an fp32 master when they are not
    fp32, as :func:`repro_torch.optim.adamw.init` keeps one)."""
    with fake_mode():
        return adamw.init(params)


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
                    use_kernel: bool = False, accum_steps: int = 1,
                    attn_impl: Optional[str] = None):
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
            remat=remat, use_kernel=use_kernel, attn_impl=attn_impl,
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
    attn_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, Any]]:
    """The retrofit objective's (loss, metrics, grads) at ``params``: logit
    distillation from the frozen vanilla teacher + the one-sided L1
    compression loss (§3.2, §4); ``phase1`` runs the borrowed-neuron zeroing
    schedule (App. B) instead of the DMS mask."""
    tokens = batch["tokens"]
    inputs = dict(frontend_embeds=batch.get("frontend_embeds"),
                  enc_embeds=batch.get("enc_embeds"), attn_impl=attn_impl)
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
                       phase1: bool = False, attn_impl: Optional[str] = None):
    """Paper-faithful DMS retrofit step.  Returns ``retrofit_step(params,
    teacher_params, opt_state, batch, step, uniforms=None) -> (params,
    opt_state, metrics)``; the teacher's logits carry no gradient."""

    def retrofit_step(params, teacher_params, opt_state, batch, step: int,
                      uniforms: Optional[List[torch.Tensor]] = None):
        _, metrics, grads = retrofit_loss_and_grads(
            arch, params, teacher_params, batch, step, use_kernel=use_kernel,
            phase1=phase1, remat=remat, uniforms=uniforms,
            attn_impl=attn_impl)
        params, opt_state, om = adamw.apply_updates(params, grads, opt_state,
                                                    opt_cfg)
        return params, opt_state, {**metrics, **om}

    return retrofit_step


def make_prefill_step(arch: ArchConfig, *, dms: bool = False,
                      use_kernel: bool = False,
                      attn_impl: Optional[str] = None):
    """Prefill: the full forward (``dms_eval`` when ``dms`` and DMS is on,
    else ``vanilla``), returning the last position's logits (B, V_pad) fp32
    and the per-layer KV (``model_forward``'s ``layer_kv``), which
    :meth:`~repro_torch.core.policy.KVPolicy.prefill_import` turns into a
    cache.  ``use_kernel`` attends through the flash kernel's forward.  It
    runs under :func:`torch.inference_mode` (:func:`torch.no_grad` over
    DTensor params, whose views set version counters that inference tensors
    refuse), so the kernel's autograd Function saves nothing for a
    backward."""
    mode = "dms_eval" if (dms and arch.dms.enabled) else "vanilla"

    def prefill_step(params, batch):
        sharded = spmd.first_dtensor(params) is not None
        with torch.no_grad() if sharded else torch.inference_mode():
            logits, aux = tfm.model_forward(
                params, batch["tokens"], arch, mode=mode, collect_kv=True,
                use_kernel=use_kernel, attn_impl=attn_impl,
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
