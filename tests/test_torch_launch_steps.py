"""The port's launch steps on the families beyond the tiny Qwen model,
against the reference's ``repro.launch.steps``: the prefill, train and
retrofit steps of qwen2-vl-7b with prepended patch embeddings (the batch's
``frontend_embeds``, which every step passes to ``model_forward``), one
train step of granite-moe-1b, gemma2 and chatglm3, and gemma2's and
recurrentgemma's prefill and retrofit steps on the kernel path at their
head dim, 256 (Pallas in interpret mode against the plain flash versions).

All in fp32 on the smoke configs with the reference's seeded weights
copied through numpy.  Tolerances: the train step's loss and gradient
norm within 1e-5 relative; the retrofit step's metrics within 1e-4
relative (its distillation sums logits over the vocab); logits and the
per-layer KV to rtol 1e-4 / atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.core.tree import tree_map
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw as tadamw

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, T_TEXT = 2, 12


def _setup(name, bias=None, head_dim=None):
    jarch = dataclasses.replace(jget_smoke(name), dtype="float32")
    if bias is not None:
        jarch = dataclasses.replace(jarch, dms=dataclasses.replace(
            jarch.dms, logit_bias=bias))
    if head_dim is not None:
        jarch = dataclasses.replace(jarch, attn=dataclasses.replace(
            jarch.attn, head_dim=head_dim))
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu",
        dtype=torch.float32)
    return jarch, tarch, jparams, tparams


def _batch(arch, seed=0):
    """Tokens, labels over every position, and (for a vision frontend) 4
    patch embeddings in front of the text."""
    r = np.random.default_rng(seed)
    f = arch.frontend_tokens if arch.frontend == "vision_patches" else 0
    batch = {"tokens": r.integers(0, arch.vocab_size, (B, T_TEXT)),
             "labels": r.integers(0, arch.vocab_size, (B, T_TEXT + f))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if f:
        batch["frontend_embeds"] = (r.normal(size=(B, f, arch.d_model))
                                    * 0.02).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_qwen2_vl_prefill_step_reads_patches():
    """Last logits and every layer's KV equal the reference's with 4 patch
    embeddings; without them the logits move (the patches are read)."""
    jarch, tarch, jparams, tparams = _setup("qwen2-vl-7b")
    assert jarch.frontend_tokens == 4
    jb, tb = _both(_batch(jarch))
    jl, jkv = jsteps.make_prefill_step(jarch)(jparams, jb)
    tl, tkv = tsteps.make_prefill_step(tarch)(tparams, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    for pi, kv in tkv.items():
        for key, val in kv.items():
            want = np.asarray(jkv[pi][key])
            assert val.shape[3] == T_TEXT + 4
            np.testing.assert_allclose(val.float().numpy(), want,
                                       err_msg=key, **F32)
    bare, _ = tsteps.make_prefill_step(tarch)(
        tparams, {"tokens": tb["tokens"]})
    assert float((bare - tl).abs().max()) > 1e-3


@pytest.mark.parametrize("name", ["qwen2-vl-7b", "granite-moe-1b-a400m",
                                  "gemma2-2b", "chatglm3-6b"])
def test_train_step_matches_reference(name):
    """One LM train step (CE + MoE aux): loss and gradient norm within 1e-5
    relative; qwen2-vl with its patch embeddings and labels over all 16
    positions."""
    jarch, tarch, jparams, tparams = _setup(name)
    jb, tb = _both(_batch(jarch, seed=1))
    jstep = jax.jit(jsteps.make_train_step(
        jarch, jadamw.AdamWConfig(**OPT), remat=False))
    _, _, jm = jstep(jparams, jadamw.init(jparams), jb, jnp.int32(2))
    tstep = tsteps.make_train_step(tarch, tadamw.AdamWConfig(**OPT),
                                   remat=False)
    _, _, tm = tstep(tparams, tadamw.init(tparams), tb, 2)
    for key in ("loss", "ce", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), key


def _layer_uniforms(step, arch, b, t):
    """The reference's per-layer Gumbel uniforms of a retrofit step."""
    rng = jax.random.fold_in(jax.random.PRNGKey(23), step)
    keys = jax.random.split(rng, arch.num_layers)
    return [torch.from_numpy(np.asarray(jax.random.uniform(
        keys[i], (b, arch.attn.num_kv_heads, t), minval=1e-6,
        maxval=1 - 1e-6))) for i in range(arch.num_layers)]


@pytest.mark.parametrize("phase1,step", [(True, 1000), (False, 3)])
def test_qwen2_vl_retrofit_step_reads_patches(phase1, step):
    """Teacher and student both see the patch embeddings: every metric of
    one retrofit step (phase 1 and the main phase, DMS bias 0) within 1e-4
    relative of the reference's."""
    jarch, tarch, jparams, tparams = _setup("qwen2-vl-7b", bias=0.0)
    jb, tb = _both(_batch(jarch, seed=2))
    jstep = jsteps.make_retrofit_step(jarch, jadamw.AdamWConfig(**OPT),
                                      remat=False, phase1=phase1)
    _, _, jm = jax.jit(jstep)(jparams, jparams, jadamw.init(jparams), jb,
                              jnp.int32(step))
    teacher = tree_map(lambda a: a.clone(), tparams)
    tstep = tsteps.make_retrofit_step(tarch, tadamw.AdamWConfig(**OPT),
                                      remat=False, phase1=phase1)
    uniforms = None if phase1 else _layer_uniforms(step, jarch, B, T_TEXT + 4)
    _, _, tm = tstep(tparams, teacher, tadamw.init(tparams), tb, step,
                     uniforms=uniforms)
    assert sorted(tm) == sorted(jm)
    for key in jm:
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-4,
                                               abs=1e-6), key


DH256 = ["gemma2-2b", "recurrentgemma-2b"]
T_DH256 = 64


def _tokens_batch(arch, t, seed):
    r = np.random.default_rng(seed)
    return {k: r.integers(0, arch.vocab_size, (B, t)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("name", DH256)
def test_dh256_prefill_step_on_the_kernel_path(name):
    """gemma2 (a local and a global layer, softcap 50) and recurrentgemma
    (an RG-LRU and a local layer, G 4 over one kv head) at one superblock
    with head_dim 256, B 2, T 64: ``make_prefill_step(dms=True,
    use_kernel=True)``'s last logits and every layer's prefill outputs
    against the reference's kernel path."""
    jarch, tarch, jparams, tparams = _setup(name, head_dim=256)
    assert len(jarch.layer_pattern) == jarch.num_layers
    jb, tb = _both(_tokens_batch(jarch, T_DH256, seed=3))
    jl, jkv = jsteps.make_prefill_step(jarch, dms=True, use_kernel=True)(
        jparams, jb)
    tl, tkv = tsteps.make_prefill_step(tarch, dms=True, use_kernel=True)(
        tparams, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    assert sorted(tkv) == sorted(jkv)
    for pi, kv in tkv.items():
        for key, val in kv.items():
            np.testing.assert_allclose(
                np.asarray(val.float() if torch.is_tensor(val) else val),
                np.asarray(jkv[pi][key], dtype=np.float32),
                err_msg=f"{pi} {key}", **F32)


@pytest.mark.parametrize("name", DH256)
def test_dh256_retrofit_step_on_the_kernel_path(name):
    """One retrofit step (the main phase, the reference's per-layer Gumbel
    uniforms) at head_dim 256 through the flash kernels' plain versions
    against the reference's Pallas kernels: loss and gradient norm within
    1e-5 relative, every other metric within 1e-4."""
    jarch, tarch, jparams, tparams = _setup(name, head_dim=256)
    jb, tb = _both(_tokens_batch(jarch, T_DH256, seed=4))
    jstep = jsteps.make_retrofit_step(jarch, jadamw.AdamWConfig(**OPT),
                                      remat=False, use_kernel=True)
    _, _, jm = jstep(jparams, jparams, jadamw.init(jparams), jb,
                     jnp.int32(3))
    teacher = tree_map(lambda a: a.clone(), tparams)
    tstep = tsteps.make_retrofit_step(tarch, tadamw.AdamWConfig(**OPT),
                                      remat=False, use_kernel=True)
    _, _, tm = tstep(tparams, teacher, tadamw.init(tparams), tb, 3,
                     uniforms=_layer_uniforms(3, jarch, B, T_DH256))
    assert sorted(tm) == sorted(jm)
    for key in jm:
        rel = 1e-5 if key in ("loss", "grad_norm") else 1e-4
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=rel,
                                               abs=1e-6), key
