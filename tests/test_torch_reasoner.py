"""The hyper-scaling demo's trained reasoner against the JAX reference, on
the CPU.

(i) ``repro_torch.examples.reasoner.trained_reasoner`` against the
    reference's recipe (``benchmarks/pareto.py::_trained_reasoner``,
    rebuilt here from ``repro``'s own ``init_model``, train and retrofit
    steps, AdamW and tasks with that file's constants) at ``steps=8``: 8
    pretrain and 4 retrofit steps from the reference's init (bridged) with
    the reference's per-layer Gumbel uniforms of each retrofit step.  In
    fp32 (the model's dtype set to float32 on both sides) per-step metrics
    agree to ``test_torch_train.py``'s 1e-4 relative / 1e-6 absolute and
    the final params to 1e-4 absolute (each leaf's largest magnitude is
    0.08–1.0).  As shipped, in bf16, the two frameworks round the
    activations apart a little every step (a bf16 rounding is up to 2^-9
    relative, and a step compounds several): metrics within 2e-2 relative
    or 1e-5 absolute (the distillation term of the first retrofit steps is
    ~1e-5, and its bf16 noise absolute), the params within 2e-3 (one step
    of the pretrain learning rate).  The batches carry ``tokens`` and
    ``labels`` only, as the reference's do.
(ii) ``evaluate_hyperscale`` with the trained weights (the reference's
    recipe at 32 steps, bridged): the JAX ``Engine`` (``use_kernel=True``,
    Pallas interpret mode) and the port's ``Engine`` on the CPU return the
    same dict, key for key, for the demo's two settings (vanilla
    40-1-1, dms 40-4-4) on 4 problems; the seed is pinned where no draw
    meets a near tie that an ulp of Gumbel noise could flip.
(iii) The W-4 request's prefill reads equal one W-1 dms request's on the
    same prompt: the four chains share one prefill.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import hyperscale as jhs
from repro.core.config import DMSConfig as JDMSConfig
from repro.core.config import KVPolicyConfig as JKV
from repro.data import tasks as jtasks
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import evaluate_hyperscale as jevaluate
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core import hyperscale as ths
from repro_torch.core.config import KVPolicyConfig
from repro_torch.examples import reasoner
from repro_torch.serving.engine import Engine, evaluate_hyperscale

torch.set_num_threads(1)

STEPS = 8            # (i): 8 pretrain and 4 retrofit steps
TRAINED = 32         # (ii), (iii): 32 and 16
N_EVAL = 4
SEED = 0
# per dtype: (metrics relative, metrics absolute, params absolute)
TOL = {"float32": (1e-4, 1e-6, 1e-4), "bfloat16": (2e-2, 1e-5, 2e-3)}


def _jax_recipe(steps, dtype):
    """``benchmarks/pareto.py::_trained_reasoner`` (:27-66) rebuilt from
    ``repro``'s modules with the model in ``dtype``; returns (arch, init
    params, final params, task, pretrain losses, retrofit metrics)."""
    arch = dataclasses.replace(
        jget_smoke("qwen-r1-1.5b"), vocab_size=64, dtype=dtype,
        dms=JDMSConfig(enabled=True, window=4, target_cr=4.0,
                       steps_per_cr_unit=max(steps // 8, 5)))
    task = jtasks.TaskConfig(kind="chain_arith", vocab_size=64, prompt_len=32,
                             chain_len=5, seed=0)
    base = dataclasses.replace(arch, dms=JDMSConfig(enabled=False))
    init = jtfm.init_model(jax.random.PRNGKey(0), base)
    params, opt = init, jadamw.init(init)
    step_fn = jax.jit(jsteps.make_train_step(base, jadamw.AdamWConfig(
        lr=2e-3, warmup_steps=20, total_steps=steps)))
    pre = []
    for s in range(steps):
        b = jtasks.make_train_batch(task, s, 32)
        batch = {"tokens": jnp.asarray(b["tokens"]),
                 "labels": jnp.asarray(b["labels"])}
        params, opt, m = step_fn(params, opt, batch, jnp.asarray(s, jnp.int32))
        pre.append(float(m["loss"]))
    teacher = jax.tree_util.tree_map(jnp.copy, params)
    ropt = jadamw.init(params)
    rstep = jax.jit(jsteps.make_retrofit_step(arch, jadamw.AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=steps // 2)))
    ret = []
    for s in range(steps // 2):
        b = jtasks.make_train_batch(task, 10_000 + s, 32)
        batch = {"tokens": jnp.asarray(b["tokens"]),
                 "labels": jnp.asarray(b["labels"])}
        params, ropt, m = rstep(params, teacher, ropt, batch,
                                jnp.asarray(s, jnp.int32))
        ret.append({k: float(v) for k, v in m.items()})
    return arch, init, params, task, pre, ret


def _uniforms_fn(arch):
    """The reference retrofit step's per-layer uniforms:
    ``fold_in(PRNGKey(23), step)`` split over the layers (``_scan_blocks``)."""
    def fn(step):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(23),
                                                   step), arch.num_layers)
        return [torch.tensor(np.asarray(jax.random.uniform(
            k, (32, arch.attn.num_kv_heads, 32), minval=1e-6,
            maxval=1 - 1e-6))) for k in keys]
    return fn


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def recipes():
    return {}


def _recipe(recipes, steps, dtype):
    if (steps, dtype) not in recipes:
        recipes[steps, dtype] = _jax_recipe(steps, dtype)
    return recipes[steps, dtype]


def _leaves_close(got, want, atol, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _leaves_close(got[k], want[k], atol, f"{path}/{k}")
        return
    err = np.abs(got.float().numpy() - want).max()
    assert err <= atol, (path, err)


# -- (i) ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recipe_matches_reference(recipes, monkeypatch, dtype):
    jarch, init, jparams, _, jpre, jret = _recipe(recipes, STEPS, dtype)
    monkeypatch.setattr(reasoner, "get_smoke", lambda name: dataclasses.replace(
        get_smoke(name), dtype=dtype))
    base = bridge.arch_from_dict(dataclasses.asdict(dataclasses.replace(
        jarch, dms=JDMSConfig(enabled=False))))
    tparams = bridge.params_from_numpy(_numpy(init), base, device="cpu",
                                       dtype=torch.float32)
    arch, params, task, alpha, hist = reasoner.trained_reasoner(
        STEPS, device="cpu", params=tparams, uniforms_fn=_uniforms_fn(jarch))
    assert arch == bridge.arch_from_dict(dataclasses.asdict(jarch))
    assert dataclasses.asdict(task) == dataclasses.asdict(
        jtasks.TaskConfig(kind="chain_arith", vocab_size=64, prompt_len=32,
                          chain_len=5, seed=0))
    rel, abs_, params_tol = TOL[dtype]
    assert len(hist["pretrain"]) == STEPS and len(hist["retrofit"]) == STEPS // 2
    for s, (got, want) in enumerate(zip(hist["pretrain"], jpre)):
        assert got["loss"] == pytest.approx(want, rel=rel, abs=abs_), s
    for s, (got, want) in enumerate(zip(hist["retrofit"], jret)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=rel, abs=abs_), (s, k)
    assert alpha == pytest.approx(jret[-1]["alpha_mean"], rel=rel, abs=abs_)
    _leaves_close(params, _numpy(jparams), params_tol)


def test_batches_carry_tokens_and_labels_only(monkeypatch):
    """What the two steps receive: the reference passes ``tokens`` and
    ``labels`` and drops ``make_train_batch``'s ``loss_mask``."""
    seen = []

    def spying(make):
        def wrapped(*args, **kw):
            step = make(*args, **kw)

            def run(*a, **k):
                batch = next(x for x in a if isinstance(x, dict)
                             and "tokens" in x)
                seen.append((make.__name__, sorted(batch)))
                return step(*a, **k)
            return run
        return wrapped

    for name in ("make_train_step", "make_retrofit_step"):
        monkeypatch.setattr(reasoner.steps_lib, name,
                            spying(getattr(reasoner.steps_lib, name)))
    _, task = reasoner.reasoner_config(2)
    assert "loss_mask" in reasoner.tasks.make_train_batch(task, 0, 2)
    reasoner.trained_reasoner(2, device="cpu")
    assert seen == [("make_train_step", ["labels", "tokens"]),
                    ("make_train_step", ["labels", "tokens"]),
                    ("make_retrofit_step", ["labels", "tokens"])]


# -- (ii), (iii) -------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(recipes):
    jarch, _, jparams, task, _, _ = _recipe(recipes, TRAINED, "bfloat16")
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    return (jarch, jparams, tarch,
            bridge.params_from_numpy(_numpy(jparams), tarch, device="cpu"),
            task)


SETTINGS = [("vanilla", dict(kind="vanilla"), 1, 1.0),
            ("dms", dict(kind="dms", cr=4.0, window=4), 4, 4.0)]


@pytest.mark.parametrize("name,kw,width,cr", SETTINGS,
                         ids=[s[0] for s in SETTINGS])
def test_evaluate_hyperscale_trained_equals_reference(trained, name, kw,
                                                      width, cr):
    jarch, jparams, tarch, tparams, task = trained
    prompts, answers = jtasks.make_eval_set(task, N_EVAL)
    cfg = (task.prompt_len + 8, width, cr)
    want = jevaluate(JEngine(jarch, jparams, JKV(**kw), use_kernel=True,
                             temperature=0.7),
                     prompts, answers, jhs.ScalingConfig(*cfg), seed=SEED)
    got = evaluate_hyperscale(
        Engine(tarch, tparams, KVPolicyConfig(**kw), use_kernel=True,
               temperature=0.7, device="cpu"),
        prompts, answers, ths.ScalingConfig(*cfg), seed=SEED)
    assert got == want, name


def test_four_chains_share_one_prefill(trained):
    _, _, tarch, tparams, task = trained
    prompts, _ = jtasks.make_eval_set(task, 1)
    engine = Engine(tarch, tparams, KVPolicyConfig(kind="dms", cr=4.0,
                                                   window=4),
                    temperature=0.7, device="cpu")
    reads = {}
    for width in (4, 1):
        res = engine.hyperscale_generate(
            prompts[0], ths.ScalingConfig(task.prompt_len + 8, width, 4.0))
        req = res.requests[0]
        assert req.status == "ok"
        reads[width] = (req.prefill_meter.kv_reads, req.decode_meter.kv_reads)
    assert reads[4][0] == reads[1][0] > 0
    assert reads[4][1] > reads[1][1]
