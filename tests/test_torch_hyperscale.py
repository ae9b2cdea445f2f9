"""The paper's hyper-scaling comparison in the port against the reference.

(a) Sampling at temperature 0.7, end to end: the port's ``Engine`` (CPU,
    the decode kernel's plain version) against the JAX ``Engine``
    (``use_kernel=True``, Pallas interpret mode), seeded — tokens and the
    five meters equal on ``test_torch_engine.py``'s traces (a) (two
    11-token prompts, 5 new) and (c) (a width-4 ``hyperscale_generate``)
    for ``dms``, and on trace (a) for ``vanilla``, ``window``, ``quest``
    (8-token pages) and ``dmc``.  The
    seeds are pinned: none of their draws has a near tie that an ulp of
    Gumbel noise could flip.
(b) ``data/tasks.py`` draws the reference's problems, and the
    ``core/hyperscale.py`` functions equal the reference's on random
    inputs.
(c) ``evaluate_hyperscale`` returns the reference's dict, key for key, for
    ``examples/hyperscale_serve.py``'s two settings (vanilla 1-chain, DMS
    4-chain) on ``tiny_arch``.
(d) The configs this slice registers: each SMOKE config served with
    ``dms`` at CR 2, kernel on — tokens, ``kv_reads`` and ``peak_tokens``
    equal the JAX ``Engine``'s.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import hyperscale as jhs
from repro.core.config import KVPolicyConfig as JKV
from repro.data import tasks as jtasks
from repro.models import transformer as jtfm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import evaluate_hyperscale as jevaluate
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core import hyperscale as ths
from repro_torch.core.config import KVPolicyConfig
from repro_torch.data import tasks as ttasks
from repro_torch.serving.engine import Engine, evaluate_hyperscale

torch.set_num_threads(1)

METERS = ("kv_reads", "peak_tokens", "peak_bytes", "steps", "generated_tokens")


@pytest.fixture(scope="module")
def port(tiny_arch, tiny_params):
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    return tarch, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")


def _engines(tiny_arch, tiny_params, port, **kw):
    tarch, tparams = port
    kw.setdefault("window", tiny_arch.dms.window)
    return (JEngine(tiny_arch, tiny_params, JKV(**kw), use_kernel=True,
                    temperature=0.7),
            Engine(tarch, tparams, KVPolicyConfig(**kw), use_kernel=True,
                   temperature=0.7, device="cpu"))


def assert_meters_equal(mt, mj, what):
    for key in METERS:
        assert getattr(mt, key) == getattr(mj, key), (what, key)


# -- (a) -------------------------------------------------------------------------


POLICIES = [("dms", dict(kind="dms", cr=2.0)),
            ("vanilla", dict(kind="vanilla")),
            ("window", dict(kind="window", budget=6)),
            ("quest", dict(kind="quest", cr=2.0, quest_page_size=8,
                           block_p=8)),
            ("dmc", dict(kind="dmc", cr=2.0))]


@pytest.mark.parametrize("name,kw", POLICIES, ids=[p[0] for p in POLICIES])
def test_trace_a_sampled(tiny_arch, tiny_params, port, name, kw):
    jeng, teng = _engines(tiny_arch, tiny_params, port, **kw)
    prompts = np.random.default_rng(5).integers(
        3, tiny_arch.vocab_size, size=(2, 11)).astype(np.int32)
    for seed in (0, 1):
        rj = jeng.generate(prompts, 5, seed=seed)
        rt = teng.generate(prompts, 5, seed=seed)
        np.testing.assert_array_equal(rt.tokens, rj.tokens, err_msg=str(seed))
        assert_meters_equal(rt.meter, rj.meter, f"seed {seed}")
        for a, b in zip(rt.requests, rj.requests):
            assert_meters_equal(a.prefill_meter, b.prefill_meter, "prefill")
            assert_meters_equal(a.decode_meter, b.decode_meter, "decode")
    # the seed is the stream: another seed draws other tokens
    assert not np.array_equal(teng.generate(prompts, 5, seed=0).tokens,
                              teng.generate(prompts, 5, seed=1).tokens)


def test_trace_c_sampled_hyperscale_fork(tiny_arch, tiny_params, port):
    jeng, teng = _engines(tiny_arch, tiny_params, port, kind="dms", cr=2.0)
    w, t0 = 4, 16
    prompt = np.random.default_rng(2).integers(
        3, tiny_arch.vocab_size, size=(t0,)).astype(np.int32)
    for seed in (0, 3):
        rj = jeng.hyperscale_generate(prompt, jhs.ScalingConfig(t0 + 6, w),
                                      seed=seed)
        rt = teng.hyperscale_generate(prompt, ths.ScalingConfig(t0 + 6, w),
                                      seed=seed)
        assert rt.tokens.shape == (w, 6)
        np.testing.assert_array_equal(rt.tokens, rj.tokens, err_msg=str(seed))
        assert_meters_equal(rt.meter, rj.meter, f"seed {seed}")
        # sampling happened: the W chains of one prefill differ
        assert len({tuple(row) for row in rt.tokens.tolist()}) > 1


# -- (b) -------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["chain_arith", "needle", "var_track"])
def test_tasks_equal_reference(kind):
    kw = dict(kind=kind, vocab_size=64, prompt_len=40, seed=3)
    tp, ta = ttasks.make_eval_set(ttasks.TaskConfig(**kw), 6)
    jp, ja = jtasks.make_eval_set(jtasks.TaskConfig(**kw), 6)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ta, ja)
    tb = ttasks.make_train_batch(ttasks.TaskConfig(**kw), 7, 4)
    jb = jtasks.make_train_batch(jtasks.TaskConfig(**kw), 7, 4)
    assert sorted(tb) == sorted(jb)
    for key in tb:
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)


def test_hyperscale_functions_equal_reference():
    r = np.random.default_rng(0)
    for _ in range(5):
        args = (int(r.integers(1, 300)), int(r.integers(1, 9)),
                float(r.choice([1.0, 2.0, 4.0, 8.0])), int(r.integers(1, 29)),
                int(r.integers(0, 64)))
        assert ths.analytic_budget(*args) == jhs.analytic_budget(*args)
    assert [c.label for c in ths.default_grid(512, (1.0, 4.0))] == \
        [c.label for c in jhs.default_grid(512, (1.0, 4.0))]
    assert ths.ScalingConfig(2048, 4, 8.0).label == "2-4-8"
    for _ in range(5):
        pa = [(float(b), float(a)) for b, a in r.random((12, 2)) * [1e4, 1]]
        pb = [(float(b), float(a)) for b, a in r.random((9, 2)) * [1e4, 1]]
        fa, fb = ths.pareto_frontier(pa), ths.pareto_frontier(pb)
        assert fa == jhs.pareto_frontier(pa) and fb == jhs.pareto_frontier(pb)
        np.testing.assert_equal(ths.frontier_margin(fa, fb),
                                jhs.frontier_margin(fa, fb))
    # disjoint budgets: a below b
    lo, hi = [(1.0, 0.5), (2.0, 0.7)], [(5.0, 0.4), (9.0, 0.6)]
    assert ths.frontier_margin(lo, hi) == jhs.frontier_margin(lo, hi)
    assert np.isnan(ths.frontier_margin(hi, lo))
    preds, targets = ["1", None, "3", "4"], ["1", "2", "3", "5"]
    assert ths.exact_match_accuracy(preds, targets) == \
        jhs.exact_match_accuracy(preds, targets)
    for chains in ([False, False], [False, True], []):
        assert ths.pass_at_all(chains) == jhs.pass_at_all(chains)


# -- (c) -------------------------------------------------------------------------


def test_evaluate_hyperscale_equals_reference(tiny_arch, tiny_params, port):
    task = jtasks.TaskConfig(kind="chain_arith", vocab_size=64, prompt_len=16)
    prompts, answers = jtasks.make_eval_set(task, 2)
    settings = [(dict(kind="vanilla"), 1, 1.0),
                (dict(kind="dms", cr=tiny_arch.dms.target_cr), 4,
                 tiny_arch.dms.target_cr)]
    for kw, width, cr in settings:
        jeng, teng = _engines(tiny_arch, tiny_params, port, **kw)
        cfg = (task.prompt_len + 8, width, cr)
        want = jevaluate(jeng, prompts, answers, jhs.ScalingConfig(*cfg),
                         seed=2)
        got = evaluate_hyperscale(teng, prompts, answers,
                                  ths.ScalingConfig(*cfg), seed=2)
        assert got == want, kw["kind"]


# -- (d) -------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama32-1b", "minitron-4b",
                                  "phi3-mini-3.8b"])
def test_new_config_serves_like_reference(name):
    jarch = jget_smoke(name)
    tarch = get_smoke(name)
    assert bridge.arch_from_dict(dataclasses.asdict(jarch)) == tarch
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu")
    kw = dict(kind="dms", cr=2.0, window=jarch.dms.window)
    prompts = np.random.default_rng(5).integers(
        3, jarch.vocab_size, size=(2, 11)).astype(np.int32)
    rj = JEngine(jarch, jparams, JKV(**kw), use_kernel=True).generate(
        prompts, 5)
    rt = Engine(tarch, tparams, KVPolicyConfig(**kw), use_kernel=True,
                device="cpu").generate(prompts, 5)
    np.testing.assert_array_equal(rt.tokens, rj.tokens)
    assert (rt.meter.kv_reads, rt.meter.peak_tokens) == \
        (rj.meter.kv_reads, rj.meter.peak_tokens)
