"""The paged slice as a whole: the port's ``Engine`` and scheduler on a
paged KV block pool (CPU, the decode kernel's plain version in shared-pool
mode) against the JAX ``Engine`` on the same traces.

Pool traces (``tests/test_block_pool.py``), each with the kernel path off
and on (the reference's on is Pallas interpret mode):

* ``test_engine_paged_generate_token_parity`` — 2 prompts of 11 tokens;
* ``test_scheduler_paged_fork_token_parity`` — a width-2 request, CoW fork;
* ``test_scheduler_pool_budget_serializes_admission`` — a pool sized for
  one worst-case lane serializes two requests.

Preemption and failure traces (``tests/test_scheduler.py``), kernel path
off as the reference runs them: oversubscribed preempt mode, the
exhausted-latch backstop, deadlines, the NaN tripwire and the
unservable-request check.  Tokens, statuses, ``preempt_count``, lifecycle
counters, tick stamps and meters must be equal.  The NaN trace runs in
fp32: in bf16 its surviving request's fourth token is a near tie that XLA
and PyTorch round apart (on fixed arenas as well; in fp32 both packages
give the port's bf16 tokens).  The reference's red
``test_oversubscribed_ignore_mode_corrupts_silently`` is no target.
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.core.config import KVPolicyConfig as JKV
from repro.serving.engine import Engine as JEngine
from repro.serving.faults import Fault as JFault, FaultPlan as JFaultPlan
from repro.serving.scheduler import Request as JRequest
from repro_torch import bridge
from repro_torch.core.config import KVPolicyConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.faults import Fault, FaultPlan
from repro_torch.serving.scheduler import Request

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)


def _prompt(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(3, vocab, size=(n,)).astype(np.int32)


@pytest.fixture(scope="module")
def port(tiny_arch, tiny_params):
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")
    return tarch, params


def _pair(tiny_arch, tiny_params, port, use_kernel, chunk=8, dtype=None,
          **kv):
    """A JAX and a port engine on the same weights and policy."""
    kw = dict(kind="dms", cr=2.0, window=tiny_arch.dms.window, **kv)
    tarch, params = port
    if dtype is not None:
        tiny_arch = dataclasses.replace(tiny_arch, dtype=dtype)
        tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
        params = bridge.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, tiny_params), tarch,
            device="cpu")
    return (JEngine(tiny_arch, tiny_params, JKV(**kw), use_kernel=use_kernel,
                    chunk=chunk),
            Engine(tarch, params, KVPolicyConfig(**kw), use_kernel=use_kernel,
                   chunk=chunk, device="cpu"))


def assert_meters_equal(mt, mj, what):
    for key in ("kv_reads", "peak_tokens", "peak_bytes", "steps",
                "generated_tokens"):
        assert getattr(mt, key) == getattr(mj, key), (what, key)


def assert_results_equal(rt, rj):
    assert sorted(rt) == sorted(rj)
    for uid in rj:
        a, b = rt[uid], rj[uid]
        assert a.status == b.status, uid
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(uid))
        np.testing.assert_array_equal(a.lengths, b.lengths, err_msg=str(uid))
        assert (a.preempt_count, a.latency_ticks, a.admitted_tick,
                a.finished_tick) == (b.preempt_count, b.latency_ticks,
                                     b.admitted_tick, b.finished_tick), uid
        assert_meters_equal(a.meter, b.meter, uid)


POOL_KEYS = ("pool_blocks", "allocated_blocks", "free_blocks",
             "shared_blocks", "mapped_entries", "cow_copies", "alloc_events",
             "high_water_blocks", "exhausted", "live_tokens")


def assert_pool_stats_equal(st, sj):
    assert {k: st[k] for k in POOL_KEYS} == {k: sj[k] for k in POOL_KEYS}
    assert st["lifecycle"] == {k: sj["lifecycle"][k] for k in st["lifecycle"]}


# -- pool traces, kernel path off and on --------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_paged_generate_token_parity(tiny_arch, tiny_params, port,
                                            use_kernel):
    jeng, teng = _pair(tiny_arch, tiny_params, port, use_kernel, paged=True)
    _, tfixed = _pair(tiny_arch, tiny_params, port, use_kernel)
    prompts = np.random.default_rng(9).integers(
        3, tiny_arch.vocab_size, size=(2, 11)).astype(np.int32)
    rj = jeng.generate(prompts, 5)
    rt = teng.generate(prompts, 5)
    np.testing.assert_array_equal(rt.tokens, rj.tokens)
    assert_meters_equal(rt.meter, rj.meter, "generate")
    for a, b in zip(rt.requests, rj.requests):
        assert_meters_equal(a.prefill_meter, b.prefill_meter, "prefill")
        assert_meters_equal(a.decode_meter, b.decode_meter, "decode")
    # the layout changes storage only: the port's fixed arenas agree
    np.testing.assert_array_equal(tfixed.generate(prompts, 5).tokens, rt.tokens)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_scheduler_paged_fork_token_parity(tiny_arch, tiny_params, port,
                                           use_kernel):
    jeng, teng = _pair(tiny_arch, tiny_params, port, use_kernel, paged=True)
    prompt = _prompt(9, seed=4, vocab=tiny_arch.vocab_size)

    def run_one(eng, req_cls):
        sched = eng.scheduler(num_lanes=4, max_len=16)
        sched.submit(req_cls(uid=0, prompt=prompt, max_new=5, width=2))
        return {r.uid: r for r in sched.run()}, sched

    rj, sj = run_one(jeng, JRequest)
    rt, st = run_one(teng, Request)
    assert_results_equal(rt, rj)
    stats = st.pool_stats()
    assert_pool_stats_equal(stats, sj.pool_stats())
    assert stats["allocated_blocks"] == 0 and stats["high_water_blocks"] > 0
    assert not stats["exhausted"]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_scheduler_pool_budget_serializes_admission(tiny_arch, tiny_params,
                                                    port, use_kernel):
    max_len = 12
    _, probe = _pair(tiny_arch, tiny_params, port, use_kernel, paged=True)
    demand = probe.scheduler(num_lanes=2,
                             max_len=max_len)._lane_pool_demand(max_len)
    jeng, teng = _pair(tiny_arch, tiny_params, port, use_kernel, paged=True,
                       pool_blocks=int(max(demand)))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, tiny_arch.vocab_size, size=(8,)).astype(np.int32)
               for _ in range(2)]

    def run(eng, req_cls):
        sched = eng.scheduler(num_lanes=2, max_len=max_len)
        for i, p in enumerate(prompts):
            sched.submit(req_cls(uid=i, prompt=p, max_new=4))
        return {r.uid: r for r in sched.run()}, sched

    rj, sj = run(jeng, JRequest)
    rt, st = run(teng, Request)
    assert_results_equal(rt, rj)
    ticks = sorted(r.admitted_tick for r in rt.values())
    assert ticks[1] > ticks[0], "the second request waits for pool pages"
    stats = st.pool_stats()
    assert_pool_stats_equal(stats, sj.pool_stats())
    assert not stats["exhausted"] and stats["allocated_blocks"] == 0


# -- preemption and failure traces ---------------------------------------------


def _fault_pair(tiny_arch, tiny_params, port, pool_blocks=8, dtype=None):
    """Paged engines with a tight pool: a lane's worst-case demand at
    max_len 24 is 6 pages, so two lanes oversubscribe 8 pages."""
    return _pair(tiny_arch, tiny_params, port, False, chunk=4, dtype=dtype,
                 paged=True, block_p=8, pool_blocks=pool_blocks)


def _serve(eng, reqs, sched_kw=None, patch=None, lanes=2):
    sched = eng.scheduler(num_lanes=lanes, max_len=24, **(sched_kw or {}))
    if patch is not None:
        patch(sched)
    for r in reqs:
        sched.submit(r)
    return {r.uid: r for r in sched.run()}, sched


def _reqs(cls, tiny_arch, seeds, plen, max_new, **kw):
    return [cls(uid=i, prompt=_prompt(plen, seed=s, vocab=tiny_arch.vocab_size),
                max_new=max_new, **kw) for i, s in enumerate(seeds)]


def test_oversubscribed_preempt_mode_absorbs_pressure(tiny_arch, tiny_params,
                                                      port):
    jeng, teng = _fault_pair(tiny_arch, tiny_params, port)
    kw = dict(oversub=2.0, on_pressure="preempt")
    rj, sj = _serve(jeng, _reqs(JRequest, tiny_arch, (50, 51), 10, 8), kw)
    rt, st = _serve(teng, _reqs(Request, tiny_arch, (50, 51), 10, 8), kw)
    assert_results_equal(rt, rj)
    stats = st.pool_stats()
    assert_pool_stats_equal(stats, sj.pool_stats())
    assert not stats["exhausted"]
    life = stats["lifecycle"]
    assert life["preemptions"] > 0 and life["resumes"] == life["preemptions"]
    assert all(r.status == "ok" and r.latency_ticks > 0 for r in rt.values())
    # every request equals its solo run
    for r in _reqs(Request, tiny_arch, (50, 51), 10, 8):
        solo, _ = _serve(teng, [r])
        np.testing.assert_array_equal(rt[r.uid].tokens, solo[r.uid].tokens)


def test_pool_exhausted_backstop_fails_instead_of_corrupting(tiny_arch,
                                                             tiny_params, port):
    jeng, teng = _fault_pair(tiny_arch, tiny_params, port)
    kw = dict(oversub=2.0, on_pressure="preempt")

    def corner(sched):           # no pressure relief: only the backstop
        sched._relieve_pressure = lambda results: None

    rj, sj = _serve(jeng, _reqs(JRequest, tiny_arch, (50, 51), 10, 8), kw,
                    corner)
    rt, st = _serve(teng, _reqs(Request, tiny_arch, (50, 51), 10, 8), kw,
                    corner)
    assert_results_equal(rt, rj)
    assert any(r.status == "failed" for r in rt.values())
    assert not st.pool_stats()["exhausted"]        # the latch was consumed
    assert st.lifecycle_stats() == {k: sj.lifecycle_stats()[k]
                                    for k in st.lifecycle_stats()}


def test_deadline_timeouts_active_and_queued(tiny_arch, tiny_params, port):
    jeng, teng = _fault_pair(tiny_arch, tiny_params, port)

    def reqs(cls):
        p = _prompt(8, seed=9, vocab=tiny_arch.vocab_size)
        return [cls(uid=0, prompt=p, max_new=10, deadline=3),
                cls(uid=1, prompt=p, max_new=2, deadline=1)]

    rj, sj = _serve(jeng, reqs(JRequest), lanes=1)
    rt, st = _serve(teng, reqs(Request), lanes=1)
    assert_results_equal(rt, rj)
    assert rt[0].status == rt[1].status == "timeout"
    assert rt[1].admitted_tick == -1
    assert st.lifecycle_stats()["timeouts"] == 2


def test_nan_tripwire_fails_lane_and_isolates_neighbours(tiny_arch,
                                                         tiny_params, port):
    jeng, teng = _fault_pair(tiny_arch, tiny_params, port, pool_blocks=None,
                             dtype="float32")
    rj, sj = _serve(jeng, _reqs(JRequest, tiny_arch, (60, 61), 8, 6),
                    dict(faults=JFaultPlan([JFault("nan_logits", tick=2,
                                                   lane=0)])))
    rt, st = _serve(teng, _reqs(Request, tiny_arch, (60, 61), 8, 6),
                    dict(faults=FaultPlan([Fault("nan_logits", tick=2,
                                                 lane=0)])))
    assert_results_equal(rt, rj)
    assert sorted(r.status for r in rt.values()) == ["failed", "ok"]
    assert st.lifecycle_stats()["failures"] == 1


def test_submit_rejects_unservable_request(tiny_arch, tiny_params, port):
    _, teng = _fault_pair(tiny_arch, tiny_params, port)   # 8 pages, 6 a lane
    sched = teng.scheduler(num_lanes=2, max_len=24)
    prompt = _prompt(10, seed=3, vocab=tiny_arch.vocab_size)
    with pytest.raises(ValueError, match="pool"):
        sched.submit(Request(uid=0, prompt=prompt, max_new=8, width=2))
    sched.submit(Request(uid=1, prompt=prompt, max_new=8))


@pytest.mark.parametrize("seed", [3, 7])
def test_seeded_fault_plans_replay_the_reference(tiny_arch, tiny_params, port,
                                                 seed):
    """A seeded random plan (pool shrink, CoW storm, forced preemption,
    stall, NaN) draws the same faults in both packages and leaves the same
    statuses, tokens, counters and pool state."""
    jeng, teng = _fault_pair(tiny_arch, tiny_params, port, pool_blocks=14)
    jplan = JFaultPlan.random(seed, lanes=2, horizon=8, max_faults=3)
    tplan = FaultPlan.random(seed, lanes=2, horizon=8, max_faults=3)
    assert [dataclasses.astuple(f) for f in tplan.faults] == \
        [dataclasses.astuple(f) for f in jplan.faults]
    kw = dict(oversub=2.0)
    rj, sj = _serve(jeng, _reqs(JRequest, tiny_arch, (70, 71, 72), 9, 6),
                    dict(kw, faults=jplan))
    rt, st = _serve(teng, _reqs(Request, tiny_arch, (70, 71, 72), 9, 6),
                    dict(kw, faults=tplan))
    assert_results_equal(rt, rj)
    assert_pool_stats_equal(st.pool_stats(), sj.pool_stats())
    assert tplan.log == jplan.log
