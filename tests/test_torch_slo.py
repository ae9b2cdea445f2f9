"""The port's SLO ladder against the JAX reference: the SLO cases of
``tests/test_scheduler.py`` and the ``benchmarks/slo_harness.py`` trace.

Every scenario runs through the JAX ``Engine`` and the port's on the same
tiny model (weights copied through numpy) and the same requests, and holds
each result's status, ticks (admitted, finished, first token), TTFT, TPOT,
``degraded``, served width and prefill reads, and the scheduler's
``slo_stats()`` and ``lifecycle_stats()`` equal to the reference's; then
the reference test's own assertions run on the port.  Scheduling is host
arithmetic over integers, so everything is compared exactly; greedy tokens
are compared against a solo run of the port at the served width (the
ladder changes widths, never tokens).
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.core.config import KVPolicyConfig as JKV
from repro.serving import workload as jworkload
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import SLOSpec as JSLO
from repro.serving.scheduler import compute_slo_stats as jstats
from repro_torch import bridge
from repro_torch.core.config import KVPolicyConfig
from repro_torch.serving import workload
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import (Request, SLOSpec,
                                           compute_slo_stats, slo_attained)

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

FIELDS = ("status", "admitted_tick", "finished_tick", "first_token_tick",
          "ttft_ticks", "tpot_ticks", "degraded", "latency_ticks",
          "preempt_count")


def _prompt(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(3, vocab, size=(n,)).astype(np.int32)


@pytest.fixture(scope="module")
def engines(tiny_arch, tiny_params):
    """Fixed-arena engines (no pool), chunk 4, as the reference's SLO tests
    use: the ladder without the preemption layer's pool pressure."""
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")
    kw = dict(kind="dms", cr=2.0, window=tiny_arch.dms.window)
    return (JEngine(tiny_arch, tiny_params, JKV(**kw), chunk=4),
            Engine(tarch, params, KVPolicyConfig(**kw), chunk=4, device="cpu"))


def _slo_pair(**kw):
    return JSLO(**kw), SLOSpec(**kw)


def _drive(engines, reqs, *, lanes, max_len, slo=None):
    """``reqs`` (port Requests) through both engines; checks every result
    and the scheduler's stats against the reference and returns the port's
    results by uid and its scheduler."""
    jeng, teng = engines
    jslo, tslo = (None, None) if slo is None else _slo_pair(**slo)
    js = jeng.scheduler(num_lanes=lanes, max_len=max_len, slo=jslo)
    ts = teng.scheduler(num_lanes=lanes, max_len=max_len, slo=tslo)
    for r in reqs:
        js.submit(JRequest(**dataclasses.asdict(r)))
        ts.submit(r)
    jres = {r.uid: r for r in js.run()}
    tres = {r.uid: r for r in ts.run()}
    assert sorted(jres) == sorted(tres)
    for uid in jres:
        for f in FIELDS:
            assert getattr(tres[uid], f) == getattr(jres[uid], f), (uid, f)
        np.testing.assert_array_equal(tres[uid].lengths, jres[uid].lengths)
        assert tres[uid].prefill_meter.kv_reads \
            == jres[uid].prefill_meter.kv_reads, uid
    assert ts.lifecycle_stats() == js.lifecycle_stats()
    assert ts.slo_stats() == js.slo_stats()
    assert (ts.ticks, ts.offered) == (js.ticks, js.offered)
    return tres, ts


def test_deadline_boundary_exact_tick(tiny_arch, engines):
    prompt = _prompt(8, seed=70, vocab=tiny_arch.vocab_size)
    kw = dict(lanes=1, max_len=24)
    lat = _drive(engines, [Request(uid=0, prompt=prompt, max_new=4)],
                 **kw)[0][0].latency_ticks
    res = _drive(engines, [Request(uid=0, prompt=prompt, max_new=4,
                                   deadline=lat)], **kw)[0][0]
    assert res.status == "ok" and res.finished_tick == lat
    res = _drive(engines, [Request(uid=0, prompt=prompt, max_new=4,
                                   deadline=lat - 1)], **kw)[0][0]
    assert res.status == "ok" and res.finished_tick == lat
    res = _drive(engines, [Request(uid=0, prompt=prompt, max_new=4,
                                   deadline=lat - 2)], **kw)[0][0]
    assert res.status == "timeout" and res.finished_tick == (lat - 2) + 1
    res = _drive(engines, [Request(uid=0, prompt=prompt, max_new=8),
                           Request(uid=1, prompt=prompt, max_new=4,
                                   deadline=1)], **kw)[0][1]
    assert res.status == "timeout" and res.admitted_tick == -1
    assert res.finished_tick == 1 + 1


def test_bounded_queue_rejects_newest_arrivals(tiny_arch, engines):
    prompt = _prompt(8, seed=71, vocab=tiny_arch.vocab_size)
    reqs = [Request(uid=i, prompt=prompt, max_new=4) for i in range(3)]
    reqs.append(Request(uid=3, prompt=prompt, max_new=4, arrival=30))
    results, sched = _drive(engines, reqs, lanes=1, max_len=24,
                            slo=dict(max_queue=1, shed=False,
                                     degrade_width=False))
    assert results[0].status == "ok"
    for uid in (1, 2):
        assert results[uid].status == "rejected", uid
        assert results[uid].admitted_tick == -1
        assert results[uid].prefill_meter.kv_reads == 0
    assert results[3].status == "ok"
    life = sched.lifecycle_stats()
    assert life["rejected"] == 2 and life["shed"] == 0
    assert sched.offered == 4


def test_shed_provably_doomed_request_zero_prefill(tiny_arch, engines):
    long = Request(uid=0, prompt=_prompt(12, seed=72,
                                         vocab=tiny_arch.vocab_size),
                   max_new=10)
    doomed = Request(uid=1, prompt=_prompt(12, seed=73,
                                           vocab=tiny_arch.vocab_size),
                     max_new=8, deadline=6)
    results, sched = _drive(engines, [long, doomed], lanes=1, max_len=24,
                            slo=dict(degrade_width=False))
    assert results[0].status == "ok"
    assert results[1].status == "rejected"
    assert results[1].admitted_tick == -1
    assert results[1].prefill_meter.kv_reads == 0
    assert results[1].finished_tick <= doomed.deadline
    life = sched.lifecycle_stats()
    assert life["shed"] == 1 and life["timeouts"] == 0
    results, _ = _drive(engines, [dataclasses.replace(long),
                                  dataclasses.replace(doomed)],
                        lanes=1, max_len=24)
    assert results[1].status == "timeout"


def test_width_degradation_token_equal_and_hysteresis(tiny_arch, engines):
    teng = engines[1]
    reqs = [Request(uid=i, prompt=_prompt(8, seed=80 + i,
                                          vocab=tiny_arch.vocab_size),
                    max_new=4, width=2) for i in range(3)]
    slo = dict(min_width=1, cooldown_ticks=4)
    results, sched = _drive(engines, reqs, lanes=2, max_len=24, slo=slo)
    assert sched.lifecycle_stats()["degraded"] >= 1
    saw_degraded = False
    for r in reqs:
        got = results[r.uid]
        assert got.status == "ok"
        served_w = len(got.lengths)
        assert got.degraded == (served_w < r.width)
        saw_degraded |= got.degraded
        solo = teng.scheduler(num_lanes=2, max_len=24)
        solo.submit(dataclasses.replace(r, width=served_w, arrival=0))
        ref = solo.run()[0]
        np.testing.assert_array_equal(got.tokens, ref.tokens,
                                      err_msg=f"uid {r.uid}")
        np.testing.assert_array_equal(got.lengths, ref.lengths)
    assert saw_degraded
    res, sched = _drive(engines, [dataclasses.replace(reqs[0])], lanes=2,
                        max_len=24, slo=slo)
    assert not res[0].degraded and len(res[0].lengths) == 2
    assert sched.lifecycle_stats()["degraded"] == 0


def test_ttft_tpot_metering_and_slo_stats(tiny_arch, engines):
    slo = dict(ttft_ticks=4, tpot_ticks=1.0)
    p0 = _prompt(8, seed=90, vocab=tiny_arch.vocab_size)
    results, sched = _drive(engines, [Request(uid=0, prompt=p0, max_new=6)],
                            lanes=1, max_len=24, slo=slo)
    res = results[0]
    assert res.first_token_tick == 2 and res.ttft_ticks == 2
    assert res.tpot_ticks == pytest.approx(
        (res.finished_tick - res.first_token_tick) / 5)
    assert slo_attained(res, SLOSpec(**slo))
    stats = sched.slo_stats()
    assert stats["offered"] == 1 and stats["goodput"] == 1.0
    assert stats["ttft"]["p50"] == 2.0
    assert stats["queue_depth"]["max"] == 0
    assert 0.0 < stats["lane_util"] <= 1.0
    assert stats["lifecycle"]["completed"] == 1
    results, _ = _drive(engines, [
        Request(uid=0, prompt=p0, max_new=6),
        Request(uid=1, prompt=_prompt(8, seed=91, vocab=tiny_arch.vocab_size),
                max_new=4, deadline=1)], lanes=1, max_len=24, slo=slo)
    assert results[1].ttft_ticks == -1
    assert not slo_attained(results[1], SLOSpec(**slo))


def test_slo_spec_validation(engines):
    with pytest.raises(ValueError, match="min_width"):
        engines[1].scheduler(num_lanes=1, max_len=24,
                             slo=SLOSpec(min_width=0))


# -- benchmarks/slo_harness.py at its smoke size ---------------------------------

HARNESS = dict(lanes=2, max_len=24, n=12)
HARNESS_SLO = dict(ttft_ticks=6, max_queue=4, min_width=1, cooldown_ticks=4)


def _harness_spec(mod):
    return mod.WorkloadSpec(vocab=64, max_len=HARNESS["max_len"],
                            prompt_len=(6, 10), max_new=(4, 6),
                            widths=(1, 2), deadline=12)


def test_slo_harness_trace_matches_reference(engines):
    """The harness's 2x-overload burst trace, uncontrolled and controlled:
    equal to the reference run for run; the ladder beats no control on
    goodput; every status definite; shed requests read nothing; every ok
    request equals a solo run at its served width.  Then the calm Poisson
    trace: nothing shed or degraded, goodput 1.0."""
    jeng, teng = engines
    treqs = workload.burst_trace(0, HARNESS["n"], rate=2.0, on_ticks=4,
                                 off_ticks=4, spec=_harness_spec(workload))
    jreqs = jworkload.burst_trace(0, HARNESS["n"], rate=2.0, on_ticks=4,
                                  off_ticks=4, spec=_harness_spec(jworkload))
    for a, b in zip(treqs, jreqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
    kw = dict(lanes=HARNESS["lanes"], max_len=HARNESS["max_len"])
    base, _ = _drive(engines, treqs, **kw)
    ctrl, sched = _drive(engines, treqs, slo=HARNESS_SLO, **kw)
    slo = SLOSpec(**HARNESS_SLO)
    base_stats = compute_slo_stats(list(base.values()), slo,
                                   offered=len(treqs))
    ctrl_stats = sched.slo_stats()
    want = jstats(list(base.values()), JSLO(**HARNESS_SLO),
                  offered=len(treqs))
    assert base_stats == want
    assert ctrl_stats["goodput"] > base_stats["goodput"], (ctrl_stats,
                                                           base_stats)
    definite = {"ok", "failed", "timeout", "rejected"}
    assert all(r.status in definite for r in list(base.values())
               + list(ctrl.values()))
    life = ctrl_stats["lifecycle"]
    assert life["shed"] + life["rejected"] > 0 and life["degraded"] > 0
    by_uid = {r.uid: r for r in treqs}
    for r in ctrl.values():
        if r.status == "rejected":
            assert r.prefill_meter.kv_reads == 0 and r.admitted_tick == -1
        if r.status != "ok":
            continue
        w = len(r.lengths)
        solo = teng.scheduler(num_lanes=max(HARNESS["lanes"], w),
                              max_len=HARNESS["max_len"])
        solo.submit(dataclasses.replace(by_uid[r.uid], width=w, arrival=0,
                                        deadline=None))
        s = solo.run()[0]
        np.testing.assert_array_equal(r.tokens, s.tokens, err_msg=str(r.uid))
        np.testing.assert_array_equal(r.lengths, s.lengths)

    calm_spec = dataclasses.replace(_harness_spec(workload), deadline=None,
                                    widths=(1,), width_weights=None)
    calm = workload.poisson_trace(1, 6, rate=0.2, spec=calm_spec)
    _, calm_sched = _drive(engines, calm, slo=HARNESS_SLO, **kw)
    st = calm_sched.slo_stats()
    assert st["goodput"] == 1.0 and st["lifecycle"]["shed"] == 0 \
        and st["lifecycle"]["degraded"] == 0
