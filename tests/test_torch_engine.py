"""The slice as a whole: the port's ``Engine`` (CPU, the decode kernel's
plain version) against the JAX ``Engine`` with ``use_kernel=True`` (Pallas
interpret mode) on traces the reference suite already pins:

(a) ``tests/test_kernels.py::test_scheduler_smoke_with_kernel`` — 2 prompts
    of 11 tokens, ``dms`` at CR 2, 5 new tokens;
(b) ``tests/test_scheduler.py::test_eos_lane_is_reclaimed_for_queued_request``
    — 4 staggered prompts on 2 lanes, lanes reclaimed and reused;
(c) ``tests/test_scheduler.py::test_fork_prefill_reads_drop_by_width`` — a
    width-4 ``hyperscale_generate`` whose prefill meters 4x fewer reads than
    4 tiled prefills.

Greedy tokens must be equal, and so must the budget meters (``kv_reads``,
``peak_tokens``): they count integer tokens in the same order.  A fourth
trace runs (b) in fp32 with the DMS bias at 0, so that tokens are evicted
mid-prompt and the whole eviction path is exercised end to end; a fifth
runs (b) sampled at temperature 0.7 from seeded keys.
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.core.config import KVPolicyConfig as JKV
from repro.core.hyperscale import ScalingConfig as JScaling
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import bridge
from repro_torch.core.config import KVPolicyConfig
from repro_torch.core.hyperscale import ScalingConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)


def _prompt(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(3, vocab, size=(n,)).astype(np.int32)


def _engines(tiny_arch, tiny_params, cr=2.0, dtype=None, bias=None,
             temperature=0.0):
    jarch = tiny_arch
    if dtype is not None:
        jarch = dataclasses.replace(jarch, dtype=dtype, dms=dataclasses.replace(
            jarch.dms, logit_bias=bias))
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")
    kw = dict(kind="dms", cr=cr, window=jarch.dms.window)
    return (JEngine(jarch, tiny_params, JKV(**kw), use_kernel=True,
                    temperature=temperature),
            Engine(tarch, params, KVPolicyConfig(**kw), use_kernel=True,
                   temperature=temperature, device="cpu"))


def assert_meters_equal(mt, mj, what):
    for key in ("kv_reads", "peak_tokens", "peak_bytes", "steps",
                "generated_tokens"):
        assert getattr(mt, key) == getattr(mj, key), (what, key)


def test_trace_a_two_prompts_kernel_path(tiny_arch, tiny_params):
    jeng, teng = _engines(tiny_arch, tiny_params)
    prompts = np.random.default_rng(5).integers(
        3, tiny_arch.vocab_size, size=(2, 11)).astype(np.int32)
    rj = jeng.generate(prompts, 5)
    rt = teng.generate(prompts, 5)
    assert rt.tokens.shape == (2, 5)
    np.testing.assert_array_equal(rt.tokens, rj.tokens)
    assert_meters_equal(rt.meter, rj.meter, "generate")
    for a, b in zip(rt.requests, rj.requests):
        assert_meters_equal(a.prefill_meter, b.prefill_meter, "prefill")
        assert_meters_equal(a.decode_meter, b.decode_meter, "decode")


def _staggered(eng, req_cls, prompts):
    sched = eng.scheduler(num_lanes=2, max_len=32)
    for i, p in enumerate(prompts):
        sched.submit(req_cls(uid=i, prompt=p, max_new=5, arrival=i))
    return {r.uid: r for r in sched.run()}


@pytest.mark.parametrize("dtype,bias", [(None, None), ("float32", 0.0)])
def test_trace_b_staggered_lane_reuse(tiny_arch, tiny_params, dtype, bias):
    jeng, teng = _engines(tiny_arch, tiny_params, dtype=dtype, bias=bias)
    prompts = [_prompt(n, seed=10 + n, vocab=tiny_arch.vocab_size)
               for n in (9, 14, 6, 11)]
    rj = _staggered(jeng, JRequest, prompts)
    rt = _staggered(teng, Request, prompts)
    assert sorted(rt) == [0, 1, 2, 3]
    for i in range(4):
        assert rt[i].status == "ok"
        np.testing.assert_array_equal(rt[i].tokens, rj[i].tokens, err_msg=str(i))
        assert_meters_equal(rt[i].meter, rj[i].meter, f"request {i}")
        assert (rt[i].admitted_tick, rt[i].finished_tick) == \
            (rj[i].admitted_tick, rj[i].finished_tick)
    if bias == 0.0:        # about half the tokens were evicted mid-prompt
        assert rt[1].meter.peak_tokens < tiny_arch.num_layers * (14 + 5 - 1)
    # a request served on a reclaimed lane equals a solo run on a fresh arena
    solo = teng.scheduler(num_lanes=1, max_len=32)
    solo.submit(Request(uid=0, prompt=prompts[3], max_new=5))
    np.testing.assert_array_equal(solo.run()[0].tokens, rt[3].tokens)


def test_trace_c_hyperscale_fork(tiny_arch, tiny_params):
    jeng, teng = _engines(tiny_arch, tiny_params)
    w, t0 = 4, 16
    prompt = _prompt(t0, seed=2, vocab=tiny_arch.vocab_size)
    rj = jeng.hyperscale_generate(prompt, JScaling(t0 + 6, w))
    rt = teng.hyperscale_generate(prompt, ScalingConfig(t0 + 6, w))
    assert rt.tokens.shape == (w, 6)
    np.testing.assert_array_equal(rt.tokens, rj.tokens)
    assert_meters_equal(rt.meter, rj.meter, "hyperscale")
    assert_meters_equal(rt.requests[0].prefill_meter,
                        rj.requests[0].prefill_meter, "prefill")
    # the shared prefill meters W x fewer reads than W tiled prefills, and
    # the forked chains equal the tiled ones
    tiled = teng.generate(np.tile(prompt[None], (w, 1)), 6)
    fork_pre = rt.requests[0].prefill_meter.kv_reads
    assert fork_pre == pytest.approx(
        sum(r.prefill_meter.kv_reads for r in tiled.requests) / w)
    np.testing.assert_array_equal(rt.tokens, tiled.tokens)


def test_temperature_sampling_matches_reference(tiny_arch, tiny_params):
    """Trace (b) at temperature 0.7: every request's first token comes from
    the scheduler's per-request key and every later one from the chunk
    step's, so seeded tokens and meters equal the reference's across
    staggered admissions and reused lanes (pinned seeds: no near tie)."""
    jeng, teng = _engines(tiny_arch, tiny_params, temperature=0.7)
    prompts = [_prompt(n, seed=10 + n, vocab=tiny_arch.vocab_size)
               for n in (9, 14, 6, 11)]
    for seed in (0, 7):
        runs = []
        for eng, req_cls in ((jeng, JRequest), (teng, Request)):
            sched = eng.scheduler(num_lanes=2, max_len=32, seed=seed)
            for i, p in enumerate(prompts):
                sched.submit(req_cls(uid=i, prompt=p, max_new=5, arrival=i))
            runs.append({r.uid: r for r in sched.run()})
        rj, rt = runs
        for i in range(4):
            np.testing.assert_array_equal(rt[i].tokens, rj[i].tokens,
                                          err_msg=f"seed {seed} request {i}")
            assert_meters_equal(rt[i].meter, rj[i].meter, f"request {i}")
