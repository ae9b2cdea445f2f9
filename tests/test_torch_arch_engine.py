"""The port's ``Engine`` serving gemma2, chatglm3, qwen2-vl and granite (the
smoke configs, bf16, the reference's seeded weights copied through numpy)
against the JAX ``Engine`` with ``use_kernel=True`` (Pallas interpret mode;
the port's decode kernel runs its plain version on the CPU).

Greedy tokens must be equal, and so must both budget meters (``kv_reads``,
``peak_tokens``): they count integer tokens in the same order.  The trace
is four staggered prompts on two lanes, lanes reclaimed and reused, on
fixed arenas and on the paged pool; gemma2 also under per-kind layer maps
(a window ring on its local layers; TOVA and Keyformer on its global
layers, through the weights-out mode and per-layer noise salts), a prefix
cache (warm equal to cold on a two-position state) and granite under pool
pressure (preemption and resume).  bf16 MoE routing can flip on an ulp, so
the prompts are pinned on seeds with no near tie.
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.config import KVPolicyConfig as JKV
from repro.models import transformer as jtfm
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import bridge
from repro_torch.core.config import KVPolicyConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

NAMES = ("gemma2-2b", "chatglm3-6b", "qwen2-vl-7b", "granite-moe-1b-a400m",
         "granite-moe-3b-a800m")
_PORTS = {}


def _port(name):
    """(reference arch, reference params, port arch, port params), cached
    per module: each family's weights are drawn once."""
    if name not in _PORTS:
        jarch = jget_smoke(name)
        jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
        tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
        tparams = bridge.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu")
        _PORTS[name] = (jarch, jparams, tarch, tparams)
    return _PORTS[name]


def _engines(name, chunk=8, **pol):
    jarch, jparams, tarch, tparams = _port(name)
    kw = dict(kind="dms", cr=2.0, window=jarch.dms.window, **pol)
    return (JEngine(jarch, jparams, JKV(**kw), use_kernel=True, chunk=chunk),
            Engine(tarch, tparams, KVPolicyConfig(**kw), use_kernel=True,
                   chunk=chunk, device="cpu"))


def _prompts(name, lens=(9, 14, 6, 11), seed=13):
    vocab = jget_smoke(name).vocab_size
    return [np.random.default_rng(seed + n).integers(3, vocab, size=(n,))
            .astype(np.int32) for n in lens]


def _serve(eng, req_cls, prompts, lanes=2, max_len=32, max_new=5, **kw):
    sched = eng.scheduler(num_lanes=lanes, max_len=max_len, **kw)
    for i, p in enumerate(prompts):
        sched.submit(req_cls(uid=i, prompt=p, max_new=max_new, arrival=i))
    return {r.uid: r for r in sched.run()}, sched


def assert_same(rt, rj):
    assert sorted(rt) == sorted(rj)
    for uid in rj:
        assert rt[uid].status == rj[uid].status == "ok", uid
        np.testing.assert_array_equal(rt[uid].tokens, rj[uid].tokens,
                                      err_msg=str(uid))
        for key in ("kv_reads", "peak_tokens", "steps", "generated_tokens"):
            assert getattr(rt[uid].meter, key) == getattr(rj[uid].meter, key), \
                (uid, key)


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_reference(name, paged):
    jeng, teng = _engines(name, paged=paged, block_p=8)
    prompts = _prompts(name)
    rj, _ = _serve(jeng, JRequest, prompts)
    rt, _ = _serve(teng, Request, prompts)
    assert_same(rt, rj)


LAYER_MAPS = {
    "window-local": dict(budget=12, layer_map={"attn_local": "window",
                                               "attn": "dms"}),
    "tova-global": dict(budget=12, layer_map={"attn": "tova"}),
    "keyformer-global": dict(budget=12, layer_map={"attn": "keyformer"}),
}


@pytest.mark.parametrize("layout", sorted(LAYER_MAPS))
def test_gemma2_layer_maps_match_reference(layout):
    """Longer prompts than gemma2's smoke window (16), so the local ring
    wraps; the weight-driven global layers evict past their budget."""
    jeng, teng = _engines("gemma2-2b", **LAYER_MAPS[layout])
    prompts = _prompts("gemma2-2b", lens=(21, 15, 26), seed=3)
    rj, _ = _serve(jeng, JRequest, prompts, max_len=40, max_new=6)
    rt, st = _serve(teng, Request, prompts, max_len=40, max_new=6)
    assert_same(rt, rj)
    pols = {key: pc.policy for key, pc in st.state.items()}
    want = dict(LAYER_MAPS[layout]["layer_map"])
    assert pols == {"0": want.get("attn_local", "dms"), "1": want["attn"]}


def test_gemma2_prefix_cache_warm_equals_cold():
    """Two requests sharing a 20-token prefix through the prefix cache
    (its hot slab): the second's suffix prefill starts from the first's
    two-position snapshot, and its tokens equal a cold serve's and the
    reference's."""
    name = "gemma2-2b"
    jarch, jparams, tarch, tparams = _port(name)
    kw = dict(kind="dms", cr=2.0, window=tarch.dms.window, budget=12,
              layer_map={"attn_local": "window", "attn": "dms"})
    pol = KVPolicyConfig(**kw)
    vocab = tarch.vocab_size
    r = np.random.default_rng(4)
    prefix = r.integers(3, vocab, size=(20,)).astype(np.int32)
    prompts = [np.concatenate([prefix, r.integers(3, vocab, size=(n,))
                               .astype(np.int32)]) for n in (5, 8)]
    out = {}
    for mode, mb in (("warm", 64), ("cold", 0)):
        eng = Engine(tarch, tparams, pol, chunk=8, device="cpu",
                     prefix_cache_mb=mb, prefix_cache_device_mb=mb)
        res = []
        for p in prompts:
            sched = eng.scheduler(num_lanes=1, max_len=40)
            sched.submit(Request(uid=0, prompt=p, max_new=5))
            res.append(sched.run()[0])
        out[mode] = (eng, res)
    eng, warm = out["warm"]
    cold = out["cold"][1]
    assert warm[1].prefill_meter.kv_reads_saved > 0
    assert eng.prefix_cache.stats()["hot_hits"] > 0
    jeng = JEngine(jarch, jparams, JKV(**kw), use_kernel=True, chunk=8)
    for w, c, p in zip(warm, cold, prompts):
        np.testing.assert_array_equal(w.tokens, c.tokens)
        sched = jeng.scheduler(num_lanes=1, max_len=40)
        sched.submit(JRequest(uid=0, prompt=p, max_new=5))
        np.testing.assert_array_equal(w.tokens, sched.run()[0].tokens)
    assert warm[1].prefill_meter.kv_reads + \
        warm[1].prefill_meter.kv_reads_saved == \
        pytest.approx(cold[1].prefill_meter.kv_reads)


def test_granite_paged_preemption_matches_reference():
    """Two lanes oversubscribe a pool of 10 pages (a lane's worst case at
    max_len 24 is 3 pages a kv head, 6 a layer): preemption and resume on
    an MoE model, equal to the reference and to solo runs."""
    name = "granite-moe-1b-a400m"
    jeng, teng = _engines(name, chunk=4, paged=True, block_p=8,
                          pool_blocks=10)
    prompts = _prompts(name, lens=(10, 10), seed=50)
    kw = dict(oversub=2.0, on_pressure="preempt")
    rj, sj = _serve(jeng, JRequest, prompts, max_len=24, max_new=8, **kw)
    rt, st = _serve(teng, Request, prompts, max_len=24, max_new=8, **kw)
    assert_same(rt, rj)
    life = st.pool_stats()["lifecycle"]
    assert life == sj.pool_stats()["lifecycle"]
    assert life["preemptions"] > 0 and life["resumes"] == life["preemptions"]
    for i, p in enumerate(prompts):
        solo, _ = _serve(teng, Request, [p], lanes=1, max_len=24, max_new=8)
        np.testing.assert_array_equal(rt[i].tokens, solo[0].tokens)
