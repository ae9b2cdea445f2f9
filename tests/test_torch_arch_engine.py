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

The hybrids: recurrentgemma (an RG-LRU state beside a local-attention
cache) under ``dms``, ``window`` and ``vanilla`` and mamba2 (SSD states
only, no cache) under ``vanilla``, on the same trace fixed and paged; a
recurrentgemma prefix-cache trace whose snapshots carry the RG-LRU state;
and both archs' prefix-cache entry bytes.  XLA's bf16 SiLU and GELU round
apart from torch's in some elements (ROADMAP's bf16 caveat); the pinned
prompts (seeds 13, 27 and 50, and the prefix trace's 4) meet no near tie.
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
    kw = {"kind": "dms", "cr": 2.0, "window": jarch.dms.window, **pol}
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


def _warm_equals_cold(name, kw):
    """Two requests sharing a 20-token prefix through the prefix cache (its
    hot slab): the second's suffix prefill starts from the first's
    snapshot, and its tokens equal a cold serve's and the reference's."""
    jarch, jparams, tarch, tparams = _port(name)
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


def test_gemma2_prefix_cache_warm_equals_cold():
    """``_warm_equals_cold`` on a two-position state (a window ring on the
    local layer, dms on the global one)."""
    _warm_equals_cold("gemma2-2b", dict(
        kind="dms", cr=2.0, window=_port("gemma2-2b")[2].dms.window,
        budget=12, layer_map={"attn_local": "window", "attn": "dms"}))


def _preemption_trace(name, kw, prompts):
    """Two lanes oversubscribe the pool of ``kw`` (``oversub`` 2):
    preemption and resume, equal to the reference and to solo runs."""
    jeng, teng = _engines(name, chunk=4, **kw)
    over = dict(oversub=2.0, on_pressure="preempt")
    rj, sj = _serve(jeng, JRequest, prompts, max_len=24, max_new=8, **over)
    rt, st = _serve(teng, Request, prompts, max_len=24, max_new=8, **over)
    assert_same(rt, rj)
    life = st.pool_stats()["lifecycle"]
    assert life == sj.pool_stats()["lifecycle"]
    assert life["preemptions"] > 0 and life["resumes"] == life["preemptions"]
    for i, p in enumerate(prompts):
        solo, _ = _serve(teng, Request, [p], lanes=1, max_len=24, max_new=8)
        np.testing.assert_array_equal(rt[i].tokens, solo[0].tokens)


def test_granite_paged_preemption_matches_reference():
    """A pool of 10 pages (a lane's worst case at max_len 24 is 3 pages a
    kv head, 6 a layer) on an MoE model."""
    name = "granite-moe-1b-a400m"
    _preemption_trace(name, dict(paged=True, block_p=8, pool_blocks=10),
                      _prompts(name, lens=(10, 10), seed=50))


HYBRID_CASES = [("recurrentgemma-2b", "dms"), ("recurrentgemma-2b", "window"),
                ("recurrentgemma-2b", "vanilla"), ("mamba2-2.7b", "vanilla")]


def _hybrid_policy(name, kind, **kw):
    jarch = _port(name)[0]
    return dict(kind=kind, cr=2.0, window=jarch.dms.window,
                budget=12 if kind == "window" else None, **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("name,kind", HYBRID_CASES,
                         ids=[f"{n}-{k}" for n, k in HYBRID_CASES])
def test_hybrid_engine_matches_reference(name, kind, paged):
    """The staggered trace on two lanes (lanes reclaimed and reused, the
    recurrent state reset with them); the 14-token prompt plus 5 new
    tokens outruns the smoke window of 16, so recurrentgemma's local
    caches hide keys.  mamba2 has no cache: no pool, zero reads."""
    jeng, teng = _engines(name, **_hybrid_policy(name, kind, paged=paged,
                                                 block_p=8))
    prompts = _prompts(name)
    rj, sj = _serve(jeng, JRequest, prompts)
    rt, st = _serve(teng, Request, prompts)
    assert_same(rt, rj)
    if name == "mamba2-2.7b":
        assert st.pool_stats() is None and st.peak_bytes == 0.0
        assert all(r.meter.kv_reads == 0 for r in rt.values())
    else:
        assert st.peak_bytes == sj.peak_bytes > 0


def test_recurrentgemma_prefix_cache_warm_equals_cold():
    """``_warm_equals_cold`` with the snapshot carrying the RG-LRU state
    beside the local cache."""
    _warm_equals_cold("recurrentgemma-2b",
                      _hybrid_policy("recurrentgemma-2b", "dms"))


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("name,kind", [HYBRID_CASES[0], HYBRID_CASES[3]],
                         ids=["recurrentgemma-2b", "mamba2-2.7b"])
def test_snapshot_bytes_match_reference(name, kind, paged):
    """One prefix-cache entry's bytes (a lane snapshot, recurrent leaves
    included, and its logits row) equal the reference's, as
    ``test_torch_prefix_cache.py``'s test of that name holds them for the
    dense model."""
    jarch, jparams, tarch, tparams = _port(name)
    kw = _hybrid_policy(name, kind, paged=paged, block_p=8)
    want = JEngine(jarch, jparams, JKV(**kw), prefix_cache_mb=64).scheduler(
        num_lanes=2, max_len=32)._snap_nbytes
    got = Engine(tarch, tparams, KVPolicyConfig(**kw), device="cpu",
                 prefix_cache_mb=64).scheduler(
        num_lanes=2, max_len=32)._snap_nbytes
    assert got == want


def test_recurrentgemma_paged_preemption_matches_reference():
    """A pool of 4 pages: a preempted request's snapshot carries its RG-LRU
    state to the host and back."""
    name = "recurrentgemma-2b"
    _preemption_trace(name, dict(paged=True, block_p=8, pool_blocks=4),
                      _prompts(name, lens=(10, 10), seed=50))


def test_recurrentgemma_fork_matches_reference():
    """A width-2 request: the prompt is prefilled once and the lane forked
    (the RG-LRU state copied with the local cache), beside a width-1
    request; tokens and meters equal the JAX ``Engine``'s."""
    name = "recurrentgemma-2b"
    jeng, teng = _engines(name, block_p=8)
    prompts = _prompts(name, lens=(13, 9), seed=27)
    out = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        sched = eng.scheduler(num_lanes=3, max_len=32)
        for i, (p, w) in enumerate(zip(prompts, (2, 1))):
            sched.submit(req(uid=i, prompt=p, max_new=6, arrival=i, width=w))
        out.append({r.uid: r for r in sched.run()})
    rj, rt = out
    assert_same(rt, rj)
    assert rt[0].tokens.shape == (2, 6)
