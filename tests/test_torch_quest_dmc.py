"""The port's ``quest`` and ``dmc`` policies against the reference.

(a) ``block_pool.gather_rows`` reads the reference's rows on mapped and
    unmapped slots of an fp32 pool.
(b) ``QuestCache`` and ``DMCCache`` leaf for leaf after every
    ``decode_update`` of a random q/K/V/α stream, on fixed arenas and on
    the paged pool, with partial ``active`` masks: a frozen lane equals
    the reference's after its ``lane_select`` rollback, and the step's
    ``live_tokens`` and ``reads_tokens`` equal the reference's ``metrics``
    before it.  Quest's page selection, its table, ``n`` and token mask
    equal the reference's on active lanes; DMC's operands are its fp32
    accumulators cast to the model dtype.  Then the lifecycle hooks: gather
    fork, reclaim (kmin back to +inf, kmax to -inf), export/import, width-2
    fork.  A tie case selects more than ``top_pages`` pages in both.
(c) The slice as a whole: the port's ``Engine`` against the JAX ``Engine``
    (``use_kernel=True``: Pallas interpret mode against the plain version
    of the CUDA kernel) — tokens and meters on the traces
    ``tests/test_block_tables.py::test_quest_scheduler_smoke_use_kernel``
    and ``tests/test_policy_registry.py::test_quest_meters_reads_not_size``
    pin, greedy, fixed and paged; Quest's ``kv_reads`` below vanilla's at
    equal ``peak_tokens``; a width-4 fork sampled at temperature 0.7; and
    a paged pool oversubscribed so that a request is preempted and
    resumed.  Sampled parity of ``generate`` is in
    ``tests/test_torch_hyperscale.py``.

Tolerances: none — leaves, masks, tables, meters and tokens compare
exactly, DMC's fp32 accumulators included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import block_pool as jbp
from repro.core import policy as jpolicy
from repro.core.config import KVPolicyConfig as JKV
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import bridge
from repro_torch.core import block_pool as tbp
from repro_torch.core import policy as tpolicy
from repro_torch.core.config import KVPolicyConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

torch.set_num_threads(1)

POOL_LEAVES = ("k", "v", "ref", "cow_copies", "alloc_events", "high_water",
               "exhausted")
METERS = ("kv_reads", "peak_tokens", "peak_bytes", "steps", "generated_tokens")


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _lane_sel(act, new, old):
    """The reference's lane_select on an unstacked cache: the pool is kept."""
    def sel(x, y):
        if isinstance(x, jbp.BlockPool):
            return x
        m = jnp.asarray(act).reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(m, x, y)
    return jax.tree_util.tree_map(sel, new, old,
                                  is_leaf=lambda x: isinstance(x, jbp.BlockPool))


def assert_cache_same(tc, jc, where=""):
    assert type(tc).__name__ == type(jc).__name__
    fields = [(f.name, f.metadata.get("static")) for f in dataclasses.fields(tc)]
    assert fields == [(f.name, f.metadata.get("static"))
                      for f in dataclasses.fields(jc)]
    for name, static in fields:
        t, j = getattr(tc, name), getattr(jc, name)
        if static:
            assert t == j, name
        elif name == "pool":
            assert (t is None) == (j is None)
            if t is not None:
                for leaf in POOL_LEAVES:
                    np.testing.assert_array_equal(
                        _np(getattr(t, leaf)), np.asarray(getattr(j, leaf)),
                        err_msg=f"pool.{leaf} {where}")
        elif t is None:
            assert j is None, name
        else:
            want = np.asarray(j, np.float32 if j.dtype == jnp.bfloat16 else None)
            np.testing.assert_array_equal(_np(t), want.astype(_np(t).dtype),
                                          err_msg=f"{name} {where}")


@pytest.fixture(scope="module")
def arches(tiny_arch):
    jarch = dataclasses.replace(tiny_arch, dtype="float32")
    return jarch, bridge.arch_from_dict(dataclasses.asdict(jarch))


@pytest.fixture(scope="module")
def port(tiny_arch, tiny_params):
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    return tarch, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")


# -- (a) -------------------------------------------------------------------------


def test_gather_rows_matches_reference():
    r = np.random.default_rng(0)
    npool, bp, dh = 6, 4, 8
    pages = r.normal(size=(npool, bp, dh)).astype(np.float32)
    phys = np.array([[[0, 3, -1], [5, -1, 2]],
                     [[-1, -1, -1], [1, 4, 0]]], np.int32)          # (2, 2, 3)
    # (lane, head) (0, 0) and (1, 1) mapped; (0, 1) and (1, 0) unmapped
    slot = np.array([[1, 5], [0, 11]], np.int32)
    for s in (slot, slot + 1, np.zeros_like(slot), np.full_like(slot, 12)):
        want = jbp.gather_rows(jnp.asarray(pages), jnp.asarray(phys),
                               jnp.asarray(s), bp)
        got = tbp.gather_rows(torch.from_numpy(pages), torch.from_numpy(phys),
                              torch.from_numpy(s), bp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tbp.gather_rows(torch.from_numpy(pages), torch.from_numpy(phys),
                          torch.from_numpy(slot), bp)
    np.testing.assert_array_equal(got[0, 0].numpy(), pages[0, 1])
    np.testing.assert_array_equal(got[1, 1].numpy(), pages[0, 3])
    assert not got[0, 1].any() and not got[1, 0].any()   # unmapped: zero


# -- (b) -------------------------------------------------------------------------


KINDS = {"quest": dict(quest_page_size=4, quest_top_pages=2),
         "dmc": dict(cr=2.0)}


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_cache_matches_reference_every_step(arches, kind, paged):
    jarch, tarch = arches
    b, max_len = 3, 30
    kw = dict(kind=kind, block_p=4, paged=paged, **KINDS[kind])
    pol_j, pol_t = jpolicy.get_policy(kind), tpolicy.get_policy(kind)
    jc = jpolicy.init_policy_cache(jarch, b, max_len, JKV(**kw)).cache
    tc = tpolicy.init_policy_cache(tarch, b, max_len, KVPolicyConfig(**kw),
                                   device="cpu").cache
    fresh_j = jc
    fresh_t = tpolicy.init_policy_cache(tarch, b, max_len,
                                        KVPolicyConfig(**kw),
                                        device="cpu").cache
    if paged:       # DMC's pool holds fp32 accumulators in a bf16 model too
        assert tc.pool.block_p == 4 and tc.pool.k.dtype == torch.float32
    a = jarch.attn
    r = np.random.default_rng(len(kind) * 10 + paged)
    merged = []

    def step(jc, tc, i):
        q = r.normal(size=(b, 1, a.num_heads, a.head_dim)).astype(np.float32)
        k = r.normal(size=(b, a.num_kv_heads, 1, a.head_dim)).astype(np.float32)
        v = r.normal(size=(b, a.num_kv_heads, 1, a.head_dim)).astype(np.float32)
        alpha = r.random((b, a.num_kv_heads)) < 0.6
        act = r.random(b) < 0.7 if i % 3 else None
        jaux = {"attn_cfg": a, "arch": jarch, "dtype": jnp.bfloat16,
                "alpha_bin": jnp.asarray(alpha),
                "active": None if act is None else jnp.asarray(act)}
        taux = {"attn_cfg": tarch.attn, "arch": tarch, "dtype": torch.bfloat16,
                "alpha_bin": torch.from_numpy(alpha),
                "active": None if act is None else torch.from_numpy(act)}
        count0 = None if kind != "dmc" else tc.count.clone()
        new, jspec = pol_j.decode_update(jc, jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jaux)
        want = pol_j.metrics(new)
        tc, tspec, meters = pol_t.decode_update(
            tc, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            taux)
        for key in ("live_tokens", "reads_tokens"):
            np.testing.assert_array_equal(meters[key].numpy(),
                                          np.asarray(want[key]),
                                          err_msg=f"{key} step {i}")
        on = np.ones(b, bool) if act is None else act
        vis = tspec.visible.expand(jspec.visible.shape).numpy()
        np.testing.assert_array_equal(vis[on], np.asarray(jspec.visible)[on])
        assert tspec.block_p == jspec.block_p
        for x, y in ((tspec.block_tbl, jspec.block_tbl),
                     (tspec.block_n, jspec.block_n)):
            np.testing.assert_array_equal(x.numpy()[on], np.asarray(y)[on])
        if kind == "dmc":
            # the kernel's operands: the fp32 accumulators cast to bf16
            assert tspec.k.dtype == torch.bfloat16 and tspec.pool is None
            np.testing.assert_array_equal(_np(tspec.k)[on],
                                          np.asarray(jspec.k, np.float32)[on])
            merged.append(int((tc.count == count0).sum()))
        else:
            assert (tspec.pool is None) == (not paged)
        jc = new if act is None else _lane_sel(act, new, jc)
        assert_cache_same(tc, jc, f"step {i}")
        return jc, tc

    for i in range(20):
        jc, tc = step(jc, tc, i)
    if kind == "dmc":
        assert sum(merged) > 0                       # merges ran
    else:
        assert int(tc.length.max()) > 4 * tc.top_pages   # reads < live
    src = np.array([0, 2, 0])
    jc = pol_j.gather_cache(jc, jnp.asarray(src))
    tc = pol_t.gather_cache(tc, torch.from_numpy(src))
    assert_cache_same(tc, jc, "gather fork")
    for i in range(20, 24):
        jc, tc = step(jc, tc, i)
    mask = np.array([False, True, False])
    jc = pol_j.reclaim_cache(jc, jnp.asarray(mask), fresh_j)
    tc = pol_t.reclaim_cache(tc, torch.from_numpy(mask), fresh_t)
    assert_cache_same(tc, jc, "reclaim")
    if kind == "quest":
        assert torch.isinf(tc.kmin[1]).all() and (tc.kmin[1] > 0).all()
        assert torch.isinf(tc.kmax[1]).all() and (tc.kmax[1] < 0).all()
    jsnap, tsnap = pol_j.export_prefix(jc, 0), pol_t.export_prefix(tc, 0)
    assert tsnap.pool is None and tsnap.phys is None
    np.testing.assert_array_equal(_np(tsnap.k), np.asarray(jsnap.k))
    jc = pol_j.import_prefix(jc, jsnap, 1)
    tc = pol_t.import_prefix(tc, tsnap, 1)
    assert_cache_same(tc, jc, "export/import")
    for i in range(24, 27):
        jc, tc = step(jc, tc, i)
    assert_cache_same(pol_t.fork_cache(tc, 2), pol_j.fork_cache(jc, 2),
                      "fork width 2")
    assert pol_t.peak_bytes(tc) == pol_j.peak_bytes(jc)


def test_quest_tie_selects_more_than_top_pages(arches):
    """Pages whose upper-bound scores tie at the ``top_pages``-th value are
    all selected: ``n`` exceeds ``top_pages``, the table lists the selected
    pages ascending, and an unwritten page (NaN score) is never listed."""
    jarch, tarch = arches
    a = jarch.attn
    b, h, ps, top = 2, a.num_kv_heads, 4, 2
    kw = dict(kind="quest", quest_page_size=ps, quest_top_pages=top)
    jc = jpolicy.init_policy_cache(jarch, b, 32, JKV(**kw)).cache
    tc = tpolicy.init_policy_cache(tarch, b, 32, KVPolicyConfig(**kw),
                                   device="cpu").cache
    # 5 written pages (18 tokens): pages 1, 2 and 4 hold the same keys, page
    # 0 a larger one, page 3 smaller; pages 5-7 are unwritten
    rows = np.ones((18, a.head_dim), np.float32)
    rows[0:4] *= 2.0
    rows[12:16] *= 0.5
    for t in range(18):
        kt = np.broadcast_to(rows[t], (b, h, 1, a.head_dim)).copy()
        jc = jc.append(jnp.asarray(kt), jnp.asarray(kt))
        tc.append(torch.from_numpy(kt), torch.from_numpy(kt))
    q = np.ones((b, h, a.head_dim), np.float32)
    q[..., 0] = 0.0             # 0 · ±inf: NaN on the unwritten pages
    jsel = jc.select_pages(jnp.asarray(q))
    tsel = tc.select_pages(torch.from_numpy(q))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(tsel[0, 0].numpy(),
                                  [1, 1, 1, 0, 1, 0, 0, 0])
    jt, jn = jc.block_table_from_pages(jsel)
    tt, tn = tc.block_table_from_pages(tsel)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert (tn == 4).all() and int(tn.max()) > top
    np.testing.assert_array_equal(tt.numpy()[..., :4], np.asarray(jt)[..., :4])
    np.testing.assert_array_equal(tt[0, 0, :4].numpy(), [0, 1, 2, 4])
    np.testing.assert_array_equal(tc.token_mask_from_pages(tsel).numpy(),
                                  np.asarray(jc.token_mask_from_pages(jsel)))
    # the unwritten pages score NaN before the live mask masks them
    qf = torch.from_numpy(q)[..., None, :]
    raw = torch.maximum(qf * tc.kmin, qf * tc.kmax).sum(-1)
    assert torch.isnan(raw[..., 5:]).all() and torch.isfinite(raw[..., :5]).all()
    np.testing.assert_array_equal(tc.reads_per_step().numpy(),
                                  np.asarray(jc.reads_per_step()))
    assert tc.reads_per_step().tolist() == [top * ps] * b


# -- (c) the Engine ----------------------------------------------------------------


def _engines(tiny_arch, tiny_params, port, **kw):
    tarch, tparams = port
    kw.setdefault("window", tiny_arch.dms.window)
    return (JEngine(tiny_arch, tiny_params, JKV(**kw), use_kernel=True),
            Engine(tarch, tparams, KVPolicyConfig(**kw), use_kernel=True,
                   device="cpu"))


def assert_meters_equal(mt, mj, what):
    for key in METERS:
        assert getattr(mt, key) == getattr(mj, key), (what, key)


# (policy config, prompt seed, prompt length, new tokens): the two pinned
# traces, each served by both policies
TRACES = {
    "block_tables": (dict(cr=2.0, quest_page_size=8), 9, 11, 5),
    "policy_registry": (dict(quest_page_size=4, quest_top_pages=2), 1, 24, 16),
}


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("trace", list(TRACES))
@pytest.mark.parametrize("kind", ["quest", "dmc"])
def test_engine_matches_reference_engine(tiny_arch, tiny_params, port, kind,
                                         trace, paged):
    cfg, seed, plen, new = TRACES[trace]
    n = 2 if trace == "block_tables" else 1
    prompts = np.random.default_rng(seed).integers(
        3, tiny_arch.vocab_size, size=(n, plen)).astype(np.int32)
    block_p = cfg["quest_page_size"] if kind == "quest" else 8
    jeng, teng = _engines(tiny_arch, tiny_params, port, kind=kind,
                          block_p=block_p, paged=paged, **cfg)
    rj = jeng.generate(prompts, new)
    rt = teng.generate(prompts, new)
    np.testing.assert_array_equal(rt.tokens, rj.tokens)
    assert_meters_equal(rt.meter, rj.meter, "generate")
    for a, b in zip(rt.requests, rj.requests):
        assert a.status == "ok"
        assert_meters_equal(a.prefill_meter, b.prefill_meter, "prefill")
        assert_meters_equal(a.decode_meter, b.decode_meter, "decode")


@pytest.mark.parametrize("kind", ["quest", "dmc"])
def test_sampled_hyperscale_fork_matches_reference(tiny_arch, tiny_params,
                                                   port, kind):
    """A width-4 ``hyperscale_generate`` at temperature 0.7: the prefilled
    lane forks into four chains (kmin/kmax, or z, count and pos, copied
    with the K/V), which sample apart; tokens and meters equal the JAX
    ``Engine``'s on seeds 0 and 3 (pinned: no near tie)."""
    from repro.core import hyperscale as jhs
    from repro_torch.core import hyperscale as ths
    tarch, tparams = port
    kw = dict(kind=kind, cr=2.0, quest_page_size=8, block_p=8,
              window=tiny_arch.dms.window)
    jeng = JEngine(tiny_arch, tiny_params, JKV(**kw), use_kernel=True,
                   temperature=0.7)
    teng = Engine(tarch, tparams, KVPolicyConfig(**kw), use_kernel=True,
                  temperature=0.7, device="cpu")
    w, t0 = 4, 16
    prompt = np.random.default_rng(2).integers(
        3, tiny_arch.vocab_size, size=(t0,)).astype(np.int32)
    for seed in (0, 3):
        rj = jeng.hyperscale_generate(prompt, jhs.ScalingConfig(t0 + 6, w),
                                      seed=seed)
        rt = teng.hyperscale_generate(prompt, ths.ScalingConfig(t0 + 6, w),
                                      seed=seed)
        np.testing.assert_array_equal(rt.tokens, rj.tokens, err_msg=str(seed))
        assert_meters_equal(rt.meter, rj.meter, f"seed {seed}")
        assert len({tuple(row) for row in rt.tokens.tolist()}) > 1


def test_quest_meters_reads_not_size(tiny_arch, tiny_params, port):
    """The port's Quest reads fewer tokens than vanilla and holds as many."""
    cfg, seed, plen, new = TRACES["policy_registry"]
    prompts = np.random.default_rng(seed).integers(
        3, tiny_arch.vocab_size, size=(1, plen)).astype(np.int32)
    tarch, tparams = port
    res = {kind: Engine(tarch, tparams, KVPolicyConfig(kind=kind, **cfg),
                        use_kernel=True, device="cpu").generate(prompts, new)
           for kind in ("vanilla", "quest")}
    assert res["quest"].meter.kv_reads < res["vanilla"].meter.kv_reads
    assert res["quest"].meter.peak_tokens == res["vanilla"].meter.peak_tokens


@pytest.mark.parametrize("kind", ["quest", "dmc"])
def test_paged_preemption_round_trips(tiny_arch, tiny_params, port, kind):
    """Two requests oversubscribe a pool that holds one lane's worst case:
    one is preempted (its lane exported through host memory, densified)
    and resumed (imported into fresh pages).  Tokens, statuses, tick
    stamps and meters equal the JAX scheduler's, every request equals its
    solo run, and every page is back in the pool at the end.  The kernel
    path is on (the reference's Pallas interpret mode): on the reference
    attention path Quest's request 0 meets a 0.002 bf16 logit tie at its
    second token that XLA and PyTorch round apart."""
    kw = dict(kind=kind, cr=2.0, quest_page_size=8, block_p=8,
              pool_blocks=8 if kind == "quest" else 10, paged=True,
              window=tiny_arch.dms.window)
    tarch, tparams = port
    jeng = JEngine(tiny_arch, tiny_params, JKV(**kw), use_kernel=True,
                   chunk=4)
    teng = Engine(tarch, tparams, KVPolicyConfig(**kw), use_kernel=True,
                  chunk=4, device="cpu")

    def reqs(cls):
        return [cls(uid=i, prompt=np.random.default_rng(s).integers(
            3, tiny_arch.vocab_size, size=(10,)).astype(np.int32), max_new=8)
            for i, s in enumerate((50, 51))]

    def serve(eng, rs):
        sched = eng.scheduler(num_lanes=2, max_len=24, oversub=2.0,
                              on_pressure="preempt")
        for r in rs:
            sched.submit(r)
        return {r.uid: r for r in sched.run()}, sched

    rj, _ = serve(jeng, reqs(JRequest))
    rt, st = serve(teng, reqs(Request))
    for uid in rj:
        a, b = rt[uid], rj[uid]
        assert a.status == b.status == "ok", uid
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(uid))
        assert (a.preempt_count, a.latency_ticks, a.finished_tick) == \
            (b.preempt_count, b.latency_ticks, b.finished_tick), uid
        assert_meters_equal(a.meter, b.meter, uid)
    life = st.pool_stats()["lifecycle"]
    assert life["preemptions"] > 0 and life["resumes"] == life["preemptions"]
    stats = tpolicy.state_pool_stats(st.state)
    assert stats["allocated_blocks"] == 0 and not stats["exhausted"]
    for r in reqs(Request):
        solo, _ = serve(teng, [r])
        np.testing.assert_array_equal(rt[r.uid].tokens, solo[r.uid].tokens)


@pytest.mark.parametrize("kind", ["quest", "dmc"])
def test_stacked_export_import_round_trip(tiny_arch, port, kind):
    """A preemption snapshot of a paged stacked state (host memory) imports
    into a fresh state's pristine lane and exports back unchanged, kmin and
    kmax, z, count and pos included."""
    tarch, tparams = port
    cfg = KVPolicyConfig(kind=kind, cr=2.0, block_p=4, quest_page_size=4,
                         paged=True)
    state = ttfm.init_decode_state(tarch, 2, 16, cfg, device="cpu")
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    for t in range(7):
        ttfm.decode_step(tparams, tok + t, state, tarch, torch.tensor([t, t]))
    snap = ttfm.export_lane_state(state, 0)
    fresh = ttfm.init_decode_state(tarch, 2, 16, cfg, device="cpu")
    back = ttfm.import_lane_state(fresh, snap, 1)
    again = ttfm.export_lane_state(back, 1)
    for x, y in zip(tree_leaves(again), tree_leaves(snap)):
        assert torch.equal(x, y)
