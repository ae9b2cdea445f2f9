"""The port's ``vanilla``, ``window`` and ``dms_masked`` policies against the
reference.

(a) ``prefix_block_spec`` equals the reference's (``block_p`` 0 gives no
    table), and the port registers every reference policy.
(b) The caches behind the three policies — ``VanillaCache``,
    ``MaskedDMSCache`` and ``SlotDMSCache(dms_active=False)`` — leaf for
    leaf after every ``decode_update`` of a random K/V/α stream, on fixed
    arenas and on the paged pool (``block_p`` 4), with partial ``active``
    masks: a frozen lane equals the reference's after its ``lane_select``
    rollback, and the step's ``live_tokens`` and ``reads_tokens`` equal
    the reference's ``metrics`` before it.  The attention operands (mask, table, ``n``; vanilla's
    from ``prepare_step``, as ``decode_step`` builds them) equal the
    reference's on active lanes.  Then the lifecycle hooks: gather fork,
    reclaim, export/import, width-2 fork.
(c) Repairs: a bare ``KVPolicyConfig()`` (``vanilla``) builds a decode
    state and serves, and ``_masked_decode`` takes Hkv from K, not from a
    lazy (B, 1, P) mask, on both attention paths at G > 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import block_pool as jbp
from repro.core import kv_cache as jkv
from repro.core import policy as jpolicy
from repro.core.config import KVPolicyConfig as JKV
from repro.models import attention as jattn
from repro_torch import bridge
from repro_torch.core import kv_cache as tkv
from repro_torch.core import policy as tpolicy
from repro_torch.core.config import KVPolicyConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

BP = 4
POOL_LEAVES = ("k", "v", "ref", "cow_copies", "alloc_events", "high_water",
               "exhausted")
TABLE = ("count", "tbl", "pos", "n")


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


def _step_aux(pol, cache, active):
    """The layer's entry of ``prepare_step`` for one layer's cache, built as
    ``decode_step`` builds it for the stacked cache ({} when the policy
    prepares nothing)."""
    prepared = pol.prepare_step(tree_map(lambda a: a[None], cache),
                                {"active": active})
    return {} if prepared is None else prepared[0]


def assert_cache_same(tc, jc, where=""):
    assert type(tc).__name__ == type(jc).__name__
    fields = [(f.name, f.metadata.get("static")) for f in dataclasses.fields(tc)]
    assert fields == [(f.name, f.metadata.get("static"))
                      for f in dataclasses.fields(jc)]
    for name, static in fields:
        t, j = getattr(tc, name), getattr(jc, name)
        if static:
            assert t == j, name
        elif name == "blocks":
            for leaf in TABLE:
                np.testing.assert_array_equal(
                    getattr(t, leaf).numpy(), np.asarray(getattr(j, leaf)),
                    err_msg=f"blocks.{leaf} {where}")
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


# -- (a) -----------------------------------------------------------------------


@pytest.mark.parametrize("block_p", [0, 4, 16])
def test_prefix_block_spec_matches_reference(block_p):
    length = np.array([0, 1, 4, 5, 17, 40], np.int32)
    jt, jn = jkv.prefix_block_spec(jnp.asarray(length), 32, block_p, 3)
    tt, tn = tkv.prefix_block_spec(torch.from_numpy(length), 32, block_p, 3)
    if not block_p:
        assert (jt, jn, tt, tn) == (None, None, None, None)
        return
    assert tt.is_contiguous() and tn.is_contiguous()
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # stacked over layers: one table per layer, each the reference's
    st, sn = tkv.prefix_block_spec(torch.from_numpy(np.stack([length] * 2)),
                                   32, block_p, 3)
    np.testing.assert_array_equal(st[1].numpy(), np.asarray(jt))
    np.testing.assert_array_equal(sn[1].numpy(), np.asarray(jn))


def test_available_policies_are_the_reference_less_quest_and_dmc():
    """The name is kept from the slice that lacked the two: the port now
    registers exactly the reference's nine."""
    assert tpolicy.available_policies() == jpolicy.available_policies()
    assert len(tpolicy.available_policies()) == 9


# -- (b) -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def arches(tiny_arch):
    jarch = dataclasses.replace(tiny_arch, dtype="float32")
    return jarch, bridge.arch_from_dict(dataclasses.asdict(jarch))


CASES = [("vanilla", {}), ("window", dict(budget=6)), ("dms_masked", {})]


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("kind,extra", CASES, ids=[c[0] for c in CASES])
def test_cache_matches_reference_every_step(arches, kind, extra, paged):
    jarch, tarch = arches
    b, max_len = 3, 30
    kw = dict(kind=kind, cr=2.0, block_p=BP, paged=paged, **extra)
    pol_j, pol_t = jpolicy.get_policy(kind), tpolicy.get_policy(kind)
    jc = jpolicy.init_policy_cache(jarch, b, max_len, JKV(**kw)).cache
    tc = tpolicy.init_policy_cache(tarch, b, max_len, KVPolicyConfig(**kw),
                                   device="cpu").cache
    fresh_j = jc
    fresh_t = tpolicy.init_policy_cache(tarch, b, max_len,
                                        KVPolicyConfig(**kw),
                                        device="cpu").cache
    if kind == "window":
        assert not tc.dms_active and tc.slots == 7
    a = jarch.attn
    r = np.random.default_rng(len(kind) * 10 + paged)

    def step(jc, tc, i):
        k = r.normal(size=(b, a.num_kv_heads, 1, a.head_dim)).astype(np.float32)
        v = r.normal(size=(b, a.num_kv_heads, 1, a.head_dim)).astype(np.float32)
        alpha = r.random((b, a.num_kv_heads)) < 0.6
        act = r.random(b) < 0.7 if i % 3 else None
        jaux = {"attn_cfg": a, "arch": jarch, "dtype": jnp.float32,
                "alpha_bin": jnp.asarray(alpha),
                "active": None if act is None else jnp.asarray(act)}
        taux = {"attn_cfg": tarch.attn, "arch": tarch, "dtype": torch.float32,
                "alpha_bin": torch.from_numpy(alpha),
                "active": None if act is None else torch.from_numpy(act)}
        taux.update(_step_aux(pol_t, tc, taux["active"]))
        new, jspec = pol_j.decode_update(jc, None, jnp.asarray(k),
                                         jnp.asarray(v), jaux)
        want = pol_j.metrics(new)
        tc, tspec, meters = pol_t.decode_update(
            tc, None, torch.from_numpy(k), torch.from_numpy(v), taux)
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
        jc = new if act is None else _lane_sel(act, new, jc)
        assert_cache_same(tc, jc, f"step {i}")
        return jc, tc

    for i in range(20):
        jc, tc = step(jc, tc, i)
    if kind == "window":
        assert bool(tc.overflowed.any())           # the ring recycles
    if kind == "dms_masked":
        assert bool((tc.alpha & ~tc.retained).any())   # evictions ran
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


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("kind", ["vanilla", "dms_masked"])
def test_stacked_export_import_round_trip(tiny_arch, kind, paged):
    """Preemption's snapshot of a stacked decode state (the lazy vanilla
    mask, the paged re-import) continues exactly as the lane it left; the
    pool's live-token count reads a vanilla cache, which keeps no table."""
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    cfg = KVPolicyConfig(kind=kind, cr=2.0, block_p=BP, paged=paged)
    state = ttfm.init_decode_state(tarch, 2, 16, cfg, device="cpu")
    pol = tpolicy.get_policy(kind)
    r = np.random.default_rng(4)
    for _ in range(7):
        pc = state["0"]
        prepared = pol.prepare_step(pc.cache, {"active": None})
        k = torch.from_numpy(r.normal(size=(2, 2, 1, 16)).astype(np.float32))
        alpha = torch.from_numpy(r.random((2, 2)) < 0.5)
        for layer in range(tarch.num_layers):        # keep the layers level
            lc = tree_map(lambda a, i=layer: a[i], pc.cache)
            pol.decode_update(lc, None, k, k + 1, {
                "attn_cfg": tarch.attn, "active": None,
                "alpha_bin": alpha if layer == 0 else torch.zeros_like(alpha),
                **({} if prepared is None else prepared[layer])})
    if paged:
        live = tpolicy.state_pool_stats(state)["live_tokens"]
        assert live == int(state["0"].cache.retained_tokens().sum()) > 0
    snap = ttfm.export_lane_state(state, 0)
    fresh = ttfm.init_decode_state(tarch, 2, 16, cfg, device="cpu")
    back = ttfm.import_lane_state(fresh, snap, 1)
    again = ttfm.export_lane_state(back, 1)
    for x, y in zip(tree_leaves(again), tree_leaves(snap)):
        assert torch.equal(x, y)


# -- (c) the repairs ---------------------------------------------------------------


def test_bare_policy_config_serves(tiny_arch):
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    assert KVPolicyConfig().kind == "vanilla"
    state = ttfm.init_decode_state(tarch, 2, 12, KVPolicyConfig(),
                                   device="cpu")
    assert type(state["0"].cache).__name__ == "VanillaCache"
    params = ttfm.init_model(tarch, device="cpu")
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    for t in range(3):
        logits, state, aux = ttfm.decode_step(params, tok, state, tarch, t,
                                              use_kernel=True)
    assert bool(torch.isfinite(logits).all())
    np.testing.assert_array_equal(aux["live_tokens"].numpy(),
                                  [3.0 * tarch.num_layers] * 2)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "kernel"])
@pytest.mark.parametrize("block_p", [0, 4])
def test_lazy_mask_at_g_above_one(arches, use_kernel, block_p):
    """A (B, 1, P) mask over an arena of Hkv 2 heads at G 2: Hkv comes from
    K, the mask is materialised, and the output equals the reference's."""
    jarch, tarch = arches
    a = jarch.attn
    assert a.num_heads // a.num_kv_heads > 1
    b, p = 3, 16
    r = np.random.default_rng(11)
    q = r.normal(size=(b, 1, a.num_heads, a.head_dim)).astype(np.float32)
    k = r.normal(size=(b, a.num_kv_heads, p, a.head_dim)).astype(np.float32)
    v = r.normal(size=(b, a.num_kv_heads, p, a.head_dim)).astype(np.float32)
    length = np.array([3, 16, 9], np.int32)
    lazy = np.arange(p)[None, None, :] < length[:, None, None]     # (B, 1, P)
    jt, jn = jkv.prefix_block_spec(jnp.asarray(length), p, block_p,
                                   a.num_kv_heads)
    jspec = jpolicy.AttendSpec(jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lazy), block_tbl=jt, block_n=jn,
                               block_p=block_p)
    want = jattn._masked_decode(jnp.asarray(q), jspec, None, a, False)[0]
    tt, tn = tkv.prefix_block_spec(torch.from_numpy(length), p, block_p,
                                   a.num_kv_heads)
    tspec = tpolicy.AttendSpec(torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(lazy), block_tbl=tt,
                               block_n=tn, block_p=block_p)
    got = tattn._masked_decode(torch.from_numpy(q), tspec, None, tarch.attn,
                               use_kernel)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
