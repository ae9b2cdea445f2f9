"""The port's paged KV block pool against the JAX reference's.

* ``core/block_pool.py``: the same seeded traces of ``alloc`` (through
  ``token_write``), ``token_write`` (allocate-on-first-write, copy-on-write,
  poisoned failed blocks, multi-token events), ``free_block``,
  ``set_refcounts``/``recount``, ``clear_flags``, ``dense_kv``,
  ``translate_table`` and ``stats`` go through both packages; every pool
  leaf and the page map must be equal after every call.
* The paged ``SlotDMSCache`` leaf-equal to the reference's after every
  step (with lanes frozen by an ``active`` mask, as the reference's
  ``lane_select`` freezes them), fork (``gather_cache``), reclaim and
  prefix export/import, with the allocator invariants of
  ``tests/test_block_pool.py`` checked on the port: refcounts equal the
  page map's multiplicities, pages are conserved, no page is mapped twice
  in a (lane, head), and a block is mapped iff it holds a live slot.
* The decode wrapper in shared-pool mode (CPU: the plain version) against
  the reference wrapper with ``pool_k``/``pool_v``/``phys`` in Pallas
  interpret mode, with NaN in every page the table does not list.
* Pooled against fixed attention in the port: bitwise equal, on the
  reference path and the kernel path.
* The kernel path builds no dense view of the pool.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import block_pool as jbp
from repro.core import policy as jpolicy
from repro.core.config import KVPolicyConfig as JKV
from repro.core.kv_cache import SlotDMSCache as JCache, pack_dense as jpack
from repro.kernels.dms_decode import ops as jops
from repro_torch import bridge
from repro_torch.core import block_pool as tbp
from repro_torch.core import policy as tpolicy
from repro_torch.core.config import KVPolicyConfig
from repro_torch.core.kv_cache import SlotDMSCache, pack_dense
from repro_torch.kernels.dms_decode import ops as tops
from repro_torch.models import transformer as ttfm

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

POOL_LEAVES = ("k", "v", "ref", "cow_copies", "alloc_events", "high_water",
               "exhausted")
CACHE_LEAVES = ("pos", "valid", "free_ring", "free_head", "free_count",
                "pending_slot", "pending_alpha", "length", "overflowed", "phys")
TABLE = ("count", "tbl", "pos", "n")


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def assert_pool_same(tp, jp, where=""):
    for name in POOL_LEAVES:
        np.testing.assert_array_equal(
            _np(getattr(tp, name)), np.asarray(getattr(jp, name), np.float32
                                               if name in "kv" else None),
            err_msg=f"pool.{name} {where}")


def assert_cache_same(tc, jc, where=""):
    for name in CACHE_LEAVES:
        np.testing.assert_array_equal(_np(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=f"{name} {where}")
    for name in TABLE:
        np.testing.assert_array_equal(getattr(tc.blocks, name).numpy(),
                                      np.asarray(getattr(jc.blocks, name)),
                                      err_msg=f"blocks.{name} {where}")
    assert_pool_same(tc.pool, jc.pool, where)


def assert_invariants(cache, exhausted_ok=False):
    """The allocator invariants of tests/test_block_pool.py, on the port."""
    pool, phys = cache.pool, cache.phys.numpy()
    ref = pool.ref.numpy()
    np.testing.assert_array_equal(ref, tbp.recount(cache.phys,
                                                   pool.num_blocks).numpy())
    allocated = int((ref > 0).sum())
    assert allocated + int((ref == 0).sum()) == pool.num_blocks
    for lane in range(phys.shape[0]):
        for h in range(phys.shape[1]):
            mapped = phys[lane, h][phys[lane, h] >= 0]
            assert len(set(mapped.tolist())) == len(mapped), (lane, h)
    if not exhausted_ok:
        live = cache.blocks.count.numpy() > 0
        np.testing.assert_array_equal(phys >= 0, live)


# -- block_pool functions -----------------------------------------------------


@pytest.mark.parametrize("t,npool", [(1, 40), (1, 9), (3, 40), (3, 9)])
def test_pool_functions_match_reference(t, npool):
    """Random token writes (t events per (lane, head), repeated blocks
    included), block frees, lane forks through set_refcounts, on a roomy
    and a tight pool (exhaustion, poisoned blocks)."""
    b, h, nb, bp, dh = 3, 2, 4, 4, 8
    r = np.random.default_rng(100 * t + npool)
    jp = jbp.BlockPool.init(npool, bp, dh, jnp.float32)
    tp = tbp.BlockPool.init(npool, bp, dh, torch.float32, device="cpu")
    jphys = jnp.full((b, h, nb), -1, jnp.int32)
    tphys = torch.full((b, h, nb), -1, dtype=torch.int32)
    for step in range(30):
        op = "fork" if step % 10 == 5 else r.choice(["write", "write", "free"])
        if op == "write":
            slot = r.integers(0, nb * bp, size=(b, h, t)).astype(np.int32)
            mask = r.random((b, h, t)) < 0.8
            k = r.normal(size=(b, h, t, dh)).astype(np.float32)
            v = r.normal(size=(b, h, t, dh)).astype(np.float32)
            jp, jphys = jbp.token_write(jp, jphys, jnp.asarray(slot),
                                        jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(mask))
            tbp.token_write(tp, tphys, torch.from_numpy(slot),
                            torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(mask))
        elif op == "free":
            slot = r.integers(0, nb * bp, size=(b, h)).astype(np.int32)
            mask = r.random((b, h)) < 0.5
            jp, jphys = jbp.free_block(jp, jphys, jnp.asarray(slot),
                                       jnp.asarray(mask))
            tbp.free_block(tp, tphys, torch.from_numpy(slot),
                           torch.from_numpy(mask))
        else:                                   # lane 0 forked over lane 2
            src = np.array([0, 1, 0])
            jphys = jphys[src]
            tphys = tphys[torch.from_numpy(src)]
            jp = jbp.set_refcounts(jp, jphys)
            tp = tbp.set_refcounts(tp, tphys)
        assert_pool_same(tp, jp, f"step {step} ({op})")
        np.testing.assert_array_equal(tphys.numpy(), np.asarray(jphys))
    assert int(tp.cow_copies) > 0
    assert bool(tp.exhausted) == (npool < 24)
    kd, vd = tbp.dense_kv(tp, tphys)
    jkd, jvd = jbp.dense_kv(jp, jphys)
    np.testing.assert_array_equal(kd.numpy(), np.asarray(jkd))
    np.testing.assert_array_equal(vd.numpy(), np.asarray(jvd))
    tbl = r.integers(-1, nb + 1, size=(b, h, nb)).astype(np.int32)
    np.testing.assert_array_equal(
        tbp.translate_table(tphys, torch.from_numpy(tbl)).numpy(),
        np.asarray(jbp.translate_table(jphys, jnp.asarray(tbl))))
    live = torch.from_numpy(r.integers(0, 5, size=(b, h, nb)).astype(np.int32))
    assert tbp.stats(tp, tphys, live) == jbp.stats(jp, jphys,
                                                   jnp.asarray(live.numpy()))
    # recount over leading (layer) axes
    stacked = torch.stack([tphys, tphys.flip(0)])
    np.testing.assert_array_equal(
        tbp.recount(stacked, npool).numpy(),
        np.asarray(jbp.recount(jnp.asarray(stacked.numpy()), npool)))
    tbp.clear_flags(tp)
    np.testing.assert_array_equal(tp.exhausted.numpy(),
                                  np.asarray(jbp.clear_flags(jp).exhausted))


# -- the paged SlotDMSCache ------------------------------------------------------


def _lane_sel(act, new, old):
    """The reference's lane_select on an unstacked cache: the pool is kept."""
    def sel(x, y):
        if isinstance(x, jbp.BlockPool):
            return x
        m = jnp.asarray(act).reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(m, x, y)
    return jax.tree_util.tree_map(sel, new, old,
                                  is_leaf=lambda x: isinstance(x, jbp.BlockPool))


@pytest.mark.parametrize("pool_blocks,p_active", [(None, None), (None, 0.6),
                                                  (10, 0.7)])
def test_paged_cache_matches_reference(pool_blocks, p_active):
    b, h, ns, dh, w, bp = 3, 2, 24, 8, 3, 8
    pol_t, pol_j = tpolicy.get_policy("dms"), jpolicy.get_policy("dms")
    jc = JCache.init(b, h, ns, dh, w, jnp.float32, block_p=bp, paged=True,
                     pool_blocks=pool_blocks)
    tc = SlotDMSCache.init(b, h, ns, dh, w, torch.float32, block_p=bp,
                           paged=True, pool_blocks=pool_blocks, device="cpu")
    fresh_j, fresh_t = jc, SlotDMSCache.init(
        b, h, ns, dh, w, torch.float32, block_p=bp, paged=True,
        pool_blocks=pool_blocks, device="cpu")
    r = np.random.default_rng(7 if pool_blocks is None else pool_blocks)
    tight = pool_blocks is not None

    def step(jc, i):
        k = r.normal(size=(b, h, 1, dh)).astype(np.float32)
        v = r.normal(size=(b, h, 1, dh)).astype(np.float32)
        a = r.random((b, h)) < 0.5
        act = None if p_active is None else r.random(b) < p_active
        jact = None if act is None else jnp.asarray(act)
        new = jc.step(jnp.asarray(k), jnp.asarray(v), jnp.asarray(a),
                      active=jact)
        jc = new if act is None else _lane_sel(act, new, jc)
        tc.step(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(a),
                active=None if act is None else torch.from_numpy(act))
        assert_cache_same(tc, jc, f"step {i}")
        assert_invariants(tc, exhausted_ok=tight)
        return jc

    for i in range(20):
        jc = step(jc, i)
    # width-2 fork of lane 0 over lane 2: CoW sharers, no page moves
    src = np.array([0, 1, 0])
    jc = pol_j.gather_cache(jc, jnp.asarray(src))
    tc = pol_t.gather_cache(tc, torch.from_numpy(src))
    assert_cache_same(tc, jc, "fork")
    assert_invariants(tc, exhausted_ok=tight)
    if not tight:
        assert int((tc.pool.ref > 1).sum()) > 0
    for i in range(20, 30):
        jc = step(jc, i)
    assert int(tc.pool.cow_copies) > 0
    assert bool(tc.pool.exhausted) or not tight
    # reclaim lane 1, then export lane 0 and import it into lane 1
    mask = np.array([False, True, False])
    jc = pol_j.reclaim_cache(jc, jnp.asarray(mask), fresh_j)
    tc = pol_t.reclaim_cache(tc, torch.from_numpy(mask), fresh_t)
    assert_cache_same(tc, jc, "reclaim")
    assert_invariants(tc, exhausted_ok=tight)
    jsnap = pol_j.export_prefix(jc, 0)
    tsnap = pol_t.export_prefix(tc, 0)
    assert tsnap.pool is None and tsnap.phys is None
    np.testing.assert_array_equal(tsnap.k.numpy(), np.asarray(jsnap.k))
    np.testing.assert_array_equal(tsnap.v.numpy(), np.asarray(jsnap.v))
    jc = pol_j.import_prefix(jc, jsnap, 1)
    tc = pol_t.import_prefix(tc, tsnap, 1)
    assert_cache_same(tc, jc, "import")
    assert_invariants(tc, exhausted_ok=tight)
    for i in range(30, 36):
        jc = step(jc, i)
    assert tpolicy.get_policy("dms").peak_bytes(tc) == \
        jpolicy.get_policy("dms").peak_bytes(jc)


def test_pack_dense_matches_reference():
    b, h, ns, dh, w, bp = 2, 2, 20, 8, 3, 4
    jc = JCache.init(b, h, ns, dh, w, jnp.float32, block_p=bp)
    tc = SlotDMSCache.init(b, h, ns, dh, w, torch.float32, block_p=bp,
                           device="cpu")
    r = np.random.default_rng(5)
    for _ in range(15):
        k = r.normal(size=(b, h, 1, dh)).astype(np.float32)
        a = r.random((b, h)) < 0.6
        jc = jc.step(jnp.asarray(k), jnp.asarray(k), jnp.asarray(a))
        tc.step(torch.from_numpy(k), torch.from_numpy(k), torch.from_numpy(a))
    jp, tp = jpack(jc), pack_dense(tc)
    assert_cache_same(tp, jp, "pack_dense")
    assert tp.k.shape == (b, h, tc.k.shape[2], 0)


# -- the kernel in shared-pool mode ----------------------------------------------


def _pool_case(seed, dtype, b=2, hkv=2, g=3, dh=16, nb=5, bp=8, npool=24):
    """A pool with the listed pages scattered in shuffled order; NaN in every
    page the table does not list.  Stale entries past n, and phys = -1
    there."""
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, 1, hkv * g, dh)).astype(np.float32)
    pk = r.normal(size=(npool, bp, dh)).astype(np.float32)
    pv = r.normal(size=(npool, bp, dh)).astype(np.float32)
    valid = r.random((b, hkv, nb * bp)) < 0.6
    n = r.integers(0, nb + 1, size=(b, hkv)).astype(np.int32)
    n[0, 0] = 0                                           # an empty row
    tbl = np.zeros((b, hkv, nb), np.int32)
    phys = np.full((b, hkv, nb), -1, np.int32)
    pages = iter(r.permutation(npool))
    listed = np.zeros(npool, bool)
    for i in range(b):
        for j in range(hkv):
            blocks = r.permutation(nb)
            tbl[i, j] = blocks
            for blk in blocks[:n[i, j]]:
                phys[i, j, blk] = next(pages)
                listed[phys[i, j, blk]] = True
    pk[~listed] = np.nan
    pv[~listed] = np.nan
    return q, pk, pv, valid, tbl, n, phys, bp


@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=1e-5, atol=1e-5)),
                                       ("bfloat16", dict(rtol=2e-2, atol=2e-2))])
def test_shared_pool_plain_matches_reference_wrapper(dtype, tol):
    """fp32: only the order of sums differs (Pallas' blockwise online
    softmax vs one softmax), hence 1e-5; bf16: each side rounds its output
    to bf16 (8 significant bits)."""
    q, pk, pv, valid, tbl, n, phys, bp = _pool_case(3, dtype)
    b, hkv, p = valid.shape
    dh = q.shape[-1]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    dense = jnp.zeros((b, hkv, p, dh), jdt)
    out_j = jops.dms_decode_attention(
        jnp.asarray(q, jdt), dense, dense, jnp.asarray(valid),
        block_tbl=jnp.asarray(tbl), block_n=jnp.asarray(n), block_p=bp,
        interpret=True, pool_k=jnp.asarray(pk, jdt), pool_v=jnp.asarray(pv, jdt),
        phys=jnp.asarray(phys))
    before = tops.shared_launches
    out_t = tops.dms_decode_attention(
        torch.from_numpy(q).to(tdt), None, None, torch.from_numpy(valid),
        block_tbl=torch.from_numpy(tbl), block_n=torch.from_numpy(n),
        block_p=bp, pool_k=torch.from_numpy(pk).to(tdt),
        pool_v=torch.from_numpy(pv).to(tdt), phys=torch.from_numpy(phys))
    assert tops.shared_launches == before           # the CPU never launches
    out_t = out_t.float().numpy()
    assert np.isfinite(out_t).all()
    assert not out_t[0, 0, :q.shape[2] // hkv].any()      # n = 0 row is zero
    np.testing.assert_allclose(out_t, np.asarray(out_j, np.float32), **tol)


def test_shared_pool_plain_equals_fixed_plain_bitwise():
    """The same logical contents in the same table order: the shared-pool
    plain version gives the fixed-arena plain version's bits."""
    q, pk, pv, valid, tbl, n, phys, bp = _pool_case(11, "bfloat16")
    b, hkv, p = valid.shape
    kp = torch.from_numpy(pk).bfloat16()
    vp = torch.from_numpy(pv).bfloat16()
    pool = tbp.BlockPool.init(pk.shape[0], bp, pk.shape[-1], torch.bfloat16)
    pool.k_buf[:-1] = kp
    pool.v_buf[:-1] = vp
    kd, vd = tbp.dense_kv(pool, torch.from_numpy(phys))
    args = dict(block_tbl=torch.from_numpy(tbl), block_n=torch.from_numpy(n),
                block_p=bp)
    qt = torch.from_numpy(q).bfloat16()
    valid_t = torch.from_numpy(valid)
    fixed = tops.dms_decode_attention(qt, kd, vd, valid_t, **args)
    shared = tops.dms_decode_attention(qt, None, None, valid_t, pool_k=kp,
                                       pool_v=vp, phys=torch.from_numpy(phys),
                                       **args)
    assert torch.equal(fixed, shared)


# -- pooled against fixed, through the model ----------------------------------------


@pytest.fixture(scope="module")
def port(tiny_arch, tiny_params):
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")
    return tarch, params


def _decode_trace(port, policy, use_kernel, steps=14, lanes=2):
    tarch, params = port
    state = ttfm.init_decode_state(tarch, lanes, steps + 1, policy, device="cpu")
    r = np.random.default_rng(2)
    logits = []
    for t in range(steps):
        tok = torch.from_numpy(r.integers(3, tarch.vocab_size, size=(lanes, 1)))
        act = torch.from_numpy(r.random(lanes) < 0.8)
        lg, state, aux = ttfm.decode_step(params, tok, state, tarch, t,
                                          use_kernel=use_kernel, active=act)
        assert aux["attn_impl_kernel"] == int(use_kernel)
        logits.append(lg)
    return torch.stack(logits), state


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pooled_decode_equals_fixed_bitwise(tiny_arch, port, use_kernel):
    kw = dict(kind="dms", cr=2.0, window=tiny_arch.dms.window, block_p=8)
    fixed, _ = _decode_trace(port, KVPolicyConfig(**kw), use_kernel)
    pooled, state = _decode_trace(port, KVPolicyConfig(**kw, paged=True),
                                  use_kernel)
    assert torch.equal(fixed, pooled)
    stats = tpolicy.state_pool_stats(state)
    assert stats["allocated_blocks"] > 0 and not stats["exhausted"]


def test_kernel_path_builds_no_dense_view(tiny_arch, port, monkeypatch):
    """The dense (B, H, P, Dh) view would read the whole pool in every layer
    of every step: with ``dense_kv`` made to raise, the kernel path still
    decodes, and the reference path (which needs the view) does not."""
    def refuse(*args, **kwargs):
        raise AssertionError("dense_kv called")

    monkeypatch.setattr(tbp, "dense_kv", refuse)
    policy = KVPolicyConfig(kind="dms", cr=2.0, window=tiny_arch.dms.window,
                            block_p=8, paged=True)
    logits, _ = _decode_trace(port, policy, use_kernel=True, steps=6)
    assert torch.isfinite(logits).all()
    with pytest.raises(AssertionError, match="dense_kv called"):
        _decode_trace(port, policy, use_kernel=False, steps=2)


def test_paged_config_builds_one_pool_per_layer(tiny_arch, port):
    tarch, _ = port
    policy = KVPolicyConfig(kind="dms", cr=2.0, window=tiny_arch.dms.window,
                            block_p=8, paged=True, pool_blocks=11)
    cache = ttfm.init_decode_state(tarch, 3, 20, policy, device="cpu")["0"].cache
    nl, dh = tarch.num_layers, tarch.attn.head_dim
    assert cache.pool.k.shape == (nl, 11, 8, dh)
    assert cache.pool.ref.shape == (nl, 11)
    assert cache.k.shape[-1] == 0
    jstate = jpolicy.init_policy_cache(
        tiny_arch, 3, 20, JKV(kind="dms", cr=2.0, window=tiny_arch.dms.window,
                              block_p=8, paged=True, pool_blocks=11))
    assert tuple(cache.phys.shape[1:]) == tuple(jstate.cache.phys.shape)
    assert tpolicy.state_peak_bytes(
        ttfm.init_decode_state(tarch, 3, 20, policy, device="cpu")) == \
        nl * jpolicy.state_peak_bytes(jstate)
