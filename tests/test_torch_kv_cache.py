"""The port's slot-compacted DMS cache against the JAX reference's.

The same seeded K/V/α stream goes through ``repro.core.kv_cache.SlotDMSCache``
(pure functions) and ``repro_torch.core.kv_cache.SlotDMSCache`` (in place);
every leaf must be equal after every step — delayed eviction, the free ring,
overflow recycling (arenas too small for the stream), and an ``active`` mask
that freezes lanes (the reference freezes them with a per-lane select after
the step, as ``transformer.lane_select`` does).  The block-table invariant
pinned by ``tests/test_block_tables.py`` is checked on the port's tables.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core.kv_cache import SlotDMSCache as JCache
from repro_torch.core import policy as tpolicy
from repro_torch.core.kv_cache import BlockTable, SlotDMSCache

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

LEAVES = ("k", "v", "pos", "valid", "free_ring", "free_head", "free_count",
          "pending_slot", "pending_alpha", "length", "overflowed")
TABLE = ("count", "tbl", "pos", "n")


def _stream(seed, t, b, h, dh, p_alpha=0.5, p_active=None):
    r = np.random.default_rng(seed)
    k = r.normal(size=(t, b, h, 1, dh)).astype(np.float32)
    v = r.normal(size=(t, b, h, 1, dh)).astype(np.float32)
    a = r.random((t, b, h)) < p_alpha
    act = None if p_active is None else r.random((t, b)) < p_active
    return k, v, a, act


def assert_same(tc: SlotDMSCache, jc, where=""):
    for name in LEAVES:
        np.testing.assert_array_equal(getattr(tc, name).float().numpy(),
                                      np.asarray(getattr(jc, name), np.float32),
                                      err_msg=f"{name} {where}")
    for name in TABLE:
        np.testing.assert_array_equal(getattr(tc.blocks, name).numpy(),
                                      np.asarray(getattr(jc.blocks, name)),
                                      err_msg=f"blocks.{name} {where}")


def assert_table_canonical(bt: BlockTable, valid: torch.Tensor):
    """Incremental table == the from_valid recomputation up to order."""
    ref = BlockTable.from_valid(valid, bt.block_p)
    assert torch.equal(bt.count, ref.count) and torch.equal(bt.n, ref.n)
    tbl, pos, n, cnt = bt.tbl.numpy(), bt.pos.numpy(), bt.n.numpy(), bt.count.numpy()
    b, h, nb = cnt.shape
    for bi in range(b):
        for hi in range(h):
            live = set(np.where(cnt[bi, hi] > 0)[0].tolist())
            assert set(tbl[bi, hi, :n[bi, hi]].tolist()) == live
            for blk in range(nb):
                if blk in live:
                    assert tbl[bi, hi, pos[bi, hi, blk]] == blk
                else:
                    assert pos[bi, hi, blk] == -1


@pytest.mark.parametrize("num_slots,window,block_p,p_active", [
    (24, 3, 8, None),      # roomy arena, tables on
    (9, 3, 8, None),       # overflow recycling (odd size, padded extent)
    (19, 4, 0, None),      # tables off
    (11, 2, 8, 0.6),       # overflow + lanes frozen by the active mask
])
def test_step_equals_reference_leaf_for_leaf(num_slots, window, block_p,
                                             p_active):
    b, h, dh, t = 3, 2, 8, 40
    k, v, a, act = _stream(num_slots, t, b, h, dh, p_active=p_active)
    jc = JCache.init(b, h, num_slots, dh, window, jnp.float32, block_p=block_p)
    tc = SlotDMSCache.init(b, h, num_slots, dh, window, torch.float32,
                           block_p=block_p, device="cpu")
    overflowed = False
    for i in range(t):
        new = jc.step(jnp.asarray(k[i]), jnp.asarray(v[i]), jnp.asarray(a[i]))
        retained_j = np.asarray(new.retained_tokens())
        if act is None:
            jc = new
        else:
            m = jnp.asarray(act[i])
            jc = jax.tree_util.tree_map(
                lambda n_, o_: jnp.where(
                    m.reshape((-1,) + (1,) * (n_.ndim - 1)), n_, o_), new, jc)
        retained_t = tc.step(torch.from_numpy(k[i]), torch.from_numpy(v[i]),
                             torch.from_numpy(a[i]),
                             active=None if act is None else torch.from_numpy(act[i]))
        assert_same(tc, jc, where=f"after step {i}")
        # the step reports what every lane would hold, frozen lanes included
        np.testing.assert_array_equal(retained_t.numpy(), retained_j)
        if block_p:
            assert_table_canonical(tc.blocks, tc.valid)
        overflowed |= bool(tc.overflowed.any())
    mt = tpolicy.get_policy("dms").metrics(tc)
    mj = jpolicy.get_policy("dms").metrics(jc)
    for key in ("live_tokens", "reads_tokens"):
        np.testing.assert_array_equal(mt[key].numpy(), np.asarray(mj[key]))
    assert mt["peak_bytes"] == mj["peak_bytes"]
    assert overflowed == (num_slots < 20)


def test_overflow_recycles_the_oldest_slot_first_index_on_ties():
    """No eviction ever fires and the arena overflows: each step recycles
    the slot with the lowest position — the reference's argmin."""
    b, h, dh, slots = 1, 2, 4, 5
    k, v, _, _ = _stream(3, 12, b, h, dh)
    a = np.zeros((12, b, h), bool)
    jc = JCache.init(b, h, slots, dh, 2, jnp.float32, block_p=4)
    tc = SlotDMSCache.init(b, h, slots, dh, 2, torch.float32, block_p=4)
    for i in range(12):
        jc = jc.step(jnp.asarray(k[i]), jnp.asarray(v[i]), jnp.asarray(a[i]))
        tc.step(torch.from_numpy(k[i]), torch.from_numpy(v[i]),
                torch.from_numpy(a[i]))
        assert_same(tc, jc, where=f"after step {i}")
    assert sorted(tc.pos[0, 0, :slots].tolist()) == list(range(7, 12))


@pytest.mark.parametrize("seed,num_slots", [(0, 24), (1, 19), (2, 9)])
def test_incremental_table_equals_from_valid(seed, num_slots):
    """tests/test_block_tables.py's invariant on the port's own tables."""
    k, v, a, _ = _stream(seed, 30, 2, 2, 8)
    c = SlotDMSCache.init(2, 2, num_slots, 8, window=3, dtype=torch.float32,
                          block_p=8)
    assert c.k.shape[2] % 8 == 0
    for i in range(30):
        c.step(torch.from_numpy(k[i]), torch.from_numpy(v[i]),
               torch.from_numpy(a[i]))
        assert_table_canonical(c.blocks, c.valid)


def test_reclaimed_lane_is_pristine_and_gather_copies():
    pol = tpolicy.get_policy("dms")
    k, v, a, _ = _stream(6, 5, 2, 2, 8)
    c = SlotDMSCache.init(2, 2, 16, 8, window=3, dtype=torch.float32, block_p=8)
    for i in range(5):
        c.step(torch.from_numpy(k[i]), torch.from_numpy(v[i]),
               torch.from_numpy(a[i]))
    fresh = SlotDMSCache.init(2, 2, 16, 8, window=3, dtype=torch.float32,
                              block_p=8)
    r = pol.reclaim_cache(c, torch.tensor([True, False]), fresh)
    assert int(r.blocks.n[0].sum()) == 0 and int(r.blocks.n[1].sum()) > 0
    assert_table_canonical(r.blocks, r.valid)
    g = pol.gather_cache(c, torch.tensor([1, 1]))
    assert torch.equal(g.k[0], g.k[1])
    g.k[0].fill_(7.0)                          # lanes never share storage
    assert not torch.equal(g.k[0], g.k[1]) and not bool((c.k == 7.0).any())
