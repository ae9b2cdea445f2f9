"""The port's cross-request radix prefix cache: the reference suite's cases
(``tests/test_prefix_cache.py``) run on the port, parity traces against the
JAX ``Engine``, and the snapshot bytes against the reference's.

* Exactness, per registered policy and through both tiers: importing a
  cached prefix and prefilling only the suffix gives the tokens, the meters
  (paid + saved == cold) and every state leaf of a cold prefill, bitwise, on
  the port's CPU path (the decode kernel's plain version).  The one-slot
  slab's demote/promote round trip too.
* The radix tree, the LRU byte budget, ``want_export`` (``always``,
  ``second-miss``, the stride) and the hot tier's slab on dummy snapshots.
* Parity: a shared system prompt with distinct suffixes (staggered, two
  lanes) and a multi-turn trace from ``workload.multi_turn_trace``, each
  through the JAX ``Engine`` and the port's with a cold-only and a hot
  tier: tokens, prefill and decode meters, ``kv_reads_saved``, the cache's
  ``stats()`` counts and its ``traffic()`` bytes equal.  These run in fp32
  with the DMS bias at 0 (about half the tokens evicted), where the two
  attention paths pick the same tokens.
* Snapshot bytes equal the reference's for every policy but Keyformer,
  whose per-layer salt the port keeps as int64 (ROADMAP C).
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.core.config import KVPolicyConfig as JKV
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import bridge
from repro_torch.core.config import KVPolicyConfig
from repro_torch.core.hyperscale import ScalingConfig
from repro_torch.core.policy import available_policies
from repro_torch.core.tree import tree_leaves
from repro_torch.serving import prefix_cache as pcm
from repro_torch.serving import workload
from repro_torch.serving.engine import Engine
from repro_torch.serving.prefix_cache import PrefixCache, snapshot_nbytes
from repro_torch.serving.scheduler import Request

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

POLICIES = sorted(available_policies())


def _prompt(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(3, vocab, size=(n,)).astype(np.int32)


def _policy_cfg(kind, window, cls=KVPolicyConfig, **kw):
    return cls(kind=kind, cr=2.0, budget=12, window=window, quest_page_size=4,
               **kw)


@pytest.fixture(scope="module")
def port(tiny_arch, tiny_params):
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")
    return tarch, params


def _engine(port, kind, **kw):
    tarch, params = port
    return Engine(tarch, params, _policy_cfg(kind, tarch.dms.window),
                  chunk=8, device="cpu", **kw)


def _serve_one(eng, prompt, max_new, max_len):
    sched = eng.scheduler(num_lanes=1, max_len=max_len)
    sched.submit(Request(uid=0, prompt=prompt, max_new=max_new))
    return sched.run()[0]


# -- exactness per policy ------------------------------------------------------


@pytest.mark.parametrize("device_mb", [0, 64], ids=["cold-tier", "hot-tier"])
@pytest.mark.parametrize("kind", POLICIES)
def test_prefix_import_suffix_prefill_bitwise_equals_cold(port, kind,
                                                          device_mb):
    vocab = port[0].vocab_size
    prefix = _prompt(16, seed=1, vocab=vocab)
    pa = np.concatenate([prefix, _prompt(7, seed=2, vocab=vocab)])
    pb = np.concatenate([prefix, _prompt(9, seed=3, vocab=vocab)])
    max_new = 5
    max_len = len(pb) + max_new
    warm = _engine(port, kind, prefix_cache_mb=64,
                   prefix_cache_device_mb=device_mb)
    ra = _serve_one(warm, pa, max_new, max_len)
    rb = _serve_one(warm, pb, max_new, max_len)
    assert rb.prefill_meter.kv_reads_saved > 0, kind
    if device_mb:
        st = warm.prefix_cache.stats()
        assert st["hot_hits"] > 0, kind
        assert st["h2d_bytes"] == 0 and st["d2h_bytes"] == 0, (kind, st)
    cold = _engine(port, kind)
    ca = _serve_one(cold, pa, max_new, max_len)
    cb = _serve_one(cold, pb, max_new, max_len)
    np.testing.assert_array_equal(ra.tokens, ca.tokens, err_msg=kind)
    np.testing.assert_array_equal(rb.tokens, cb.tokens, err_msg=kind)
    assert rb.prefill_meter.kv_reads + rb.prefill_meter.kv_reads_saved \
        == pytest.approx(cb.prefill_meter.kv_reads), kind


@pytest.mark.parametrize("device_mb", [0, 64], ids=["cold-tier", "hot-tier"])
@pytest.mark.parametrize("kind", POLICIES)
def test_prefix_import_state_bitwise_equals_cold_state(port, kind, device_mb):
    vocab = port[0].vocab_size
    prefix = _prompt(16, seed=4, vocab=vocab)
    pa = np.concatenate([prefix, _prompt(5, seed=5, vocab=vocab)])
    pb = np.concatenate([prefix, _prompt(6, seed=6, vocab=vocab)])
    max_len = len(pb) + 4

    def state_after_prefill(eng, prompt):
        sched = eng.scheduler(num_lanes=1, max_len=max_len)
        sched.submit(Request(uid=0, prompt=prompt, max_new=4))
        sched._admit()
        results = []
        while sched.active_reqs[0].hold_logits is None:
            sched._tick(results)
        return sched.state

    warm = _engine(port, kind, prefix_cache_mb=64,
                   prefix_cache_device_mb=device_mb)
    _serve_one(warm, pa, 4, max_len)
    got = state_after_prefill(warm, pb)
    assert warm.prefix_cache.hits > 0, kind
    if device_mb:
        assert warm.prefix_cache.hot_hits > 0, kind
    ref = state_after_prefill(_engine(port, kind), pb)
    g, r = tree_leaves(got), tree_leaves(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        assert a.dtype == b.dtype and a.shape == b.shape, kind
        assert torch.equal(a, b), kind


def test_full_prompt_hit_skips_prefill_entirely(port):
    p = _prompt(19, seed=7, vocab=port[0].vocab_size)
    warm = _engine(port, "dms", prefix_cache_mb=64)
    r1 = _serve_one(warm, p, 5, len(p) + 5)
    r2 = _serve_one(warm, p, 5, len(p) + 5)
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    assert r2.prefill_meter.kv_reads == 0.0
    assert r2.prefill_meter.kv_reads_saved \
        == pytest.approx(r1.prefill_meter.kv_reads)


def test_hyperscale_fork_composes_with_prefix_hit(port):
    p = _prompt(16, seed=8, vocab=port[0].vocab_size)
    warm = _engine(port, "dms", prefix_cache_mb=64)
    sched = warm.scheduler(num_lanes=4, max_len=24)
    sched.submit(Request(uid=0, prompt=p, max_new=6))
    sched.run()
    sched2 = warm.scheduler(num_lanes=4, max_len=24)
    sched2.submit(Request(uid=1, prompt=p, max_new=6, width=4))
    r = sched2.run()[0]
    assert r.prefill_meter.kv_reads == 0.0
    ref = _engine(port, "dms").hyperscale_generate(p, ScalingConfig(24, 4))
    np.testing.assert_array_equal(r.tokens, ref.tokens[:, :6])


def test_tiny_budget_evicts_and_falls_back_to_cold(port):
    eng = _engine(port, "dms")
    eng.prefix_cache = PrefixCache(capacity_bytes=64)     # < any snapshot
    p1 = _prompt(17, seed=9, vocab=port[0].vocab_size)
    r1 = _serve_one(eng, p1, 4, len(p1) + 4)
    r2 = _serve_one(eng, p1, 4, len(p1) + 4)
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    assert r2.prefill_meter.kv_reads_saved == 0.0
    st = eng.prefix_cache.stats()
    assert st["hits"] == 0 and st["entries"] == 0
    assert st["inserts"] == 0 and st["bytes"] == 0
    c = _serve_one(_engine(port, "dms"), p1, 4, len(p1) + 4)
    np.testing.assert_array_equal(r2.tokens, c.tokens)
    assert r2.prefill_meter.kv_reads == pytest.approx(c.prefill_meter.kv_reads)


def test_lru_eviction_keeps_recently_used_prefix(port):
    """The budget is sized in entries of a real snapshot (3.5 of them)."""
    eng = _engine(port, "vanilla")
    pa = _prompt(16, seed=10, vocab=port[0].vocab_size)
    pb = _prompt(16, seed=11, vocab=port[0].vocab_size)
    r = _serve_one(_engine(port, "vanilla", prefix_cache_mb=64), pa, 4, 20)
    probe = _engine(port, "vanilla", prefix_cache_mb=64)
    _serve_one(probe, pa, 4, 20)
    per_entry = probe.prefix_cache.total_bytes / max(
        probe.prefix_cache.stats()["entries"], 1)
    eng.prefix_cache = PrefixCache(capacity_bytes=int(per_entry * 3.5))
    _serve_one(eng, pa, 4, 20)
    _serve_one(eng, pa, 4, 20)
    _serve_one(eng, pb, 4, 20)
    assert eng.prefix_cache.evictions > 0
    r3 = _serve_one(eng, pa, 4, 20)
    assert r3.prefill_meter.kv_reads_saved > 0
    np.testing.assert_array_equal(r3.tokens, r.tokens)


# -- the two tiers -----------------------------------------------------------------


@pytest.mark.parametrize("kind", POLICIES)
def test_hot_roundtrip_demote_promote_bitwise(port, kind):
    """A one-slot slab forces every tier transition, and every serve stays
    equal to a cold prefill."""
    vocab = port[0].vocab_size
    prefix = _prompt(16, seed=20, vocab=vocab)
    pa = np.concatenate([prefix, _prompt(7, seed=21, vocab=vocab)])
    pb = np.concatenate([prefix, _prompt(9, seed=22, vocab=vocab)])
    pc8 = np.concatenate([prefix[:8], _prompt(6, seed=23, vocab=vocab)])
    max_new, max_len = 5, len(pb) + 5
    warm = _engine(port, kind, prefix_cache_mb=64)
    entry_nb = warm.scheduler(num_lanes=1, max_len=max_len)._snap_nbytes
    snap_nb = entry_nb - port[0].padded_vocab * 4
    warm.prefix_cache = PrefixCache(
        64 * 2 ** 20, device_capacity_bytes=entry_nb + entry_nb // 2)
    ra = _serve_one(warm, pa, max_new, max_len)
    st = warm.prefix_cache.stats()
    assert st["hot_inserts"] == 3 and st["demotions"] == 2, (kind, st)
    assert st["d2h_bytes"] == 2 * snap_nb, (kind, st)
    rb = _serve_one(warm, pb, max_new, max_len)
    rc = _serve_one(warm, pc8, max_new, max_len)
    st = warm.prefix_cache.stats()
    assert st["promotions"] >= 2 and st["hot_hits"] >= 2, (kind, st)
    cold = _engine(port, kind)
    for r, p in ((ra, pa), (rb, pb), (rc, pc8)):
        c = _serve_one(cold, p, max_new, max_len)
        np.testing.assert_array_equal(r.tokens, c.tokens, err_msg=kind)
        assert r.prefill_meter.kv_reads + r.prefill_meter.kv_reads_saved \
            == pytest.approx(c.prefill_meter.kv_reads), kind


def test_full_prompt_hot_hit_zero_snapshot_bytes(port):
    p = _prompt(19, seed=7, vocab=port[0].vocab_size)
    warm = _engine(port, "dms", prefix_cache_mb=64, prefix_cache_device_mb=64)
    r1 = _serve_one(warm, p, 5, len(p) + 5)
    r2 = _serve_one(warm, p, 5, len(p) + 5)
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    assert r2.prefill_meter.kv_reads == 0.0
    st = warm.prefix_cache.stats()
    assert st["hot_hits"] == 1 and st["h2d_bytes"] == 0 \
        and st["d2h_bytes"] == 0, st
    assert st["aux_sync_bytes"] == port[0].padded_vocab * 4, st


def test_tiny_device_slab_degrades_to_cold_tier(port):
    vocab = port[0].vocab_size
    prefix = _prompt(16, seed=24, vocab=vocab)
    pa = np.concatenate([prefix, _prompt(5, seed=25, vocab=vocab)])
    pb = np.concatenate([prefix, _prompt(6, seed=26, vocab=vocab)])
    max_len = len(pb) + 4
    warm = _engine(port, "dms", prefix_cache_mb=64,
                   prefix_cache_device_mb=128 / 2 ** 20)   # 128 B < snapshot
    _serve_one(warm, pa, 4, max_len)
    rb = _serve_one(warm, pb, 4, max_len)
    assert rb.prefill_meter.kv_reads_saved > 0
    st = warm.prefix_cache.stats()
    assert st["hot_inserts"] == 0 and st["hot_hits"] == 0, st
    assert st["device_bytes"] == 0 and st["promotions"] == 0, st
    np.testing.assert_array_equal(
        rb.tokens, _serve_one(_engine(port, "dms"), pb, 4, max_len).tokens)


def test_second_miss_exports_exactly_what_traffic_asked(port):
    vocab = port[0].vocab_size
    eng = _engine(port, "dms", prefix_cache_mb=64, export_policy="second-miss")
    max_len = 28
    for s in range(3):
        _serve_one(eng, _prompt(20, seed=30 + s, vocab=vocab), 4, max_len)
    assert eng.prefix_cache.inserts == 0
    prefix = _prompt(16, seed=40, vocab=vocab)
    p1, p2, p3 = (np.concatenate([prefix, _prompt(n, seed=s, vocab=vocab)])
                  for n, s in ((6, 41), (7, 42), (5, 43)))
    _serve_one(eng, p1, 4, max_len)
    assert eng.prefix_cache.inserts == 0
    _serve_one(eng, p2, 4, max_len)
    assert eng.prefix_cache.inserts == 2
    sig = eng.scheduler(num_lanes=1, max_len=max_len).signature
    assert eng.prefix_cache.covered(sig, prefix) == 16
    assert eng.prefix_cache.covered(sig, p2) == 16
    r3 = _serve_one(eng, p3, 4, max_len)
    assert r3.prefill_meter.kv_reads_saved > 0
    c3 = _serve_one(_engine(port, "dms"), p3, 4, max_len)
    np.testing.assert_array_equal(r3.tokens, c3.tokens)
    assert r3.prefill_meter.kv_reads + r3.prefill_meter.kv_reads_saved \
        == pytest.approx(c3.prefill_meter.kv_reads)


def test_export_stride_bounds_boundary_churn(port):
    prompt = _prompt(32, seed=21, vocab=port[0].vocab_size)
    max_len = len(prompt) + 5
    e1 = _engine(port, "dms", prefix_cache_mb=64, export_stride=1)
    e2 = _engine(port, "dms", prefix_cache_mb=64, export_stride=2)
    _serve_one(e1, prompt, 5, max_len)
    _serve_one(e2, prompt, 5, max_len)
    assert e1.prefix_cache.inserts == 4
    assert e2.prefix_cache.inserts == 2
    r2 = _serve_one(e2, prompt, 5, max_len)
    assert r2.prefill_meter.kv_reads == 0.0
    cold = _serve_one(_engine(port, "dms"), prompt, 5, max_len)
    np.testing.assert_array_equal(r2.tokens, cold.tokens)


# -- radix tree and LRU, on dummy snapshots ------------------------------------


def _mk(tokens):
    return np.asarray(tokens, np.int32)


def _dummy_snap(nbytes=64):
    return {"x": torch.zeros((nbytes // 8,), dtype=torch.float64)}


SIG = ("t", ((1,), "f32"))


def _insert(pc, tokens, reads=1.0, nbytes=64):
    return pc.insert(SIG, _mk(tokens), _dummy_snap(nbytes),
                     torch.zeros((4,), dtype=torch.float32), reads)


def test_radix_lookup_returns_deepest_boundary():
    pc = PrefixCache(1 << 20)
    assert _insert(pc, [1, 2, 3, 4], reads=4.0)
    assert _insert(pc, [1, 2, 3, 4, 5, 6], reads=6.0)
    hit = pc.lookup(SIG, _mk([1, 2, 3, 4, 5, 6, 7, 8]))
    assert hit.length == 6 and hit.reads_cum == 6.0
    hit = pc.lookup(SIG, _mk([1, 2, 3, 4, 5, 9]))
    assert hit.length == 4 and hit.reads_cum == 4.0
    assert pc.lookup(SIG, _mk([2, 2, 3])) is None
    assert pc.lookup(("other",), _mk([1, 2, 3, 4])) is None


def test_radix_edge_split_on_divergence():
    pc = PrefixCache(1 << 20)
    assert _insert(pc, [5, 6, 7, 8])
    assert _insert(pc, [5, 6, 9])
    assert pc.lookup(SIG, _mk([5, 6, 7, 8, 1])).length == 4
    assert pc.lookup(SIG, _mk([5, 6, 9, 1])).length == 3
    assert pc.covered(SIG, _mk([5, 6])) == 0
    assert _insert(pc, [5, 6])
    assert pc.covered(SIG, _mk([5, 6])) == 2


def test_radix_never_returns_boundary_past_prompt():
    pc = PrefixCache(1 << 20)
    assert _insert(pc, [3, 3, 3, 3, 3, 3])
    assert pc.lookup(SIG, _mk([3, 3, 3])) is None
    assert _insert(pc, [3, 3])
    assert pc.lookup(SIG, _mk([3, 3, 3])).length == 2


def test_radix_duplicate_insert_is_noop():
    pc = PrefixCache(1 << 20)
    assert _insert(pc, [1, 2], reads=2.0)
    assert not _insert(pc, [1, 2], reads=99.0)
    assert pc.lookup(SIG, _mk([1, 2])).reads_cum == 2.0
    assert pc.stats()["entries"] == 1


def test_lru_evicts_least_recently_used_first():
    pc = PrefixCache(capacity_bytes=3 * 80)               # snap 64 + logits 16
    _insert(pc, [1, 1])
    _insert(pc, [2, 2])
    _insert(pc, [3, 3])
    pc.lookup(SIG, _mk([1, 1]))
    _insert(pc, [4, 4])
    assert pc.lookup(SIG, _mk([2, 2])) is None
    assert pc.lookup(SIG, _mk([1, 1])) is not None
    assert pc.lookup(SIG, _mk([4, 4])) is not None
    assert pc.evictions == 1
    assert pc.total_bytes <= pc.capacity_bytes


def test_byte_accounting_tracks_entries():
    pc = PrefixCache(1 << 20)
    snap = _dummy_snap(128)
    logits = torch.zeros((4,), dtype=torch.float32)
    want = snapshot_nbytes(snap) + 4 * 4
    pc.insert(SIG, _mk([7]), snap, logits, 1.0)
    assert pc.total_bytes == want
    pc.insert(SIG, _mk([7, 8]), snap, logits, 2.0)
    assert pc.total_bytes == 2 * want
    assert pc.stats()["bytes"] == pc.total_bytes


def test_oversized_snapshot_rejected():
    pc = PrefixCache(capacity_bytes=16)
    assert not _insert(pc, [1, 2, 3], nbytes=1024)
    assert pc.stats()["insert_rejects"] == 1
    assert pc.total_bytes == 0


def test_want_export_always_only_skips_covered_boundaries():
    pc = PrefixCache(1 << 20)
    assert pc.want_export(SIG, _mk([1, 2]))
    _insert(pc, [1, 2])
    assert not pc.want_export(SIG, _mk([1, 2]))
    assert pc.want_export(SIG, _mk([1, 2, 3]))


def test_want_export_second_miss_needs_two_askers():
    pc = PrefixCache(1 << 20, export_policy="second-miss")
    p = _mk([1, 2, 3, 4, 5, 6])
    assert not pc.want_export(SIG, p[:2])
    pc.lookup(SIG, p)
    assert not pc.want_export(SIG, p[:2])
    pc.lookup(SIG, p)
    for depth in (2, 4, 6):
        assert pc.want_export(SIG, p[:depth]), depth
    assert not pc.want_export(SIG, _mk([1, 2, 9]))
    pc.lookup(SIG, _mk([1, 2, 9, 9]))
    assert pc.want_export(SIG, p[:2])
    assert not pc.want_export(SIG, _mk([1, 2, 9]))
    _insert(pc, [1, 2])
    assert not pc.want_export(SIG, p[:2])


def test_want_export_stride_gates_chunk_boundaries():
    pc = PrefixCache(1 << 20, export_stride=2)
    p = _mk([1, 2, 3, 4, 5, 6])
    assert not pc.want_export(SIG, p[:2], chunk_index=1)
    assert pc.want_export(SIG, p[:4], chunk_index=2)
    assert not pc.want_export(SIG, p[:5], chunk_index=3)
    assert pc.want_export(SIG, p, chunk_index=3, final=True)
    assert PrefixCache(1 << 20).want_export(SIG, p[:2], chunk_index=1)
    assert pc.want_export(SIG, p[:2])
    with pytest.raises(ValueError):
        PrefixCache(1 << 20, export_stride=0)


def test_second_miss_records_survive_pruning_resets():
    pc = PrefixCache(1 << 20, export_policy="second-miss")
    _insert(pc, [7, 7])
    pc.lookup(SIG, _mk([1, 2, 3]))
    pc.lookup(SIG, _mk([1, 2, 3]))
    assert pc.want_export(SIG, _mk([1, 2]))
    pc._miss_tokens[SIG] = pcm.MISS_RECORD_TOKENS + 1
    pc.lookup(SIG, _mk([9, 9, 9]))
    assert not pc.want_export(SIG, _mk([1, 2]))
    assert pc.lookup(SIG, _mk([7, 7])) is not None


def test_eviction_prunes_only_the_dead_path():
    pc = PrefixCache(capacity_bytes=2 * 80)
    _insert(pc, [1, 1])
    _insert(pc, [1, 1, 2, 2])
    _insert(pc, [1, 1, 3, 3])
    assert pc.evictions == 1
    root = pc._roots[SIG]
    assert sorted(root.children[1].children) == [2, 3]
    assert pc.lookup(SIG, _mk([1, 1, 2, 2])).length == 4
    _insert(pc, [5])
    assert sorted(root.children[1].children) == [2]
    assert pc.lookup(SIG, _mk([1, 1, 2, 2])).length == 4


# -- the slab, on dummy device snapshots ---------------------------------------


def _dev_snap(val, n=16):
    return {"x": torch.full((1, 1, n), float(val), dtype=torch.float32)}


def test_hot_tier_slab_store_demote_promote_unit():
    n, snap_nb = 16, 16 * 4
    logits = torch.zeros((4,), dtype=torch.float32)
    pc = PrefixCache(1 << 20, device_capacity_bytes=snap_nb + snap_nb // 2)
    assert pc.insert(SIG, _mk([1, 1]), _dev_snap(1.0), logits, 1.0)
    assert pc.hot_inserts == 1 and pc.d2h_bytes == 0
    assert pc.total_bytes == 0
    assert pc.insert(SIG, _mk([2, 2]), _dev_snap(2.0), logits, 2.0)
    assert pc.demotions == 1 and pc.d2h_bytes == snap_nb
    h1 = pc.lookup(SIG, _mk([1, 1]))
    assert h1.tier == "hot" and pc.promotions == 1
    np.testing.assert_array_equal(h1.snapshot["x"].numpy().ravel(),
                                  np.full(n, 1.0, np.float32))
    h2 = pc.lookup(SIG, _mk([2, 2]))
    assert h2.tier == "hot" and pc.promotions == 2
    np.testing.assert_array_equal(h2.snapshot["x"].numpy().ravel(),
                                  np.full(n, 2.0, np.float32))
    assert pc.h2d_bytes == 2 * snap_nb


def test_hot_tier_multiple_slots_lru_demotion_order():
    entry_nb = 16 * 4 + 16
    logits = torch.zeros((4,), dtype=torch.float32)
    pc = PrefixCache(1 << 20, device_capacity_bytes=2 * entry_nb)
    pc.insert(SIG, _mk([1, 1]), _dev_snap(1.0), logits, 1.0)
    pc.insert(SIG, _mk([2, 2]), _dev_snap(2.0), logits, 2.0)
    pc.lookup(SIG, _mk([1, 1]))
    pc.insert(SIG, _mk([3, 3]), _dev_snap(3.0), logits, 3.0)
    assert pc.demotions == 1
    assert pc.lookup(SIG, _mk([1, 1])).tier == "hot"
    assert pc.lookup(SIG, _mk([3, 3])).tier == "hot"


def test_hot_insert_survives_demotion_eviction_prune_race():
    entry_nb = 16 * 4 + 16
    logits = torch.zeros((4,), dtype=torch.float32)
    pc = PrefixCache(capacity_bytes=entry_nb, device_capacity_bytes=entry_nb)
    assert pc.insert(SIG, _mk([1, 1, 2, 2]), _dev_snap(1.0), logits, 1.0)
    assert pc.insert(SIG, _mk([5]), _dev_snap(2.0), logits, 2.0)
    assert pc.demotions == 1
    assert pc.insert(SIG, _mk([1, 1]), _dev_snap(3.0), logits, 3.0)
    assert pc.evictions == 1
    hit = pc.lookup(SIG, _mk([1, 1]))
    assert hit is not None and hit.length == 2 and hit.tier == "hot"
    np.testing.assert_array_equal(hit.snapshot["x"].numpy().ravel(),
                                  np.full(16, 3.0, np.float32))


def test_hot_slab_slot_cap_leaves_budget_for_later_signatures():
    entry_nb = 16 * 4 + 16
    logits = torch.zeros((4,), dtype=torch.float32)
    pc = PrefixCache(1 << 20, device_capacity_bytes=10 * entry_nb,
                     max_hot_slots=2)
    sig2 = ("t2", ((1,), "f32"))
    assert pc.insert(SIG, _mk([1, 1]), _dev_snap(1.0), logits, 1.0)
    assert pc._device_bytes == 2 * entry_nb
    assert pc.insert(sig2, _mk([1, 1]), _dev_snap(5.0), logits, 1.0)
    assert pc.stats()["hot_entries"] == 2
    assert pc.lookup(sig2, _mk([1, 1])).tier == "hot"


def test_hot_insert_without_host_room_still_works():
    snap_nb = 16 * 4
    logits = torch.zeros((4,), dtype=torch.float32)
    pc = PrefixCache(capacity_bytes=8,
                     device_capacity_bytes=snap_nb + snap_nb // 2)
    assert pc.insert(SIG, _mk([1, 1]), _dev_snap(1.0), logits, 1.0)
    assert pc.total_bytes == 0
    assert pc.insert(SIG, _mk([2, 2]), _dev_snap(2.0), logits, 2.0)
    assert pc.demotions == 1 and pc.evictions == 1
    assert pc.lookup(SIG, _mk([1, 1])) is None
    assert pc.lookup(SIG, _mk([2, 2])).tier == "hot"


# -- against the reference ---------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("kind", POLICIES)
def test_snapshot_bytes_match_reference(tiny_arch, tiny_params, port, kind,
                                        paged):
    """One prefix-cache entry's bytes (a lane snapshot and its logits row)
    equal the reference's, so byte budgets evict alike; Keyformer's int64
    salt adds 4 bytes per layer (ROADMAP C)."""
    kw = dict(paged=paged, block_p=4)
    want = JEngine(tiny_arch, tiny_params,
                   _policy_cfg(kind, tiny_arch.dms.window, JKV, **kw),
                   prefix_cache_mb=64).scheduler(
        num_lanes=2, max_len=30)._snap_nbytes
    tarch, params = port
    got = Engine(tarch, params, _policy_cfg(kind, tarch.dms.window, **kw),
                 device="cpu", prefix_cache_mb=64).scheduler(
        num_lanes=2, max_len=30)._snap_nbytes
    extra = 4 * tarch.num_layers if kind == "keyformer" else 0
    assert got == want + extra, (kind, got, want)


def _fp32(tiny_arch, tiny_params):
    jarch = dataclasses.replace(tiny_arch, dtype="float32", dms=dataclasses.replace(
        tiny_arch.dms, logit_bias=0.0))
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")
    return jarch, tarch, params


def _shared_trace(vocab):
    """A 16-token system prompt, four distinct suffixes, staggered arrivals;
    the last request repeats the first (a whole-prompt hit)."""
    prefix = _prompt(16, seed=50, vocab=vocab)
    out = []
    for i, n in enumerate((5, 9, 12)):
        out.append((np.concatenate([prefix, _prompt(n, seed=51 + i,
                                                    vocab=vocab)]), 5, i))
    out.append((out[0][0], 4, 6))
    return out


def _multi_turn(vocab):
    spec = workload.WorkloadSpec(vocab=vocab, max_len=60, prompt_len=(4, 10),
                                 max_new=(3, 5))
    return [(r.prompt, r.max_new, r.arrival) for r in
            workload.multi_turn_trace(3, sessions=2, turns=3, spec=spec,
                                      think_ticks=2)]


def _run(eng, req_cls, trace, max_len, lanes=2):
    sched = eng.scheduler(num_lanes=lanes, max_len=max_len)
    for uid, (p, n, arr) in enumerate(trace):
        sched.submit(req_cls(uid=uid, prompt=p, max_new=n, arrival=arr))
    return {r.uid: r for r in sched.run()}, sched


@pytest.mark.parametrize("device_mb", [0, 64], ids=["cold-tier", "hot-tier"])
@pytest.mark.parametrize("trace", ["shared-prefix", "multi-turn"])
def test_traces_match_reference_engine(tiny_arch, tiny_params, trace,
                                       device_mb):
    jarch, tarch, params = _fp32(tiny_arch, tiny_params)
    reqs = (_shared_trace if trace == "shared-prefix" else _multi_turn)(
        jarch.vocab_size)
    max_len = max(len(p) + n for p, n, _ in reqs)
    kw = dict(kind="dms", cr=2.0, window=jarch.dms.window)
    cache = dict(prefix_cache_mb=64, prefix_cache_device_mb=device_mb)
    jeng = JEngine(jarch, tiny_params, JKV(**kw), chunk=8, **cache)
    teng = Engine(tarch, params, KVPolicyConfig(**kw), chunk=8, device="cpu",
                  **cache)
    jres, jsched = _run(jeng, JRequest, reqs, max_len)
    tres, tsched = _run(teng, Request, reqs, max_len)
    cold, _ = _run(Engine(tarch, params, KVPolicyConfig(**kw), chunk=8,
                          device="cpu"), Request, reqs, max_len)
    assert sorted(tres) == sorted(jres) == list(range(len(reqs)))
    saved = 0.0
    for uid in jres:
        t, j = tres[uid], jres[uid]
        assert t.status == j.status == "ok"
        np.testing.assert_array_equal(t.tokens, j.tokens, err_msg=str(uid))
        np.testing.assert_array_equal(t.tokens, cold[uid].tokens)
        for m in ("prefill_meter", "decode_meter"):
            for key in ("kv_reads", "kv_reads_saved", "peak_tokens",
                        "peak_bytes", "steps", "generated_tokens"):
                assert getattr(getattr(t, m), key) == getattr(
                    getattr(j, m), key), (uid, m, key)
        assert (t.admitted_tick, t.finished_tick) == (j.admitted_tick,
                                                      j.finished_tick)
        assert t.prefill_meter.kv_reads + t.prefill_meter.kv_reads_saved \
            == pytest.approx(cold[uid].prefill_meter.kv_reads)
        saved += t.prefill_meter.kv_reads_saved
    assert saved > 0
    ts, js = teng.prefix_cache.stats(), jeng.prefix_cache.stats()
    assert ts == js
    assert teng.prefix_cache.traffic() == jeng.prefix_cache.traffic()
    if device_mb:
        assert ts["hot_hits"] > 0 and ts["h2d_bytes"] == ts["d2h_bytes"] == 0
    assert tsched.signature != _run(Engine(
        tarch, params, KVPolicyConfig(**kw), chunk=8, device="cpu"),
        Request, [], max_len + 8)[1].signature


@pytest.mark.parametrize("arrival,degrades", [(5, 1), (8, 0)],
                         ids=["pool-short", "pool-room"])
def test_paged_import_under_pressure_degrades_counted(tiny_arch, tiny_params,
                                                      arrival, degrades):
    """An oversubscribed pool (8 pages of 8 slots, two lanes of 24) and a
    third request sharing the first's 16-token prompt: while the second
    request holds the pages the hit's boundary needs, the import degrades
    to a cold prefill, as the reference's does (saved reads 0, the same
    ``stats()``); the port counts it in ``prefix_import_degrades``.  The
    degraded request's tokens equal a cold serve's."""
    jarch, tarch, params = _fp32(tiny_arch, tiny_params)
    vocab = jarch.vocab_size
    prefix = _prompt(16, seed=1, vocab=vocab)
    reqs = [(np.concatenate([prefix, _prompt(2, seed=2, vocab=vocab)]), 4, 0),
            (_prompt(18, seed=3, vocab=vocab), 6, 0),
            (np.concatenate([prefix, _prompt(3, seed=4, vocab=vocab)]), 4,
             arrival)]
    kw = dict(kind="dms", cr=2.0, window=jarch.dms.window, paged=True,
              block_p=8, pool_blocks=8)
    sched_kw = dict(oversub=2.0, on_pressure="preempt")

    def run(eng, req_cls):
        sched = eng.scheduler(num_lanes=2, max_len=24, **sched_kw)
        for uid, (p, n, arr) in enumerate(reqs):
            sched.submit(req_cls(uid=uid, prompt=p, max_new=n, arrival=arr))
        return {r.uid: r for r in sched.run()}, sched

    jeng = JEngine(jarch, tiny_params, JKV(**kw), chunk=4, prefix_cache_mb=64)
    teng = Engine(tarch, params, KVPolicyConfig(**kw), chunk=4, device="cpu",
                  prefix_cache_mb=64)
    jres, _ = run(jeng, JRequest)
    tres, tsched = run(teng, Request)
    for uid, j in jres.items():
        t = tres[uid]
        assert t.status == j.status == "ok"
        np.testing.assert_array_equal(t.tokens, j.tokens, err_msg=str(uid))
        assert t.prefill_meter.kv_reads_saved == j.prefill_meter.kv_reads_saved
    assert teng.prefix_cache.stats() == jeng.prefix_cache.stats()
    assert teng.prefix_cache.stats()["hits"] == 1
    assert tsched.prefix_import_degrades == degrades
    stats = tsched.prefix_stats()
    assert stats == dict(teng.prefix_cache.stats(), import_degrades=degrades)
    assert (tres[2].prefill_meter.kv_reads_saved == 0) == bool(degrades)
    cold = Engine(tarch, params, KVPolicyConfig(**dict(kw, paged=False)),
                  chunk=4, device="cpu")
    solo = cold.scheduler(num_lanes=1, max_len=24)
    solo.submit(Request(uid=2, prompt=reqs[2][0], max_new=4))
    np.testing.assert_array_equal(tres[2].tokens, solo.run()[0].tokens)
