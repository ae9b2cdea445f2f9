"""The weight-evicting policies of the port — ``tova``, ``h2o`` and
``keyformer`` — against the reference.

(a) The caches (``core/baselines.py``, ``core/keyformer.py``) leaf for leaf
    after every step of a random trace, fed the same tokens and the same
    attention weights, on fixed arenas and on the paged pool (a roomy pool
    and one tight enough to exhaust): lanes frozen by an ``active`` mask
    equal the reference's after its ``lane_select`` rollback, and
    ``live_tokens`` and ``reads_tokens`` equal the reference's ``metrics``
    after ``post_attend``.  Then the generic lifecycle hooks (gather fork, reclaim,
    export/import, width-2 fork) on the new caches.
(b) The slice as a whole: the port's ``Engine`` against the JAX ``Engine``,
    both with ``use_kernel=True`` (the reference's Pallas kernel in
    interpret mode, the port's plain version of its CUDA kernel), token- and
    meter-equal on the trace ``tests/test_block_tables.py::
    test_weight_policy_scheduler_smoke_use_kernel`` pins (seed 3, two
    11-token prompts, 5 new tokens, CR 2, ``block_p`` 8), fixed and paged.
(c) ``use_kernel=True`` routes every layer through the weights-out entry
    of the decode wrapper; Keyformer's salt is each layer's fp32 ``wo[0,
    0]`` bits, carried across the bf16 cast, and its noise, drawn for every
    layer of a step at once, equals each layer's own draw.
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
from repro_torch import bridge
from repro_torch.core import policy as tpolicy
from repro_torch.core import threefry
from repro_torch.core.block_pool import BlockPool
from repro_torch.core.config import KVPolicyConfig
from repro_torch.kernels.dms_decode import ops as tops
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)

KINDS = ["tova", "h2o", "keyformer"]
BP = 8
POOL_LEAVES = ("k", "v", "ref", "cow_copies", "alloc_events", "high_water",
               "exhausted")
TABLE = ("count", "tbl", "pos", "n")
SCORES = ("acc", "score")           # fp32 accumulators: log/exp/softmax ulps


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
    names = [f.name for f in dataclasses.fields(tc)
             if not f.metadata.get("static")
             and f.name not in ("blocks", "pool")]
    assert names == [f.name for f in dataclasses.fields(jc)
                     if not f.metadata.get("static")
                     and f.name not in ("blocks", "pool")]
    for name in names:
        t, j = getattr(tc, name), getattr(jc, name)
        if t is None:
            assert j is None, name
            continue
        want = np.asarray(j, np.float32 if j.dtype == jnp.bfloat16 else None)
        if name in SCORES:
            np.testing.assert_allclose(_np(t), want, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {where}")
        else:
            np.testing.assert_array_equal(_np(t), want.astype(_np(t).dtype),
                                          err_msg=f"{name} {where}")
    for name in TABLE:
        np.testing.assert_array_equal(getattr(tc.blocks, name).numpy(),
                                      np.asarray(getattr(jc.blocks, name)),
                                      err_msg=f"blocks.{name} {where}")
    assert (tc.pool is None) == (jc.pool is None)
    if tc.pool is not None:
        for name in POOL_LEAVES:
            np.testing.assert_array_equal(
                _np(getattr(tc.pool, name)), np.asarray(getattr(jc.pool, name)),
                err_msg=f"pool.{name} {where}")


@pytest.fixture(scope="module")
def arches(tiny_arch):
    jarch = dataclasses.replace(tiny_arch, dtype="float32")
    return jarch, bridge.arch_from_dict(dataclasses.asdict(jarch))


@pytest.mark.parametrize("pool", [None, 0, 10], ids=["fixed", "paged",
                                                     "tight-pool"])
@pytest.mark.parametrize("kind", KINDS)
def test_cache_matches_reference_every_step(arches, kind, pool):
    jarch, tarch = arches
    b, max_len = 3, 40
    kw = dict(kind=kind, cr=2.0, block_p=BP, paged=pool is not None,
              pool_blocks=pool or None)
    pol_j, pol_t = jpolicy.get_policy(kind), tpolicy.get_policy(kind)
    jc = jpolicy.init_policy_cache(jarch, b, max_len, JKV(**kw)).cache
    tc = tpolicy.init_policy_cache(tarch, b, max_len, KVPolicyConfig(**kw),
                                   device="cpu").cache
    fresh_j = jc
    fresh_t = tpolicy.init_policy_cache(tarch, b, max_len,
                                        KVPolicyConfig(**kw),
                                        device="cpu").cache
    a = jarch.attn
    r = np.random.default_rng(KINDS.index(kind) * 10 + (pool or 1))
    salts = [0x80000001, 0x3F2A0000]           # two layers' salts, top bit set

    def step(jc, tc, i):
        k = r.normal(size=(b, a.num_kv_heads, 1, a.head_dim)).astype(np.float32)
        v = r.normal(size=(b, a.num_kv_heads, 1, a.head_dim)).astype(np.float32)
        act = r.random(b) < 0.7 if i % 3 else None
        salt = salts[i % 2]
        jaux = {"attn_cfg": a, "arch": jarch, "dtype": jnp.float32,
                "active": None if act is None else jnp.asarray(act),
                "layer_salt": jnp.uint32(salt)}
        taux = {"attn_cfg": tarch.attn, "arch": tarch, "dtype": torch.float32,
                "active": None if act is None else torch.from_numpy(act),
                "layer_salt": torch.tensor(salt)}
        new, jspec = pol_j.decode_update(jc, None, jnp.asarray(k),
                                         jnp.asarray(v), jaux)
        tc, tspec, meters = pol_t.decode_update(tc, None, torch.from_numpy(k),
                                                torch.from_numpy(v), taux)
        assert jspec.needs_weights and tspec.needs_weights and meters is None
        w = np.where(np.asarray(jspec.visible),
                     r.random(jspec.visible.shape), 0.0).astype(np.float32)
        new = pol_j.post_attend(new, jnp.asarray(w), active=jaux["active"])
        want = pol_j.metrics(new)
        tc, meters = pol_t.post_attend(tc, torch.from_numpy(w),
                                       active=taux["active"])
        for key in ("live_tokens", "reads_tokens"):
            np.testing.assert_array_equal(meters[key].numpy(),
                                          np.asarray(want[key]),
                                          err_msg=f"{key} step {i}")
        jc = new if act is None else _lane_sel(act, new, jc)
        assert_cache_same(tc, jc, f"step {i}")
        return jc, tc

    for i in range(26):
        jc, tc = step(jc, tc, i)
    assert int(tc.valid.sum(-1).max()) == tc.budget      # evicting by now
    # the generic lifecycle hooks take the new caches unchanged
    src = np.array([0, 1, 0])
    jc = pol_j.gather_cache(jc, jnp.asarray(src))
    tc = pol_t.gather_cache(tc, torch.from_numpy(src))
    assert_cache_same(tc, jc, "gather fork")
    for i in range(26, 32):
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
    for i in range(32, 36):
        jc, tc = step(jc, tc, i)
    assert_cache_same(pol_t.fork_cache(tc, 2), pol_j.fork_cache(jc, 2),
                      "fork width 2")
    assert pol_t.peak_bytes(tc) == pol_j.peak_bytes(jc)


# -- (b) the Engine ----------------------------------------------------------------


@pytest.fixture(scope="module")
def port(tiny_arch, tiny_params):
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    return tarch, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")


def assert_meters_equal(mt, mj, what):
    for key in ("kv_reads", "peak_tokens", "peak_bytes", "steps",
                "generated_tokens"):
        assert getattr(mt, key) == getattr(mj, key), (what, key)


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("kind", KINDS)
def test_engine_matches_reference_engine(tiny_arch, tiny_params, port, kind,
                                         paged):
    tarch, tparams = port
    prompts = np.random.default_rng(3).integers(
        3, tiny_arch.vocab_size, size=(2, 11)).astype(np.int32)
    kw = dict(kind=kind, cr=2.0, window=tiny_arch.dms.window, block_p=BP,
              paged=paged)
    rj = JEngine(tiny_arch, tiny_params, JKV(**kw),
                 use_kernel=True).generate(prompts, 5)
    rt = Engine(tarch, tparams, KVPolicyConfig(**kw), use_kernel=True,
                device="cpu").generate(prompts, 5)
    assert rt.tokens.shape == (2, 5)
    np.testing.assert_array_equal(rt.tokens, rj.tokens)
    assert_meters_equal(rt.meter, rj.meter, "generate")
    for a, b in zip(rt.requests, rj.requests):
        assert a.status == "ok"
        assert_meters_equal(a.prefill_meter, b.prefill_meter, "prefill")
        assert_meters_equal(a.decode_meter, b.decode_meter, "decode")


# -- (c) the kernel route and the layer salt ------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("kind", KINDS)
def test_every_layer_takes_the_weights_out_entry(tiny_arch, port, kind, paged,
                                                 monkeypatch):
    """No reference bypass: with ``use_kernel=True`` every layer of a decode
    step calls the kernel's interface in weights-out mode (in the paged
    layout, in shared-pool mode), and the step reports the kernel path."""
    tarch, tparams = port
    calls = []
    real = tops.decode_rows

    def spy(*args, **kw):
        calls.append((kw.get("need_weights", False), kw.get("shared_kv")))
        return real(*args, **kw)

    monkeypatch.setattr(tops, "decode_rows", spy)
    cfg = KVPolicyConfig(kind=kind, cr=2.0, block_p=BP, paged=paged)
    state = ttfm.init_decode_state(tarch, 2, 16, cfg, device="cpu")
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    for t in range(3):
        _, state, aux = ttfm.decode_step(tparams, tok, state, tarch,
                                         torch.tensor([t, t]),
                                         use_kernel=True)
        assert aux["attn_impl_kernel"] == 1
    assert calls == [(True, paged)] * (3 * tarch.num_layers)
    calls.clear()
    _, _, aux = ttfm.decode_step(tparams, tok, state, tarch,
                                 torch.tensor([3, 3]), use_kernel=False)
    assert calls == [] and aux["attn_impl_kernel"] == 0


def test_layer_salt_is_the_fp32_weight_bits(tiny_arch, tiny_params, port):
    """The salt of each layer is the bits of its fp32 ``wo[0, 0]``, kept
    across the cast to bf16 (whose upcast has other bits) by the bridge and
    by ``init_model``, and it reaches the Keyformer cache of every lane."""
    tarch, tparams = port
    wo = np.asarray(tiny_params["blocks"]["0"]["attn"]["wo"], np.float32)
    want = wo[:, 0, 0].view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(ttfm.layer_salts(tparams).numpy(), want)
    upcast = threefry.float_bits(tparams["blocks"]["0"]["attn"]["wo"][:, 0, 0])
    assert not torch.equal(upcast, ttfm.layer_salts(tparams))
    # init_model: the bf16 model's salts are the fp32 model's weight bits
    p16 = ttfm.init_model(tarch, seed=3, device="cpu")
    p32 = ttfm.init_model(tarch, seed=3, device="cpu", dtype=torch.float32)
    assert torch.equal(ttfm.layer_salts(p16), threefry.float_bits(
        p32["blocks"]["0"]["attn"]["wo"][:, 0, 0]))
    assert torch.equal(ttfm.layer_salts(p32), ttfm.layer_salts(p16))
    cfg = KVPolicyConfig(kind="keyformer", cr=2.0, block_p=BP)
    state = ttfm.init_decode_state(tarch, 2, 16, cfg, device="cpu")
    ttfm.decode_step(tparams, torch.tensor([[5], [9]]), state, tarch,
                     torch.tensor([0, 0]), use_kernel=True)
    np.testing.assert_array_equal(state["0"].cache.salt.numpy(),
                                  np.repeat(want[:, None], 2, axis=1))
    # a state's caches are the registry's: the pool stays one object a layer
    assert isinstance(ttfm.init_decode_state(
        tarch, 1, 16, dataclasses.replace(cfg, paged=True),
        device="cpu")["0"].cache.pool, BlockPool)


def test_batched_noise_equals_each_layers_own_draw(tiny_arch, port):
    """``KeyformerPolicy.prepare_step`` draws a decode step's noise for every
    layer at once; for every active lane it equals the draw each layer's
    cache makes on its own after the step's insert (length + 1, its salt)."""
    from repro_torch.core.keyformer import gumbel_noise
    from repro_torch.core.tree import tree_map
    tarch, tparams = port
    cfg = KVPolicyConfig(kind="keyformer", cr=2.0, block_p=BP)
    state = ttfm.init_decode_state(tarch, 2, 16, cfg, device="cpu")
    tok = torch.tensor([[5], [9]])
    for t in range(5):
        ttfm.decode_step(tparams, tok, state, tarch, torch.tensor([t, t]))
    pol = tpolicy.get_policy("keyformer")
    salts = ttfm.layer_salts(tparams)
    prepared = pol.prepare_step(state["0"].cache, {"layer_salt": salts})
    assert len(prepared) == tarch.num_layers
    a = tarch.attn
    for i in range(tarch.num_layers):
        cache = tree_map(lambda x: x[i].clone(), state["0"].cache)
        kv = torch.zeros((2, a.num_kv_heads, 1, a.head_dim))
        cache.insert(kv, kv, salt=salts[i])
        own = gumbel_noise(cache.length, cache.salt, cache.valid.shape[1:])
        assert torch.equal(prepared[i]["gumbel"], own)
