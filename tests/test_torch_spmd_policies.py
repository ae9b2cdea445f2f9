"""Every decode policy on a slot-split arena, against one rank.

The reference's sharding rule splits an arena's slot axis across ranks in
every decode cell whose batch and kv heads cannot take the mesh, and it
shards every policy's slot metadata with the slots.  Here four CPU
processes on a gloo group (a 2×2 mesh, real collectives) serve the smoke
qwen-r1-1.5b config in fp32 at 2 layers with one kv head and one lane, so
the arena's slots split four ways over ``data`` and ``model``.  The arenas
are sized so that no shard is block-aligned: a block straddles two shards.
TOVA, H2O, Keyformer, Quest and DMC each run at least 16 decode steps past
their budget, placed (DTensors) and unsharded, from the same weights, on
the reference attention path and on the decode kernel's (its plain
versions here: the slot-shard mode on each rank); per step the logits and
every state leaf are compared.  Integer and bool
leaves (the evictions' ``valid``/``pos`` and block tables, DMC's merge
counts, positions and weights ``z``) and Quest's selected pages must be
equal; float leaves and logits within ``TOL`` (2e-5 relative to each
output's largest magnitude: fp32 sums in another order).

One rank of the port is held against the JAX caches leaf for leaf in
``tests/test_torch_weight_policies.py`` and ``tests/test_torch_quest_dmc.py``,
so parity with the reference is transitive through those tests.

The same file holds the decode kernel's slot-shard mode on its plain
version (the shards' partials, combined, against the whole row; an empty
shard, softcap 50 at Dh 256, G 16) and lowers the five policies'
``long_500k`` decode cells on the 16×16 mesh, which raised before.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
TOL = 2e-5
MAX_LEN = 48
# policy -> (KVPolicyConfig fields, decode steps); the budgets: 19 tokens in
# a 24-slot arena (block_p 8, shards of 6), Quest's 2 pages of 8 in 48
# slots (shards of 12), DMC's 40-slot arena (shards of 10)
POLICIES = {
    "tova": (dict(budget=19, block_p=8), 36),
    "h2o": (dict(budget=19, block_p=8), 36),
    "keyformer": (dict(budget=19, block_p=8), 36),
    "quest": (dict(quest_page_size=8, quest_top_pages=2), 40),
    "dmc": (dict(cr=2.0, block_p=8), 40),
}


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _policy_runs(mesh):
    """(policy, use_kernel) -> the comparison of the placed run with the
    plain one; ``use_kernel`` takes the decode kernel's path on both (on
    the CPU its plain versions: the slot-shard mode on each rank)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke
    from repro_torch.core import baselines
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding

    arch = dataclasses.replace(get_smoke("qwen-r1-1.5b"), dtype="float32")
    # one kv head; DMC's merge logit unbiased, so that about half merge
    arch = dataclasses.replace(
        arch, attn=dataclasses.replace(arch.attn, num_kv_heads=1),
        dms=dataclasses.replace(arch.dms, logit_bias=0.0))
    params = tfm.init_model(arch, seed=7, device="cpu")
    placed = sharding.distribute(
        params, sharding.param_shardings(params, arch, mesh), mesh)
    pages = {"plain": [], "placed": []}
    select = baselines.QuestCache.select_pages
    which = ["plain"]

    def spy(self, q):
        got = select(self, q)
        pages[which[0]].append(got.clone())
        return got

    baselines.QuestCache.select_pages = spy
    out = {}
    gen = torch.Generator().manual_seed(11)
    try:
        with implicit_replication():
            for (name, (kw, steps)), use_kernel in (
                    (item, k) for k in (False, True)
                    for item in POLICIES.items()):
                cfg = KVPolicyConfig(kind=name, **kw)
                plain = tfm.init_decode_state(arch, 1, MAX_LEN, cfg,
                                              device="cpu")
                state = tfm.init_decode_state(arch, 1, MAX_LEN, cfg,
                                              device="cpu")
                specs = sharding.cache_shardings(state, mesh, 1, arch)
                state = sharding.distribute(state, specs, mesh)
                arena = state["0"].cache.k
                local = arena.to_local().shape[-2]
                rec = dict(logits=0.0, state=0.0, meters=0.0, unequal=[],
                           shards=arena.shape[-2] // local, local=local,
                           pages_unequal=0)
                for p in pages.values():
                    p.clear()
                for t in range(steps):
                    tok = torch.randint(3, arch.vocab_size, (1, 1),
                                        generator=gen, dtype=torch.int32)
                    pos = torch.full((1,), t, dtype=torch.int32)
                    which[0] = "plain"
                    want, plain, want_aux = tfm.decode_step(
                        params, tok, plain, arch, pos, use_kernel=use_kernel)
                    which[0] = "placed"
                    got, state, got_aux = tfm.decode_step(
                        placed, tok, state, arch, pos, use_kernel=use_kernel)
                    rec["logits"] = max(rec["logits"],
                                        _rel(got.full_tensor(), want))
                    for m in ("live_tokens", "reads_tokens"):
                        g = got_aux[m]
                        g = g.full_tensor() if isinstance(g, DTensor) else g
                        rec["meters"] = max(rec["meters"],
                                            float((g - want_aux[m]).abs()
                                                  .max()))
                    for (path, g), (_, w) in zip(
                            sharding.leaves_with_path(state),
                            sharding.leaves_with_path(plain)):
                        g = g.full_tensor() if isinstance(g, DTensor) else g
                        if w.dtype.is_floating_point:
                            fin = torch.isfinite(w)
                            if not torch.equal(fin, torch.isfinite(g)):
                                rec["unequal"].append((t, path))
                            elif fin.any():
                                rec["state"] = max(rec["state"],
                                                   _rel(g[fin], w[fin]))
                        elif not torch.equal(g, w):
                            rec["unequal"].append((t, path))
                rec["pages"] = len(pages["plain"])
                rec["pages_unequal"] = sum(
                    not torch.equal(a, b) for a, b in zip(pages["plain"],
                                                          pages["placed"]))
                rec["pages_counted"] = len(pages["placed"])
                inner = plain["0"].cache
                if name in ("tova", "h2o", "keyformer"):
                    rec["evictions"] = int(steps - inner.valid[0].sum(-1)
                                           .max())
                    rec["budget"] = inner.budget
                if name == "dmc":
                    rec["merges"] = int(steps - inner.count[0].max())
                out[name, use_kernel] = rec
    finally:
        baselines.QuestCache.select_pages = select
    return out


def _worker(rank, store_path, out_path):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import MeshAxes, make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh(MeshAxes((2, 2), ("data", "model")), device="cpu")
        out = _policy_runs(mesh)
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{out_path}.{rank}")


@pytest.fixture(scope="module")
def policy_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_policies")
    out = str(tmp / "runs")
    mp.spawn(_worker, args=(str(tmp / "store"), out), nprocs=WORLD,
             join=True)
    return [torch.load(f"{out}.{rank}") for rank in range(WORLD)]


@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "kernel"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_on_a_slot_split_arena_matches_one_rank(policy_runs, name,
                                                       use_kernel):
    for rank, runs in enumerate(policy_runs):
        rec = runs[name, use_kernel]
        print(rank, name, use_kernel, rec)
        # four shards of the slot axis, none a whole number of blocks
        assert rec["shards"] == WORLD and rec["local"] % 8, rec
        assert not rec["unequal"], (rank, rec["unequal"][:5])
        assert rec["logits"] <= TOL and rec["state"] <= TOL, (rank, rec)
        assert rec["meters"] == 0.0, (rank, rec)
        if name == "quest":
            assert rec["pages"] == rec["pages_counted"] > 0
            assert rec["pages_unequal"] == 0, (rank, rec)
        if name in ("tova", "h2o", "keyformer"):
            steps = POLICIES[name][1]
            assert rec["evictions"] == steps - rec["budget"] >= 16, rec
        if name == "dmc":
            assert rec["merges"] > 0, rec


# ---------------------------------------------------------------------------
# the kernel's slot-shard mode, plain version
# ---------------------------------------------------------------------------


def _shard_case(bh, g, dh, nb, bp, seed):
    r = np.random.default_rng(seed)
    p = nb * bp
    tbl = np.stack([r.permutation(nb) for _ in range(bh)]).astype(np.int32)
    counts = r.integers(1, nb + 1, bh).astype(np.int32)
    counts[0] = nb
    q = torch.tensor(r.normal(size=(bh, g, dh)), dtype=torch.float32)
    k = torch.tensor(r.normal(size=(bh, p, dh)), dtype=torch.float32)
    v = torch.tensor(r.normal(size=(bh, p, dh)), dtype=torch.float32)
    valid = torch.tensor(r.random((bh, p)) < 0.7)
    return q, k, v, valid, torch.tensor(tbl), torch.tensor(counts)


@pytest.mark.parametrize("bh,g,dh,nb,cap,cuts,empty", [
    (4, 6, 32, 10, None, (0, 37, 90, 100, 160), 2),
    (2, 2, 256, 6, 50.0, (0, 33, 66, 96), None),
    (3, 16, 16, 9, None, (0, 13, 100, 144), None),
], ids=["empty-shard", "softcap-dh256", "g16"])
def test_plain_shard_partials_combine_to_the_whole_row(bh, g, dh, nb, cap,
                                                       cuts, empty):
    """Each shard ``[lo, hi)`` (not block-aligned) through ``decode_rows(
    slot_lo=lo)`` on the CPU (the plain shard mode), combined by
    ``combine_partials``, equals the whole row's plain output; the shards'
    weights, scattered under the combined statistics, equal the whole
    row's; shard ``empty``, whose slots are all hidden, gives m = -1e30 and
    l = 0."""
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode.ref import (combine_partials,
                                                    dms_decode_plain)
    bp = 16
    q, k, v, valid, tbl, n = _shard_case(bh, g, dh, nb, bp, seed=nb * g)
    if empty is not None:
        valid[:, cuts[empty]:cuts[empty + 1]] = False
    want = dms_decode_plain(q, k, v, valid, tbl, n, bp, cap)
    raw = ops.decode_rows(q, k, v, valid, tbl, n, bp, cap, need_weights=True)
    want_w = ops.table_weights_to_arena(raw[1], raw[2], raw[3], raw[4], n,
                                        tbl, nb)
    stats, shards = [], []
    for i, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
        args = (q, k[:, lo:hi], v[:, lo:hi], valid[:, lo:hi], tbl, n, bp,
                cap)
        out, m, l = ops.decode_rows(*args, slot_lo=lo)
        if i == empty:
            assert (m == -1e30).all() and (l == 0).all() and (out == 0).all()
        stats.append((m, l, out.float() * l[..., None]))
        shards.append(ops.decode_rows(*args, need_weights=True, slot_lo=lo))
    m, l, acc = combine_partials(*(torch.stack(x) for x in zip(*stats)))
    got = acc / torch.where(l > 0, l, 1.0)[..., None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(m.numpy(), raw[3].numpy(), rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), raw[4].numpy(), rtol=1e-5)
    got_w = torch.cat([ops.table_weights_to_arena(
        s[1], s[2], m, l, n, tbl, 0, slot_lo=lo, p_local=hi - lo)
        for s, lo, hi in zip(shards, cuts, cuts[1:])], dim=1)
    np.testing.assert_allclose(got_w.numpy(), want_w.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_shard_attention_matches_the_reference_decode():
    """``attention.shard_partial`` under ``use_kernel`` (the wrapper's
    plain shard mode here) over four unaligned shards, combined by
    ``combine_shards`` with a reduction over the shard index, against the
    reference's ``dms_decode_attention`` over the whole arena (Pallas,
    interpret mode) in fp32, and its weights against the one-rank
    ``_masked_decode``'s."""
    import jax.numpy as jnp
    from repro.kernels.dms_decode import ops as jops
    from repro_torch.core.config import AttentionConfig
    from repro_torch.core.kv_cache import BlockTable
    from repro_torch.core.policy import AttendSpec
    from repro_torch.kernels.dms_decode.ref import (combine_partials,
                                                    reduce_stacked)
    from repro_torch.models import attention

    b, hkv, g, dh, bp, p = 2, 2, 3, 16, 8, 48
    r = np.random.default_rng(3)
    q = r.normal(size=(b, 1, hkv * g, dh)).astype(np.float32)
    k = r.normal(size=(b, hkv, p, dh)).astype(np.float32)
    v = r.normal(size=(b, hkv, p, dh)).astype(np.float32)
    valid = r.random((b, hkv, p)) < 0.6
    valid[..., 0] = True
    blocks = BlockTable.from_valid(torch.tensor(valid), bp)
    want = np.asarray(jops.dms_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        block_tbl=jnp.asarray(blocks.tbl.numpy()),
        block_n=jnp.asarray(blocks.n.numpy()), block_p=bp), np.float32)
    cfg = AttentionConfig(num_heads=hkv * g, num_kv_heads=hkv, head_dim=dh)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    vis = torch.tensor(valid)
    parts = []
    for lo in range(0, p, 12):
        spec = AttendSpec(kt[:, :, lo:lo + 12], vt[:, :, lo:lo + 12], vis,
                          block_tbl=blocks.tbl, block_n=blocks.n,
                          block_p=bp, needs_weights=True)
        parts.append(attention.shard_partial(qt, spec, None, cfg, True, None,
                                             lo, need_weights=True))
    stack = attention.ShardPartial(
        *(torch.stack([getattr(x, f) for x in parts])
          for f in ("m", "l", "acc")))
    out, _ = attention.combine_shards(stack, reduce_stacked, qt.shape)
    m, den, _ = combine_partials(stack.m, stack.l, stack.acc)
    got_w = torch.cat([x.weights(m, den) for x in parts], dim=-1)
    _, want_w, _ = attention._masked_decode(
        qt, AttendSpec(kt, vt, vis, block_tbl=blocks.tbl, block_n=blocks.n,
                       block_p=bp), None, cfg, True, need_weights=True)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), want_w.numpy(), rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the dry-run's decode cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["vanilla", "window", "dms", "dms_masked",
                                    "tova", "h2o", "keyformer", "quest",
                                    "dmc"])
def test_every_policy_decode_state_has_named_rules_and_split_slots(policy):
    """The decode state of each of the nine policies in qwen-r1-1.5b's
    ``decode_32k`` and ``long_500k`` cells (fake tensors, one layer) on
    both production meshes: every leaf hits a named sharding rule (the
    audit's coverage check finds nothing), and the K arena's slots are
    split, so the step runs on a slot shard."""
    from repro_torch.analysis import contracts
    from repro_torch.configs import get_arch
    from repro_torch.core.config import SHAPES, KVPolicyConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import production_axes
    from repro_torch.parallel import sharding
    arch = dataclasses.replace(get_arch("qwen-r1-1.5b"), num_layers=1)
    for cell in ("decode_32k", "long_500k"):
        shape = SHAPES[cell]
        state = steps.decode_input_specs(
            arch, shape, KVPolicyConfig(kind=policy, cr=8.0))["cache"]
        for axes in (production_axes(), production_axes(multi_pod=True)):
            assert not contracts.check_sharding_coverage(
                state, axes, shape.global_batch, arch), (cell, axes)
            arenas = [(path, x) for path, x in sharding.leaves_with_path(state)
                      if path[-1] == "k" and x.dim() == 5]
            assert arenas
            for path, k in arenas:
                spec = sharding.cache_spec(path, tuple(k.shape), axes,
                                           shape.global_batch, arch)
                assert spec[3] is not None, (cell, path, spec)


@pytest.mark.parametrize("policy", ["tova", "h2o", "keyformer", "quest",
                                    "dmc"])
def test_long_context_decode_cell_lowers_under_every_policy(policy):
    """``qwen-r1-1.5b`` × ``long_500k`` at CR 8 on the 16×16 mesh: one lane,
    so the arena's slots split 16 ways over ``data`` (4097 slots a shard
    for TOVA, H2O, Keyformer and DMC: no shard block-aligned).  The flops
    pass runs each policy's decode step on fake shards without raising, as
    the reference's dry-run lowers these cells."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("qwen-r1-1.5b", "long_500k", policy_kind=policy,
                          cr=8.0, flops_pass=True, memory_pass=False,
                          save=False, verbose=False)
    assert not dist.is_initialized()
    assert rec["flops_per_device"] > 0 and rec["collectives_recorded"] > 0
