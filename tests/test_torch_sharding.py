"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the reference's ``repro.parallel.sharding``, leaf for leaf.

The reference's rules run on ``jax.sharding.AbstractMesh`` and the port's
on :class:`~repro_torch.launch.mesh.MeshAxes` (names and sizes, no
devices), over the trees each package builds for the same config: the
params (``params_spec``), the AdamW state, the batches of every shape, the
prefill outputs and the decode state of every policy.  A port spec is a
tuple that compares equal to ``tuple(P)`` of the reference's spec.  Also:
the coverage audit's red and green cases, the divisibility of every
``model`` shard, and DTensor placements of a spec.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ASSIGNED_ARCHS, PAPER_ARCHS
from repro.configs import get_arch as jget_arch
from repro.configs import get_smoke as jget_smoke
from repro.core.config import SHAPES as JSHAPES
from repro.core.config import KVPolicyConfig as JPolicy
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.parallel import sharding as jsh
from repro_torch.analysis import contracts
from repro_torch.configs import get_arch, get_smoke
from repro_torch.core.config import SHAPES, KVPolicyConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshAxes, batch_axes, dp_size, tp_size
from repro_torch.models import transformer as tfm
from repro_torch.parallel import sharding

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SMALL_MESHES = {"2x2": ((2, 2), ("data", "model")),
                "2x4": ((2, 4), ("data", "model")),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
POLICIES = ("vanilla", "window", "dms", "dms_masked", "tova", "h2o",
            "keyformer", "quest", "dmc")


def _meshes(shape, names):
    try:
        jm = AbstractMesh(shape, names)
    except TypeError:                    # older jax: ((name, size), ...)
        jm = AbstractMesh(tuple(zip(names, shape)))
    return jm, MeshAxes(shape, names)


def _jflat(tree):
    """path → tuple(spec) of a tree of NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {tuple(str(getattr(p, "key", getattr(p, "name", p))) for p in path):
            tuple(leaf.spec) for path, leaf in flat}


def _tflat(tree):
    return dict(sharding.leaves_with_path(tree))


@pytest.fixture(scope="module")
def param_trees():
    """(reference, port) bf16 params specs per arch, built once."""
    return {name: (jsteps.params_spec(jget_arch(name), dtype="bfloat16"),
                   steps.params_spec(get_arch(name), dtype="bfloat16"))
            for name in ASSIGNED_ARCHS + PAPER_ARCHS}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ASSIGNED_ARCHS + PAPER_ARCHS)
def test_param_and_opt_specs_match_reference(param_trees, name, mesh_name):
    jm, tm = _meshes(*MESHES[mesh_name])
    jp, tp_tree = param_trees[name]
    ja, ta = jget_arch(name), get_arch(name)
    for tp in (None, 1, 2, 4, 16):
        assert _tflat(sharding.param_shardings(tp_tree, ta, tm, tp=tp)) == \
            _jflat(jsh.param_shardings(jp, ja, jm, tp=tp)), (name, tp)
        jo = jsh.opt_shardings(jp, ja, jm, tp=tp)
        to = sharding.opt_shardings(tp_tree, ta, tm, tp=tp)
        assert to.step == tuple(jo.step.spec) == ()
        for field in ("mu", "nu", "master"):
            assert _tflat(getattr(to, field)) == _jflat(getattr(jo, field)), \
                (name, tp, field)


@pytest.mark.parametrize("mesh_name", list(MESHES) + list(SMALL_MESHES))
@pytest.mark.parametrize("name", ASSIGNED_ARCHS + PAPER_ARCHS)
def test_batch_and_prefill_out_specs_match_reference(name, mesh_name):
    jm, tm = _meshes(*{**MESHES, **SMALL_MESHES}[mesh_name])
    ja, ta = jget_arch(name), get_arch(name)
    for sh in SHAPES:
        for accum in (1, 8) if SHAPES[sh].global_batch % 8 == 0 else (1,):
            jb = jsteps.train_input_specs(ja, JSHAPES[sh], accum_steps=accum)
            tb = steps.train_input_specs(ta, SHAPES[sh], accum_steps=accum)
            for over in (False, True):
                assert _tflat(sharding.batch_shardings(
                    tm, tb, microbatched=accum > 1, batch_over_model=over)) \
                    == _jflat(jsh.batch_shardings(
                        jm, jb, microbatched=accum > 1,
                        batch_over_model=over)), (sh, accum, over)
        assert sharding.data_spec(tm, SHAPES[sh].global_batch, 2) == \
            tuple(jsh.data_spec(jm, JSHAPES[sh].global_batch, 2))
    # the prefill outputs: last logits (B, V) and per-position KV stacked
    # over superblocks, at the prefill shape
    shp = SHAPES["prefill_32k"]
    b, t, a = shp.global_batch, shp.seq_len, ta.attn
    out = {"logits": (b, ta.padded_vocab)}
    if a is not None:
        for pi in range(ta.pattern_period):
            kv = (ta.num_superblocks, b, a.num_kv_heads, t)
            out[str(pi)] = {"k_rope": kv + (a.head_dim,),
                            "v": kv + (a.head_dim,), "retained": kv}
    jtree = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32), out,
        is_leaf=lambda x: isinstance(x, tuple))
    ttree = sharding.map_with_path(
        lambda _, s: torch.empty(s, device="meta"),
        jax.tree_util.tree_map(lambda s: torch.Size(s), out,
                               is_leaf=lambda x: isinstance(x, tuple)))
    assert _tflat(sharding.prefill_out_shardings(ttree, tm, ta)) == \
        _jflat(jsh.prefill_out_shardings(jtree, jm, ja))


def _state_rules(state, mesh, batch, arch, flat):
    rules = {}
    for path, leaf in flat(state):
        if any(k in ("k_buf", "v_buf") for k in path):  # the port's pool
            path = tuple({"k_buf": "k", "v_buf": "v"}.get(k, k) for k in path)
        rules[path] = sharding.cache_spec_with_rule(path, tuple(leaf.shape),
                                                    mesh, batch, arch)
    return rules


def _jstate_leaves(state):
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    return [(tuple(str(getattr(p, "key", getattr(p, "name", p)))
                   for p in path), leaf) for path, leaf in flat]


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_cache_rules_match_reference_smoke(policy, paged):
    """Every decode-state leaf of every policy hits the same named rule
    and spec as the reference's, at the smoke size on small meshes (lanes
    that shard, that do not, and a single lane: context parallelism)."""
    ja, ta = jget_smoke("qwen-r1-1.5b"), get_smoke("qwen-r1-1.5b")
    cfg = dict(kind=policy, cr=2.0, window=4, block_p=8, paged=paged,
               quest_page_size=8, quest_top_pages=2)
    for batch in (1, 2, 4):
        jstate = jax.eval_shape(lambda: jtfm.init_decode_state(
            ja, batch, 32, JPolicy(**cfg)))
        tstate = tfm.init_decode_state(ta, batch, 32, KVPolicyConfig(**cfg),
                                       device="cpu")
        for shape, names in SMALL_MESHES.values():
            jm, tm = _meshes(shape, names)
            want = {}
            for path, leaf in _jstate_leaves(jstate):
                rule, spec = jsh.cache_spec_with_rule(path, leaf.shape, jm,
                                                      batch, ja)
                want[path] = (rule, tuple(spec))
            got = _state_rules(tstate, tm, batch, ta,
                               sharding.leaves_with_path)
            assert got == want, (batch, shape)
            assert all(r != "fallback" for r, _ in got.values())


@pytest.mark.parametrize("policy", ["vanilla", "dms"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("name", ["qwen-r1-1.5b", "recurrentgemma-2b",
                                  "mamba2-2.7b", "granite-moe-3b-a800m",
                                  "seamless-m4t-large-v2"])
def test_cache_rules_match_reference_full_size(name, shape_name, policy):
    """The full-size decode state (fake tensors: nothing allocated), on
    both production meshes; qwen's decode_32k arena splits its slots over
    ``model`` (2 kv heads on 16)."""
    ja, ta = jget_arch(name), get_arch(name)
    jstate = jsteps.decode_input_specs(ja, JSHAPES[shape_name],
                                       JPolicy(kind=policy))["cache"]
    tstate = steps.decode_input_specs(ta, SHAPES[shape_name],
                                      KVPolicyConfig(kind=policy))["cache"]
    batch = SHAPES[shape_name].global_batch
    for shape, names in MESHES.values():
        jm, tm = _meshes(shape, names)
        want = {path: (r, tuple(s)) for path, leaf in _jstate_leaves(jstate)
                for r, s in [jsh.cache_spec_with_rule(path, leaf.shape, jm,
                                                      batch, ja)]}
        got = _state_rules(tstate, tm, batch, ta, sharding.leaves_with_path)
        assert got == want
        assert all(r != "fallback" for r, _ in got.values())
        if (name, shape_name) == ("qwen-r1-1.5b", "decode_32k"):
            assert got[("0", "cache", "k")][1][3] == "model"


def _shape_tree(tree, flat):
    return {path: (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
            for path, leaf in flat(tree)}


@pytest.mark.parametrize("name", ["qwen-r1-1.5b", "granite-moe-3b-a800m",
                                  "recurrentgemma-2b", "mamba2-2.7b",
                                  "seamless-m4t-large-v2", "qwen2-vl-7b"])
def test_input_specs_match_reference_eval_shape(name):
    """``steps``' specs (fake tensors) against the reference's
    ``jax.eval_shape`` trees: the same leaf paths, shapes and dtypes, the
    full-size decode states included."""
    ja, ta = jget_arch(name), get_arch(name)
    pairs = [(jsteps.params_spec(ja), steps.params_spec(ta)),
             (jsteps.params_spec(ja, dtype="bfloat16"),
              steps.params_spec(ta, dtype="bfloat16"))]
    for sh in ("train_4k", "prefill_32k"):
        for accum in (1, 8) if sh == "train_4k" else (1,):
            pairs.append((jsteps.train_input_specs(ja, JSHAPES[sh], accum),
                          steps.train_input_specs(ta, SHAPES[sh], accum)))
        pairs.append((jsteps.prefill_input_specs(ja, JSHAPES[sh]),
                      steps.prefill_input_specs(ta, SHAPES[sh])))
    for sh in ("decode_32k", "long_500k"):
        for policy in ("vanilla", "dms"):
            pairs.append((jsteps.decode_input_specs(ja, JSHAPES[sh],
                                                    JPolicy(kind=policy)),
                          steps.decode_input_specs(ta, SHAPES[sh],
                                                   KVPolicyConfig(kind=policy))))
    for jtree, ttree in pairs:
        assert _shape_tree(ttree, sharding.leaves_with_path) == \
            _shape_tree(jtree, _jstate_leaves)
    bf16 = steps.params_spec(ta, dtype="bfloat16")
    ja_opt = jsteps.opt_state_spec(jsteps.params_spec(ja, dtype="bfloat16"))
    t_opt = steps.opt_state_spec(bf16)
    for field in ("mu", "nu", "master"):
        assert _shape_tree(getattr(t_opt, field), sharding.leaves_with_path) \
            == _shape_tree(getattr(ja_opt, field), _jstate_leaves)


def test_sharding_coverage_red_unknown_leaf():
    arch = get_smoke("qwen-r1-1.5b")
    mesh = MeshAxes((1, 1), ("data", "model"))
    state = {"mystery_blob": torch.empty((3, 2, 5, 7, 2), device="meta")}
    got = contracts.check_sharding_coverage(state, mesh, 2, arch)
    assert [f.rule for f in got] == ["sharding-coverage"]
    assert not contracts.check_sharding_coverage(
        state, mesh, 2, arch, allow=("mystery_blob",))


def test_sharding_coverage_green_real_state():
    arch = get_smoke("qwen-r1-1.5b")
    cfg = KVPolicyConfig(kind="dms", cr=2.0, window=4, block_p=8, paged=True)
    state = tfm.init_decode_state(arch, 2, 32, cfg, device="cpu")
    mesh = MeshAxes((1, 1), ("data", "model"))
    assert not contracts.check_sharding_coverage(state, mesh, 2, arch)


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_param_specs_divisibility(param_trees, name):
    """Every dim sharded on ``model`` divides the mesh dim (tp 16)."""
    arch = get_arch(name)
    for path, leaf in sharding.leaves_with_path(param_trees[name][1]):
        spec = sharding.param_spec(path, tuple(leaf.shape), arch, 16)
        for dim, s in zip(leaf.shape, spec):
            if s == "model":
                assert dim % 16 == 0, (name, path, tuple(leaf.shape), spec)


def test_mesh_helpers_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    tm = MeshAxes((2, 16, 16), ("pod", "data", "model"))
    assert batch_axes(tm) == ("pod", "data")
    assert (tp_size(tm), dp_size(tm)) == (16, 32)
    assert sharding.placements((("pod", "data"), None, "model"), tm) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, None), tm) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.placements((("model", "data"),), tm)
    tree = {"a": {"b": (None, "model")}, "c": ("data",)}
    assert sharding.leaves_with_path(tree) == [(("a", "b"), (None, "model")),
                                                (("c",), ("data",))]


def test_mesh_refuses_a_wrong_world_size():
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    with pytest.raises(RuntimeError):
        mesh_lib.make_production_mesh(device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError):
            mesh_lib.make_production_mesh(device="cpu")
        local = mesh_lib.make_local_mesh(device="cpu")
        assert tuple(local.mesh_dim_names) == ("data", "model")
        assert (local.size(0), local.size(1)) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_distribute_places_per_spec(tmp_path):
    """``distribute`` on a 1×1 mesh: every leaf a DTensor with the spec's
    placements and the same values; the params' layer salts survive; a
    checkpoint of it restores onto the mesh (``restore(shardings=)``)."""
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import mesh as mesh_lib
    arch = dataclasses.replace(get_smoke("qwen-r1-1.5b"), num_layers=2)
    params = tfm.init_model(arch, device="cpu", dtype=torch.float32)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.make_local_mesh(device="cpu")
        specs = sharding.param_shardings(params, arch, mesh)
        placed = sharding.distribute(params, specs, mesh)
        assert torch.equal(placed.layer_salt, params.layer_salt)
        for (path, x), (_, y) in zip(sharding.leaves_with_path(placed),
                                     sharding.leaves_with_path(params)):
            assert isinstance(x, DTensor), path
            assert torch.equal(x.full_tensor(), y)
        # the elastic re-shard: a checkpoint of the placed tree restored
        # onto the mesh with each leaf's placements
        mgr = CheckpointManager(tmp_path)
        mgr.save(3, placed)
        shardings = sharding.map_with_path(
            lambda _, x: (mesh, sharding.placements(x, mesh)), specs)
        back, step, _ = mgr.restore(params, shardings=shardings)
        assert step == 3
        for (_, x), (_, y) in zip(sharding.leaves_with_path(back),
                                  sharding.leaves_with_path(params)):
            assert isinstance(x, DTensor)
            assert torch.equal(x.full_tensor(), y)
    finally:
        dist.destroy_process_group()
