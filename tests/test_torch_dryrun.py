"""The port's dry-run (``repro_torch.launch.dryrun``) on reduced cells.

A smoke config over fake process groups of 4 (a 2×2 mesh) and 8 (2×2×2),
one tiny shape of each kind, vanilla and DMS, with nothing allocated (fake
tensors).  The argument bytes of each cell equal the local-shard bytes the
*reference's* specs imply for the reference's own trees of the same config
(``repro.parallel.sharding`` on a ``jax.sharding.AbstractMesh``), and the
collectives the card issues are counted, as many by the dry-run's counter
as by ``CommDebugMode``.  Decode cells include both slot-split layouts:
context parallelism (one lane: the arena's slots over ``data``) and
split-KV (one kv head on two ``model`` shards: the slots over ``model``).
Each cell opens its fake group and destroys it.

The dry-run's attention path, ``attention_chunked`` (and
``model_forward(attn_impl="chunked")``), is held against the reference's
``attention_chunked`` and ``attention_chunked_scan`` in fp32, at chunks
smaller than T (several tiles, causal and window skips, the DMS delay,
softcap): within 1e-5 absolute (tile sums in another order).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_smoke as jget_smoke
from repro.core.config import KVPolicyConfig as JPolicy
from repro.core.config import ShapeConfig as JShape
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.parallel import sharding as jsh
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core.config import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshAxes
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SHAPES = {"train": (8, 32), "prefill": (4, 48), "decode": (4, 40),
          "decode_one_lane": (1, 40)}


def _arches(kv_heads=None):
    """The qwen smoke config at one layer (DTensor's per-op cost, not the
    size, sets a cell's time), optionally with ``kv_heads`` kv heads."""
    ja, ta = (dataclasses.replace(get("qwen-r1-1.5b"), num_layers=1)
              for get in (jget_smoke, get_smoke))
    if kv_heads is not None:
        ja = dataclasses.replace(ja, attn=dataclasses.replace(
            ja.attn, num_kv_heads=kv_heads))
        ta = dataclasses.replace(ta, attn=dataclasses.replace(
            ta.attn, num_kv_heads=kv_heads))
    return ja, ta


def _local_bytes(tree, shardings, mesh_sizes):
    """Σ local-shard bytes of the reference's leaves under its specs."""
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    total = 0
    for leaf, sh in zip(leaves, specs):
        n = math.prod(leaf.shape) * leaf.dtype.itemsize
        for entry in tuple(sh.spec):
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= mesh_sizes[ax]
        total += n
    return total


def _reference_arg_bytes(arch, kind, batch, seq, policy, mesh):
    shape, names = MESHES[mesh]
    try:
        am = AbstractMesh(shape, names)
    except TypeError:
        am = AbstractMesh(tuple(zip(names, shape)))
    sizes = dict(zip(names, shape))
    sc = JShape("tiny", seq, batch, "train" if kind == "train" else
                "prefill" if kind == "prefill" else "decode")
    pspec = jsteps.params_spec(arch, dtype=arch.dtype)
    total = _local_bytes(pspec, jsh.param_shardings(pspec, arch, am), sizes)
    if kind == "train":
        ospec = jsteps.opt_state_spec(pspec)
        total += _local_bytes(ospec, jsh.opt_shardings(pspec, arch, am),
                              sizes)
        b = jsteps.train_input_specs(arch, sc)
        total += _local_bytes(b, jsh.batch_shardings(am, b), sizes)
    elif kind == "prefill":
        b = jsteps.prefill_input_specs(arch, sc)
        total += _local_bytes(b, jsh.batch_shardings(am, b), sizes)
    else:
        b = jsteps.decode_input_specs(arch, sc, JPolicy(kind=policy))
        cache = b.pop("cache")
        total += _local_bytes(cache, jsh.cache_shardings(cache, am, batch,
                                                         arch), sizes)
        total += _local_bytes(b, jsh.batch_shardings(am, b), sizes)
    return total


# (kind, policy, mesh, kv heads, memory pass): every cell on 2×2; on
# 2×2×2 (three times DTensor's per-op cost) one cell of each kind and
# layout, the train step's flops pass only
CELLS = [(kind, policy, "2x2", kv, True)
         for kind, policy, kv in (("train", "vanilla", None),
                                  ("prefill", "vanilla", None),
                                  ("prefill", "dms", None),
                                  ("decode", "vanilla", None),
                                  ("decode", "dms", None),
                                  ("decode_one_lane", "vanilla", None),
                                  ("decode_one_lane", "dms", None),
                                  ("decode", "vanilla", 1),
                                  ("decode", "dms", 1))] + [
    ("train", "vanilla", "2x2x2", None, False),
    ("prefill", "dms", "2x2x2", None, True),
    ("decode", "dms", "2x2x2", None, True),
    ("decode_one_lane", "vanilla", "2x2x2", None, True),
    ("decode", "dms", "2x2x2", 1, True)]


@pytest.mark.parametrize("kind,policy,mesh,kv_heads,memory", CELLS)
def test_dryrun_cell_arg_bytes_and_collectives(kind, policy, mesh, kv_heads,
                                               memory):
    ja, ta = _arches(kv_heads)
    batch, seq = SHAPES[kind]
    step_kind = kind.split("_")[0]
    shape = ShapeConfig(f"tiny_{kind}", seq, batch, step_kind)
    rec = dryrun.run_cell(ta.name, shape.name, arch=ta, shape=shape,
                          axes=MeshAxes(*MESHES[mesh]), policy_kind=policy,
                          accum_steps=2 if step_kind == "train" else 1,
                          memory_pass=memory, save=False, verbose=False)
    assert not dist.is_initialized()
    want = _reference_arg_bytes(ja, step_kind, batch, seq, policy, mesh)
    assert rec["memory_analysis"]["argument_bytes"] == want
    assert rec["collectives_recorded"] > 0
    assert rec["collectives_recorded"] == sum(
        rec["comm_debug_counts"].values())
    assert rec["flops_per_device"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    if memory:
        assert rec["memory_fit"]["argument_bytes"] > 0
        assert rec["memory_fit"]["peak_bytes"] >= \
            rec["memory_fit"]["argument_bytes"]


def test_slot_split_layouts_are_exercised():
    """The one-lane and one-kv-head decode cells above do split the arena's
    slots (context parallelism over ``data``, split-KV over ``model``)."""
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding
    for kv, batch, axis in ((None, 1, "data"), (1, 4, "model")):
        _, ta = _arches(kv)
        st = steps.decode_input_specs(ta, ShapeConfig("t", 40, batch,
                                                      "decode"),
                                      KVPolicyConfig(kind="vanilla"))
        specs = sharding.cache_shardings(st["cache"],
                                         MeshAxes(*MESHES["2x2"]), batch, ta)
        assert specs["0"].cache.k[3] == axis


def test_cli_skips_and_fails_as_the_reference(capsys):
    assert dryrun.main(["--arch", "qwen-r1-1.5b", "--shape",
                        "long_500k"]) == 0
    assert "SKIP" in capsys.readouterr().out
    assert dryrun.main(["--arch", "no-such-arch", "--shape",
                        "decode_32k"]) == 1
    assert "1 failed" in capsys.readouterr().out
    assert not dist.is_initialized()


CHUNK_CASES = {  # b, t, hq, hkv, dh, causal, window, cap, delay, chunk
    "causal, window, softcap, dms": (1, 70, 6, 2, 16, True, 20, 30.0, 8, 24),
    "bidirectional dms": (2, 33, 2, 2, 8, False, None, None, 4, 16),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_attention_chunked_matches_reference(case):
    b, t, hq, hkv, dh, causal, window, cap, delay, chunk = CHUNK_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(b, t, hq, dh)).astype(np.float32)
    k, v = (rng.normal(size=(b, t, hkv, dh)).astype(np.float32)
            for _ in range(2))
    alpha = (rng.uniform(size=(b, hkv, t)).astype(np.float32) if delay
             else None)
    kw = dict(dms_delay=delay, causal=causal, window=window, logit_cap=cap,
              chunk_q=chunk, chunk_k=chunk)
    got = tattn.attention_chunked(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        None if alpha is None else torch.tensor(alpha), **kw).numpy()
    jargs = [jnp.asarray(x) for x in (q, k, v)] + [
        None if alpha is None else jnp.asarray(alpha)]
    for ref in (jattn.attention_chunked, jattn.attention_chunked_scan):
        np.testing.assert_allclose(got, np.asarray(ref(*jargs, **kw)),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,mode", [("qwen-r1-1.5b", "dms_eval"),
                                       ("gemma2-2b", "vanilla")])
def test_model_forward_chunked_matches_reference(name, mode):
    """fp32 smoke configs with the reference's weights: the logits of
    ``attn_impl="chunked"`` against the reference's (rtol 1e-4, atol
    1e-5, as the other step tests)."""
    jarch = dataclasses.replace(jget_smoke(name), dtype="float32")
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu",
        dtype=torch.float32)
    toks = np.random.default_rng(1).integers(
        0, jarch.vocab_size, (2, 24)).astype(np.int32)
    want = jtfm.model_forward(jparams, jnp.asarray(toks), jarch, mode=mode,
                              attn_impl="chunked")[0]
    got = tfm.model_forward(tparams, torch.tensor(toks), tarch, mode=mode,
                            attn_impl="chunked")[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
