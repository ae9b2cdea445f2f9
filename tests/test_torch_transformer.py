"""The port's decode step and lane lifecycle against the JAX reference, on
the shared tiny Qwen-R1 model (``tiny_arch``/``tiny_params``, weights copied
through numpy) with the ``dms`` policy.

Per token: active lanes' logits, ``live_tokens`` and ``reads_tokens``
under a seeded per-lane ``active`` mask and per-lane positions — the port's kernel branch
(its plain version on the CPU) against the reference with ``use_kernel=True``
(Pallas interpret mode), and both reference branches against each other.
The algorithmic checks run the model in fp32 (rtol 1e-4 / atol 1e-5 on
logits: fp32 sums in another order); the token budget axes are integers
summed in the same order and must be equal.  The DMS bias is 0 there so
that about half the tokens are marked for eviction.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.config import KVPolicyConfig as JKV
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.core.config import KVPolicyConfig
from repro_torch.models import transformer as ttfm

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
META = ("pos", "valid", "free_ring", "free_head", "free_count",
        "pending_slot", "pending_alpha", "length", "overflowed")
TABLE = ("count", "tbl", "pos", "n")
B, MAX_LEN, STEPS = 3, 24, 14


def _arch(tiny_arch, dtype, bias):
    return dataclasses.replace(tiny_arch, dtype=dtype, dms=dataclasses.replace(
        tiny_arch.dms, logit_bias=bias))


def _port(tiny_arch, tiny_params, dtype="float32", bias=0.0):
    jarch = _arch(tiny_arch, dtype, bias)
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")
    return jarch, tarch, params


def _policies(jarch):
    kw = dict(kind="dms", cr=2.0, window=jarch.dms.window)
    return JKV(**kw), KVPolicyConfig(**kw)


def assert_state_equal(ts, js, kv_tol=F32):
    tc, jc = ts["0"].cache, js["0"].cache
    for name in META:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), err_msg=name)
    for name in TABLE:
        np.testing.assert_array_equal(getattr(tc.blocks, name).numpy(),
                                      np.asarray(getattr(jc.blocks, name)),
                                      err_msg="blocks." + name)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(tc, name).float().numpy(),
                                   np.asarray(getattr(jc, name), np.float32),
                                   err_msg=name, **kv_tol)


def _run(jarch, tarch, tiny_params, params, use_kernel, steps=STEPS, seed=0,
         tol=F32):
    """Drive both decode steps on one seeded token/active stream; compare
    every step's outputs; return the final states."""
    jcfg, tcfg = _policies(jarch)
    js = jtfm.init_decode_state(jarch, B, MAX_LEN, jcfg)
    ts = ttfm.init_decode_state(tarch, B, MAX_LEN, tcfg, device="cpu")
    jstep = jax.jit(lambda p, tok, s, pos, act: jtfm.decode_step(
        p, tok, s, jarch, pos, use_kernel=use_kernel, active=act))
    r = np.random.default_rng(seed)
    pos = np.zeros((B,), np.int32)
    for i in range(steps):
        tok = r.integers(3, jarch.vocab_size, size=(B, 1)).astype(np.int32)
        act = r.random(B) < 0.8
        act[i % B] = True
        lj, js, aj = jstep(tiny_params, jnp.asarray(tok), js, jnp.asarray(pos),
                           jnp.asarray(act))
        lt, ts, at = ttfm.decode_step(params, torch.from_numpy(tok), ts, tarch,
                                      torch.from_numpy(pos), use_kernel=use_kernel,
                                      active=torch.from_numpy(act))
        # an inactive lane's logits are discarded by the scheduler; the
        # reference computes them against the step it then rolls back
        np.testing.assert_allclose(lt.numpy()[act], np.asarray(lj)[act],
                                   err_msg=f"step {i}", **tol)
        for key in ("live_tokens", "reads_tokens"):
            np.testing.assert_array_equal(at[key].numpy(), np.asarray(aj[key]),
                                          err_msg=f"{key} step {i}")
        assert at["attn_impl_kernel"] == int(aj["attn_impl_kernel"])
        pos = pos + act
    return js, ts


@pytest.mark.parametrize("use_kernel", [True, False])
def test_decode_step_matches_reference(tiny_arch, tiny_params, use_kernel):
    jarch, tarch, params = _port(tiny_arch, tiny_params)
    js, ts = _run(jarch, tarch, tiny_params, params, use_kernel)
    assert_state_equal(ts, js)
    # the stream exercised eviction: some slots were freed and reused
    assert int(ts["0"].cache.free_ring.ne(
        torch.arange(ts["0"].cache.free_ring.shape[-1]) % ts["0"].cache.slots
    ).sum()) > 0


def test_decode_step_bf16_matches_reference(tiny_arch, tiny_params):
    """The model's own dtype.  bf16 logits at 2e-2: the frameworks round
    bf16 matmul outputs and activations at different places (2 layers of
    ~0.4% relative error each); the trained bias keeps α at 0 so the cache
    metadata stays exactly equal."""
    jarch, tarch, params = _port(tiny_arch, tiny_params, "bfloat16", -5.0)
    js, ts = _run(jarch, tarch, tiny_params, params, True, steps=8,
                  tol=dict(rtol=2e-2, atol=2e-2))
    assert_state_equal(ts, js, kv_tol=dict(rtol=2e-2, atol=2e-2))


def test_lane_lifecycle_matches_reference(tiny_arch, tiny_params):
    """gather_lanes / reclaim_lanes / lane_select / fork_decode_state leaf
    for leaf, and forked or gathered lanes own their storage."""
    jarch, tarch, params = _port(tiny_arch, tiny_params)
    js, ts = _run(jarch, tarch, tiny_params, params, False, steps=6, seed=3)
    src = np.array([2, 2, 0], np.int32)
    assert_state_equal(ttfm.gather_lanes(ts, torch.from_numpy(src)),
                       jtfm.gather_lanes(js, jnp.asarray(src)))
    mask = np.array([True, False, True])
    jcfg, tcfg = _policies(jarch)
    assert_state_equal(
        ttfm.reclaim_lanes(ts, torch.from_numpy(mask),
                           ttfm.init_decode_state(tarch, B, MAX_LEN, tcfg,
                                                  device="cpu")),
        jtfm.reclaim_lanes(js, jnp.asarray(mask),
                           jtfm.init_decode_state(jarch, B, MAX_LEN, jcfg)))
    sel = np.array([False, True, True])
    assert_state_equal(
        ttfm.lane_select(torch.from_numpy(sel), ts,
                         ttfm.gather_lanes(ts, torch.from_numpy(src))),
        jtfm.lane_select(jnp.asarray(sel), js,
                         jtfm.gather_lanes(js, jnp.asarray(src))))
    one_t = ttfm.gather_lanes(ts, torch.tensor([1]))
    one_j = jtfm.gather_lanes(js, jnp.asarray([1]))
    forked = ttfm.fork_decode_state(one_t, 3)
    assert_state_equal(forked, jtfm.fork_decode_state(one_j, 3))
    # a write into one forked lane must not reach its siblings
    k = forked["0"].cache.k
    before = k[:, 1].clone()
    k[:, 0].add_(1.0)
    assert torch.equal(k[:, 1], before)
    assert not torch.equal(one_t["0"].cache.k[:, 0], k[:, 0])


def test_init_model_shapes_and_scales():
    """init_model draws the reference's layout, distributions and scales
    (not its threefry stream) from a seeded generator."""
    from repro_torch.configs import get_smoke
    arch = get_smoke("qwen-r1-1.5b")
    p1 = ttfm.init_model(arch, seed=3, device="cpu")
    p2 = ttfm.init_model(arch, seed=3, device="cpu")
    jp = jtfm.init_model(jax.random.PRNGKey(0), get_smoke_ref())
    t_leaves = dict(_leaves(p1))
    j_leaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    assert t_leaves.keys() == j_leaves.keys()
    for name, t in t_leaves.items():
        assert tuple(t.shape) == j_leaves[name].shape, name
        assert torch.equal(t, dict(_leaves(p2))[name])          # seeded
        want = float(np.std(j_leaves[name]))
        got = float(t.float().std()) if t.numel() > 1 else 0.0
        assert got == pytest.approx(want, rel=0.15, abs=1e-6), name
        expect = torch.float32 if name.endswith("scale") else torch.bfloat16
        assert t.dtype == expect, name


def get_smoke_ref():
    from repro.configs import get_smoke
    return get_smoke("qwen-r1-1.5b")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v
