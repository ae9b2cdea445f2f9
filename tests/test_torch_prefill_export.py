"""The prefill export of the port against the JAX reference, on the shared
tiny Qwen-R1 model (weights copied through numpy):

* ``core/dms.py::retained_after_prefill`` equal to the reference's, over
  seeds, delay windows and lengths (and immediate eviction);
* ``model_forward(collect_kv=True)``'s ``layer_kv`` in ``vanilla`` and
  ``dms_eval``, on the flash kernel's path (its plain version on the CPU;
  the reference's Pallas kernels in interpret mode) and the reference
  path: ``k_rope`` and ``v`` within the stated tolerance, ``retained`` and
  ``alpha_bin`` equal;
* ``SlotDMSCache.from_prefill`` and ``KVPolicy.prefill_import`` (vanilla
  and dms, fixed arenas and paged) leaf for leaf on the same inputs;
* 8 greedy decode steps from the imported caches: the reference's tokens;
* ``make_prefill_step``'s last-position logits.

Algorithmic checks run in fp32 with the DMS bias at 0, so that about half
the tokens are marked for eviction (rtol 1e-4 / atol 1e-5: fp32 sums in
another order); bf16 runs hold K/V to 2e-2 and logits to 5e-2 of their
scale (bf16 keeps 8 significant bits).  Integer and bool leaves must be
equal.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import dms as jdms
from repro.core import policy as jpolicy
from repro.core.config import KVPolicyConfig as JKV
from repro.core.kv_cache import SlotDMSCache as JSlot
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.core import dms as tdms
from repro_torch.core import policy as tpolicy
from repro_torch.core.config import DMSConfig, KVPolicyConfig
from repro_torch.core.kv_cache import SlotDMSCache
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttfm

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
T, MAX_LEN, B, DECODE = 13, 24, 2, 8


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _setup(tiny_arch, tiny_params, dtype="float32", bias=0.0):
    jarch = tiny_arch
    if dtype == "float32":
        jarch = dataclasses.replace(tiny_arch, dtype=dtype, dms=dataclasses.replace(
            tiny_arch.dms, logit_bias=bias))
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")
    return jarch, tarch, params


def _tokens(vocab, seed=3):
    return np.random.default_rng(seed).integers(
        3, vocab, size=(B, T)).astype(np.int32)


def assert_tree_equal(t, j, where="", tol=F32):
    """Every field of the reference's dataclass tree against the port's
    (floats within ``tol``, the rest equal); the port's pool is read
    through its public ``k``/``v`` views."""
    if j is None:
        assert t is None, where
        return
    if dataclasses.is_dataclass(j):
        for f in dataclasses.fields(j):
            assert_tree_equal(getattr(t, f.name), getattr(j, f.name),
                              f"{where}.{f.name}", tol)
        return
    if isinstance(j, (int, float, bool, str)):
        assert t == j, where
        return
    jv = np.asarray(j)
    tv = _np(t)
    assert tv.shape == jv.shape, (where, tv.shape, jv.shape)
    if jv.dtype.kind == "f" or jv.dtype == jnp.bfloat16:
        np.testing.assert_allclose(tv, jv.astype(np.float32), err_msg=where,
                                   **tol)
    else:
        np.testing.assert_array_equal(tv, jv, err_msg=where)


# -- retained_after_prefill --------------------------------------------------


@pytest.mark.parametrize("immediate", [False, True], ids=["delayed", "immediate"])
@pytest.mark.parametrize("seq_len", [3, 11, 17])
@pytest.mark.parametrize("window", [1, 4, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_retained_after_prefill_matches_reference(tiny_arch, seed, window,
                                                  seq_len, immediate):
    jcfg = dataclasses.replace(tiny_arch.dms, window=window,
                               immediate_eviction=immediate)
    tcfg = DMSConfig(**dataclasses.asdict(jcfg))
    a = np.random.default_rng(seed).random((2, 3, seq_len)) < 0.5
    want = np.asarray(jdms.retained_after_prefill(jnp.asarray(a), seq_len, jcfg))
    got = tdms.retained_after_prefill(torch.from_numpy(a), seq_len, tcfg)
    np.testing.assert_array_equal(got.numpy(), want)


# -- layer_kv ------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "kernel"])
@pytest.mark.parametrize("mode", ["vanilla", "dms_eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_kv_matches_reference(tiny_arch, tiny_params, dtype, mode,
                                    use_kernel):
    jarch, tarch, params = _setup(tiny_arch, tiny_params, dtype)
    toks = _tokens(jarch.vocab_size)
    jl, jaux = jtfm.model_forward(tiny_params, jnp.asarray(toks), jarch,
                                  mode=mode, collect_kv=True,
                                  use_kernel=use_kernel)
    tl, taux = ttfm.model_forward(params, torch.from_numpy(toks), tarch,
                                  mode=mode, collect_kv=True,
                                  use_kernel=use_kernel)
    jkv, tkv = jaux["layer_kv"]["0"], taux["layer_kv"]["0"]
    assert set(tkv) == set(jkv)
    assert ("retained" in tkv) == (mode == "dms_eval")
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for key in ("k_rope", "v"):
        assert tuple(tkv[key].shape) == jkv[key].shape
        np.testing.assert_allclose(_np(tkv[key]), np.asarray(jkv[key], np.float32),
                                   err_msg=key, **tol)
    for key in ("retained", "alpha_bin"):
        if key in jkv:
            np.testing.assert_array_equal(tkv[key].numpy(), np.asarray(jkv[key]),
                                          err_msg=key)
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=1e-4 * scale if dtype == "float32"
                               else 5e-2 * scale, rtol=0)


# -- from_prefill / prefill_import --------------------------------------------


@pytest.mark.parametrize("with_alpha", [False, True], ids=["no-ring", "ring"])
@pytest.mark.parametrize("block_p", [0, 4])
@pytest.mark.parametrize("num_slots", [9, 20])
@pytest.mark.parametrize("seed", [0, 1])
def test_from_prefill_matches_reference(seed, num_slots, block_p, with_alpha):
    """Random K/V, retained maps and decisions: the compacted cache, its
    pending ring and block table equal the reference's, leaf for leaf
    (more retained tokens than slots included)."""
    r = np.random.default_rng(seed)
    b, h, t, dh, w = 2, 3, 14, 4, 5
    k = r.standard_normal((b, h, t, dh)).astype(np.float32)
    v = r.standard_normal((b, h, t, dh)).astype(np.float32)
    alpha = r.random((b, h, t)) < 0.5
    retained = r.random((b, h, t)) < 0.7
    retained[..., t - w:] = True          # the delay window is never evicted
    pos = np.arange(t, dtype=np.int32)
    jc = JSlot.from_prefill(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            jnp.asarray(retained), w, num_slots,
                            alpha_bin=jnp.asarray(alpha) if with_alpha else None,
                            block_p=block_p)
    tc = SlotDMSCache.from_prefill(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
        torch.from_numpy(retained), w, num_slots,
        alpha_bin=torch.from_numpy(alpha) if with_alpha else None,
        block_p=block_p)
    assert_tree_equal(tc, jc, "from_prefill")


def _prefill(jarch, tarch, tiny_params, params, mode, use_kernel=False):
    toks = _tokens(jarch.vocab_size)
    jl, jkv = jsteps.make_prefill_step(
        jarch, dms=mode == "dms_eval", use_kernel=use_kernel)(
        tiny_params, {"tokens": jnp.asarray(toks)})
    tl, tkv = tsteps.make_prefill_step(
        tarch, dms=mode == "dms_eval", use_kernel=use_kernel)(
        params, {"tokens": torch.from_numpy(toks)})
    return jl, jkv, tl, tkv


def _jax_state(jarch, cfg, jkv):
    """The reference's per-layer prefill_import, stacked over layers."""
    kv = jkv["0"]
    name = cfg.kind_for_layer("attn")
    pol = jpolicy.get_policy(name)
    t = kv["k_rope"].shape[3]
    caches = [pol.prefill_import(
        jarch, cfg, kv["k_rope"][i], kv["v"][i], jnp.arange(t, dtype=jnp.int32),
        kv["retained"][i] if "retained" in kv else None,
        kv["alpha_bin"][i] if "alpha_bin" in kv else None, max_len=MAX_LEN)
        for i in range(jarch.num_layers)]
    return {"0": jpolicy.PolicyCache(
        jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *caches), name)}


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("kind", ["vanilla", "dms"])
def test_prefill_import_then_decode_matches_reference(tiny_arch, tiny_params,
                                                      kind, paged):
    """The imported decode state leaf for leaf, then 8 greedy decode steps
    from it through the decode kernel (its plain version here; the
    reference's in interpret mode): the same tokens, logits and meters."""
    jarch, tarch, params = _setup(tiny_arch, tiny_params)
    mode = "dms_eval" if kind == "dms" else "vanilla"
    kw = dict(kind=kind, cr=2.0, window=jarch.dms.window, block_p=4,
              paged=paged)
    jcfg, tcfg = JKV(**kw), KVPolicyConfig(**kw)
    jl, jkv, tl, tkv = _prefill(jarch, tarch, tiny_params, params, mode)
    js = _jax_state(jarch, jcfg, jkv)
    ts = ttfm.state_from_prefill(tarch, tcfg, tkv, MAX_LEN)
    assert_tree_equal(ts["0"].cache, js["0"].cache, f"{kind} import")
    if kind == "dms":
        # a third of the prompt is evicted at once: the import compacts
        assert int(ts["0"].cache.valid.sum()) < jarch.num_layers * B * \
            jarch.attn.num_kv_heads * T

    jstep = jax.jit(lambda p, tok, s, pos: jtfm.decode_step(
        p, tok, s, jarch, pos, use_kernel=True))
    jtok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    ttok = torch.argmax(tl, dim=-1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    for i in range(DECODE):
        pos = np.full((B,), T + i, np.int32)
        jlog, js, jaux = jstep(tiny_params, jnp.asarray(jtok[:, None]), js,
                               jnp.asarray(pos))
        tlog, ts, taux = ttfm.decode_step(params, ttok[:, None], ts, tarch,
                                          torch.from_numpy(pos), use_kernel=True)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   err_msg=f"step {i}", **F32)
        for key in ("live_tokens", "reads_tokens"):
            np.testing.assert_array_equal(taux[key].numpy(),
                                          np.asarray(jaux[key]), err_msg=key)
        jtok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
        ttok = torch.argmax(tlog, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), jtok, err_msg=f"step {i}")
    assert_tree_equal(ts["0"].cache, js["0"].cache, f"{kind} after decode")


@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "kernel"])
@pytest.mark.parametrize("mode", ["vanilla", "dms_eval"])
def test_make_prefill_step_last_logits(tiny_arch, tiny_params, mode,
                                       use_kernel):
    """The step's last-position logits, in the compute dtype (bf16) the
    engine serves in, within 5e-2 of their scale; and under
    ``inference_mode`` nothing is saved for a backward."""
    jarch, tarch, params = _setup(tiny_arch, tiny_params, "bfloat16")
    jl, jkv, tl, tkv = _prefill(jarch, tarch, tiny_params, params, mode,
                                use_kernel)
    assert tuple(tl.shape) == jl.shape == (B, jarch.padded_vocab)
    assert not tl.requires_grad and tl.is_inference()
    live = slice(0, jarch.vocab_size)
    scale = float(np.abs(np.asarray(jl)[:, live]).max())
    np.testing.assert_allclose(tl.numpy()[:, live], np.asarray(jl)[:, live],
                               atol=5e-2 * scale, rtol=0)


def test_prefill_import_unported_policies_raise(tiny_arch):
    """As in the reference, only vanilla and dms import a dense prefill."""
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    k = torch.zeros((1, tarch.attn.num_kv_heads, 4, tarch.attn.head_dim))
    for kind in ("window", "tova", "quest"):
        with pytest.raises(NotImplementedError, match="no prefill import"):
            tpolicy.get_policy(kind).prefill_import(
                tarch, KVPolicyConfig(kind=kind), k, k,
                torch.arange(4, dtype=torch.int32), None, None, max_len=8)
