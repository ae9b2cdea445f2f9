"""The hybrid slice of the port — recurrentgemma-2b (RG-LRU and local
attention) and mamba2-2.7b (SSD) — against the JAX reference on the same
numpy inputs and the same weights (the reference's seeded init copied
through numpy).

Tolerances: fp32 replicas (``dtype="float32"``) to rtol 1e-4 / atol 1e-5
(the two frameworks differ in the order of fp32 sums, in the scan's
products only where XLA fuses them, and in libm ulps); bf16 to 2e-2 (bf16
products rounded at other places); budget meters, lengths and integer
leaves must be equal; a train step's loss and gradient norm within 1e-5
relative.  The bf16 SSD step reads SiLU outputs that XLA's CPU ``logistic``
rounds apart from torch's (ROADMAP's bf16 caveat) and compounds them over
three convs and a gated norm, so it is held to 2% of its largest magnitude
(``_close_bf16``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import get_smoke as jget_smoke
from repro.core.config import KVPolicyConfig as JKV
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import rglru as jrglru
from repro.models import ssd as jssd
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs import get_arch, get_smoke
from repro_torch.core import policy as tpolicy
from repro_torch.core.config import KVPolicyConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.ssd import ops as tssd_ops
from repro_torch.kernels.ssd import ref as tssd_ref
from repro_torch.launch import steps as tsteps
from repro_torch.models import rglru as trglru
from repro_torch.models import ssd as tssd
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
NAMES = ("recurrentgemma-2b", "mamba2-2.7b")
_PAIRS = {}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _n(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        a.dtype.name == "bfloat16" else a


def _close_bf16(got, want, frac=2e-2, err_msg=""):
    """Every element within ``frac`` of the largest reference magnitude."""
    got, want = _n(got), _n(want)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (err_msg, err)


def _pair(name, dtype="float32"):
    """(reference arch, port arch, reference params, port params) of the
    smoke config in ``dtype``, drawn once per module."""
    if (name, dtype) not in _PAIRS:
        jarch = dataclasses.replace(jget_smoke(name), dtype=dtype)
        tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
        jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
        tparams = bridge.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu")
        _PAIRS[name, dtype] = (jarch, tarch, jparams, tparams)
    return _PAIRS[name, dtype]


def _layer(name, dtype, key):
    """One layer's params of the smoke model (superblock 0): the reference's
    numpy-backed leaves and the port's."""
    jarch, tarch, jparams, tparams = _pair(name, dtype)
    pi = str(jarch.layer_pattern.index("rglru" if key == "rglru" else "ssd"))
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"][pi][key])
    tp = {k: v[0] for k, v in tparams["blocks"][pi][key].items()}
    return jarch, tarch, jp, tp


def _assert_tree(t, j, tol=None, path=""):
    """A port state against the reference's, leaf for leaf by field name:
    integer and bool leaves equal, float leaves within ``tol`` (None:
    equal)."""
    if isinstance(t, torch.Tensor):
        want = _n(j)
        assert tuple(t.shape) == want.shape, path
        if tol is None or not t.is_floating_point():
            np.testing.assert_array_equal(_n(t), want, err_msg=path)
        else:
            np.testing.assert_allclose(_n(t), want, err_msg=path, **tol)
    elif isinstance(t, dict):
        assert sorted(t) == sorted(j), path
        for k in t:
            _assert_tree(t[k], j[k], tol, f"{path}.{k}")
    elif dataclasses.is_dataclass(t):
        assert type(t).__name__ == type(j).__name__, path
        for f in dataclasses.fields(t):
            val = getattr(t, f.name)
            if f.metadata.get("static"):
                assert val == getattr(j, f.name), path
            else:
                _assert_tree(val, getattr(j, f.name), tol,
                             f"{path}.{f.name}")
    else:
        assert t is None and j is None, path


# ---------------------------------------------------------------------------
# configs, init, support
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name):
    for jcfg, tcfg in ((jget_arch(name), get_arch(name)),
                       (jget_smoke(name), get_smoke(name))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert bridge.arch_from_dict(dataclasses.asdict(jcfg)) == tcfg
    ssm = get_arch(name).ssm
    if ssm is not None:
        assert (ssm.d_inner(2560), ssm.num_heads(2560)) == (5120, 80)
    ttfm.check_supported(get_arch(name))


def _shapes(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _shapes(v, path)
        else:
            yield path, (tuple(v.shape), str(np.asarray(v).dtype)
                         if not isinstance(v, torch.Tensor) else None)


@pytest.mark.parametrize("name", NAMES)
def test_init_model_layout_matches_reference(name):
    """The port's own init gives the reference's tree (the same leaves in
    the same shapes); its recurrent constants are the reference's, and the
    fp32 leaves stay fp32 in a bf16 model."""
    tarch = get_smoke(name)
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jget_smoke(name))
    tparams = ttfm.init_model(tarch, seed=0, device="cpu")
    want = {k: s for k, (s, _) in _shapes(jparams)}
    assert {k: s for k, (s, _) in _shapes(tparams)} == want
    assert tparams.layer_salt.shape == (tarch.num_layers,)
    pi = "0"
    if name == "mamba2-2.7b":
        for key in ("a_log", "d_skip", "dt_bias", "norm_scale"):
            got = tparams["blocks"][pi]["ssd"][key]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jparams["blocks"][pi]["ssd"][key]),
                rtol=1e-6)
    else:
        lam = tparams["blocks"][pi]["rglru"]["lam"]
        assert lam.dtype == torch.float32
        jlam = np.asarray(jparams["blocks"][pi]["rglru"]["lam"])
        assert jlam.min() > 4.0 and jlam.max() < 9.1       # the same law
        assert float(lam.min()) > 4.0 and float(lam.max()) < 9.1
        # a recurrent layer reads no salt
        assert ttfm.layer_salts(tparams).reshape(-1, 2)[:, 0].eq(0).all()


@pytest.mark.parametrize("name", NAMES)
def test_bridge_keeps_recurrent_vectors_fp32(name):
    _, _, jparams, tparams = _pair(name, "bfloat16")
    key = "rglru" if name == "recurrentgemma-2b" else "ssd"
    blk = tparams["blocks"]["0"][key]
    fp32 = {"lam", "b_gate_r", "b_gate_i", "a_log", "dt_bias", "d_skip",
            "norm_scale"}
    for leaf, val in blk.items():
        assert val.dtype == (torch.float32 if leaf in fp32
                             else torch.bfloat16), leaf
        if leaf in fp32:
            np.testing.assert_array_equal(
                val.numpy(), np.asarray(jparams["blocks"]["0"][key][leaf]))
    salts = tparams.layer_salt.reshape(-1, len(jget_smoke(name).layer_pattern))
    if name == "recurrentgemma-2b":
        wo = np.asarray(jparams["blocks"]["1"]["attn"]["wo"], np.float32)
        assert salts[:, 1].tolist() == [int(w) for w in
                                        wo[:, 0, 0].view(np.uint32)]
    assert salts[:, 0].eq(0).all()


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def test_softplus_has_no_threshold():
    """``jax.nn.softplus`` at the reference's init (−Λ in (−9, −4.3)) and
    above ``F.softplus``'s threshold of 20, where the two differ."""
    jarch, tarch, jp, tp = _layer("recurrentgemma-2b", "float32", "rglru")
    lam = np.asarray(jp["lam"])
    np.testing.assert_allclose(trglru.softplus(_t(-lam)).numpy(),
                               np.asarray(jax.nn.softplus(-lam)), rtol=1e-6)
    x = np.array([-30.0, -4.6, 0.0, 19.0, 20.5, 25.0], np.float32)
    np.testing.assert_allclose(trglru.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-7)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 37])
def test_associative_scan_is_the_recurrence(n):
    r = np.random.default_rng(n)
    a = r.uniform(0.5, 1.0, (2, n, 5)).astype(np.float32)
    b = r.normal(size=(2, n, 5)).astype(np.float32)
    _, h = trglru.associative_scan(trglru._combine, (_t(a), _t(b)), dim=1)
    _, hj = jax.lax.associative_scan(trglru_combine_jax, (a, b), axis=1)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=1e-6,
                               atol=1e-6)
    want = np.zeros((2, 5), np.float32)
    for i in range(n):
        want = a[:, i] * want + b[:, i]
    np.testing.assert_allclose(h[:, -1].numpy(), want, rtol=1e-5, atol=1e-6)


def trglru_combine_jax(c1, c2):
    return c1[0] * c2[0], c1[1] * c2[0] + c2[1]


def _rglru_state(r, b, w, k, dtype):
    return (r.normal(size=(b, w)).astype(np.float32),
            r.normal(size=(b, k - 1, w)).astype(np.float32),
            np.array([5, 9][:b], np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_forward_matches_reference(dtype, carried):
    jarch, tarch, jp, tp = _layer("recurrentgemma-2b", dtype, "rglru")
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 13, jarch.d_model)).astype(np.float32)
    js = ts = None
    if carried:
        h, conv, length = _rglru_state(r, 2, jarch.rglru.lru_width,
                                       jarch.rglru.conv_kernel, dtype)
        js = jrglru.RGLRUState(jnp.asarray(h), jnp.asarray(conv),
                               jnp.asarray(length))
        ts = trglru.RGLRUState(_t(h), _t(conv), torch.from_numpy(length))
    xd = jnp.dtype(dtype)
    yj, sj = jrglru.rglru_forward(jp, jnp.asarray(x).astype(xd), jarch, js)
    yt, st = trglru.rglru_forward(tp, _t(x, getattr(torch, dtype)), tarch, ts)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_n(yt), _n(yj), **tol)
    np.testing.assert_allclose(_n(st.h), _n(sj.h), **tol)
    np.testing.assert_array_equal(_n(st.conv), _n(sj.conv))
    np.testing.assert_array_equal(_n(st.length), _n(sj.length))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_decode_step_matches_reference(dtype, carried):
    """Eight steps from a zero or a random state: output and state each
    step."""
    jarch, tarch, jp, tp = _layer("recurrentgemma-2b", dtype, "rglru")
    r = np.random.default_rng(4)
    w, k = jarch.rglru.lru_width, jarch.rglru.conv_kernel
    if carried:
        h, conv, length = _rglru_state(r, 2, w, k, dtype)
    else:
        h, conv = np.zeros((2, w), np.float32), np.zeros((2, k - 1, w),
                                                          np.float32)
        length = np.zeros((2,), np.int32)
    js = jrglru.RGLRUState(jnp.asarray(h), jnp.asarray(conv),
                           jnp.asarray(length))
    ts = trglru.RGLRUState(_t(h), _t(conv), torch.from_numpy(length))
    tol = F32 if dtype == "float32" else BF16
    for i in range(8):
        x = r.normal(size=(2, 1, jarch.d_model)).astype(np.float32)
        yj, js = jrglru.rglru_decode_step(
            jp, jnp.asarray(x).astype(jnp.dtype(dtype)), js, jarch)
        yt, ts = trglru.rglru_decode_step(tp, _t(x, getattr(torch, dtype)),
                                          ts, tarch)
        np.testing.assert_allclose(_n(yt), _n(yj), err_msg=str(i), **tol)
        np.testing.assert_allclose(_n(ts.h), _n(js.h), err_msg=str(i), **tol)
        np.testing.assert_allclose(_n(ts.conv), _n(js.conv), **tol)
        np.testing.assert_array_equal(_n(ts.length), _n(js.length))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,init", [(45, False), (45, True), (64, False),
                                    (5, True)])
def test_ssd_chunked_ref_matches_reference(t, init):
    """T not a multiple of the chunk (45, 5 with chunk 16) and a multiple
    (64); with and without an initial state; the kernels/ op and ref
    re-export are the same function."""
    r = np.random.default_rng(t)
    b, h, p, g, n, q = 2, 4, 8, 2, 6, 16
    x = r.normal(size=(b, t, h, p)).astype(np.float32)
    dt = r.uniform(0.001, 0.2, (b, t, h)).astype(np.float32)
    a = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    bm = r.normal(size=(b, t, g, n)).astype(np.float32)
    cm = r.normal(size=(b, t, g, n)).astype(np.float32)
    s0 = r.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    yj, fj = jssd.ssd_chunked_ref(x, dt, a, bm, cm, q,
                                  init_state=None if s0 is None else s0)
    args = [_t(v) for v in (x, dt, a, bm, cm)]
    init_t = None if s0 is None else _t(s0)
    yt, ft = tssd.ssd_chunked_ref(*args, q, init_state=init_t)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **F32)
    yo, fo = tssd_ops.ssd_chunked(*args, chunk=q, init_state=init_t)
    assert torch.equal(yo, yt) and torch.equal(fo, ft)
    assert tssd_ref.ssd_chunked_ref is tssd.ssd_chunked_ref


def _ssd_state(r, b, arch):
    cfg = arch.ssm
    di, nh = cfg.d_inner(arch.d_model), cfg.num_heads(arch.d_model)
    gn, k1 = cfg.n_groups * cfg.d_state, cfg.conv_kernel - 1
    vals = (r.normal(size=(b, nh, cfg.head_dim, cfg.d_state)) * 0.3,
            r.normal(size=(b, k1, di)), r.normal(size=(b, k1, gn)),
            r.normal(size=(b, k1, gn)))
    vals = [v.astype(np.float32) for v in vals] + [np.array([3, 7][:b],
                                                            np.int32)]
    return (jssd.SSDState(*(jnp.asarray(v) for v in vals)),
            tssd.SSDState(*(torch.from_numpy(v) for v in vals)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_forward_matches_reference(dtype, carried):
    """T = 45 over the smoke chunk of 32.  The reference's ``use_kernel``
    routes to the same ``ssd_chunked_ref``; its default is held here."""
    jarch, tarch, jp, tp = _layer("mamba2-2.7b", dtype, "ssd")
    r = np.random.default_rng(6)
    x = r.normal(size=(2, 45, jarch.d_model)).astype(np.float32)
    js, ts = _ssd_state(r, 2, jarch) if carried else (None, None)
    yj, sj = jssd.ssd_forward(jp, jnp.asarray(x).astype(jnp.dtype(dtype)),
                              jarch, js)
    yt, st = tssd.ssd_forward(tp, _t(x, getattr(torch, dtype)), tarch, ts)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_n(yt), _n(yj), **tol)
    # a fresh forward's length is the reference's scalar T, per lane here
    np.testing.assert_array_equal(
        st.length.numpy(), np.broadcast_to(np.asarray(sj.length), (2,)))
    _assert_tree(dataclasses.replace(st, length=None),
                 dataclasses.replace(sj, length=None), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step_matches_reference(dtype):
    jarch, tarch, jp, tp = _layer("mamba2-2.7b", dtype, "ssd")
    r = np.random.default_rng(7)
    js, ts = _ssd_state(r, 2, jarch)
    for i in range(6):
        x = r.normal(size=(2, 1, jarch.d_model)).astype(np.float32)
        yj, js = jssd.ssd_decode_step(
            jp, jnp.asarray(x).astype(jnp.dtype(dtype)), js, jarch)
        yt, ts = tssd.ssd_decode_step(tp, _t(x, getattr(torch, dtype)), ts,
                                      tarch)
        if dtype == "float32":
            np.testing.assert_allclose(_n(yt), _n(yj), err_msg=str(i), **F32)
            _assert_tree(ts, js, F32, f"step {i}")
            continue
        _close_bf16(yt, yj, err_msg=str(i))
        for name in ("ssm", "conv_x", "conv_b", "conv_c"):
            _close_bf16(getattr(ts, name), getattr(js, name),
                        err_msg=f"{name} {i}")
        np.testing.assert_array_equal(_n(ts.length), _n(js.length))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_model_forward_matches_reference(name, dtype):
    """T = 45: past the smoke window (16) and not a multiple of the SSD
    chunk (32)."""
    jarch, tarch, jparams, tparams = _pair(name, dtype)
    tokens = np.random.default_rng(8).integers(
        0, jarch.vocab_size, size=(2, 45)).astype(np.int32)
    lj, aj = jtfm.model_forward(jparams, jnp.asarray(tokens), jarch,
                                collect_kv=True)
    lt, at = ttfm.model_forward(tparams, torch.from_numpy(tokens), tarch,
                                collect_kv=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                               **(F32 if dtype == "float32" else BF16))
    assert at["layer_kv"].keys() == aj["layer_kv"].keys()
    for pi, kv in at["layer_kv"].items():
        assert kv.keys() == aj["layer_kv"][pi].keys()


def _decode_run(name, cfg_kw, steps=14, lanes=3, max_len=24, seed=0):
    """Both decode steps on one seeded token/active stream with per-lane
    positions (fp32); per-step logits and meters, and the final states."""
    jarch, tarch, jparams, tparams = _pair(name)
    js = jtfm.init_decode_state(jarch, lanes, max_len, JKV(**cfg_kw))
    ts = ttfm.init_decode_state(tarch, lanes, max_len,
                                KVPolicyConfig(**cfg_kw), device="cpu")
    jstep = jax.jit(lambda p, tok, s, pos, act: jtfm.decode_step(
        p, tok, s, jarch, pos, use_kernel=False, active=act))
    r = np.random.default_rng(seed)
    pos = np.zeros((lanes,), np.int32)
    out = []
    for i in range(steps):
        tok = r.integers(3, jarch.vocab_size, size=(lanes, 1)).astype(np.int32)
        act = r.random(lanes) < 0.7
        act[i % lanes] = True
        lj, js, aj = jstep(jparams, jnp.asarray(tok), js, jnp.asarray(pos),
                           jnp.asarray(act))
        lt, ts, at = ttfm.decode_step(tparams, torch.from_numpy(tok), ts, tarch,
                                      torch.from_numpy(pos), use_kernel=True,
                                      active=torch.from_numpy(act))
        out.append((act, lt.numpy(), np.asarray(lj), at, aj))
        pos = pos + act
    return out, ts, js


DECODE_CASES = [("recurrentgemma-2b", dict(kind="dms", cr=2.0, window=4)),
                ("recurrentgemma-2b", dict(kind="window", budget=6)),
                ("recurrentgemma-2b", dict(kind="vanilla")),
                ("mamba2-2.7b", dict(kind="vanilla"))]


@pytest.mark.parametrize("name,cfg_kw", DECODE_CASES,
                         ids=[f"{n}-{c['kind']}" for n, c in DECODE_CASES])
def test_decode_step_matches_reference(name, cfg_kw):
    """fp32 logits per step (active lanes), both meters equal, and the
    whole state leaf for leaf after 14 steps (an inactive lane's h, conv
    history and length untouched); ``attn_impl_kernel`` is 1 only with an
    attention layer."""
    run, ts, js = _decode_run(name, cfg_kw)
    for i, (act, lt, lj, at, aj) in enumerate(run):
        np.testing.assert_allclose(lt[act], lj[act], err_msg=f"step {i}",
                                   **F32)
        for key in ("live_tokens", "reads_tokens"):
            np.testing.assert_array_equal(at[key].numpy(), np.asarray(aj[key]),
                                          err_msg=f"{key} step {i}")
        assert at["attn_impl_kernel"] == int(name == "recurrentgemma-2b")
    _assert_tree(ts, js, F32)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_full_forward(name):
    """The reference's ``test_decode_matches_full_forward`` on the port:
    teacher-forced vanilla decode against the full forward (bf16, the
    reference test's tolerance of 0.12)."""
    arch = get_smoke(name)
    params = ttfm.init_model(arch, seed=0, device="cpu")
    b, t = 2, 12
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, arch.vocab_size, size=(b, t)).astype(np.int32))
    full, _ = ttfm.model_forward(params, tokens, arch)
    state = ttfm.init_decode_state(arch, b, t, KVPolicyConfig(kind="vanilla"),
                                   device="cpu")
    outs = []
    for i in range(t):
        lg, state, _ = ttfm.decode_step(params, tokens[:, i:i + 1], state,
                                        arch, i)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=0.12, atol=0.12)


# ---------------------------------------------------------------------------
# lane hooks and state helpers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=NAMES)
def hybrid_states(request):
    """A decoded 3-lane state of each arch (six steps, lanes at different
    positions) on both sides, fp32, plus fresh states."""
    name = request.param
    kw = (dict(kind="dms", cr=2.0, window=4) if name == "recurrentgemma-2b"
          else dict(kind="vanilla"))
    run, ts, js = _decode_run(name, kw, steps=6)
    jarch, tarch, _, _ = _pair(name)
    fresh_j = jtfm.init_decode_state(jarch, 3, 24, JKV(**kw))
    fresh_t = ttfm.init_decode_state(tarch, 3, 24, KVPolicyConfig(**kw),
                                     device="cpu")
    _assert_tree(ts, js, F32)
    return name, ts, js, fresh_t, fresh_j


HOOKS = ("fork", "gather", "reclaim", "export", "import", "slab", "select")


@pytest.mark.parametrize("hook", HOOKS)
def test_lane_hooks_match_reference(hybrid_states, hook):
    """Every lane hook on a hybrid state (raw recurrent states beside a
    policy cache), leaf for leaf against the reference's hook."""
    name, ts, js, fresh_t, fresh_j = hybrid_states
    if hook == "fork":
        got, want = ttfm.fork_decode_state(ts, 2), jtfm.fork_decode_state(js, 2)
    elif hook == "gather":
        src = np.array([2, 2, 0], np.int32)
        got = ttfm.gather_lanes(ts, torch.from_numpy(src))
        want = jtfm.gather_lanes(js, jnp.asarray(src))
    elif hook == "reclaim":
        m = np.array([False, True, False])
        got = ttfm.reclaim_lanes(ts, torch.from_numpy(m), fresh_t)
        want = jtfm.reclaim_lanes(js, jnp.asarray(m), fresh_j)
    elif hook == "export":
        got, want = ttfm.export_lane_state(ts, 1), jtfm.export_lane_state(js, 1)
    elif hook == "import":
        snap_t, snap_j = ttfm.export_lane_state(ts, 2), \
            jtfm.export_lane_state(js, 2)
        got = ttfm.import_lane_state(fresh_t, snap_t, 0)
        want = jtfm.import_lane_state(fresh_j, snap_j, 0)
    elif hook == "slab":
        snap_t, snap_j = ttfm.export_lane_state(ts, 1), \
            jtfm.export_lane_state(js, 1)
        slab_t = ttfm.init_snapshot_slab(snap_t, 3)
        slab_j = jtfm.init_snapshot_slab(snap_j, 3)
        _assert_tree(slab_t, slab_j)
        slab_t = ttfm.store_lane_snapshot(slab_t, snap_t, 2)
        slab_j = jtfm.store_lane_snapshot(slab_j, snap_j, 2)
        _assert_tree(slab_t, slab_j, F32)
        got = ttfm.fetch_lane_snapshot(slab_t, 2)
        want = jtfm.fetch_lane_snapshot(slab_j, 2)
        _assert_tree(got, snap_t)
    else:
        m = np.array([True, False, True])
        got = ttfm.lane_select(torch.from_numpy(m), ts, fresh_t)
        want = jtfm.lane_select(jnp.asarray(m), js, fresh_j)
    _assert_tree(got, want, F32)
    if hook == "export":
        # one lane's snapshot shapes, as the reference's signature has them
        sig_t = ttfm.lane_state_signature(ts)
        assert [s for s, _ in sig_t[1]] == [
            tuple(s) for s, _ in jtfm.lane_state_signature(js)[1]]
        assert sig_t == ttfm.lane_state_signature(fresh_t)
        assert [tuple(a.shape) for a in tree_leaves(got)] == [
            s for s, _ in sig_t[1]]


def test_state_helpers_skip_recurrent_states():
    """mamba2's state holds no policy cache: peak bytes 0, no pool stats,
    nothing pooled; recurrentgemma's counts its attention caches only."""
    for name, kw in (("mamba2-2.7b", dict(kind="vanilla", paged=True,
                                          block_p=8)),
                     ("recurrentgemma-2b", dict(kind="dms", paged=True,
                                                block_p=8))):
        jarch, tarch, _, _ = _pair(name)
        js = jtfm.init_decode_state(jarch, 2, 24, JKV(**kw))
        ts = ttfm.init_decode_state(tarch, 2, 24, KVPolicyConfig(**kw),
                                    device="cpu")
        assert tpolicy.state_peak_bytes(ts) == \
            jtfm.policy_lib.state_peak_bytes(js)
        n_pc = len(list(tpolicy.iter_policy_caches(ts)))
        assert n_pc == len(list(jtfm.policy_lib.iter_policy_caches(js)))
        seen = []
        tpolicy.map_pooled_caches(ts, lambda i, c: seen.append(i) or c)
        assert len(seen) == n_pc
        if name == "mamba2-2.7b":
            assert n_pc == 0 and tpolicy.state_peak_bytes(ts) == 0
            assert tpolicy.state_pool_stats(ts) is None
        else:
            assert tpolicy.state_pool_stats(ts)["pools"] == 1


def test_state_from_prefill_refuses_recurrent_layers():
    """The reference has no path from a prefill to a recurrent state: the
    port raises by name and builds no zero state."""
    jarch, tarch, _, tparams = _pair("recurrentgemma-2b")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, tarch.vocab_size, size=(1, 10)).astype(np.int32))
    _, layer_kv = tsteps.make_prefill_step(tarch)(tparams, {"tokens": tokens})
    assert layer_kv["0"] == {} and "k_rope" in layer_kv["1"]
    with pytest.raises(NotImplementedError, match="'rglru' layer"):
        ttfm.state_from_prefill(tarch, KVPolicyConfig(kind="vanilla"),
                                layer_kv, 16)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name):
    """One fp32 LM train step on the reference attention path: loss and
    gradient norm within 1e-5 relative, the first moment within 1e-4 of
    its largest magnitude."""
    jarch, tarch, jparams, _ = _pair(name)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu",
        dtype=torch.float32)
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    cfg = jpipe.DataConfig(vocab_size=jarch.vocab_size, seq_len=20,
                           global_batch=2, seed=1)
    batch = jpipe.make_batch(cfg, 2)
    jstep = jsteps.make_train_step(jarch, jadamw.AdamWConfig(**opt_kw),
                                   remat=False)
    _, js2, jm = jax.jit(jstep)(jparams, jadamw.init(jparams), batch,
                                jnp.int32(2))
    tstep = tsteps.make_train_step(tarch, tadamw.AdamWConfig(**opt_kw),
                                   remat=True)
    _, ts2, tm = tstep(tparams, tadamw.init(tparams),
                       {k: torch.from_numpy(np.asarray(v))
                        for k, v in batch.items()}, 2)
    for key in ("loss", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
    flat_t = dict(_flat(ts2.mu))
    for path, want in _flat(js2.mu):
        err = np.abs(flat_t[path].numpy() - np.asarray(want)).max()
        assert err <= 1e-4 * np.abs(np.asarray(want)).max() + 1e-12, path


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}"
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v
