"""The encoder–decoder slice of the port — seamless-m4t-large-v2: LayerNorm,
a bidirectional encoder over precomputed frame embeddings, and
cross-attention over its output in every decoder layer — against the JAX
reference on the same numpy inputs and the same weights (the reference's
seeded init copied through numpy).

Tolerances: fp32 replicas (``dtype="float32"``) to rtol 1e-4 / atol 1e-5
(the two frameworks differ only in the order of fp32 sums and in libm
ulps); bf16 to 2e-2 (bf16 products rounded at other places), the whole
model's bf16 outputs to 2e-2 of their largest magnitude; budget
meters, lengths and integer leaves must be equal; the train, retrofit and
prefill steps' loss and gradient norm within 1e-5 relative; greedy tokens
and the ``Engine``'s meters equal.  Where the reference reaches a Pallas
kernel (``use_kernel=True``) it runs in interpret mode; the port's
wrappers run their kernels' plain versions on the CPU.
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
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import get_arch, get_smoke
from repro_torch.core.config import KVPolicyConfig
from repro_torch.core.tree import tree_map
from repro_torch.kernels.dms_attention import ops as fkops
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
NAME = "seamless-m4t-large-v2"
B, S_ENC, T_TEXT = 2, 10, 12        # S_ENC off every block size
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
_PAIRS = {}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _n(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close_bf16(got, want, frac=2e-2, err_msg=""):
    """Every element within ``frac`` of the largest reference magnitude:
    XLA's bf16 GELU rounds apart from torch's in some elements, and 2e-2
    elementwise does not hold where such an element feeds a small one."""
    got, want = _n(got), _n(want)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (err_msg, err)


def _pair(dtype="float32", bias=None):
    """(reference arch, port arch, reference params, port params) of the
    smoke config in ``dtype`` (port matmul weights in ``dtype`` too), drawn
    once per module; ``bias`` sets the DMS logit bias."""
    if (dtype, bias) not in _PAIRS:
        jarch = dataclasses.replace(jget_smoke(NAME), dtype=dtype)
        if bias is not None:
            jarch = dataclasses.replace(jarch, dms=dataclasses.replace(
                jarch.dms, logit_bias=bias))
        tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
        jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
        tparams = bridge.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu")
        _PAIRS[dtype, bias] = (jarch, tarch, jparams, tparams)
    return _PAIRS[dtype, bias]


def _enc(d, seed=3, b=B, s=S_ENC):
    """Frame embeddings (B, S, D) ~ N(0, 1) · 0.02, as the reference's
    encoder–decoder test draws them."""
    return (np.random.default_rng(seed).normal(size=(b, s, d)) * 0.02
            ).astype(np.float32)


def _tokens(arch, seed=1, b=B, t=T_TEXT):
    return np.random.default_rng(seed).integers(
        3, arch.vocab_size, size=(b, t)).astype(np.int32)


def _assert_tree(t, j, tol=None, path=""):
    """A port state against the reference's, leaf for leaf by field name:
    integer and bool leaves equal, float leaves within ``tol``."""
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
                _assert_tree(val, getattr(j, f.name), tol, f"{path}.{f.name}")
    else:
        assert t is None and j is None, path


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


# ---------------------------------------------------------------------------
# config, LayerNorm, init
# ---------------------------------------------------------------------------


def test_config_equals_reference():
    for jcfg, tcfg in ((jget_arch(NAME), get_arch(NAME)),
                       (jget_smoke(NAME), get_smoke(NAME))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert bridge.arch_from_dict(dataclasses.asdict(jcfg)) == tcfg
    ttfm.check_supported(get_arch(NAME))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """fp32 statistics with the population variance (``jnp.var``), the
    result cast back to x's dtype; rows far from zero mean."""
    r = np.random.default_rng(0)
    x = (r.normal(size=(3, 5, 64)) * 3.0 + 1.5).astype(np.float32)
    p = {"scale": r.normal(size=(64,)).astype(np.float32),
         "bias": r.normal(size=(64,)).astype(np.float32)}
    y_j = jlayers.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x, dtype), "layernorm", 1e-6)
    tdt = getattr(torch, dtype)
    y_t = tlayers.norm_apply({k: _t(v) for k, v in p.items()}, _t(x, tdt),
                             "layernorm", 1e-6)
    assert y_t.dtype == tdt
    np.testing.assert_allclose(_n(y_t), _n(y_j),
                               **(F32 if dtype == "float32" else BF16))


def test_init_model_leaves_match_reference():
    """The port's own init draws the reference's tree: encoder blocks over
    ``encoder_layers`` superblocks with no cross weights, ``cross_norm``
    and ``cross`` in every decoder block, LayerNorm biases (zeros, fp32,
    as the scales), and one salt a decoder layer.  The bridge keeps norm
    scales and biases fp32 and casts the matmul weights."""
    jarch = jget_smoke(NAME)
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
    tparams = ttfm.init_model(get_smoke(NAME), seed=0, device="cpu")
    want = {k: tuple(v.shape) for k, v in _leaves(jparams)}
    assert {k: tuple(v.shape) for k, v in _leaves(tparams)} == want
    assert "cross" not in tparams["enc_blocks"]["0"]
    assert tparams["enc_blocks"]["0"]["attn"]["wq"].shape[0] == \
        jarch.encoder_layers
    assert tparams.layer_salt.shape == (jarch.num_layers,)
    _, _, _, bridged = _pair("bfloat16")
    for path, leaf in _leaves(bridged):
        norm = path.endswith((".scale", ".bias"))
        assert leaf.dtype == (torch.float32 if norm else torch.bfloat16), path
        if path.endswith(".bias"):
            assert not leaf.any(), path


# ---------------------------------------------------------------------------
# attention, encoder, forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype, use_kernel):
    """The bidirectional encoder over 10 frames (off every block): the
    masked-softmax path and the flash path (``causal=False``; the
    reference's Pallas kernel in interpret mode, the port's plain
    version)."""
    jarch, tarch, jparams, tparams = _pair(dtype)
    enc = _enc(jarch.d_model)
    out_j = jtfm.encode(jparams, jnp.asarray(enc), jarch, use_kernel=use_kernel)
    out_t = ttfm.encode(tparams, _t(enc), tarch, use_kernel=use_kernel)
    assert out_t.shape == (B, S_ENC, jarch.d_model)
    np.testing.assert_allclose(_n(out_t), _n(out_j),
                               **(F32 if dtype == "float32" else BF16))


def test_encoder_is_bidirectional():
    """A change to the last frame moves the encoder output of the first
    (it would not under a causal mask); the flash path agrees."""
    _, tarch, _, tparams = _pair()
    enc = _t(_enc(tarch.d_model))
    moved = enc.clone()
    moved[:, -1] = torch.randn(moved[:, -1].shape,
                               generator=torch.Generator().manual_seed(0))
    for use_kernel in (False, True):
        a = ttfm.encode(tparams, enc, tarch, use_kernel=use_kernel)
        b = ttfm.encode(tparams, moved, tarch, use_kernel=use_kernel)
        assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


def test_full_attention_kv_override_matches_reference(monkeypatch):
    """Cross-attention over given K/V (no RoPE on them, no mask): equal to
    the reference's; with ``use_kernel`` it still takes the masked-softmax
    path and never calls the flash wrapper, as the reference's kernel
    branch requires no override."""
    jarch, tarch, jparams, tparams = _pair()
    a = jarch.attn
    cfg_j = dataclasses.replace(a, causal=False, rope="none")
    cfg_t = dataclasses.replace(tarch.attn, causal=False, rope="none")
    r = np.random.default_rng(4)
    x = r.normal(size=(B, T_TEXT, jarch.d_model)).astype(np.float32)
    ek, ev = (r.normal(size=(B, S_ENC, a.num_kv_heads, a.head_dim))
              .astype(np.float32) for _ in range(2))
    pj = jax.tree_util.tree_map(lambda v: v[0], jparams["blocks"]["0"]["cross"])
    pt = {k: v[0] for k, v in tparams["blocks"]["0"]["cross"].items()}
    y_j, _ = jattn.full_attention(pj, jnp.asarray(x), cfg_j, jarch,
                                  kv_override=(jnp.asarray(ek),
                                               jnp.asarray(ev)))

    def refuse(*args, **kw):
        raise AssertionError("the flash wrapper was called for cross-attention")

    monkeypatch.setattr(fkops, "dms_flash_attention", refuse)
    for use_kernel in (False, True):
        y_t, _ = tattn.full_attention(pt, _t(x), cfg_t, tarch,
                                      use_kernel=use_kernel,
                                      kv_override=(_t(ek), _t(ev)))
        np.testing.assert_allclose(y_t.numpy(), _n(y_j), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_matches_reference(dtype):
    """Logits and ``aux["enc_out"]`` with encoder inputs (bf16: within 2e-2
    of the largest magnitude, ``_close_bf16``); without them the decoder
    runs alone (no cross-attention) and the logits move."""
    jarch, tarch, jparams, tparams = _pair(dtype)
    enc, tok = _enc(jarch.d_model), _tokens(jarch)
    lj, aj = jtfm.model_forward(jparams, jnp.asarray(tok), jarch,
                                enc_embeds=jnp.asarray(enc))
    lt, at = ttfm.model_forward(tparams, torch.from_numpy(tok), tarch,
                                enc_embeds=_t(enc))
    for got, want in ((lt, lj), (at["enc_out"], aj["enc_out"])):
        if dtype == "float32":
            np.testing.assert_allclose(_n(got), _n(want), **F32)
        else:
            _close_bf16(got, want)
    bare, aux = ttfm.model_forward(tparams, torch.from_numpy(tok), tarch)
    assert "enc_out" not in aux
    assert float((bare - lt).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _valid(tail):
    """(B, S_ENC) bool: lane 1 hides its last ``tail`` frames; None when
    ``tail`` is 0 (every frame visible)."""
    if not tail:
        return None
    v = np.ones((B, S_ENC), bool)
    v[1, S_ENC - tail:] = False
    return v


@pytest.mark.parametrize("tail", [0, 4], ids=["all-frames", "tail-hidden"])
def test_decode_step_matches_reference(tail):
    """14 steps with ``enc_out`` (the reference's encoder output),
    per-lane positions and an active mask, dms at CR 2 (delay 4): fp32
    logits of active lanes per step, both meters equal (cross-attention
    adds nothing to them), the whole state leaf for leaf after the last
    step; the port's cross-attention through the decode wrapper's dense
    mode (plain version), ``attn_impl_kernel`` 1."""
    jarch, tarch, jparams, tparams = _pair()
    cfg_kw = dict(kind="dms", cr=2.0, window=4)
    lanes, max_len, steps = B, 24, 14
    enc_out = jtfm.encode(jparams, jnp.asarray(_enc(jarch.d_model)), jarch)
    valid = _valid(tail)
    js = jtfm.init_decode_state(jarch, lanes, max_len, JKV(**cfg_kw))
    ts = ttfm.init_decode_state(tarch, lanes, max_len,
                                KVPolicyConfig(**cfg_kw), device="cpu")
    jstep = jax.jit(lambda p, tok, s, pos, act, e, v: jtfm.decode_step(
        p, tok, s, jarch, pos, enc_out=e, enc_valid=v, active=act))
    kw_t = dict(enc_out=_t(enc_out),
                enc_valid=None if valid is None else torch.from_numpy(valid))
    r = np.random.default_rng(0)
    pos = np.zeros((lanes,), np.int32)
    for i in range(steps):
        tok = r.integers(3, jarch.vocab_size, size=(lanes, 1)).astype(np.int32)
        act = r.random(lanes) < 0.7
        act[i % lanes] = True
        lj, js, aj = jstep(jparams, jnp.asarray(tok), js, jnp.asarray(pos),
                           jnp.asarray(act), enc_out,
                           None if valid is None else jnp.asarray(valid))
        lt, ts, at = ttfm.decode_step(
            tparams, torch.from_numpy(tok), ts, tarch, torch.from_numpy(pos),
            use_kernel=True, active=torch.from_numpy(act), **kw_t)
        np.testing.assert_allclose(lt.numpy()[act], _n(lj)[act],
                                   err_msg=f"step {i}", **F32)
        for key in ("live_tokens", "reads_tokens"):
            np.testing.assert_array_equal(at[key].numpy(), _n(aj[key]),
                                          err_msg=f"{key} step {i}")
        assert at["attn_impl_kernel"] == 1
        pos = pos + act
    _assert_tree(ts, js, F32)


def test_hidden_tail_changes_only_its_lane():
    """``enc_valid`` hiding lane 1's tail moves lane 1's logits and leaves
    lane 0's bit-equal."""
    _, tarch, _, tparams = _pair()
    enc_out = ttfm.encode(tparams, _t(_enc(tarch.d_model)), tarch)
    tok = torch.from_numpy(_tokens(tarch)[:, :1])
    out = []
    for valid in (None, torch.from_numpy(_valid(4))):
        st = ttfm.init_decode_state(tarch, B, 8, KVPolicyConfig(kind="vanilla"),
                                    device="cpu")
        lg, _, _ = ttfm.decode_step(tparams, tok, st, tarch, 0, enc_out=enc_out,
                                    enc_valid=valid, use_kernel=True)
        out.append(lg)
    assert torch.equal(out[0][0], out[1][0])
    assert float((out[0][1] - out[1][1]).abs().max()) > 1e-4


def test_embed_override_matches_reference():
    """``embed_override`` replaces the token's embedding in the decode
    step: the reference's logits on the same override, and the token's own
    embedding gives the token's logits bit for bit."""
    jarch, tarch, jparams, tparams = _pair()
    enc_out = jtfm.encode(jparams, jnp.asarray(_enc(jarch.d_model)), jarch)
    tok = _tokens(jarch)[:, :1]
    emb = np.random.default_rng(5).normal(
        size=(B, 1, jarch.d_model)).astype(np.float32)
    js = jtfm.init_decode_state(jarch, B, 8, JKV(kind="vanilla"))
    lj, _, _ = jtfm.decode_step(jparams, jnp.asarray(tok), js, jarch, 0,
                                enc_out=enc_out, embed_override=jnp.asarray(emb))
    out = []
    for override in (_t(emb), ttfm.embed_tokens(tparams, torch.from_numpy(tok),
                                                tarch), None):
        ts = ttfm.init_decode_state(tarch, B, 8, KVPolicyConfig(kind="vanilla"),
                                    device="cpu")
        lt, _, _ = ttfm.decode_step(tparams, torch.from_numpy(tok), ts, tarch,
                                    0, enc_out=_t(enc_out),
                                    embed_override=override)
        out.append(lt)
    np.testing.assert_allclose(out[0].numpy(), _n(lj), **F32)
    assert torch.equal(out[1], out[2])


def test_decode_matches_full_forward():
    """The reference's ``test_decode_matches_full_forward`` on the port:
    teacher-forced vanilla decode with the encoder output against the full
    forward with the frames (bf16, the port's own init, the reference
    test's tolerance of 0.12)."""
    arch = get_smoke(NAME)
    params = ttfm.init_model(arch, seed=0, device="cpu")
    enc = _t(_enc(arch.d_model, s=8))
    tokens = torch.from_numpy(_tokens(arch))
    full, aux = ttfm.model_forward(params, tokens, arch, enc_embeds=enc)
    state = ttfm.init_decode_state(arch, B, T_TEXT,
                                   KVPolicyConfig(kind="vanilla"), device="cpu")
    outs = []
    for i in range(T_TEXT):
        lg, state, _ = ttfm.decode_step(params, tokens[:, i:i + 1], state,
                                        arch, i, enc_out=aux["enc_out"])
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=0.12, atol=0.12)


def test_serve_step_matches_reference():
    """``make_serve_step`` with ``enc_out``: logits and both meters per
    step against the reference's, teacher-forced on fixed arenas (dms,
    CR 2) and vanilla; its meters are the decode step's."""
    jarch, tarch, jparams, tparams = _pair()
    enc_out = jtfm.encode(jparams, jnp.asarray(_enc(jarch.d_model)), jarch)
    tok = _tokens(jarch)
    for cfg_kw in (dict(kind="dms", cr=2.0, window=4), dict(kind="vanilla")):
        js = jtfm.init_decode_state(jarch, B, T_TEXT, JKV(**cfg_kw))
        ts = ttfm.init_decode_state(tarch, B, T_TEXT, KVPolicyConfig(**cfg_kw),
                                    device="cpu")
        jstep = jax.jit(jsteps.make_serve_step(jarch))
        tstep = tsteps.make_serve_step(tarch, use_kernel=True)
        for i in range(T_TEXT):
            lj, js, mj = jstep(jparams, js, {
                "token": jnp.asarray(tok[:, i:i + 1]), "pos": jnp.int32(i),
                "enc_out": enc_out})
            lt, ts, mt = tstep(tparams, ts, {
                "token": torch.from_numpy(tok[:, i:i + 1]), "pos": i,
                "enc_out": _t(enc_out)})
            np.testing.assert_allclose(lt.numpy(), _n(lj), err_msg=str(i),
                                       **F32)
            assert sorted(mt) == sorted(mj) == ["live_tokens", "reads_tokens"]
            for key in mj:
                np.testing.assert_array_equal(mt[key].numpy(), _n(mj[key]))


# ---------------------------------------------------------------------------
# launch steps
# ---------------------------------------------------------------------------


def _batch(arch, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, arch.vocab_size, (B, T_TEXT)).astype(np.int32),
            "labels": r.integers(0, arch.vocab_size, (B, T_TEXT)).astype(np.int32),
            "enc_embeds": (r.normal(size=(B, S_ENC, arch.d_model)) * 0.02
                           ).astype(np.float32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _fp32_pair(bias=None):
    jarch, tarch, jparams, _ = _pair(bias=bias)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu",
        dtype=torch.float32)
    return jarch, tarch, jparams, tparams


def test_train_step_matches_reference():
    """One LM train step with the frames in the batch: loss, CE and
    gradient norm within 1e-5 relative (the encoder's weights get
    gradients too); the port's step remats."""
    jarch, tarch, jparams, tparams = _fp32_pair()
    jb, tb = _both(_batch(jarch, seed=1))
    jstep = jax.jit(jsteps.make_train_step(jarch, jadamw.AdamWConfig(**OPT),
                                           remat=False))
    jp2, _, jm = jstep(jparams, jadamw.init(jparams), jb, jnp.int32(2))
    tstep = tsteps.make_train_step(tarch, tadamw.AdamWConfig(**OPT))
    enc_wq = tparams["enc_blocks"]["0"]["attn"]["wq"].clone()
    tp2, _, tm = tstep(tparams, tadamw.init(tparams), tb, 2)
    for key in ("loss", "ce", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
    assert not torch.equal(tp2["enc_blocks"]["0"]["attn"]["wq"], enc_wq)
    np.testing.assert_allclose(
        tp2["enc_blocks"]["0"]["attn"]["wq"].numpy(),
        np.asarray(jp2["enc_blocks"]["0"]["attn"]["wq"]), rtol=1e-4, atol=1e-6)


def _layer_uniforms(step, arch, b, t):
    """The reference's per-layer Gumbel uniforms of a retrofit step (the
    decoder's layers; the encoder runs vanilla)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(23), step)
    keys = jax.random.split(rng, arch.num_layers)
    return [torch.from_numpy(np.array(jax.random.uniform(
        keys[i], (b, arch.attn.num_kv_heads, t), minval=1e-6,
        maxval=1 - 1e-6))) for i in range(arch.num_layers)]


@pytest.mark.parametrize("phase1,step", [(True, 1000), (False, 3)],
                         ids=["phase1", "distill"])
def test_retrofit_step_matches_reference(phase1, step):
    """Teacher and student both encode the frames: every metric of one
    retrofit step (phase 1 and the distillation phase, DMS bias 0) within
    1e-5 relative of the reference's."""
    jarch, tarch, jparams, tparams = _fp32_pair(bias=0.0)
    jb, tb = _both(_batch(jarch, seed=2))
    jstep = jsteps.make_retrofit_step(jarch, jadamw.AdamWConfig(**OPT),
                                      remat=False, phase1=phase1)
    _, _, jm = jax.jit(jstep)(jparams, jparams, jadamw.init(jparams), jb,
                              jnp.int32(step))
    teacher = tree_map(lambda a: a.clone(), tparams)
    tstep = tsteps.make_retrofit_step(tarch, tadamw.AdamWConfig(**OPT),
                                      remat=False, phase1=phase1)
    uniforms = None if phase1 else _layer_uniforms(step, jarch, B, T_TEXT)
    _, _, tm = tstep(tparams, teacher, tadamw.init(tparams), tb, step,
                     uniforms=uniforms)
    assert sorted(tm) == sorted(jm)
    for key in jm:
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                               abs=1e-6), key


@pytest.mark.parametrize("dms", [False, True], ids=["vanilla", "dms_eval"])
def test_prefill_step_matches_reference(dms):
    """Last logits within 1e-5 relative and every decoder layer's KV (and
    retained map) equal to the reference's with the frames; without them
    the logits move."""
    jarch, tarch, jparams, tparams = _fp32_pair(bias=0.0)
    jb, tb = _both(_batch(jarch, seed=3))
    jl, jkv = jsteps.make_prefill_step(jarch, dms=dms)(jparams, jb)
    tl, tkv = tsteps.make_prefill_step(tarch, dms=dms)(tparams, tb)
    scale = float(np.abs(np.asarray(jl)).max())
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= 1e-5 * scale
    assert tkv.keys() == jkv.keys()
    for pi, kv in tkv.items():
        assert kv.keys() == jkv[pi].keys()
        for key, val in kv.items():
            np.testing.assert_allclose(_n(val), _n(jkv[pi][key]),
                                       err_msg=key, **F32)
    bare, _ = tsteps.make_prefill_step(tarch, dms=dms)(
        tparams, {"tokens": tb["tokens"]})
    assert float((bare - tl).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_engine_matches_reference(paged):
    """The ``Engine`` serves the decoder alone (no encoder output), as the
    reference's does: four staggered prompts on two lanes, dms at CR 2,
    bf16; greedy tokens, ``kv_reads`` and ``peak_tokens`` equal to the JAX
    ``Engine``'s (``use_kernel=True``, Pallas interpret mode)."""
    jarch, tarch, jparams, tparams = _pair("bfloat16")
    kw = dict(kind="dms", cr=2.0, window=jarch.dms.window, paged=paged,
              block_p=8)
    jeng = JEngine(jarch, jparams, JKV(**kw), use_kernel=True, chunk=8)
    teng = Engine(tarch, tparams, KVPolicyConfig(**kw), use_kernel=True,
                  chunk=8, device="cpu")
    prompts = [np.random.default_rng(13 + n).integers(
        3, jarch.vocab_size, size=(n,)).astype(np.int32)
        for n in (9, 14, 6, 11)]
    res = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        sched = eng.scheduler(num_lanes=2, max_len=32)
        for i, p in enumerate(prompts):
            sched.submit(req(uid=i, prompt=p, max_new=5, arrival=i))
        res.append({r.uid: r for r in sched.run()})
    rj, rt = res
    assert sorted(rt) == sorted(rj) == [0, 1, 2, 3]
    for uid in rj:
        assert rt[uid].status == rj[uid].status == "ok", uid
        np.testing.assert_array_equal(rt[uid].tokens, rj[uid].tokens,
                                      err_msg=str(uid))
        for key in ("kv_reads", "peak_tokens", "steps", "generated_tokens"):
            assert getattr(rt[uid].meter, key) == \
                getattr(rj[uid].meter, key), (uid, key)
