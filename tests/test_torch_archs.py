"""The four families this port serves beyond the dense Qwen-like decoders —
gemma2 (local and global layers, attention and final softcaps, post-norms,
GeGLU, an embedding multiplier), chatglm3 (half RoPE), qwen2-vl (M-RoPE and
prepended patch embeddings) and granite (top-k MoE) — against the JAX
reference on the same numpy inputs and the same weights (the reference's
seeded init copied through numpy).

Tolerances: fp32 replicas (``dtype="float32"``) to rtol 1e-4 / atol 1e-5
(the two frameworks differ only in the order of fp32 sums and in libm
ulps); bf16 layers to 2e-2 (bf16 products rounded at other places); the
budget meters and MoE routing are integers and must be equal; the
embedding multiplier's product must be bit-equal.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import get_smoke as jget_smoke
from repro.core.config import KVPolicyConfig as JKV
from repro.core.config import MLPConfig as JMLP
from repro.core.config import MoEConfig as JMoE
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_arch, get_smoke
from repro_torch.core.config import KVPolicyConfig, MLPConfig, MoEConfig
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
NAMES = ("gemma2-2b", "chatglm3-6b", "qwen2-vl-7b", "granite-moe-1b-a400m",
         "granite-moe-3b-a800m")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _n(t):
    return t.float().numpy()


def _pair(name, dtype="float32", bias=None):
    """(reference arch, port arch, reference params, port params) of the
    smoke config, in ``dtype``; ``bias`` sets the DMS logit bias."""
    jarch = dataclasses.replace(jget_smoke(name), dtype=dtype)
    if bias is not None:
        jarch = dataclasses.replace(jarch, dms=dataclasses.replace(
            jarch.dms, logit_bias=bias))
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu")
    return jarch, tarch, jparams, tparams


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name):
    for jcfg, tcfg in ((jget_arch(name), get_arch(name)),
                       (jget_smoke(name), get_smoke(name))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert bridge.arch_from_dict(dataclasses.asdict(jcfg)) == tcfg


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, tuple(v.shape)


@pytest.mark.parametrize("name", NAMES + ("seamless-m4t-large-v2",))
def test_init_model_layout_matches_reference(name):
    """The port's own init draws the reference's tree: the same leaves
    (post-norms, per-position blocks, MoE router and experts; seamless's
    encoder blocks, cross-attention and LayerNorm biases) in the same
    shapes, and one salt a decoder layer."""
    tarch = get_smoke(name)
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jget_smoke(name))
    tparams = ttfm.init_model(tarch, seed=0, device="cpu")
    assert dict(_leaves(tparams)) == dict(_leaves(jparams))
    assert tparams.layer_salt.shape == (tarch.num_layers,)


def test_unknown_layer_kind_still_raises():
    """A config the reference cannot build (a layer kind it does not know)
    is refused by every entry point of the port, as the reference's
    ``init_model`` refuses it; nothing falls back."""
    jarch = dataclasses.replace(jget_smoke("gemma2-2b"),
                                layer_pattern=("attn", "conv"))
    with pytest.raises(ValueError):
        jtfm.init_model(jax.random.PRNGKey(0), jarch)
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    with pytest.raises(NotImplementedError, match="layer kinds"):
        ttfm.check_supported(tarch)
    with pytest.raises(NotImplementedError):
        ttfm.init_model(tarch, device="cpu")
    with pytest.raises(NotImplementedError):
        ttfm.init_decode_state(tarch, 1, 8, KVPolicyConfig(kind="dms"),
                               device="cpu")


def test_embedding_multiplier_rounds_like_reference():
    """The multiplier is rounded to the compute dtype before the product:
    √2560 (recurrentgemma's, not exact in bf16) on gemma2's layout gives
    the reference's bits on 4096 random bf16 activations."""
    jarch = dataclasses.replace(jget_smoke("gemma2-2b"),
                                embedding_multiplier=2560 ** 0.5)
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    r = np.random.default_rng(0)
    embed = r.normal(size=(4096, 8)).astype(np.float32) * 3.0
    tokens = r.integers(0, 4096, size=(2, 4096)).astype(np.int32)
    xj = jtfm.embed_tokens({"embed": jnp.asarray(embed)}, jnp.asarray(tokens),
                           jarch)
    xt = ttfm.embed_tokens({"embed": _t(embed, torch.bfloat16)},
                           torch.from_numpy(tokens), tarch)
    assert xt.dtype == torch.bfloat16
    np.testing.assert_array_equal(xt.view(torch.int16).numpy(),
                                  np.asarray(xj).view(np.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_half_rotates_first_half(dtype):
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = r.integers(0, 500, size=(2, 5)).astype(np.int32)
    out_j = jlayers.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos), 1e4,
                               "half")
    out_t = tlayers.apply_rope(_t(x, getattr(torch, dtype)),
                               torch.from_numpy(pos), 1e4, "half")
    np.testing.assert_allclose(_n(out_t), np.asarray(out_j, np.float32),
                               **(F32 if dtype == "float32" else BF16))
    np.testing.assert_array_equal(_n(out_t)[..., 8:],
                                  _n(_t(x, getattr(torch, dtype)))[..., 8:])
    # the first pair turns by pos radians; pair 1 by pos / theta^(2/8):
    # frequencies over the rotated half's width
    if dtype == "float32":
        ang = pos[..., None] * 1e4 ** (-2 / 8)
        want = x[..., 2] * np.cos(ang) - x[..., 3] * np.sin(ang)
        np.testing.assert_allclose(_n(out_t)[..., 2], want, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("dh,sections", [(16, (2, 3, 3)), (16, (1, 2, 2)),
                                         (16, (16, 24, 24)),
                                         (128, (16, 24, 24))])
def test_rope_mrope_three_streams(dh, sections):
    """Three distinct position streams; sections that fill Dh/2 exactly,
    fall short of it (the last stream continues) and overrun it (cut)."""
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 6, 3, dh)).astype(np.float32)
    pos = r.integers(0, 800, size=(3, 2, 6)).astype(np.int32)
    out_j = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                               "mrope", sections)
    out_t = tlayers.apply_rope(_t(x), torch.from_numpy(pos), 1e6, "mrope",
                               sections)
    np.testing.assert_allclose(_n(out_t), np.asarray(out_j), **F32)
    # the streams matter: equal streams give another rotation
    if sum(sections) <= dh // 2 or sections[0] < dh // 2:
        same = tlayers.apply_rope(_t(x), torch.from_numpy(pos[:1].repeat(3, 0)),
                                  1e6, "mrope", sections)
        assert not torch.allclose(same, out_t)


@pytest.mark.parametrize("kind", ["geglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlps_match_reference(kind, dtype):
    """GeGLU and the plain GELU MLP: ``jax.nn.gelu`` is the tanh form."""
    r = np.random.default_rng(3)
    d, f = 32, 96
    names = (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))
    p = {k: r.normal(size=s).astype(np.float32) * s[0] ** -0.5
         for k, s in names if k != "w_gate" or kind == "geglu"}
    x = r.normal(size=(2, 3, d)).astype(np.float32) * 2.0
    y_j, _ = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x, dtype), JMLP(d_ff=f, kind=kind),
                               jnp.dtype(dtype))
    tdt = getattr(torch, dtype)
    y_t, aux = tlayers.mlp_apply({k: _t(v, tdt) for k, v in p.items()},
                                 _t(x, tdt), MLPConfig(d_ff=f, kind=kind), tdt)
    assert aux == {} and y_t.dtype == tdt
    np.testing.assert_allclose(_n(y_t), np.asarray(y_j, np.float32),
                               **(F32 if dtype == "float32" else BF16))


def _moe(r, d, f, e, k, kind="swiglu"):
    p = {"router": r.normal(size=(d, e)).astype(np.float32) * 0.5,
         "w_up": r.normal(size=(e, d, f)).astype(np.float32) * d ** -0.5,
         "w_down": r.normal(size=(e, f, d)).astype(np.float32) * f ** -0.5}
    if kind != "gelu":
        p["w_gate"] = r.normal(size=(e, d, f)).astype(np.float32) * d ** -0.5
    cfgs = (JMLP(d_ff=f, kind=kind, moe=JMoE(num_experts=e, top_k=k)),
            MLPConfig(d_ff=f, kind=kind, moe=MoEConfig(num_experts=e, top_k=k)))
    return p, cfgs


def _moe_both(p, cfgs, x, dtype="float32"):
    y_j, aux_j = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x, dtype), cfgs[0],
                                   jnp.dtype(dtype))
    tdt = getattr(torch, dtype)
    y_t, aux_t = tlayers.mlp_apply({k: _t(v, tdt) for k, v in p.items()},
                                   _t(x, tdt), cfgs[1], tdt)
    return (np.asarray(y_j, np.float32), aux_j), (_n(y_t), aux_t)


@pytest.mark.parametrize("t,e,k,kind", [(5, 8, 2, "swiglu"),
                                        (64, 8, 2, "swiglu"),
                                        (64, 40, 8, "swiglu"),
                                        (16, 4, 2, "geglu"),
                                        (16, 4, 1, "gelu")])
def test_moe_matches_reference(t, e, k, kind):
    """fp32 output and aux.  At T = 64 the router's skew fills some queues
    past their truncated capacity, so tokens drop."""
    r = np.random.default_rng(t + e + k)
    p, cfgs = _moe(r, 16, 24, e, k, kind)
    x = r.normal(size=(2, t, 16)).astype(np.float32)
    x[..., 0] += 3.0                          # skew the router
    (y_j, aux_j), (y_t, aux_t) = _moe_both(p, cfgs, x)
    np.testing.assert_allclose(y_t, y_j, **F32)
    for key in ("moe_aux_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]),
                                   rtol=1e-5, err_msg=key)
    if t == 64:
        assert float(aux_t["moe_drop_frac"]) > 0.0


def test_moe_router_tie_takes_lower_expert():
    """A token whose router logits tie over every expert: ``lax.top_k``
    takes the lowest indices, and so must the port (a stable sort)."""
    r = np.random.default_rng(7)
    p, cfgs = _moe(r, 16, 24, 8, 2)
    p["router"][:, 3:] = p["router"][:, 3:4]       # experts 3..7 tie
    p["router"][:, :3] = -4.0 * np.abs(p["router"][:, 3:4])
    x = np.abs(r.normal(size=(1, 6, 16))).astype(np.float32)
    (y_j, _), (y_t, _) = _moe_both(p, cfgs, x)
    np.testing.assert_allclose(y_t, y_j, **F32)
    # experts 3 and 4 serve every token: 5..7 contribute nothing
    p2 = dict(p)
    for key in ("w_up", "w_down", "w_gate"):
        p2[key] = p[key].copy()
        p2[key][5:] = 0.0
    (_, _), (y_t2, _) = _moe_both(p2, cfgs, x)
    np.testing.assert_array_equal(y_t2, y_t)


def test_moe_bf16_matches_reference():
    r = np.random.default_rng(11)
    p, cfgs = _moe(r, 16, 24, 8, 2)
    x = r.normal(size=(2, 9, 16)).astype(np.float32)
    (y_j, _), (y_t, _) = _moe_both(p, cfgs, x, "bfloat16")
    np.testing.assert_allclose(y_t, y_j, **BF16)


@pytest.mark.parametrize("name", NAMES)
def test_model_forward_matches_reference(name):
    """fp32 logits and the MoE aux loss; qwen2-vl with 4 prepended patch
    embeddings and three distinct M-RoPE position streams."""
    jarch, tarch, jparams, tparams = _pair(name)
    r = np.random.default_rng(5)
    tokens = r.integers(0, jarch.vocab_size, size=(2, 12)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if jarch.frontend == "vision_patches":
        fe = r.normal(size=(2, jarch.frontend_tokens, jarch.d_model))
        fe = (fe * 0.02).astype(np.float32)
        pos = r.integers(0, 40, size=(3, 16)).astype(np.int32)
        kw_j = dict(frontend_embeds=jnp.asarray(fe), positions=jnp.asarray(pos))
        kw_t = dict(frontend_embeds=_t(fe), positions=torch.from_numpy(pos))
    lj, aj = jtfm.model_forward(jparams, jnp.asarray(tokens), jarch, **kw_j)
    lt, at = ttfm.model_forward(tparams, torch.from_numpy(tokens), tarch, **kw_t)
    assert lt.shape == lj.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    np.testing.assert_allclose(float(at["moe_aux_loss"]),
                               float(aj["moe_aux_loss"]), rtol=1e-5, atol=1e-9)
    if jarch.mlp.moe is not None:
        assert float(at["moe_aux_loss"]) > 0.0


@pytest.mark.parametrize("name", NAMES)
def test_dms_eval_forward_collects_kv_per_position(name):
    """``dms_eval`` with ``collect_kv``: logits, α sums and each position's
    stacked K/V, retained map and α equal the reference's."""
    jarch, tarch, jparams, tparams = _pair(name, bias=0.0)
    tokens = np.random.default_rng(6).integers(
        0, jarch.vocab_size, size=(2, 20)).astype(np.int32)
    lj, aj = jtfm.model_forward(jparams, jnp.asarray(tokens), jarch,
                                mode="dms_eval", collect_kv=True)
    lt, at = ttfm.model_forward(tparams, torch.from_numpy(tokens), tarch,
                                mode="dms_eval", collect_kv=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    np.testing.assert_allclose(float(at["alpha_sum"]), float(aj["alpha_sum"]))
    assert at["layer_kv"].keys() == aj["layer_kv"].keys()
    for pi, kv in at["layer_kv"].items():
        for key, val in kv.items():
            want = np.asarray(aj["layer_kv"][pi][key])
            if val.dtype == torch.bool:
                np.testing.assert_array_equal(val.numpy(), want, err_msg=key)
            else:
                np.testing.assert_allclose(_n(val), want, err_msg=key, **F32)


def _decode_run(name, cfg_kw, steps=14, lanes=3, max_len=24, use_kernel=True,
                dtype="float32", bias=0.0, seed=0):
    """Drive both decode steps on one seeded token/active stream with
    per-lane positions; returns the per-step logits and meters of both."""
    jarch, tarch, jparams, tparams = _pair(name, dtype, bias)
    js = jtfm.init_decode_state(jarch, lanes, max_len, JKV(**cfg_kw))
    ts = ttfm.init_decode_state(tarch, lanes, max_len, KVPolicyConfig(**cfg_kw),
                                device="cpu")
    assert ts.keys() == js.keys()
    jstep = jax.jit(lambda p, tok, s, pos, act: jtfm.decode_step(
        p, tok, s, jarch, pos, use_kernel=False, active=act))
    r = np.random.default_rng(seed)
    pos = np.zeros((lanes,), np.int32)
    out = []
    for i in range(steps):
        tok = r.integers(3, jarch.vocab_size, size=(lanes, 1)).astype(np.int32)
        act = r.random(lanes) < 0.8
        act[i % lanes] = True
        lj, js, aj = jstep(jparams, jnp.asarray(tok), js, jnp.asarray(pos),
                           jnp.asarray(act))
        lt, ts, at = ttfm.decode_step(tparams, torch.from_numpy(tok), ts, tarch,
                                      torch.from_numpy(pos),
                                      use_kernel=use_kernel,
                                      active=torch.from_numpy(act))
        out.append((act, lt.numpy(), np.asarray(lj), at, aj))
        pos = pos + act
    return out, ts, js


LAYER_MAPS = {"dms": dict(kind="dms", cr=2.0, window=4),
              "local-window": dict(kind="dms", cr=2.0, window=4, budget=6,
                                   layer_map={"attn_local": "window",
                                              "attn": "dms"}),
              "vanilla": dict(kind="vanilla")}


@pytest.mark.parametrize("name,layout", [(n, "dms") for n in NAMES]
                         + [("gemma2-2b", "local-window"),
                            ("gemma2-2b", "vanilla")])
def test_decode_step_matches_reference(name, layout):
    """fp32 logits per step (active lanes), both meters equal; gemma2 also
    under a per-kind layer map and on vanilla (its local layer a ring)."""
    run, ts, js = _decode_run(name, LAYER_MAPS[layout])
    for i, (act, lt, lj, at, aj) in enumerate(run):
        np.testing.assert_allclose(lt[act], lj[act], err_msg=f"step {i}", **F32)
        for key in ("live_tokens", "reads_tokens"):
            np.testing.assert_array_equal(at[key].numpy(), np.asarray(aj[key]),
                                          err_msg=f"{key} step {i}")
        assert at["attn_impl_kernel"] == 1
    for key in ts:
        assert ts[key].policy == js[key].policy


def test_gemma2_decode_matches_full_forward():
    """The reference's ``test_decode_matches_full_forward`` for gemma2 on
    the port: teacher-forced vanilla decode against the full forward, at
    the reference test's tolerance (0.12: bf16, softcapped)."""
    arch = get_smoke("gemma2-2b")
    params = ttfm.init_model(arch, seed=0, device="cpu")
    b, t = 2, 12
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, arch.vocab_size, size=(b, t)).astype(np.int32))
    full, _ = ttfm.model_forward(params, tokens, arch)
    state = ttfm.init_decode_state(arch, b, t, KVPolicyConfig(kind="vanilla"),
                                   device="cpu")
    outs = []
    for i in range(t):
        lg, state, _ = ttfm.decode_step(params, tokens[:, i:i + 1], state, arch,
                                        i)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=0.12, atol=0.12)


def test_layer_salts_follow_reference_layer_order():
    """gemma2 at 4 layers (2 superblocks): the salts are the bits of each
    layer's fp32 ``wo[0, 0]`` in superblock-major order, as the reference
    reads them inside its scan."""
    jarch = dataclasses.replace(jget_smoke("gemma2-2b"), num_layers=4)
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu")
    want = [np.asarray(jparams["blocks"][str(pi)]["attn"]["wo"][sb, 0, 0],
                       np.float32).view(np.uint32)
            for sb in range(2) for pi in range(2)]
    assert tparams.layer_salt.tolist() == [int(w) for w in want]
    fp32 = ttfm.init_model(tarch, seed=0, device="cpu", dtype=torch.float32)
    assert torch.equal(ttfm.layer_salts(fp32),
                       ttfm.layer_salts(dict(fp32)))
