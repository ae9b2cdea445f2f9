"""The catalog's last three configurations — minitron-4b, phi3-mini-3.8b
and granite-moe-1b-a400m — against the JAX reference on the same numpy
inputs and the same weights (the reference's seeded init copied through
numpy).

* The full and smoke configs equal the reference's.
* A narrow config that keeps each model's own head grouping and, for
  phi3, its head dim: phi3-mini's MHA at Dh 96 (2/2 heads of 96, G 1),
  minitron-4b's G 3 (6/2 heads of 16) and granite-moe-1b's G 2 (4/2
  heads of 16) with its own 32 experts and top-8 (the smoke config has 8
  experts and top-2); d_model 64, 2 layers, ``dms`` at the model's target
  CR with the DMS bias at Φ⁻¹(1 − 1/CR), as the chip phases set it.  The
  smoke configs shrink phi3 to Dh 16, so this is where Dh 96 meets the
  reference's kernel spec (Pallas interpret mode; the port's decode
  kernel runs its plain version on the CPU).
* (a) The port's ``Engine``, fixed and paged, against the JAX ``Engine``
  with ``use_kernel=True``, in fp32: greedy tokens and both budget meters
  (``kv_reads``, ``peak_tokens``) equal.  fp32, because in bf16 the two
  frameworks round at other places and a greedy near tie can then pick
  another token (``tests/test_torch_paper_archs.py``).
* (b) The served dtype, bf16: 30 teacher-forced ``decode_step`` calls on
  the kernel path of both, logits within 0.05 × max |logit| (the chip
  phases' bound).  A MoE router's near tie flips between bf16 frameworks
  after the layers below round apart, and the token then meets other
  experts: for granite a step is held only where every layer routed every
  token to the same experts on both sides (the reference's routes read by
  a ``jax.debug.callback`` in its ``moe_apply``), and most steps must be.
"""
import dataclasses
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import get_smoke as jget_smoke
from repro.core.config import KVPolicyConfig as JKV
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import get_arch, get_smoke
from repro_torch.core.config import KVPolicyConfig
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

# (query heads, kv heads, head dim, experts) of each narrow config: the
# model's own G over 2 kv heads, phi3's own Dh, granite's own 32 experts
NARROW = {"phi3-mini-3.8b": (2, 2, 96, None),
          "minitron-4b": (6, 2, 16, None),
          "granite-moe-1b-a400m": (4, 2, 16, 32)}
NAMES = sorted(NARROW)


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name):
    for jcfg, tcfg in ((jget_arch(name), get_arch(name)),
                       (jget_smoke(name), get_smoke(name))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert bridge.arch_from_dict(dataclasses.asdict(jcfg)) == tcfg


def _narrow(name, dtype):
    """(reference arch, port arch, reference params, port params) of the
    smoke config in ``dtype`` with ``NARROW``'s heads and experts and the
    DMS bias that evicts at the model's target CR."""
    smoke, full = jget_smoke(name), jget_arch(name)
    hq, hkv, dh, experts = NARROW[name]
    cr = smoke.dms.target_cr
    bias = statistics.NormalDist().inv_cdf(1 - 1 / cr)
    mlp = smoke.mlp
    if experts is not None:
        mlp = dataclasses.replace(mlp, moe=dataclasses.replace(
            mlp.moe, num_experts=experts, top_k=full.mlp.moe.top_k))
    jarch = dataclasses.replace(
        smoke, dtype=dtype, mlp=mlp,
        attn=dataclasses.replace(smoke.attn, num_heads=hq,
                                 num_kv_heads=hkv, head_dim=dh),
        dms=dataclasses.replace(smoke.dms, logit_bias=bias))
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu",
        dtype=getattr(torch, dtype))
    return jarch, tarch, jparams, tparams


def test_narrow_configs_keep_each_models_grouping():
    """The narrow configs carry the full model's G, phi3's Dh 96 and
    granite-1b's 32 experts at top-8."""
    for name in NAMES:
        _, tarch, _, _ = _narrow(name, "float32")
        full = get_arch(name)
        assert tarch.attn.q_per_kv == full.attn.q_per_kv
        if name.startswith("phi3"):
            assert tarch.attn.head_dim == full.attn.head_dim == 96
        if full.mlp.moe is not None:
            assert tarch.mlp.moe == full.mlp.moe


def _serve(eng, req_cls, prompts, lanes=2, max_len=40, max_new=6):
    sched = eng.scheduler(num_lanes=lanes, max_len=max_len)
    for i, p in enumerate(prompts):
        sched.submit(req_cls(uid=i, prompt=p, max_new=max_new, arrival=i))
    return {r.uid: r for r in sched.run()}


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("name", NAMES)
def test_engine_at_the_models_grouping_matches_reference(name, paged):
    jarch, tarch, jparams, tparams = _narrow(name, "float32")
    kw = dict(kind="dms", cr=jarch.dms.target_cr, window=jarch.dms.window,
              paged=paged, block_p=8)
    jeng = JEngine(jarch, jparams, JKV(**kw), use_kernel=True)
    teng = Engine(tarch, tparams, KVPolicyConfig(**kw), use_kernel=True,
                  device="cpu")
    prompts = [np.random.default_rng(7 + n).integers(
        3, jarch.vocab_size, size=(n,)).astype(np.int32)
        for n in (20, 14, 26, 11)]
    rj = _serve(jeng, JRequest, prompts)
    rt = _serve(teng, Request, prompts)
    assert sorted(rt) == sorted(rj) == [0, 1, 2, 3]
    for uid in rj:
        assert rt[uid].status == rj[uid].status == "ok", uid
        np.testing.assert_array_equal(rt[uid].tokens, rj[uid].tokens,
                                      err_msg=str(uid))
        for key in ("kv_reads", "peak_tokens", "steps", "generated_tokens"):
            assert getattr(rt[uid].meter, key) == \
                getattr(rj[uid].meter, key), (uid, key)
    # DMS evicted: request 2 peaks below the tokens it wrote in each layer
    held = tarch.num_layers * (len(prompts[2]) + 6)
    assert rt[2].meter.peak_tokens < held


def _route_spies(monkeypatch, jroutes, troutes):
    """Both frameworks' ``moe_apply`` record each call's expert ids (B, T,
    k): the reference's through an ordered ``jax.debug.callback`` (its
    decode step scans the layers under ``jit``), the port's directly."""
    jreal, treal = jlayers.moe_apply, tlayers.moe_apply

    def jspy(p, x, cfg, dtype, *args, **kw):
        logits = (x.astype(dtype) @ p["router"].astype(dtype)).astype(
            jnp.float32)
        top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                              cfg.moe.top_k)[1]
        jax.debug.callback(lambda e: jroutes.append(np.asarray(e)), top_e,
                           ordered=True)
        return jreal(p, x, cfg, dtype, *args, **kw)

    def tspy(p, x, cfg, dtype, *args, **kw):
        troutes.append(tlayers.moe_route(p, x.to(dtype),
                                         cfg.moe.top_k)[2].numpy())
        return treal(p, x, cfg, dtype, *args, **kw)

    monkeypatch.setattr(jlayers, "moe_apply", jspy)
    monkeypatch.setattr(tlayers, "moe_apply", tspy)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_kernel_path_decode_matches_reference(name, monkeypatch):
    jarch, tarch, jparams, tparams = _narrow(name, "bfloat16")
    kw = dict(kind="dms", cr=jarch.dms.target_cr, window=jarch.dms.window,
              block_p=8)
    steps = 30
    moe = tarch.mlp.moe is not None
    jroutes, troutes = [], []
    if moe:
        _route_spies(monkeypatch, jroutes, troutes)
    toks = np.random.default_rng(3).integers(
        3, jarch.vocab_size, (2, steps)).astype(np.int32)
    jstate = jtfm.init_decode_state(jarch, 2, steps + 2, JKV(**kw))
    tstate = ttfm.init_decode_state(tarch, 2, steps + 2, KVPolicyConfig(**kw),
                                    device="cpu")
    live = slice(0, jarch.vocab_size)
    jstep = jax.jit(lambda p, tok, st, pos: jtfm.decode_step(
        p, tok, st, jarch, pos, use_kernel=True))
    held = 0
    for t in range(steps):
        jroutes.clear()
        troutes.clear()
        lj, jstate, _ = jstep(jparams, jnp.asarray(toks[:, t:t + 1]),
                              jstate, jnp.asarray(t, jnp.int32))
        jax.effects_barrier()
        lt, tstate, aux = ttfm.decode_step(
            tparams, torch.from_numpy(toks[:, t:t + 1]), tstate, tarch, t,
            use_kernel=True)
        assert aux["attn_impl_kernel"] == 1
        if moe:
            assert len(jroutes) == len(troutes) == tarch.num_layers
            if any(not np.array_equal(np.sort(a, -1), np.sort(b, -1))
                   for a, b in zip(jroutes, troutes)):
                continue                  # a near tie routed otherwise
        held += 1
        want = np.asarray(lj, np.float32)[:, live]
        gap = np.abs(lt.float().numpy()[:, live] - want).max()
        assert gap <= 0.05 * np.abs(want).max(), (t, gap)
    assert 2 * held > steps, held
    # DMS evicted in both: fewer live tokens than written
    live_tokens = float(aux["live_tokens"].sum())
    assert live_tokens < tarch.num_layers * 2 * tarch.attn.num_kv_heads * steps
