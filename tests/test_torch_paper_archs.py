"""The paper's own family — qwen-r1-1.5b, qwen-r1-7b, qwen-r1-32b and
llama32-1b — against the JAX reference on the same numpy inputs and the
same weights (the reference's seeded init copied through numpy).

* The full and smoke configs equal the reference's.
* ``model_forward(mode="dms_train")`` on the smoke configs in fp32, with
  the reference's per-layer Gumbel uniforms and the DMS bias at 0 (so that
  about half the tokens are evicted): logits to rtol 1e-4 / atol 1e-5 (the
  two frameworks differ only in the order of fp32 sums and in libm ulps),
  the α sums to rel 1e-5.
* A narrow config that keeps each model's head grouping (llama32-1b's G
  4: 8/2 heads; qwen-r1-7b's G 7: 14/2; qwen-r1-32b's G 5: 10/2; Dh 16,
  d_model 64, 2 layers) under ``dms`` at the model's target CR, with the
  DMS bias at Φ⁻¹(1 − 1/CR) so that the random weights evict at that rate,
  as the chip phases set it.  The smoke configs shrink every model to G 2,
  so this is where the real groupings meet the reference's kernel spec
  (Pallas interpret mode; the port's decode kernel runs its plain version
  on the CPU).  (a) The port's ``Engine``, fixed and paged, against the
  JAX ``Engine`` with ``use_kernel=True``, in fp32: greedy tokens and both
  budget meters (``kv_reads``, ``peak_tokens``) equal — the meters count
  integer tokens in the same order.  fp32, because in bf16 the two
  frameworks round at other places (logits ~0.03-0.06 apart at every
  step) and a greedy near tie can then pick another token.  (b) The served
  dtype, bf16: 30 teacher-forced ``decode_step`` calls on the kernel path
  of both, logits within 0.05 × max |logit| (the chip phases' bound) at
  every step.
"""
import dataclasses
import statistics

import jax
import numpy as np
import pytest
import torch

from repro.configs import PAPER_ARCHS as JPAPER_ARCHS
from repro.configs import get_arch as jget_arch
from repro.configs import get_smoke as jget_smoke
from repro.core.config import KVPolicyConfig as JKV
from repro.models import transformer as jtfm
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import PAPER_ARCHS, get_arch, get_smoke
from repro_torch.core.config import KVPolicyConfig
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
# (query heads, kv heads) of each narrow config: the model's own G over 2
# kv heads
NARROW = {"llama32-1b": (8, 2), "qwen-r1-7b": (14, 2), "qwen-r1-32b": (10, 2)}


def test_paper_archs_are_the_references():
    assert PAPER_ARCHS == list(JPAPER_ARCHS)


@pytest.mark.parametrize("name", PAPER_ARCHS)
def test_config_equals_reference(name):
    for jcfg, tcfg in ((jget_arch(name), get_arch(name)),
                       (jget_smoke(name), get_smoke(name))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert bridge.arch_from_dict(dataclasses.asdict(jcfg)) == tcfg


@pytest.mark.parametrize("name", PAPER_ARCHS)
def test_model_forward_dms_train_matches_reference(name):
    jarch = dataclasses.replace(
        jget_smoke(name), dtype="float32",
        dms=dataclasses.replace(jget_smoke(name).dms, logit_bias=0.0))
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu",
        dtype=torch.float32)
    b, t = 2, 32
    tokens = np.random.default_rng(1).integers(
        0, jarch.vocab_size, (b, t)).astype(np.int32)
    rng = jax.random.PRNGKey(1)
    keys = jax.random.split(rng, jarch.num_layers)
    uniforms = [torch.from_numpy(np.array(jax.random.uniform(
        keys[i], (b, jarch.attn.num_kv_heads, t), minval=1e-6,
        maxval=1 - 1e-6), np.float32)) for i in range(jarch.num_layers)]
    logits_j, aux_j = jtfm.model_forward(jparams, tokens, jarch,
                                         mode="dms_train", rng=rng)
    logits_t, aux_t = ttfm.model_forward(tparams, torch.from_numpy(tokens),
                                         tarch, mode="dms_train",
                                         uniforms=uniforms)
    live = slice(0, jarch.vocab_size)
    assert torch.isfinite(logits_t[..., live]).all()
    np.testing.assert_allclose(logits_t.detach().numpy()[..., live],
                               np.asarray(logits_j, np.float32)[..., live],
                               **F32)
    for k in ("alpha_sum", "alpha_count"):
        assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), rel=1e-5,
                                                abs=1e-6), k
    # the bias at 0 evicts some tokens and keeps others
    assert 0 < float(aux_t["alpha_sum"]) < float(aux_t["alpha_count"])


def _narrow(name, dtype):
    """(reference arch, port arch, reference params, port params) of the
    smoke config in ``dtype`` with ``NARROW``'s heads of Dh 16 and the DMS
    bias that evicts at the model's target CR."""
    smoke = jget_smoke(name)
    hq, hkv = NARROW[name]
    cr = smoke.dms.target_cr
    bias = statistics.NormalDist().inv_cdf(1 - 1 / cr)
    jarch = dataclasses.replace(
        smoke, dtype=dtype,
        attn=dataclasses.replace(smoke.attn, num_heads=hq,
                                        num_kv_heads=hkv, head_dim=16),
        dms=dataclasses.replace(smoke.dms, logit_bias=bias))
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu",
        dtype=getattr(torch, dtype))
    return jarch, tarch, jparams, tparams


def _serve(eng, req_cls, prompts, lanes=2, max_len=40, max_new=6):
    sched = eng.scheduler(num_lanes=lanes, max_len=max_len)
    for i, p in enumerate(prompts):
        sched.submit(req_cls(uid=i, prompt=p, max_new=max_new, arrival=i))
    return {r.uid: r for r in sched.run()}


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("name", sorted(NARROW))
def test_engine_at_the_models_head_grouping_matches_reference(name, paged):
    jarch, tarch, jparams, tparams = _narrow(name, "float32")
    assert tarch.attn.q_per_kv == get_arch(name).attn.q_per_kv
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


@pytest.mark.parametrize("name", sorted(NARROW))
def test_bf16_kernel_path_decode_matches_reference(name):
    jarch, tarch, jparams, tparams = _narrow(name, "bfloat16")
    kw = dict(kind="dms", cr=jarch.dms.target_cr, window=jarch.dms.window,
              block_p=8)
    steps = 30
    toks = np.random.default_rng(3).integers(
        3, jarch.vocab_size, (2, steps)).astype(np.int32)
    jstate = jtfm.init_decode_state(jarch, 2, steps + 2, JKV(**kw))
    tstate = ttfm.init_decode_state(tarch, 2, steps + 2, KVPolicyConfig(**kw),
                                    device="cpu")
    live = slice(0, jarch.vocab_size)
    jstep = jax.jit(lambda p, tok, st, pos: jtfm.decode_step(
        p, tok, st, jarch, pos, use_kernel=True))
    for t in range(steps):
        lj, jstate, _ = jstep(jparams, jax.numpy.asarray(toks[:, t:t + 1]),
                              jstate, jax.numpy.asarray(t, jax.numpy.int32))
        lt, tstate, aux = ttfm.decode_step(
            tparams, torch.from_numpy(toks[:, t:t + 1]), tstate, tarch, t,
            use_kernel=True)
        assert aux["attn_impl_kernel"] == 1
        want = np.asarray(lj, np.float32)[:, live]
        gap = np.abs(lt.float().numpy()[:, live] - want).max()
        assert gap <= 0.05 * np.abs(want).max(), (t, gap)
    # DMS evicted in both: fewer live tokens than written
    live_tokens = float(aux["live_tokens"].sum())
    assert live_tokens < tarch.num_layers * 2 * tarch.attn.num_kv_heads * steps
