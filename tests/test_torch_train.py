"""The port's retrofit-training path against the JAX reference, on the CPU.

DMS training functions, distillation losses, ``full_attention`` and
``model_forward`` in all four modes (reference attention and the kernel
path, whose plain versions run here against the reference's Pallas kernels
in interpret mode), one retrofit step (phase 1 and main), one train step,
AdamW, the data stream and checkpoints — on the shared tiny Qwen-R1 model
(``tiny_arch``/``tiny_params``, weights copied through numpy) run in fp32.
Gumbel noise: the reference's own ``jax.random.uniform`` draws are fed to
the port.  Tolerances: 1e-4 relative / 1e-5 absolute on fp32 activations
and losses (sums in another order); first moments 1e-4 of their largest
magnitude; updated params 1e-6 where the gradient is well above Adam's eps
(see ``_params_close``).
Then the port's own loop reproduces the reference loop's properties.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.core import distill as jdistill
from repro.core import dms as jdms
from repro.core.config import DMSConfig as JDMSConfig
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import distill as tdistill
from repro_torch.core import dms as tdms
from repro_torch.core.config import DMSConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tcli
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.train.loop import TrainConfig, train

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
B, T = 2, 24


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def setup(tiny_arch, tiny_params):
    """fp32 tiny model (DMS bias 0, so about half the tokens are evicted in
    ``dms_eval``), on both sides."""
    jarch = dataclasses.replace(tiny_arch, dtype="float32", dms=dataclasses.replace(
        tiny_arch.dms, logit_bias=0.0))
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu",
        dtype=torch.float32)
    tokens = np.random.default_rng(0).integers(
        0, jarch.vocab_size, (B, T)).astype(np.int32)
    return jarch, tarch, tiny_params, tparams, tokens


def _layer_uniforms(rng, arch, b, t):
    """The reference's per-layer Gumbel uniforms (``_scan_blocks``)."""
    keys = jax.random.split(rng, arch.num_layers)
    return [jax.random.uniform(keys[i], (b, arch.attn.num_kv_heads, t),
                               minval=1e-6, maxval=1 - 1e-6)
            for i in range(arch.num_layers)]


# ---------------------------------------------------------------------------
# core/dms.py, core/distill.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_sigmoid_matches_reference_draws(hard):
    logits = np.random.default_rng(1).standard_normal((2, 3, 17)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    u = jax.random.uniform(rng, logits.shape, minval=1e-6, maxval=1 - 1e-6)
    want = jdms.gumbel_sigmoid(logits, 0.3, rng, hard=hard)
    got = tdms.gumbel_sigmoid(_t(logits), 0.3, hard=hard, u=_t(u))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    np.testing.assert_allclose(
        tdms.gumbel_sigmoid(_t(logits), 0.3).numpy(),
        _np(jdms.gumbel_sigmoid(logits, 0.3, None)), **F32)
    # the port's own noise covers the same range
    gen = torch.Generator().manual_seed(0)
    u_t = tdms.uniform_noise((10000,), gen)
    assert 1e-6 <= float(u_t.min()) and float(u_t.max()) <= 1 - 1e-6


def test_dms_mask_schedule_and_aux_loss_match_reference():
    r = np.random.default_rng(2)
    alpha = r.uniform(0, 1, (2, 2, 12)).astype(np.float32)
    alpha[0, 0, 0] = 1.0                          # the 1 - 1e-6 clip
    for kw in (dict(window=3), dict(window=3, immediate_eviction=True)):
        jcfg, tcfg = JDMSConfig(**kw), DMSConfig(**kw)
        pos = np.arange(12)
        for causal, lw in ((True, None), (False, 5)):
            want = jdms.build_dms_mask(alpha, pos, pos, jcfg, causal, lw)
            got = tdms.build_dms_mask(_t(alpha), _t(pos), _t(pos), tcfg,
                                      causal, lw)
            np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    np.testing.assert_allclose(tdms.eviction_log_survival(_t(alpha)).numpy(),
                               _np(jdms.eviction_log_survival(alpha)), **F32)
    jcfg, tcfg = JDMSConfig(steps_per_cr_unit=5), DMSConfig(steps_per_cr_unit=5)
    for step in (0, 3, 40, 100):
        assert float(tdms.cr_schedule(step, tcfg)) == pytest.approx(
            float(jdms.cr_schedule(step, jcfg)), rel=1e-6)
        assert float(tdms.target_alpha(step, tcfg)) == pytest.approx(
            float(jdms.target_alpha(step, jcfg)), rel=1e-6, abs=1e-7)
        for s in (0.0, 5.0, 400.0):
            assert float(tdms.aux_compression_loss(
                torch.tensor(s), 480.0, step, tcfg)) == pytest.approx(
                float(jdms.aux_compression_loss(jnp.float32(s), 480.0, step,
                                                jcfg)), rel=1e-6, abs=1e-7)


def test_train_alphas_matches_reference():
    q = np.random.default_rng(3).standard_normal((2, 9, 4, 8)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    u = jax.random.uniform(rng, (2, 2, 9), minval=1e-6, maxval=1 - 1e-6)
    cfg = JDMSConfig(logit_bias=-1.0)
    a_j, q_j = jdms.train_alphas(q, 2, cfg, rng)
    a_t, q_t = tdms.train_alphas(_t(q), 2, DMSConfig(logit_bias=-1.0), u=_t(u))
    np.testing.assert_allclose(a_t.numpy(), _np(a_j), **F32)
    np.testing.assert_array_equal(q_t.numpy(), _np(q_j))


def test_distillation_losses_match_reference():
    r = np.random.default_rng(4)
    s = r.standard_normal((2, 7, 40)).astype(np.float32) * 3
    t = r.standard_normal((2, 7, 40)).astype(np.float32) * 3
    s[..., 36:] = t[..., 36:] = -1e30             # pad-vocab logits
    labels = r.integers(0, 36, (2, 7)).astype(np.int32)
    mask = (r.random((2, 7)) < 0.7).astype(np.float32)
    for m in (None, mask):
        mt = None if m is None else _t(m)
        for temp in (1.0, 2.0):
            got = tdistill.kl_logit_distillation(_t(s), _t(t), mt, temp)
            want = jdistill.kl_logit_distillation(s, t, m, temp)
            assert np.isfinite(float(got))
            assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-6)
        got = tdistill.lm_cross_entropy(_t(s), _t(labels), mt)
        want = jdistill.lm_cross_entropy(s, labels, m)
        assert float(got) == pytest.approx(float(want), rel=1e-5)
    cfg_j, cfg_t = JDMSConfig(steps_per_cr_unit=5), DMSConfig(steps_per_cr_unit=5)
    for teacher in (t, None):
        lj, mj = jdistill.retrofit_loss(s, teacher, labels, jnp.float32(10.0),
                                        96.0, 6, cfg_j, mask)
        lt, mt_ = tdistill.retrofit_loss(
            _t(s), None if teacher is None else _t(teacher), _t(labels),
            torch.tensor(10.0), 96.0, 6, cfg_t, _t(mask))
        assert sorted(mt_) == sorted(mj)
        for k in mj:
            assert float(mt_[k]) == pytest.approx(float(mj[k]), rel=1e-5,
                                                  abs=1e-6), k
        assert float(lt) == pytest.approx(float(lj), rel=1e-5)


# ---------------------------------------------------------------------------
# models: full_attention, model_forward
# ---------------------------------------------------------------------------

MODES = ["vanilla", "dms_train", "dms_eval", "dms_phase1"]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_full_attention_matches_reference(setup, mode, use_kernel):
    jarch, tarch, jparams, tparams, _ = setup
    x = np.random.default_rng(5).standard_normal(
        (B, T, jarch.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["0"]["attn"])
    tp = {k: v[0] for k, v in tparams["blocks"]["0"]["attn"].items()}
    rng = jax.random.PRNGKey(11)
    u = jax.random.uniform(rng, (B, jarch.attn.num_kv_heads, T), minval=1e-6,
                           maxval=1 - 1e-6)
    y_j, aux_j = jattn.full_attention(jp, x, jarch.attn, jarch, mode=mode,
                                      dms_rng=rng, neuron_scale=0.25,
                                      use_kernel=use_kernel)
    y_t, aux_t = tattn.full_attention(tp, _t(x), tarch.attn, tarch, mode=mode,
                                      dms_u=_t(u), neuron_scale=0.25,
                                      use_kernel=use_kernel)
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), **F32)
    assert sorted(aux_t) == sorted(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(np.asarray(aux_t[k], np.float32),
                                   _np(aux_j[k]), **F32, err_msg=k)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_model_forward_matches_reference(setup, mode, use_kernel):
    jarch, tarch, jparams, tparams, tokens = setup
    rng = jax.random.PRNGKey(5)
    logits_j, aux_j = jtfm.model_forward(jparams, tokens, jarch, mode=mode,
                                         rng=rng, neuron_scale=0.5,
                                         use_kernel=use_kernel)
    logits_t, aux_t = ttfm.model_forward(
        tparams, _t(tokens), tarch, mode=mode, neuron_scale=0.5,
        uniforms=[_t(u) for u in _layer_uniforms(rng, jarch, B, T)],
        use_kernel=use_kernel)
    live = slice(0, jarch.vocab_size)
    np.testing.assert_allclose(logits_t.numpy()[..., live],
                               _np(logits_j)[..., live], **F32)
    assert (logits_t[..., jarch.vocab_size:] == -1e30).all()
    for k in ("alpha_sum", "alpha_count", "moe_aux_loss"):
        assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), rel=1e-5,
                                                abs=1e-6), k


def test_model_forward_remat_gives_the_same_grads(setup):
    _, tarch, _, tparams, tokens = setup
    gen = torch.Generator().manual_seed(1)
    noise = ttfm.layer_noise(tarch, B, T, gen, "cpu")
    grads = []
    for remat in (False, True):
        p = {k: v for k, v in tparams.items()}
        w = p["blocks"]["0"]["attn"]["wq"].clone().requires_grad_()
        p["blocks"] = {"0": dict(p["blocks"]["0"], attn=dict(
            p["blocks"]["0"]["attn"], wq=w))}
        logits, aux = ttfm.model_forward(p, _t(tokens), tarch, mode="dms_train",
                                         uniforms=noise, remat=remat)
        (logits[..., :tarch.vocab_size].logsumexp(-1).mean()
         + aux["alpha_sum"]).backward()
        grads.append(w.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# optim, steps
# ---------------------------------------------------------------------------


def test_adamw_matches_reference():
    r = np.random.default_rng(6)
    params = {"a": r.standard_normal((5, 7)).astype(np.float32),
              "b": {"c": r.standard_normal((3,)).astype(np.float32)}}
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    jp, js = params, jadamw.init(params)
    tp = {"a": _t(params["a"]), "b": {"c": _t(params["b"]["c"])}}
    ts = tadamw.init(tp)
    assert ts.master is None                       # fp32 params need no copy
    for step in range(5):
        g = {"a": r.standard_normal((5, 7)).astype(np.float32),
             "b": {"c": r.standard_normal((3,)).astype(np.float32)}}
        jp, js, jm = jadamw.apply_updates(jp, g, js, jcfg)
        tp, ts, tm = tadamw.apply_updates(
            tp, {"a": _t(g["a"]), "b": {"c": _t(g["b"]["c"])}}, ts, tcfg)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6), k
        np.testing.assert_allclose(tp["a"].numpy(), _np(jp["a"]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tp["b"]["c"].numpy(), _np(jp["b"]["c"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.nu["a"].numpy(), _np(js.nu["a"]),
                                   rtol=1e-5, atol=1e-9)
    assert int(ts.step) == int(js.step) == 5
    # bf16 params keep an fp32 master copy, as the reference's do
    bf = tadamw.init({"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert bf.master["w"].dtype == torch.float32


def _tree_rel(tp, jp, tol):
    """Each leaf within ``tol`` x its largest magnitude."""
    if isinstance(jp, dict):
        for k in jp:
            _tree_rel(tp[k], jp[k], tol)
    else:
        want = _np(jp)
        err = np.abs(tp.float().numpy() - want).max()
        assert err <= tol * np.abs(want).max() + 1e-12, err


def _params_close(tp, jp, mu, lr):
    """Updated params after one AdamW step from the same params: where the
    gradient is well above Adam's eps (|g| = |mu| / 0.1 > 1e-6), the update
    is ±lr on both sides and the params agree to 1e-6; where it is not, the
    update g / (|g| + eps) follows the gradient's last digits, so only the
    step's size bound (lr, with weight decay) holds."""
    if isinstance(jp, dict):
        for k in jp:
            _params_close(tp[k], jp[k], mu[k], lr)
        return
    diff = np.abs(tp.float().numpy() - _np(jp))
    firm = np.abs(_np(mu)) / 0.1 > 1e-6
    assert diff[firm].max(initial=0.0) <= 1e-6
    assert diff.max(initial=0.0) <= 2.1 * lr


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _batch(arch, step, seq=T):
    cfg = jpipe.DataConfig(vocab_size=arch.vocab_size, seq_len=seq,
                           global_batch=B, seed=1)
    return jpipe.make_batch(cfg, step)


@pytest.mark.parametrize("phase1,step", [(True, 1000), (False, 3)])
def test_retrofit_step_matches_reference(setup, phase1, step):
    """Metrics, the first moment (0.1 x the clipped gradient) and the
    updated params after one retrofit step from the same params."""
    jarch, tarch, jparams, tparams, _ = setup
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    batch = _batch(jarch, step)
    jstep = jsteps.make_retrofit_step(jarch, jadamw.AdamWConfig(**opt_kw),
                                      remat=False, phase1=phase1)
    jp2, js2, jm = jstep(jparams, jparams, jadamw.init(jparams), batch,
                         jnp.int32(step))
    rng = jax.random.fold_in(jax.random.PRNGKey(23), step)
    uniforms = [_t(u) for u in _layer_uniforms(rng, jarch, B, T)]
    params, teacher = _clone(tparams), _clone(tparams)
    tstep = tsteps.make_retrofit_step(tarch, tadamw.AdamWConfig(**opt_kw),
                                      remat=False, phase1=phase1)
    tp2, ts2, tm = tstep(params, teacher, tadamw.init(params),
                         {k: _t(v) for k, v in batch.items()}, step,
                         uniforms=None if phase1 else uniforms)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                             abs=1e-6), k
    _tree_rel(ts2.mu, js2.mu, 1e-4)
    _params_close(tp2, jp2, js2.mu, float(jm["lr"]))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(setup, accum):
    """The LM train step with the DMS aux loss; ``accum = 2`` splits the
    batch into two microbatches that share the step's noise."""
    jarch, tarch, jparams, tparams, _ = setup
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    step = 2
    cfg = jpipe.DataConfig(vocab_size=jarch.vocab_size, seq_len=T,
                           global_batch=B, seed=1, accum_steps=accum)
    batch = jpipe.make_batch(cfg, step)
    jstep = jsteps.make_train_step(jarch, jadamw.AdamWConfig(**opt_kw),
                                   dms_train=True, remat=False,
                                   accum_steps=accum)
    jp2, js2, jm = jstep(jparams, jadamw.init(jparams), batch, jnp.int32(step))
    rng = jax.random.fold_in(jax.random.PRNGKey(17), step)
    uniforms = [_t(u) for u in _layer_uniforms(rng, jarch, B // accum, T)]
    params = _clone(tparams)
    tstep = tsteps.make_train_step(tarch, tadamw.AdamWConfig(**opt_kw),
                                   dms_train=True, remat=False,
                                   accum_steps=accum)
    tp2, ts2, tm = tstep(params, tadamw.init(params),
                         {k: _t(v) for k, v in batch.items()}, step,
                         uniforms=uniforms)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                             abs=1e-6), k
    _tree_rel(ts2.mu, js2.mu, 1e-4)
    _params_close(tp2, jp2, js2.mu, float(jm["lr"]))


# ---------------------------------------------------------------------------
# data, checkpoints, loop, CLI
# ---------------------------------------------------------------------------


def test_data_pipeline_is_the_reference_stream():
    for kw in (dict(), dict(kind="copy_task"), dict(accum_steps=2)):
        jc = jpipe.DataConfig(vocab_size=97, seq_len=16, global_batch=4, **kw)
        tc = tpipe.DataConfig(vocab_size=97, seq_len=16, global_batch=4, **kw)
        for step in (0, 5):
            jb, tb = jpipe.make_batch(jc, step), tpipe.make_batch(tc, step)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])


def test_checkpoint_roundtrip_and_retention(tmp_path):
    state = ({"w": torch.randn(3, 4), "n": {"s": torch.ones(2).bfloat16()}},
             tadamw.init({"w": torch.zeros(3)}))
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for step in (1, 2, 3):
        mgr.save(step, state, extra={"k": step}, blocking=step != 2)
    mgr.wait()
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    like = ({"w": torch.zeros(3, 4), "n": {"s": torch.zeros(2).bfloat16()}},
            tadamw.init({"w": torch.ones(3)}))
    got, step, extra = mgr.restore(like)
    assert step == 3 and extra == {"k": 3}
    torch.testing.assert_close(got[0]["w"], state[0]["w"])
    assert got[0]["n"]["s"].dtype == torch.bfloat16
    assert isinstance(got[1], tadamw.AdamWState) and got[1].master is None
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]][:2] == ["float32", "bfloat16"]
    assert not any(p.suffix == ".tmp" for p in tmp_path.iterdir())
    # the reference's manager reads the same layout of files
    assert JCkpt(tmp_path).latest_step() == 3


def test_retrofit_increases_alpha_and_tracks_teacher(tiny_arch):
    """The reference loop's retrofit properties (``tests/test_system.py``),
    on the port's loop with its own noise."""
    arch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    data = tpipe.DataConfig(vocab_size=arch.vocab_size, seq_len=64,
                            global_batch=8, seed=1)
    out = train(arch, data, TrainConfig(total_steps=50, retrofit=True,
                                        log_every=5, ckpt_every=1000),
                device="cpu")
    hist = out["history"]
    assert hist[-1]["alpha_mean"] > 0.15, hist[-1]
    assert hist[-1]["alpha_mean"] > hist[0]["alpha_mean"] + 0.1
    assert np.isfinite(hist[-1]["loss_main"])
    assert hist[-1]["loss_main"] < hist[0]["loss_main"] * 10 + 1.0


def test_checkpoint_resume_mid_training(tiny_arch, tmp_path):
    arch = dataclasses.replace(bridge.arch_from_dict(
        dataclasses.asdict(tiny_arch)), dms=DMSConfig(enabled=False))
    data = tpipe.DataConfig(vocab_size=arch.vocab_size, seq_len=32,
                            global_batch=4)
    cfg = TrainConfig(total_steps=20, ckpt_every=10, ckpt_dir=str(tmp_path),
                      log_every=5)
    first = train(arch, data, cfg, device="cpu")
    out2 = train(arch, data, dataclasses.replace(cfg, total_steps=30),
                 device="cpu")
    assert out2["resumed_from"] == 20
    assert out2["history"][-1]["step"] == 29
    assert first["history"][-1]["ce"] > out2["history"][-1]["ce"] - 0.5


def test_cli_trains_the_smoke_model_on_the_cpu(capsys):
    tcli.main(["--arch", "qwen-r1-1.5b", "--smoke", "--retrofit", "--steps",
               "2", "--batch", "2", "--seq-len", "16", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    final = json.loads(lines[-1])
    assert final["resumed_from"] is None and final["final"]["step"] == 1
    assert np.isfinite(final["final"]["loss"])
