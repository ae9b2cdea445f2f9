"""The port's DMS flash attention against the JAX reference, on the CPU.

On the CPU the port's wrapper runs the plain versions of its three kernels
(``flash_fwd_plain``, ``flash_dq_plain``, ``flash_dkv_plain``) through its
autograd Function; the reference runs its Pallas kernels in interpret mode.
The same numpy inputs go through both.  Tolerances: fp32 outputs 2e-5 and
fp32 gradients 1e-4 relative to their largest magnitude (the reference's own
kernel-vs-autodiff bound: sums in another order); bf16 2e-2 (each side
rounds its outputs to 8 significant bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dms_attention import dms_attention as jkern
from repro.kernels.dms_attention import ops as jops
from repro.kernels.dms_attention import ref as jref
from repro_torch.kernels.dms_attention import ops
from repro_torch.kernels.dms_attention import ref as tref

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
GRAD_REL = 1e-4
JBLOCKS = dict(block_q=16, block_k=16)     # the reference's tiles
TBLOCKS = dict(block_k=16)                  # the port's `hr` key blocks


def _inputs(shape, seed=0, binary=False):
    b, t, hq, hkv, dh = shape
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, t, hq, dh)).astype(np.float32)
    k = r.standard_normal((b, t, hkv, dh)).astype(np.float32)
    v = r.standard_normal((b, t, hkv, dh)).astype(np.float32)
    if binary:
        alpha = (r.random((b, hkv, t)) < 0.7).astype(np.float32)
    else:
        alpha = r.uniform(0.02, 0.9, (b, hkv, t)).astype(np.float32)
    tgt = r.standard_normal((b, t, hq, dh)).astype(np.float32)
    return q, k, v, alpha, tgt


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


def _both(shape, kw, alpha=True, seed=0):
    """Outputs and grads in (q, k, v[, alpha]) of both wrappers for the loss
    sum(out * tgt)."""
    q, k, v, a, tgt = _inputs(shape, seed)
    args = (q, k, v, a) if alpha else (q, k, v)

    def loss_j(*xs):
        o = jops.dms_flash_attention(*xs[:3], xs[3] if alpha else None,
                                     **JBLOCKS, **kw)
        return jnp.sum(o * tgt), o

    (_, out_j), g_j = jax.value_and_grad(loss_j, argnums=tuple(range(len(args))),
                                         has_aux=True)(*args)
    ts = [torch.tensor(x, requires_grad=True) for x in args]
    out_t = ops.dms_flash_attention(*ts[:3], ts[3] if alpha else None,
                                    **TBLOCKS, **kw)
    (out_t * torch.tensor(tgt)).sum().backward()
    return out_j, g_j, out_t.detach(), [x.grad for x in ts]


@pytest.mark.parametrize("shape", [(1, 16, 2, 1, 8),
                                   (2, 33, 6, 3, 8),      # padding
                                   (1, 40, 12, 2, 8)])    # 6:1 groups
def test_flash_matches_reference_fwd_and_grads(shape):
    out_j, g_j, out_t, g_t = _both(shape, dict(dms_window=4))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)
    for name, a, b in zip("q k v alpha".split(), g_t, g_j):
        assert _rel(a.numpy(), b) < GRAD_REL, name


@pytest.mark.parametrize("window,cap", [(16, None), (None, 30.0), (8, 50.0)])
def test_flash_window_softcap_matches_reference(window, cap):
    out_j, g_j, out_t, g_t = _both((2, 48, 4, 2, 16),
                                   dict(dms_window=4, window=window,
                                        logit_cap=cap))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)
    for name, a, b in zip("q k v alpha".split(), g_t, g_j):
        assert _rel(a.numpy(), b) < GRAD_REL, name


def test_flash_vanilla_matches_reference():
    out_j, g_j, out_t, g_t = _both((2, 32, 4, 2, 16), {}, alpha=False)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)
    for name, a, b in zip("q k v".split(), g_t, g_j):
        assert _rel(a.numpy(), b) < GRAD_REL, name


@pytest.mark.parametrize("alpha", [False, True], ids=["vanilla", "dms"])
def test_flash_noncausal_matches_reference(alpha):
    """``causal=False`` (the encoder's bidirectional attention) at T 33,
    off the 16-key blocks: the padded keys are hidden by the key-padding
    mask alone.  Output and gradients against the reference's Pallas
    kernels; vanilla is what the encoder runs (no α, log-survival 0)."""
    kw = dict(causal=False, **(dict(dms_window=4) if alpha else {}))
    out_j, g_j, out_t, g_t = _both((2, 33, 4, 4, 16), kw, alpha=alpha)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)
    for name, a, b in zip("q k v alpha".split(), g_t, g_j):
        assert _rel(a.numpy(), b) < GRAD_REL, name


def test_flash_bf16_matches_reference():
    q, k, v, a, _ = _inputs((2, 48, 4, 2, 16), seed=3)
    out_j = jops.dms_flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), a, dms_window=4,
        **JBLOCKS)
    out_t = ops.dms_flash_attention(
        *(torch.tensor(x).bfloat16() for x in (q, k, v)), torch.tensor(a),
        dms_window=4, **TBLOCKS)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), **BF16)


def test_flash_prefill_skip_blocks_matches_reference():
    """Binarised α with dead-block skipping: exact against the reference's
    prefill entry and its dense oracle."""
    b, t, hq, hkv, dh = 1, 64, 2, 1, 8
    q, k, v, _, _ = _inputs((b, t, hq, hkv, dh))
    alpha_bin = np.zeros((b, hkv, t), bool)
    alpha_bin[:, :, 4:40] = True
    out_j = jops.dms_flash_attention_prefill(q, k, v, alpha_bin, dms_window=8,
                                             **JBLOCKS)
    out_t = ops.dms_flash_attention_prefill(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(alpha_bin), dms_window=8, **TBLOCKS)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)
    with np.errstate(divide="ignore"):
        ls = np.maximum(np.log1p(-alpha_bin.astype(np.float32)), -1e30)
    oracle = tref.dms_attention_plain(torch.tensor(q), torch.tensor(k),
                                      torch.tensor(v), torch.tensor(ls),
                                      dms_window=8)
    np.testing.assert_allclose(out_t.numpy(), oracle.numpy(), **F32)


@pytest.mark.parametrize("skip,window,cap,t", [(False, None, None, 40),
                                               (True, 16, 30.0, 45)])
def test_plain_versions_match_reference_kernels(skip, window, cap, t):
    """Each plain version against its Pallas kernel (interpret mode) on the
    same folded operands: out and lse; dq; dk, dv and d(log_surv)."""
    _plain_vs_reference_kernels(skip, window, cap, t)


@pytest.mark.parametrize("delay,hkv,t", [(0, 4, 45), (4, 2, 40)],
                         ids=["vanilla-G1-T45", "dms-G2-T40"])
def test_plain_versions_match_reference_kernels_noncausal(delay, hkv, t):
    """``causal=False``, T off the 16-row block: the encoder's vanilla case
    (no DMS mask, log-survival 0 on the padded keys too, as the wrapper
    pads it, G 1) and a DMS case; each plain version against its Pallas
    kernel in interpret mode."""
    _plain_vs_reference_kernels(False, None, None, t, causal=False,
                                delay=delay, hkv=hkv)


def _plain_vs_reference_kernels(skip, window, cap, t, causal=True, delay=4,
                                hkv=2):
    b, hq, dh, bq = 2, 4, 16, 16
    q, k, v, a, do = _inputs((b, t, hq, hkv, dh), seed=1, binary=skip)
    tp = -(-t // bq) * bq
    kw = dict(t=t, orig_dh=dh, hq=hq, hkv=hkv, window=window, dms_delay=delay,
              causal=causal, logit_cap=cap, block_k=bq, skip_blocks=skip)
    jcfg = jkern.FlashConfig(interpret=True, block_q=bq, **kw)
    tcfg = tref.FlashConfig(**kw)

    def fold(x):
        x = x.transpose(0, 2, 1, 3).reshape(-1, t, x.shape[-1])
        return np.pad(x, ((0, 0), (0, tp - t), (0, 0)))

    qf, kf, vf, dof = fold(q), fold(k), fold(v), fold(do)
    if delay:
        with np.errstate(divide="ignore"):
            ls = np.maximum(np.log1p(-a), -1e30)
        ls = np.pad(ls.reshape(b * hkv, t), ((0, 0), (0, tp - t)),
                    constant_values=-1e30)
    else:                       # vanilla: the wrapper's zeros, padding too
        ls = np.zeros((b * hkv, tp), np.float32)
    hr_j, remap_j = jops._prep_tables(jnp.asarray(ls), jcfg)
    hr_t = ops.prep_tables(torch.tensor(ls), tcfg)
    if skip:
        np.testing.assert_array_equal(hr_t.numpy(), np.asarray(hr_j))
    else:                           # the kernels read hr only when skipping
        assert hr_t is None

    out_j, lse_j = jkern.flash_fwd(qf, kf, vf, ls, hr_j, remap_j, jcfg)
    delta = np.sum(dof * np.asarray(out_j), axis=-1)
    dq_j = jkern.flash_dq(qf, kf, vf, ls, dof, lse_j, delta, hr_j, remap_j, jcfg)
    dk_j, dv_j, dls_j = jkern.flash_dkv(qf, kf, vf, ls, dof, lse_j, delta,
                                        hr_j, remap_j, jcfg)
    T = [torch.tensor(x) for x in (qf, kf, vf, ls, dof, np.asarray(lse_j), delta)]
    out_t, lse_t = tref.flash_fwd_plain(*T[:4], hr_t, tcfg)
    dq_t = tref.flash_dq_plain(*T, hr_t, tcfg)
    dk_t, dv_t, dls_t = tref.flash_dkv_plain(*T, hr_t, tcfg)
    for name, got, want in (("out", out_t[:, :t], np.asarray(out_j)[:, :t]),
                            ("lse", lse_t[:, :t], np.asarray(lse_j)[:, :t]),
                            ("dq", dq_t, dq_j), ("dk", dk_t, dk_j),
                            ("dv", dv_t, dv_j), ("dls", dls_t, dls_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dh", [8, 40, 72, 160, 256])
def test_head_dim_padding_matches_unpadded_and_reference(dh):
    """The bf16 kernels run at Dh 64, 128 or 256: the wrapper zero-pads q,
    k, v and dO (``pad_head_dim``) to the next of these and slices out, dk
    and dv back (256, gemma2's and recurrentgemma's, is not padded).  The
    plain versions on padded operands, sliced back, equal the unpadded
    plain versions and the reference's Pallas kernels (interpret mode) on
    the unpadded operands; the padded columns come out zero."""
    b, hq, hkv, t, bq = 1, 4, 2, 40, 16
    kdh = ops.tensor_core_dh(dh)
    assert kdh == (64 if dh <= 64 else 128 if dh <= 128 else 256)
    q, k, v, a, do = _inputs((b, t, hq, hkv, dh), seed=6)
    tp = -(-t // bq) * bq
    kw = dict(t=t, orig_dh=dh, hq=hq, hkv=hkv, window=None, dms_delay=4,
              causal=True, logit_cap=None, block_k=bq, skip_blocks=False)
    jcfg = jkern.FlashConfig(interpret=True, block_q=bq, **kw)
    tcfg = tref.FlashConfig(**kw)

    def fold(x):
        x = x.transpose(0, 2, 1, 3).reshape(-1, t, x.shape[-1])
        return np.pad(x, ((0, 0), (0, tp - t), (0, 0)))

    qf, kf, vf, dof = fold(q), fold(k), fold(v), fold(do)
    ls = np.pad(np.log1p(-a).reshape(b * hkv, t), ((0, 0), (0, tp - t)),
                constant_values=-1e30)
    hr_j, remap_j = jops._prep_tables(jnp.asarray(ls), jcfg)
    out_j, lse_j = jkern.flash_fwd(qf, kf, vf, ls, hr_j, remap_j, jcfg)
    delta = np.sum(dof * np.asarray(out_j), axis=-1)
    dk_j, dv_j, dls_j = jkern.flash_dkv(qf, kf, vf, ls, dof, lse_j, delta,
                                        hr_j, remap_j, jcfg)

    qt, kt, vt, dot = (torch.tensor(x) for x in (qf, kf, vf, dof))
    lst, lset, deltat = (torch.tensor(np.asarray(x)) for x in (ls, lse_j, delta))
    pq, pk, pv, pdo = (ops.pad_head_dim(x, kdh) for x in (qt, kt, vt, dot))
    assert pq.shape[-1] == kdh and pq.is_contiguous()
    out_p, lse_p = tref.flash_fwd_plain(pq, pk, pv, lst, None, tcfg)
    dk_p, dv_p, dls_p = tref.flash_dkv_plain(pq, pk, pv, lst, pdo, lset,
                                             deltat, None, tcfg)
    for x in (out_p, dk_p, dv_p):
        assert not x[..., dh:].any()
    out_u, lse_u = tref.flash_fwd_plain(qt, kt, vt, lst, None, tcfg)
    dk_u, dv_u, dls_u = tref.flash_dkv_plain(qt, kt, vt, lst, dot, lset,
                                             deltat, None, tcfg)
    for name, got, unpadded, want in (
            ("out", out_p[:, :t, :dh], out_u[:, :t], np.asarray(out_j)[:, :t]),
            ("lse", lse_p[:, :t], lse_u[:, :t], np.asarray(lse_j)[:, :t]),
            ("dk", dk_p[..., :dh], dk_u, dk_j), ("dv", dv_p[..., :dh], dv_u, dv_j),
            ("dls", dls_p, dls_u, dls_j)):
        np.testing.assert_allclose(got.numpy(), unpadded.numpy(), **F32,
                                   err_msg=name)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_dense_oracle_matches_reference_oracle():
    q, k, v, a, _ = _inputs((2, 20, 6, 2, 8), seed=2)
    ls = np.log1p(-a)
    for kw in (dict(dms_window=3), dict(dms_window=3, window=5, logit_cap=20.0),
               dict(dms_window=3, immediate=True)):
        want = jref.dms_attention_ref(q, k, v, ls, **kw)
        got = tref.dms_attention_plain(*(torch.tensor(x) for x in (q, k, v, ls)),
                                       **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_saturated_alpha_keeps_gradients_finite():
    """α = 1 exactly (a saturated Gumbel-sigmoid) is fully evicted, as in the
    reference, and its gradient is 0 — the reference's
    ``maximum(log1p(-α), -1e30)`` passes NaN back there."""
    q, k, v, a, tgt = _inputs((1, 24, 2, 1, 8), seed=4)
    a[0, 0, 3] = 1.0
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v, a)]
    out = ops.dms_flash_attention(*ts, dms_window=4, **TBLOCKS)
    (out * torch.tensor(tgt)).sum().backward()
    assert all(bool(torch.isfinite(x.grad).all()) for x in ts)
    assert ts[3].grad[0, 0, 3] == 0.0
    out_j = jops.dms_flash_attention(q, k, v, a, dms_window=4, **JBLOCKS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **F32)
    g_j = jax.grad(lambda a_: jnp.sum(jops.dms_flash_attention(
        q, k, v, a_, dms_window=4, **JBLOCKS) * tgt))(a)
    assert np.isnan(np.asarray(g_j)[0, 0, 3])


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    q, k, v, a, _ = _inputs((1, 16, 2, 1, 8))
    before = dict(ops.launches)
    ops.dms_flash_attention(*(torch.tensor(x) for x in (q, k, v, a)),
                            dms_window=4)
    assert ops.launches == before
    meta = torch.empty((2, 16, 8), device="meta")
    cfg = tref.FlashConfig(t=16, orig_dh=8, hq=2, hkv=1, window=None,
                           dms_delay=4, causal=True, logit_cap=None,
                           block_k=16, skip_blocks=False)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_fwd(meta, meta[:1], meta[:1], meta[:1, :, 0],
                      meta[:1, :1, 0].int(), cfg)
