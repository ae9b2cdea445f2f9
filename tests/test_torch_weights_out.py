"""The decode kernel's weights-out mode on the port against the reference.

(a) The raw outputs: the port's plain version of the mode (``ref.
    dms_decode_plain_weights``, what the CUDA kernel computes) against the
    Pallas ``decode_fwd(weights_out=True)`` in interpret mode, on
    fragmented tables in both layouts (fixed arenas, shared pool): the
    output, ``w_blk`` and ``m_blk`` of every listed entry (entries ``>= n``
    are unwritten on both sides), ``m_out`` and ``l_out``.
(b) The weights a policy gets: the port's ``_masked_decode(need_weights=
    True)`` with the kernel (the wrapper's rescale and scatter) and with the
    reference softmax, against the reference's ``_masked_decode`` with
    either ``use_kernel``, on specs that TOVA, H2O and Keyformer caches
    built over a random trace — fp32 and bf16, fixed and paged.
(c) Window layers: slots older than the window get exactly zero weight.
(d) The wrapper never trusts what the kernel leaves unwritten.
(e) The kernel's split of a row's table over a cluster, in its plain
    version (``ref.dms_decode_plain_split``), against the unsplit Pallas
    kernel in interpret mode.

Tolerances are the reference suite's (``tests/test_block_tables.py``):
2e-5 in fp32 and 2e-2 in bf16; weights on invisible slots are exactly 0.
The CUDA kernel itself is held against the plain version in
``tests/test_torch_cuda.py`` (card only).
"""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core.config import KVPolicyConfig as JKV
from repro.kernels.dms_decode.dms_decode import DecodeConfig, decode_fwd
from repro.models.attention import _masked_decode as j_masked_decode
from repro_torch import bridge
from repro_torch.core import block_pool as tbp
from repro_torch.core.policy import AttendSpec
from repro_torch.kernels.dms_decode import ops as tops
from repro_torch.models.attention import _masked_decode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import WEIGHTS_TOL  # noqa: E402  the kernel checks' tolerance

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BP = 8
KINDS = ["tova", "h2o", "keyformer"]


def _t(x, dtype=None):
    """A JAX or numpy array as a torch tensor (bf16 through fp32: exact)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(dtype)


def _f(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# -- (a) raw outputs against Pallas in interpret mode --------------------------


def _raw_operands(seed, shared, bh=5, g=3, dh=16, nb=6, bp=BP):
    """Fragmented tables over random operands.  Row 0 lists no block; row 2
    lists half of its live blocks; row 1's first listed block has every
    slot hidden; table tails past n name other blocks.  K/V of everything
    the table does not list is NaN.  Shared: the listed blocks' pages lie
    shuffled in a pool twice the size needed, and ``valid`` is in table
    order.  Returns numpy (q, k, v, valid, tbl, n)."""
    r = np.random.default_rng(seed)
    valid = r.random((bh, nb * bp)) < 0.6
    live = valid.reshape(bh, nb, bp).any(-1)
    tbl = np.zeros((bh, nb), np.int32)
    n = np.zeros((bh,), np.int32)
    for row in range(bh):
        ids = r.permutation(np.flatnonzero(live[row]))
        listed = ids[:0] if row == 0 else ids[::2] if row == 2 else ids
        assert row != 1 or len(listed) >= 2
        n[row] = len(listed)
        rest = [b for b in range(nb) if b not in set(listed.tolist())]
        tbl[row] = np.concatenate([listed, rest])
    first = tbl[1, 0]
    valid[1, first * bp:(first + 1) * bp] = False        # listed, all hidden
    q = r.normal(size=(bh, g, dh)).astype(np.float32)
    if not shared:
        k = r.normal(size=(bh, nb * bp, dh)).astype(np.float32)
        v = r.normal(size=(bh, nb * bp, dh)).astype(np.float32)
        listed = np.zeros((bh, nb), bool)
        for row in range(bh):
            listed[row, tbl[row, :n[row]]] = True
        dead = ~np.repeat(listed, bp, axis=1)
        k[dead] = np.nan
        v[dead] = np.nan
        return q, k, v, valid, tbl, n
    need = int(n.sum())
    npool = 2 * need
    pages = iter(r.permutation(npool).tolist())
    ptbl = np.zeros((bh, nb), np.int32)
    for row in range(bh):
        for i in range(n[row]):
            ptbl[row, i] = next(pages)
        ptbl[row, n[row]:] = r.integers(0, npool, nb - n[row])   # stale
    pk = np.full((npool, bp, dh), np.nan, np.float32)
    pv = np.full((npool, bp, dh), np.nan, np.float32)
    for row in range(bh):
        for i in range(n[row]):
            pk[ptbl[row, i]] = r.normal(size=(bp, dh))
            pv[ptbl[row, i]] = r.normal(size=(bp, dh))
    valid_tbl = np.take_along_axis(valid.reshape(bh, nb, bp),
                                   tbl[..., None], axis=1).reshape(bh, -1)
    return (q, pk.reshape(1, npool * bp, dh), pv.reshape(1, npool * bp, dh),
            valid_tbl, ptbl, n)


@pytest.mark.parametrize("shared", [False, True], ids=["fixed", "shared"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_raw_outputs_match_pallas_interpret(shared, dtype, cap):
    q, k, v, valid, tbl, n = _raw_operands(3 + shared, shared)
    bh, g, dh = q.shape
    cfg = DecodeConfig(orig_dh=dh, g=g, block_p=BP, logit_cap=cap,
                       interpret=True, shared_kv=shared, weights_out=True)
    jdt = jnp.dtype(dtype)
    got_j = decode_fwd(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                       jnp.asarray(v, jdt), jnp.asarray(valid),
                       jnp.asarray(tbl), jnp.asarray(n), cfg)
    tdt = getattr(torch, dtype)
    got_t = tops.decode_rows(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(valid),
                             _t(tbl), _t(n), BP, cap, shared_kv=shared,
                             need_weights=True)
    out_j, w_j, mb_j, mo_j, lo_j = (np.asarray(x, np.float32) for x in got_j)
    out_t, w_t, mb_t, mo_t, lo_t = (_f(x) for x in got_t)
    assert w_t.shape == w_j.shape == (bh, tbl.shape[1], g, BP)
    assert mb_t.shape == mb_j.shape and mo_t.shape == lo_t.shape == (bh, g)
    tol = TOL[dtype]
    np.testing.assert_allclose(out_t, out_j, **tol)
    for row in range(bh):
        np.testing.assert_allclose(w_t[row, :n[row]], w_j[row, :n[row]], **tol)
        np.testing.assert_allclose(mb_t[row, :n[row]], mb_j[row, :n[row]],
                                   **tol)
    np.testing.assert_allclose(mo_t, mo_j, **tol)
    np.testing.assert_allclose(lo_t, lo_j, **tol)
    # n = 0: no weight, an empty denominator, the initial max
    assert not w_t[0].any() and not lo_t[0].any() and (mo_t[0] == -1e30).all()
    # the all-hidden listed block emits zeros (not exp(-1e30 + 1e30) = 1)
    assert not w_t[1, 0].any() and not w_j[1, 0].any()
    # m_blk is a running max in table order
    for row in range(bh):
        assert (np.diff(mb_t[row, :n[row]], axis=0) >= 0).all()


@functools.lru_cache(maxsize=None)
def _pallas_raw(shared):
    """Operands with several table entries a row, row 0 with n = 0, and the
    Pallas kernel's weights-out outputs on them (interpret mode, fp32)."""
    ops_np = _raw_operands(11 + shared, shared)
    q, k, v, valid, tbl, n = ops_np
    cfg = DecodeConfig(orig_dh=q.shape[2], g=q.shape[1], block_p=BP,
                       logit_cap=None, interpret=True, shared_kv=shared,
                       weights_out=True)
    got = decode_fwd(*(jnp.asarray(x) for x in ops_np), cfg)
    return ops_np, tuple(np.asarray(x, np.float32) for x in got)


@pytest.mark.parametrize("shared", [False, True], ids=["fixed", "shared"])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_arithmetic_matches_pallas_interpret(shared, splits):
    """``dms_decode_plain_split``, the kernel's arithmetic when it splits a
    row's table over a cluster (contiguous ranges of the n listed entries,
    a log-sum-exp combine, the weights-out entries rewritten to the row's
    running max in table order), against the unsplit Pallas
    ``decode_fwd(weights_out=True)`` in interpret mode: the output and
    every raw output within chip_smoke.py's WEIGHTS_TOL.  At 3 and 8 splits
    some ranges are empty (rows list at most 6 entries; row 0 none)."""
    from repro_torch.kernels.dms_decode.ref import dms_decode_plain_split
    (q, k, v, valid, tbl, n), want = _pallas_raw(shared)
    args = [_t(x) for x in (q, k, v, valid, tbl, n)]
    got = [_f(x) for x in dms_decode_plain_split(
        *args, BP, shared_kv=shared, splits=splits, need_weights=True)]
    out = _f(dms_decode_plain_split(*args, BP, shared_kv=shared,
                                    splits=splits))
    np.testing.assert_array_equal(out, got[0])
    np.testing.assert_allclose(got[0], want[0], **WEIGHTS_TOL)
    for row in range(q.shape[0]):
        for i in (1, 2):
            np.testing.assert_allclose(got[i][row, :n[row]],
                                       want[i][row, :n[row]], **WEIGHTS_TOL)
    np.testing.assert_allclose(got[3], want[3], **WEIGHTS_TOL)
    np.testing.assert_allclose(got[4], want[4], **WEIGHTS_TOL)
    assert n[0] == 0 and not got[1][0].any() and (got[3][0] == -1e30).all()


def test_raw_outputs_same_in_both_layouts():
    """The shared-pool layout on the same logical contents in the same
    table order gives the fixed layout's raw outputs bit for bit."""
    q, k, v, valid, tbl, n = _raw_operands(5, False)
    bh, nbp, dh = k.shape
    nb = nbp // BP
    pages = np.arange(bh * nb).reshape(bh, nb)
    ptbl = np.take_along_axis(pages, tbl, axis=1).astype(np.int32)
    valid_tbl = np.take_along_axis(valid.reshape(bh, nb, BP), tbl[..., None],
                                   axis=1).reshape(bh, -1)
    fixed = tops.decode_rows(_t(q), _t(k), _t(v), _t(valid), _t(tbl), _t(n),
                             BP, need_weights=True)
    shared = tops.decode_rows(_t(q), _t(k).reshape(1, -1, dh),
                              _t(v).reshape(1, -1, dh), _t(valid_tbl),
                              _t(ptbl), _t(n), BP, shared_kv=True,
                              need_weights=True)
    for a, b in zip(fixed, shared):
        assert torch.equal(a, b)


# -- (b) the weights a policy gets ---------------------------------------------


def _policy_spec(tiny_arch, kind, steps, dtype, paged=False, batch=2,
                 max_len=40):
    """A reference policy cache fragmented by a random decode trace (as
    ``tests/test_block_tables.py`` builds one); returns (reference spec, q,
    reference attention config, port attention config)."""
    arch = dataclasses.replace(tiny_arch, dtype=dtype)
    cfg = JKV(kind=kind, cr=2.0, window=arch.dms.window, block_p=BP,
              paged=paged)
    pc = jpolicy.init_policy_cache(arch, batch, max_len, cfg)
    pol = jpolicy.get_policy(pc.policy)
    a = arch.attn
    dt = jnp.dtype(dtype)
    key = jax.random.PRNGKey(17)
    cache = pc.cache
    for i in range(steps):
        key, k1, k2, k3, k4 = jax.random.split(key, 5)
        q = jax.random.normal(k1, (batch, 1, a.num_heads, a.head_dim), dt)
        k_new = jax.random.normal(k2, (batch, a.num_kv_heads, 1, a.head_dim), dt)
        v_new = jax.random.normal(k3, (batch, a.num_kv_heads, 1, a.head_dim), dt)
        aux = {"alpha_bin": None, "pos_t": jnp.full((batch,), i, jnp.int32),
               "attn_cfg": a, "arch": arch, "dtype": dt,
               "layer_salt": jnp.uint32(0x80000001)}
        cache, spec = pol.decode_update(cache, q, k_new, v_new, aux)
        w = jax.random.uniform(k4, spec.visible.shape, jnp.float32)
        cache = pol.post_attend(cache, jnp.where(spec.visible, w, 0.0))
    assert spec.needs_weights
    tarch = bridge.arch_from_dict(dataclasses.asdict(arch))
    return spec, q, a, tarch.attn


def _port_spec(js):
    """The reference's AttendSpec as the port's (same contents)."""
    kw = dict(positions=_t(js.positions), needs_weights=js.needs_weights,
              block_tbl=_t(js.block_tbl), block_n=_t(js.block_n),
              block_p=js.block_p)
    if js.pool_k is None:
        return AttendSpec(_t(js.k), _t(js.v), _t(js.visible), **kw)
    pk, pv = _t(js.pool_k), _t(js.pool_v)
    dump = torch.zeros((1,) + tuple(pk.shape[1:]), dtype=pk.dtype)
    pool = tbp.BlockPool.init(pk.shape[0], pk.shape[1], pk.shape[2], pk.dtype)
    pool = dataclasses.replace(pool, k_buf=torch.cat([pk, dump]),
                               v_buf=torch.cat([pv, dump]))
    return AttendSpec(None, None, _t(js.visible), pool=pool,
                      phys=_t(js.phys), **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_masked_decode_weights_match_reference(tiny_arch, kind, dtype, paged):
    js, q, jcfg, tcfg = _policy_spec(tiny_arch, kind, 18, dtype, paged)
    assert js.block_tbl is not None
    ts = _port_spec(js)
    tq = _t(q)
    tol = TOL[dtype]
    dead = ~np.asarray(js.visible)
    want = {}
    for use_kernel in (True, False):
        out, w, impl = j_masked_decode(q, js, None, jcfg, use_kernel,
                                       need_weights=True)
        want[use_kernel] = (np.asarray(out, np.float32), np.asarray(w))
    for use_kernel in (True, False):
        out, w, impl = _masked_decode(tq, ts, None, tcfg, use_kernel,
                                      need_weights=True)
        assert impl == ("kernel" if use_kernel else "ref")
        assert w.dtype == torch.float32 and w.shape == ts.visible.shape
        assert not _f(w)[dead].any(), "weight on an invisible slot"
        for ref in want.values():
            np.testing.assert_allclose(_f(out), ref[0], **tol)
            np.testing.assert_allclose(_f(w), ref[1], **tol)
    # without weights, the same output and no weights
    out_n, w_n, _ = _masked_decode(tq, ts, None, tcfg, True)
    assert w_n is None
    np.testing.assert_allclose(_f(out_n), want[True][0], **tol)


# -- (c) window layers ------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_window_layer_masking(tiny_arch, kind):
    """As ``test_policy_window_layer_masking``: slots older than ``pos_t -
    window`` get exactly zero weight on both paths, the newest slot keeps
    the row alive, and both paths equal the reference's."""
    steps, window = 12, 4
    js, q, jcfg, tcfg = _policy_spec(tiny_arch, kind, steps, "float32")
    ts = _port_spec(js)
    b = q.shape[0]
    jpos = jnp.full((b,), steps - 1, jnp.int32)
    tpos = torch.full((b,), steps - 1, dtype=torch.int32)
    pos = np.asarray(js.positions)
    old = pos <= (steps - 1 - window)
    assert old[np.asarray(js.visible)].any(), "the window hides nothing"
    for use_kernel in (False, True):
        _, wj, _ = j_masked_decode(q, js, window, jcfg, use_kernel, jpos,
                                   need_weights=True)
        _, w, _ = _masked_decode(_t(q), ts, window, tcfg, use_kernel, tpos,
                                 need_weights=True)
        w = _f(w)
        assert not w[old].any(), "weight on a slot beyond the window"
        assert (w.sum(axis=-1) > 0.5).all(), "the window hid every slot"
        np.testing.assert_allclose(w, np.asarray(wj), **TOL["float32"])


# -- (d) unwritten entries and empty rows --------------------------------------


def test_rescale_ignores_unwritten_entries():
    """Entries ``>= n`` of ``w_blk``/``m_blk`` hold whatever ``torch.empty``
    left (here NaN, inf and huge values): the weights come out exactly as
    from clean entries, an n = 0 row and a row whose listed slots are all
    hidden give zeros, and no weight lands outside its logical block."""
    q, k, v, valid, tbl, n = _raw_operands(11, False)
    res = tops.decode_rows(_t(q), _t(k), _t(v), _t(valid), _t(tbl), _t(n),
                           BP, need_weights=True)
    _, w_blk, m_blk, m_out, l_out = res
    nb = tbl.shape[1]
    clean = tops.table_weights_to_arena(w_blk, m_blk, m_out, l_out, _t(n),
                                        _t(tbl), nb)
    tail = torch.arange(nb)[None, :] >= _t(n)[:, None]
    junk = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e38])
    w_bad = w_blk.clone()
    m_bad = m_blk.clone()
    w_bad[tail] = junk[torch.arange(int(tail.sum())) % 4][:, None, None]
    m_bad[tail] = junk[(torch.arange(int(tail.sum())) + 1) % 4][:, None]
    dirty = tops.table_weights_to_arena(w_bad, m_bad, m_out, l_out, _t(n),
                                        _t(tbl), nb)
    assert torch.isfinite(dirty).all()
    assert torch.equal(dirty, clean)
    assert not dirty[0].any()                            # n = 0
    # each row's weights: only on visible slots of listed blocks, summing
    # to G (every listed slot hidden: 0)
    listed = torch.zeros((q.shape[0], nb), dtype=torch.bool)
    for row in range(q.shape[0]):
        listed[row, tbl[row, :n[row]]] = True
    seen = _t(valid) & listed.repeat_interleave(BP, dim=1)
    assert not dirty[~seen].any()
    g = q.shape[1]
    sums = dirty.sum(dim=-1)
    for row in range(q.shape[0]):
        want = g if seen[row].any() else 0.0
        assert float(sums[row]) == pytest.approx(want, rel=1e-5), row


def test_zero_weights_where_every_listed_slot_is_hidden():
    """A row whose listed slots the visibility mask hides entirely (a
    window past every slot) gets all-zero weights from the kernel path —
    the reference softmax gives a uniform row there instead, by design
    (``docs/kernels.md``, "edge case")."""
    b, hkv, g, dh, p = 1, 2, 3, 16, 16
    r = np.random.default_rng(2)
    q = _t(r.normal(size=(b, 1, hkv * g, dh)).astype(np.float32))
    k = _t(r.normal(size=(b, hkv, p, dh)).astype(np.float32))
    vis = torch.zeros((b, hkv, p), dtype=torch.bool)
    vis[0, 1, 3] = True
    tbl = torch.tensor([[[1, 0], [0, 1]]], dtype=torch.int32)
    n = torch.tensor([[1, 1]], dtype=torch.int32)
    out, w = tops.dms_decode_attention(q, k, k, vis, block_tbl=tbl, block_n=n,
                                       block_p=BP, need_weights=True)
    assert torch.isfinite(out).all() and torch.isfinite(w).all()
    assert not out[0, 0, :g].any() and not w[0, 0].any()
    assert float(w[0, 1, 3]) == pytest.approx(g)
    assert float(w[0, 1].sum()) == pytest.approx(g)
