"""The block-table flash-decode kernel of the port against the reference's
Pallas kernel (``repro.kernels.dms_decode.ops``, interpret mode on the CPU).

On the CPU the port's wrapper runs the kernel's plain version
(``kernels/dms_decode/ref.py``), which computes the kernel's function: the
listed blocks' visible slots only, and zeros for a row with no listed block.
The same numpy inputs go through both; shapes follow
``tests/test_kernels.py``.  fp32 at rtol 1e-4 / atol 1e-5 (both are fp32
online-vs-dense softmaxes: they differ only in summation order); bf16 at the
reference suite's 2e-2, since each side rounds its output to bf16.

The CUDA kernel itself is held against the plain version in
``tests/test_torch_cuda.py`` (card only).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.kv_cache import BlockTable as JBlockTable
from repro.kernels.dms_decode import ops as jops
from repro_torch.kernels.dms_decode import ops as tops

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
BP = 16


def _inputs(shape, seed, density=0.6):
    b, hq, hkv, p, dh = shape
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, 1, hq, dh)).astype(np.float32)
    k = r.normal(size=(b, hkv, p, dh)).astype(np.float32)
    v = r.normal(size=(b, hkv, p, dh)).astype(np.float32)
    valid = r.random((b, hkv, p)) < density
    valid[:, :, 0] = True
    return q, k, v, valid


def _both(q, k, v, valid, dtype, **table):
    """Run the reference kernel and the port's wrapper on the same inputs."""
    jt = {k_: (jnp.asarray(x) if hasattr(x, "shape") else x)
          for k_, x in table.items()}
    out_j = jops.dms_decode_attention(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(valid), **jt)
    tdt = getattr(torch, dtype)
    tt = {k_: (torch.from_numpy(np.array(x)) if hasattr(x, "shape") else x)
          for k_, x in table.items()}
    out_t = tops.dms_decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(valid), **tt)
    assert out_t.dtype == tdt and tuple(out_t.shape) == q.shape
    return out_t.float().numpy(), np.asarray(out_j, np.float32)


@pytest.mark.parametrize("shape", [(2, 4, 2, 40, 16), (1, 8, 1, 23, 16),
                                   (2, 12, 2, 19, 8), (1, 16, 2, 37, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_mode_matches_reference_kernel(shape, dtype):
    """Legacy dense mode: the table is derived from ``valid`` (odd P pads)."""
    out_t, out_j = _both(*_inputs(shape, seed=1), dtype, block_p=BP)
    np.testing.assert_allclose(out_t, out_j, **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("shape", [(2, 4, 2, 64, 16), (2, 12, 2, 32, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_table_mode_matches_reference_kernel(shape, dtype):
    """Block-table mode on a fragmented arena with the canonical table."""
    q, k, v, valid = _inputs(shape, seed=4, density=0.4)
    bt = JBlockTable.from_valid(jnp.asarray(valid), BP)
    out_t, out_j = _both(q, k, v, valid, dtype, block_tbl=np.asarray(bt.tbl),
                         block_n=np.asarray(bt.n), block_p=BP)
    np.testing.assert_allclose(out_t, out_j, **(F32 if dtype == "float32" else BF16))


def test_partial_table_attends_only_listed_blocks():
    """A table listing only some live blocks (every other block): only the
    listed blocks' slots count, as in the reference's page-sparse test."""
    b, hq, hkv, p, dh = 1, 4, 2, 64, 16
    q, k, v, _ = _inputs((b, hq, hkv, p, dh), seed=6)
    vis = np.ones((b, hkv, p), bool)
    listed = np.zeros((b, hkv, p // BP), bool)
    listed[:, :, ::2] = True
    tbl = np.zeros((b, hkv, p // BP), np.int32)
    tbl[:, :, :2] = [0, 2]
    n = np.full((b, hkv), 2, np.int32)
    out_t, out_j = _both(q, k, v, vis, "float32", block_tbl=tbl, block_n=n,
                         block_p=BP)
    np.testing.assert_allclose(out_t, out_j, **F32)
    # == dense attention over the listed blocks' slots only
    out_d, _ = _both(q, k, v, np.repeat(listed, BP, axis=2), "float32",
                     block_p=BP)
    np.testing.assert_allclose(out_t, out_d, **F32)


def test_single_live_block_far_into_the_arena():
    b, hq, hkv, p, dh = 1, 2, 1, 64, 8
    q, k, v, _ = _inputs((b, hq, hkv, p, dh), seed=3)
    valid = np.zeros((b, hkv, p), bool)
    valid[:, :, 50] = True
    bt = JBlockTable.from_valid(jnp.asarray(valid), BP)
    out_t, out_j = _both(q, k, v, valid, "float32", block_tbl=np.asarray(bt.tbl),
                         block_n=np.asarray(bt.n), block_p=BP)
    np.testing.assert_allclose(out_t, out_j, **F32)
    np.testing.assert_allclose(out_t[0, 0, 0], v[0, 0, 50], rtol=1e-5, atol=1e-6)


def test_empty_row_gives_zeros():
    """n = 0 on one (lane, head): the kernel's function is zeros (the dense
    reference oracle would give a uniform row instead)."""
    b, hq, hkv, p, dh = 2, 4, 2, 32, 16
    q, k, v, valid = _inputs((b, hq, hkv, p, dh), seed=8)
    bt = JBlockTable.from_valid(jnp.asarray(valid), BP)
    n = np.asarray(bt.n).copy()
    n[1, 0] = 0
    out_t, out_j = _both(q, k, v, valid, "float32", block_tbl=np.asarray(bt.tbl),
                         block_n=n, block_p=BP)
    np.testing.assert_allclose(out_t, out_j, **F32)
    assert not out_t[1, 0, :2].any()          # query heads of kv head 0, lane 1


def test_unpadded_arena_and_bad_shapes_raise():
    b, hkv, p, dh = 1, 1, 20, 8
    q = torch.zeros((b, 1, 2, dh))
    k = torch.zeros((b, hkv, p, dh))
    valid = torch.ones((b, hkv, p), dtype=torch.bool)
    with pytest.raises(ValueError, match="not a multiple"):
        tops.dms_decode_attention(
            q, k, k, valid, block_tbl=torch.zeros((b, hkv, 2), dtype=torch.int32),
            block_n=torch.ones((b, hkv), dtype=torch.int32), block_p=16)
    with pytest.raises(ValueError, match="valid must be"):
        tops.dms_decode_attention(q, k, k, valid[..., :4])
    with pytest.raises(ValueError, match="q must be"):
        tops.dms_decode_attention(q[:, 0], k, k, valid)


def test_cpu_path_never_counts_a_launch():
    before = tops.launches
    q, k, v, valid = _inputs((1, 4, 2, 32, 16), seed=9)
    tops.dms_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(valid),
                              block_p=BP)
    assert tops.launches == before



@pytest.mark.parametrize("sms", [132, 114, 16])
def test_split_rule_fills_the_card(sms):
    """``ops.splits``: non-increasing in B*Hkv, never above NB_tbl or 16,
    never below 1; 16 splits for one row and fewer than 8 for 64 rows on a
    132-SM card."""
    for nb in (0, 1, 3, 20, 129, 257):
        got = [tops.splits(nb, bh, sms) for bh in range(1, 300)]
        assert all(1 <= s <= min(max(nb, 1), tops.MAX_SPLITS) for s in got)
        assert all(a >= b for a, b in zip(got, got[1:]))
    if sms == 132:
        assert tops.splits(129, 1, sms) == 16 and tops.splits(20, 64, sms) < 8


@pytest.mark.parametrize("bh,g,dh,nb", [(1, 10, 64, 40), (4, 16, 32, 21),
                                        (64, 1, 16, 5), (16, 2, 32, 9)])
def test_plain_split_at_the_rule_matches_unsplit(bh, g, dh, nb):
    """The plain version of the kernel's split (``dms_decode_plain_split``)
    at the split count ``ops.splits`` picks on a 132-SM card equals the
    unsplit plain version on a seeded arena: rows of n = 0, 1 and NB_tbl,
    tables in shuffled order, NaN in every unlisted block."""
    from repro_torch.kernels.dms_decode.ref import (dms_decode_plain,
                                                    dms_decode_plain_split)
    r = np.random.default_rng(bh * nb)
    p = nb * BP
    counts = [nb] * bh if bh < 3 else [0, 1, nb] + list(
        r.integers(0, nb + 1, bh - 3))
    tbl = np.stack([r.permutation(nb) for _ in range(bh)]).astype(np.int32)
    listed = np.zeros((bh, nb), bool)
    for row, c in enumerate(counts):
        listed[row, tbl[row, :c]] = True
    q = torch.tensor(r.normal(size=(bh, g, dh)), dtype=torch.float32)
    k = torch.tensor(r.normal(size=(bh, p, dh)), dtype=torch.float32)
    v = torch.tensor(r.normal(size=(bh, p, dh)), dtype=torch.float32)
    dead = torch.tensor(~listed.repeat(BP, axis=1))
    k[dead], v[dead] = float("nan"), float("nan")
    valid = torch.tensor(r.random((bh, p)) < 0.6)
    args = (q, k, v, valid, torch.tensor(tbl),
            torch.tensor(counts, dtype=torch.int32), BP)
    splits = tops.splits(nb, bh, 132)
    want = dms_decode_plain(*args)
    got = dms_decode_plain_split(*args, splits=splits)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
