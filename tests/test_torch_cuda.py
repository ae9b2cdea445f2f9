"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, and the decode-path auditor's card side
(the sync debug mode behind the host-sync tripwire, a kernel combo's
launch counters).  They carry the ``cuda`` marker and skip
where no GPU is present.  This file imports no JAX, so on a machine without
it they run alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.dms_decode import ops
from repro_torch.kernels.dms_decode.ref import dms_decode_plain

BP = 16
BF16 = dict(rtol=2e-2, atol=2e-2)   # each side rounds its output to bf16
# (G, Dh, P, cap) of gemma2-2b, chatglm3-6b, qwen2-vl-7b, granite-moe-3b,
# granite-moe-1b and recurrentgemma-2b at their served arenas,
# recurrentgemma's window ring, and seamless-m4t's decoder (G 1 at Dh 64)
FAMILY_SHAPES = [(2, 256, 352, 50.0), (16, 128, 336, None),
                 (7, 128, 336, None), (3, 64, 336, None), (2, 64, 336, None),
                 (10, 256, 352, None), (10, 256, 2064, None),
                 (1, 64, 352, None)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("g,dh,p,cap", [(6, 128, 416, None), (2, 16, 64, None),
                                        (16, 256, 64, None), (4, 64, 128, 30.0)]
                         + FAMILY_SHAPES)
def test_decode_kernel_matches_plain(cuda_device, g, dh, p, cap):
    """Random fragmented arenas with NaN in every unlisted block: a finite,
    equal output shows those blocks are never read.  Rows 0 and 3 list no
    block and must come out zero.  Also each served family's (G, Dh, cap):
    gemma2's G 2 at Dh 256 with the softcap 50 (its one-stage ring),
    chatglm3's G 16 (the kernel's largest), qwen2-vl's G 7, granite's G 3
    and G 2 at Dh 64, recurrentgemma's G 10 at Dh 256 (its arena and its
    2049-slot window ring), seamless's G 1 at Dh 64 (the fewest query rows
    a block)."""
    gen = torch.Generator(device=cuda_device).manual_seed(g * dh)
    bh = 8
    q = torch.randn((bh, g, dh), generator=gen, device=cuda_device).bfloat16()
    k = torch.randn((bh, p, dh), generator=gen, device=cuda_device).bfloat16()
    v = torch.randn((bh, p, dh), generator=gen, device=cuda_device).bfloat16()
    valid = torch.rand((bh, p), generator=gen, device=cuda_device) < 0.5
    live = valid.reshape(bh, p // BP, BP).any(-1)
    live[:, 1::3] = False                              # unlisted, poisoned
    live[[0, 3]] = False
    tbl = torch.argsort((~live).to(torch.int8), dim=-1, stable=True).int()
    n = live.sum(-1).int()
    dead = ~live.repeat_interleave(BP, dim=1)
    k[dead] = float("nan")
    v[dead] = float("nan")
    before = ops.launches
    out = ops.decode_rows(q, k, v, valid, tbl, n, BP, cap)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    ref = dms_decode_plain(q, k, v, valid, tbl, n, BP, cap)
    assert torch.isfinite(out.float()).all()
    assert not out[[0, 3]].float().abs().any()
    torch.testing.assert_close(out.float(), ref.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("g,dh,p,block_p", [(4, 256, 512, None), (3, 64, 60, 6)],
                         ids=["one ring stage", "valid read by bytes"])
def test_decode_dense_mode_edges(cuda_device, g, dh, p, block_p):
    """The legacy dense mode on the card against the same wrapper on the
    CPU: 128-slot blocks at Dh 256 leave room for one ring stage only, and
    6-slot blocks put entries' ``valid`` flags off 4-byte boundaries, so
    the kernel stages them byte by byte."""
    gen = torch.Generator().manual_seed(p)
    b, hkv = 2, 2
    q = torch.randn((b, 1, hkv * g, dh), generator=gen).bfloat16()
    k = torch.randn((b, hkv, p, dh), generator=gen).bfloat16()
    v = torch.randn((b, hkv, p, dh), generator=gen).bfloat16()
    valid = torch.rand((b, hkv, p), generator=gen) < 0.5
    valid[0, 1] = False                               # a row with n = 0
    want = ops.dms_decode_attention(q, k, v, valid, block_p=block_p)
    before = ops.launches
    got = ops.dms_decode_attention(*(x.to(cuda_device) for x in (q, k, v, valid)),
                                   block_p=block_p)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert torch.isfinite(got.float()).all() and not got[0, 0, g:2 * g].any()
    torch.testing.assert_close(got.cpu().float(), want.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [0, 200], ids=["all-frames", "tail-hidden"])
def test_decode_dense_mode_cross_shape(cuda_device, tail):
    """Seamless's cross-attention: the dense mode at B 4, Hkv 16, G 1, Dh
    64 over a 1024-frame encoder memory in the layout the decode step
    passes (K/V transposed views, the valid mask expanded over the heads),
    every frame visible or lane 1's last ``tail`` hidden (its last block
    dropped from the derived table, the one before it masked within).  One
    launch, within bf16 rounding of the same wrapper on the CPU."""
    gen = torch.Generator().manual_seed(1024 + tail)
    b, hkv, s, dh = 4, 16, 1024, 64
    q = torch.randn((b, 1, hkv, dh), generator=gen).bfloat16()
    ek, ev = (torch.randn((b, s, hkv, dh), generator=gen).bfloat16()
              for _ in range(2))
    valid = torch.ones((b, s), dtype=torch.bool)
    valid[1, s - tail:] = False
    args = (q, ek.transpose(1, 2), ev.transpose(1, 2),
            valid[:, None, :].expand(b, hkv, s))
    want = ops.dms_decode_attention(*args)
    before = ops.launches
    got = ops.dms_decode_attention(*(x.to(cuda_device) for x in args))
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.cpu().float(), want.float(), **BF16)


# (G, Dh): the main path's, then llama32-1b's, minitron-4b's, phi3-mini's
VANILLA_SHAPES = [(6, 128), (4, 64), (3, 128), (1, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("block_p", [16, 0], ids=["prefix table", "dense"])
@pytest.mark.parametrize("g,dh", VANILLA_SHAPES,
                         ids=[f"G{g}-Dh{d}" for g, d in VANILLA_SHAPES])
def test_decode_prefix_table_matches_plain(cuda_device, g, dh, block_p):
    """The vanilla cache's operands: a length prefix per lane, its table
    (every block from 0 to ceil(length / 16), from ``prefix_block_spec``)
    or no table at all (``block_p`` 0, the wrapper's legacy dense mode),
    and the lazy mask materialised.  Lengths 0, 1, a block edge and the
    full arena; on the card against the same call on the CPU."""
    from repro_torch.core.kv_cache import prefix_block_spec
    gen = torch.Generator().manual_seed(g * dh + block_p)
    b, hkv, p = 4, 2, 384
    q = torch.randn((b, 1, hkv * g, dh), generator=gen).bfloat16()
    k = torch.randn((b, hkv, p, dh), generator=gen).bfloat16()
    v = torch.randn((b, hkv, p, dh), generator=gen).bfloat16()
    length = torch.tensor([0, 1, 160, p], dtype=torch.int32)
    valid = (torch.arange(p) < length[:, None, None]).expand(b, hkv, p)
    valid = valid.contiguous()
    tbl, n = prefix_block_spec(length, p, block_p, hkv)
    kw = dict(block_tbl=tbl, block_n=n, block_p=block_p or None)
    want = ops.dms_decode_attention(q, k, v, valid, **kw)
    dev = {key: None if x is None else x.to(cuda_device)
           for key, x in kw.items() if key != "block_p"}
    before = ops.launches
    got = ops.dms_decode_attention(
        *(x.to(cuda_device) for x in (q, k, v, valid)),
        block_p=kw["block_p"], **dev)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert torch.isfinite(got.float()).all() and not got[0].float().any()
    torch.testing.assert_close(got.cpu().float(), want.float(), **BF16)


def _quest_operands(device, page, paged, g=6, dh=128, top=2):
    """Quest's decode operands built on ``device`` by the port's own
    ``QuestCache`` (keys folded into page minima and maxima, top-k pages
    selected, the stable argsort of the mask as the table): two lanes of
    other lengths, a row where ``top + 1`` pages tie at the best score (so
    it lists more than ``top``), NaN in every page no row selected."""
    from repro_torch.core.baselines import QuestCache
    from repro_torch.core.config import AttentionConfig
    from repro_torch.core.policy import QuestPolicy
    gen = torch.Generator(device=device).manual_seed(page * 10 + paged)
    b, hkv, s = 2, 2, 96
    cache = QuestCache.init(b, hkv, s, dh, page, top, paged=paged,
                            device=device)
    lengths = torch.tensor([s - 1, s // 2 + 3], device=device)
    for t in range(s - 1):
        k, v = (torch.randn((b, hkv, 1, dh), generator=gen, device=device)
                .bfloat16() for _ in range(2))
        cache.append(k, v, t < lengths)
    q = torch.randn((b, 1, hkv * g, dh), generator=gen, device=device)
    q = q.bfloat16()
    tie = 100.0 * torch.sign(q[0, 0, :g].float().mean(0))
    cache.kmin[0, 0, :top + 1] = tie
    cache.kmax[0, 0, :top + 1] = tie
    spec = QuestPolicy.attend_spec(cache, q, AttentionConfig(hkv * g, hkv, dh))
    n, tbl = spec.block_n, spec.block_tbl
    listed = torch.zeros_like(tbl, dtype=torch.bool).scatter_(
        2, tbl.long(), torch.arange(tbl.shape[-1], device=device) < n[..., None])
    if paged:
        keep = torch.zeros(spec.pool.k_buf.shape[0], dtype=torch.bool,
                           device=device)
        keep[spec.phys[listed].long()] = True
        spec.pool.k_buf[~keep] = float("nan")
        spec.pool.v_buf[~keep] = float("nan")
        k = v = None
    else:
        dead = ~listed.repeat_interleave(page, dim=-1)
        k, v = spec.k.clone(), spec.v.clone()
        k[dead] = float("nan")
        v[dead] = float("nan")
    kw = dict(block_tbl=tbl, block_n=n, block_p=page, pool_k=spec.pool_k,
              pool_v=spec.pool_v, phys=spec.phys)
    return (q, k, v, spec.visible), kw


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "shared"])
@pytest.mark.parametrize("page", [16, 8, 4])
def test_decode_quest_page_tables_match_plain(cuda_device, page, paged):
    """Quest's top-k page tables, made on the card, in the fixed-arena and
    shared-pool modes at pages of 16, 8 and 4 slots (the vectorised
    ``valid`` path takes multiples of 4): a tied row lists ``top + 1``
    pages, NaN in the unselected pages is never read, and the kernel
    equals the same wrapper on the CPU (the plain version)."""
    args, kw = _quest_operands(cuda_device, page, paged)
    assert int(kw["block_n"][0, 0]) == 3 and int(kw["block_n"].min()) >= 1
    want = ops.dms_decode_attention(
        *(None if x is None else x.cpu() for x in args),
        **{key: x.cpu() if torch.is_tensor(x) else x for key, x in kw.items()})
    before = (ops.launches, ops.shared_launches)
    got = ops.dms_decode_attention(*args, **kw)
    again = ops.dms_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert (ops.launches - before[0], ops.shared_launches - before[1]) == \
        ((0, 2) if paged else (2, 0))
    assert torch.equal(got, again) and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.cpu().float(), want.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("block_p,paged", [(16, False), (16, True), (8, True)])
def test_decode_dmc_cast_prefix_table_matches_plain(cuda_device, block_p,
                                                    paged):
    """DMC's operands on the card: fp32 accumulators merged by the port's
    ``DMCCache`` (paged: in an fp32 pool, whose pages are cast), cast to
    bf16, the prefix table over ``count``; NaN past the listed blocks
    (paged: in every page the table does not list); the kernel in
    fixed-arena mode (paged: shared-pool mode) equals the same wrapper on
    the CPU."""
    from repro_torch.core.baselines import DMCCache
    from repro_torch.core.policy import DMCPolicy
    gen = torch.Generator(device=cuda_device).manual_seed(block_p + paged)
    b, hkv, g, dh, steps = 2, 2, 6, 128, 160
    cache = DMCCache.init(b, hkv, 56, dh, block_p=block_p, paged=paged,
                          device=cuda_device)
    lengths = torch.tensor([steps, steps - 40], device=cuda_device)
    for t in range(steps):
        k, v = (torch.randn((b, hkv, 1, dh), generator=gen,
                            device=cuda_device).bfloat16() for _ in range(2))
        alpha = torch.rand((b, hkv), generator=gen, device=cuda_device) < 0.75
        cache.step(k, v, alpha, active=t < lengths)
    assert int(cache.count.min()) > 0 and int(cache.count.max()) <= 64
    spec = DMCPolicy.attend_spec(cache, torch.bfloat16)
    assert (spec.pool is None) == (not paged)
    kw = dict(block_tbl=spec.block_tbl, block_n=spec.block_n, block_p=block_p)
    if paged:
        assert spec.pool.k.dtype == torch.bfloat16
        k = v = None
        listed = (torch.arange(spec.block_tbl.shape[-1], device=cuda_device)
                  < spec.block_n[..., None])
        keep = torch.zeros(spec.pool.k_buf.shape[0], dtype=torch.bool,
                           device=cuda_device)
        keep[spec.phys.gather(2, spec.block_tbl.long())[listed].long()] = True
        spec.pool.k_buf[~keep] = float("nan")
        spec.pool.v_buf[~keep] = float("nan")
        kw.update(pool_k=spec.pool_k, pool_v=spec.pool_v, phys=spec.phys)
    else:
        assert spec.k.dtype == torch.bfloat16
        k, v = spec.k.clone(), spec.v.clone()
        dead = torch.arange(k.shape[2], device=cuda_device) >= (
            spec.block_n * block_p)[..., None]
        k[dead] = float("nan")
        v[dead] = float("nan")
    q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                    device=cuda_device).bfloat16()
    want = ops.dms_decode_attention(
        *(None if x is None else x.cpu() for x in (q, k, v, spec.visible)),
        **{key: x.cpu() if torch.is_tensor(x) else x for key, x in kw.items()})
    before = (ops.launches, ops.shared_launches)
    got = ops.dms_decode_attention(q, k, v, spec.visible, **kw)
    torch.cuda.synchronize()
    assert (ops.launches, ops.shared_launches) == (
        (before[0], before[1] + 1) if paged else (before[0] + 1, before[1]))
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.cpu().float(), want.float(), **BF16)


@pytest.mark.cuda
def test_categorical_on_card_equals_cpu(cuda_device):
    """Temperature sampling over the served model's padded vocabulary: the
    Threefry bits on the card equal the CPU's, and so do the drawn
    indices, for 8 seeds."""
    from repro_torch.core import threefry
    from repro_torch.serving.scheduler import sample
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((4, 152064), generator=gen) * 4.0
    logits[:, 151936:] = -1e30
    for seed in range(8):
        kc, kg = threefry.prng_key(seed), threefry.prng_key(seed, cuda_device)
        _, sub_c = threefry.split(kc)
        _, sub_g = threefry.split(kg)
        assert torch.equal(threefry.random_bits(sub_g, logits.shape).cpu(),
                           threefry.random_bits(sub_c, logits.shape))
        want = sample(sub_c, logits, 0.7)
        got = sample(sub_g, logits.to(cuda_device), 0.7)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_decode_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    q = torch.zeros((1, 1, 2, 12), dtype=torch.bfloat16, device=cuda_device)
    k = torch.zeros((1, 1, 16, 12), dtype=torch.bfloat16, device=cuda_device)
    valid = torch.ones((1, 1, 16), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.dms_decode_attention(q, k, k, valid, block_p=16)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.dms_decode_attention(q.float()[..., :8], k.float()[..., :8],
                                 k.float()[..., :8], valid, block_p=16)


@pytest.mark.cuda
@pytest.mark.parametrize("g,dh,nb,cap", [(6, 128, 26, None), (2, 16, 4, None),
                                         (4, 64, 8, 30.0)]
                         + [(g, dh, p // BP, cap)
                            for g, dh, p, cap in FAMILY_SHAPES])
def test_shared_pool_kernel_matches_plain_and_fixed(cuda_device, g, dh, nb, cap):
    """Shared-pool mode through the wrapper: pages scattered in shuffled
    order over a pool twice the size needed, NaN in every unlisted page,
    stale table entries past n whose blocks are unmapped, a row with n = 0.
    Within bf16 rounding of the plain version on the CPU, and bitwise equal
    to fixed-arena mode on the dense view of the same pages."""
    from repro_torch.core import block_pool
    gen = torch.Generator().manual_seed(g * dh + nb)
    b, hkv = 4, 2
    valid = torch.rand((b, hkv, nb * BP), generator=gen) < 0.6
    live = valid.reshape(b, hkv, nb, BP).any(-1)
    live[0, 1] = False                                   # an n = 0 row
    tbl = torch.argsort((~live).to(torch.int8), dim=-1, stable=True)
    n = live.sum(-1).int()
    need = int(n.sum())
    npool = 2 * need
    pages = torch.randperm(npool, generator=gen)[:need]
    phys = torch.full((b, hkv, nb), -1, dtype=torch.int32)
    phys[live] = pages.int()
    pool = block_pool.BlockPool.init(npool, BP, dh, torch.bfloat16)
    pool.k_buf[:-1] = torch.randn((npool, BP, dh), generator=gen).bfloat16()
    pool.v_buf[:-1] = torch.randn((npool, BP, dh), generator=gen).bfloat16()
    unlisted = torch.ones(npool + 1, dtype=torch.bool)
    unlisted[pages] = False
    pool.k_buf[unlisted] = float("nan")
    pool.v_buf[unlisted] = float("nan")
    q = torch.randn((b, 1, hkv * g, dh), generator=gen).bfloat16()
    args = dict(block_tbl=tbl.int(), block_n=n, block_p=BP, logit_cap=cap)
    plain = ops.dms_decode_attention(q, None, None, valid, pool_k=pool.k,
                                     pool_v=pool.v, phys=phys, **args)
    kd, vd = block_pool.dense_kv(pool, phys)

    def on_card(*xs):
        return [x.to(cuda_device) for x in xs]

    qc, validc, kc, vc, physc, kdc, vdc = on_card(q, valid, pool.k, pool.v,
                                                  phys, kd, vd)
    argc = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
            for k, v in args.items()}
    before = (ops.launches, ops.shared_launches)
    shared = ops.dms_decode_attention(qc, None, None, validc, pool_k=kc,
                                      pool_v=vc, phys=physc, **argc)
    fixed = ops.dms_decode_attention(qc, kdc, vdc, validc, **argc)
    torch.cuda.synchronize()
    assert (ops.launches, ops.shared_launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(shared.float()).all()
    assert not shared[0, 0, g:2 * g].float().abs().any()
    assert torch.equal(shared, fixed)
    torch.testing.assert_close(shared.cpu().float(), plain.float(), **BF16)


# -- decode, weights-out mode ---------------------------------------------------

# the raw outputs and the weights are fp32 on both sides: scores summed over
# Dh in another order, then exponentiated
F32 = dict(rtol=1e-4, atol=1e-5)


def _weights_case(device, g, dh, nb, seed):
    """Both layouts of the same logical contents: rows list their live
    blocks in shuffled order, row 0 lists none, row 1's first listed block
    is hidden entirely (as a local window hides old slots), the table tail
    past n names other blocks; K/V of every unlisted block, and every
    unlisted page of a pool twice the size needed, is NaN.  Returns
    (fixed operands, shared operands) for ``ops.decode_rows``."""
    gen = torch.Generator().manual_seed(seed)
    bh = 8
    valid = torch.rand((bh, nb * BP), generator=gen) < 0.6
    live = valid.reshape(bh, nb, BP).any(-1)
    live[0] = False
    tbl = torch.zeros((bh, nb), dtype=torch.int64)
    n = live.sum(-1).int()
    for r in range(bh):
        ids = torch.nonzero(live[r]).flatten()
        ids = ids[torch.randperm(len(ids), generator=gen)]
        rest = torch.nonzero(~live[r]).flatten()
        tbl[r] = torch.cat([ids, rest])
    assert n[1] >= 2
    first = int(tbl[1, 0])
    valid[1, first * BP:(first + 1) * BP] = False
    q = torch.randn((bh, g, dh), generator=gen).bfloat16()
    k = torch.randn((bh, nb * BP, dh), generator=gen).bfloat16()
    v = torch.randn((bh, nb * BP, dh), generator=gen).bfloat16()
    dead = ~live.repeat_interleave(BP, dim=1)
    k[dead] = float("nan")
    v[dead] = float("nan")
    npool = 2 * bh * nb
    pages = torch.randperm(npool, generator=gen)[:bh * nb].reshape(bh, nb)
    pk = torch.full((npool, BP, dh), float("nan")).bfloat16()
    pv = pk.clone()
    pk[pages.flatten()] = k.reshape(bh * nb, BP, dh)
    pv[pages.flatten()] = v.reshape(bh * nb, BP, dh)
    ptbl = pages.gather(1, tbl)
    valid_tbl = valid.reshape(bh, nb, BP).gather(
        1, tbl[..., None].expand(-1, -1, BP)).reshape(bh, -1)

    def dev(*xs):
        return [x.to(device) for x in xs]

    fixed = dev(q, k, v, valid, tbl.int(), n)
    shared = dev(q, pk.reshape(1, -1, dh), pv.reshape(1, -1, dh), valid_tbl,
                 ptbl.int(), n)
    return fixed, shared


@pytest.mark.cuda
@pytest.mark.parametrize("g,dh,nb,cap", [(6, 128, 5, None), (2, 16, 4, None),
                                         (4, 64, 8, 30.0)])
def test_weights_out_kernel_matches_plain(cuda_device, g, dh, nb, cap):
    """The weights-out mode in both layouts against the plain version on
    the same tensors: the output, every listed entry's ``w_blk`` and
    ``m_blk``, ``m_out`` and ``l_out``; the hidden block and the n = 0 row
    give zero weight; the shared-pool layout is bitwise equal to the fixed
    one.  Then the wrapper's group-summed weights, zero off the visible
    slots, each live row summing to G."""
    from repro_torch.kernels.dms_decode.ref import dms_decode_plain_weights
    fixed, shared = _weights_case(cuda_device, g, dh, nb, seed=g * dh + nb)
    n = fixed[5]
    before = (ops.launches, ops.shared_launches, ops.weights_launches)
    got_f = ops.decode_rows(*fixed, BP, cap, need_weights=True)
    got_s = ops.decode_rows(*shared, BP, cap, shared_kv=True,
                            need_weights=True)
    torch.cuda.synchronize()
    assert (ops.launches, ops.shared_launches, ops.weights_launches) == \
        (before[0], before[1], before[2] + 2)
    want = dms_decode_plain_weights(*fixed, BP, cap)
    # entries >= n of w_blk and m_blk are never written: compare the rest
    listed = torch.arange(nb, device=cuda_device)[None, :] < n[:, None]
    for i, (a, b) in enumerate(zip(got_f, got_s)):
        assert torch.equal(a[listed], b[listed]) if i in (1, 2) \
            else torch.equal(a, b)
    out, w_blk, m_blk, m_out, l_out = got_f
    assert torch.isfinite(out.float()).all() and not out[0].float().any()
    torch.testing.assert_close(out.float(), want[0].float(), **BF16)
    for r in range(len(n)):
        k = int(n[r])
        torch.testing.assert_close(w_blk[r, :k], want[1][r, :k], **F32)
        torch.testing.assert_close(m_blk[r, :k], want[2][r, :k], **F32)
    torch.testing.assert_close(m_out, want[3], **F32)
    torch.testing.assert_close(l_out, want[4], **F32)
    assert not w_blk[1, 0].any() and not l_out[0].any()
    # through the wrapper: (B = 4, Hkv = 2) over the fixed arenas
    q, k, v, valid, tbl, n = fixed
    b, hkv, p = 4, 2, nb * BP
    args = dict(block_tbl=tbl.reshape(b, hkv, nb), block_n=n.reshape(b, hkv),
                block_p=BP, logit_cap=cap, need_weights=True)
    qa = q.reshape(b, 1, hkv * g, dh)
    ka, va = k.reshape(b, hkv, p, dh), v.reshape(b, hkv, p, dh)
    va_mask = valid.reshape(b, hkv, p)
    o_k, w_k = ops.dms_decode_attention(qa, ka, va, va_mask, **args)
    o_p, w_p = ops.dms_decode_attention(*(x.cpu() for x in (qa, ka, va,
                                                            va_mask)),
                                        **{a: (x.cpu() if torch.is_tensor(x)
                                               else x)
                                           for a, x in args.items()})
    torch.cuda.synchronize()
    assert torch.isfinite(w_k).all()
    torch.testing.assert_close(w_k.cpu(), w_p, **F32)
    torch.testing.assert_close(o_k.cpu().float(), o_p.float(), **BF16)
    listed = torch.zeros((b * hkv, nb), dtype=torch.bool, device=cuda_device)
    for r in range(b * hkv):
        listed[r, tbl[r, :n[r]].long()] = True
    seen = va_mask & listed.repeat_interleave(BP, dim=1).reshape(b, hkv, p)
    assert not w_k[~seen].any()
    sums = w_k.sum(-1).flatten()
    for r in range(b * hkv):
        assert float(sums[r]) == pytest.approx(
            g if seen.reshape(b * hkv, p)[r].any() else 0.0, rel=1e-4)


# -- decode, the table split across a cluster ---------------------------------


def _split_case(device, g, dh, nb, seed, front_only, bh=8):
    """Both layouts of the same logical contents, with rows of n = 0, n = 1
    and n = nb (every block listed) and random n elsewhere (one row: n =
    nb); blocks listed in shuffled order, table tails past n naming other
    blocks, NaN in every unlisted block and unlisted page.  ``front_only``:
    every slot of a listed entry past the first split's range (``[0, n //
    S)``, at least one entry) is hidden, so the later splits see no slot.
    Returns (fixed, shared) operands for ``ops.decode_rows``."""
    gen = torch.Generator().manual_seed(seed)
    splits = ops.splits(nb, bh, ops.sm_count(device))
    counts = ([0, 1, nb] + torch.randint(2, nb, (bh - 3,), generator=gen)
              .tolist() if bh >= 3 else [nb] * bh)
    valid = torch.rand((bh, nb * BP), generator=gen) < 0.6
    valid.reshape(bh, nb, BP)[..., 0] = True           # every block holds a slot
    tbl = torch.stack([torch.randperm(nb, generator=gen) for _ in range(bh)])
    n = torch.tensor(counts, dtype=torch.int32)
    listed = torch.zeros((bh, nb), dtype=torch.bool)
    for r in range(bh):
        listed[r, tbl[r, :counts[r]]] = True
        if front_only:
            for blk in tbl[r, max(counts[r] // splits, 1):counts[r]].tolist():
                valid[r, blk * BP:(blk + 1) * BP] = False
    q = torch.randn((bh, g, dh), generator=gen).bfloat16()
    k = torch.randn((bh, nb * BP, dh), generator=gen).bfloat16()
    v = torch.randn((bh, nb * BP, dh), generator=gen).bfloat16()
    dead = ~listed.repeat_interleave(BP, dim=1)
    k[dead] = float("nan")
    v[dead] = float("nan")
    npool = 2 * bh * nb
    pages = torch.randperm(npool, generator=gen)[:bh * nb].reshape(bh, nb)
    pk = torch.full((npool, BP, dh), float("nan")).bfloat16()
    pv = pk.clone()
    pk[pages.flatten()] = k.reshape(bh * nb, BP, dh)
    pv[pages.flatten()] = v.reshape(bh * nb, BP, dh)
    valid_tbl = valid.reshape(bh, nb, BP).gather(
        1, tbl[..., None].expand(-1, -1, BP)).reshape(bh, -1)

    def dev(*xs):
        return [x.to(device) for x in xs]

    return (dev(q, k, v, valid, tbl.int(), n),
            dev(q, pk.reshape(1, -1, dh), pv.reshape(1, -1, dh), valid_tbl,
                pages.gather(1, tbl).int(), n))


@pytest.mark.cuda
@pytest.mark.parametrize("nb,front_only", [(160, False), (22, True)],
                         ids=["long table", "live entries in the first split"])
def test_decode_splits_match_plain(cuda_device, nb, front_only):
    """The table split over a cluster, in both layouts and in weights-out
    mode: a table of 160 entries (several chunks in every split), or live
    slots only in each row's first split; rows with n = 0, 1 and NB_tbl.
    Against the unsplit plain version and against the plain version of the
    split (``dms_decode_plain_split`` at the kernel's split count); the
    shared pool bitwise equal to the fixed arenas; a second launch bitwise
    equal to the first."""
    from repro_torch.kernels.dms_decode.ref import (dms_decode_plain_split,
                                                    dms_decode_plain_weights)
    g, dh = 6, 128
    fixed, shared = _split_case(cuda_device, g, dh, nb, seed=nb, front_only=front_only)
    splits = ops.launch_splits(fixed[0], nb)
    assert splits > 1
    n = fixed[5]
    listed = torch.arange(nb, device=cuda_device)[None, :] < n[:, None]
    before = (ops.launches, ops.shared_launches, ops.weights_launches)
    runs = []
    for _ in range(2):
        runs.append([ops.decode_rows(*fixed, BP), ops.decode_rows(
            *shared, BP, shared_kv=True)]
            + [ops.decode_rows(*xs, BP, shared_kv=sk, need_weights=True)
               for xs, sk in ((fixed, False), (shared, True))])
    torch.cuda.synchronize()
    assert (ops.launches, ops.shared_launches, ops.weights_launches) == (
        before[0] + 2, before[1] + 2, before[2] + 4)
    out_f, out_s, got_f, got_s = runs[0]

    def raw(got):            # entries >= n of w_blk and m_blk are unwritten
        return [got[0], got[1][listed], got[2][listed], got[3], got[4]]

    for a, b in zip([out_f, out_s] + raw(got_f) + raw(got_s),
                    [runs[1][0], runs[1][1]] + raw(runs[1][2]) + raw(runs[1][3])):
        assert torch.equal(a, b)                          # a second launch
    assert torch.equal(out_f, out_s) and torch.equal(out_f, got_f[0])
    for a, b in zip(raw(got_f), raw(got_s)):
        assert torch.equal(a, b)                          # both layouts
    assert torch.isfinite(out_f.float()).all() and not out_f[0].float().any()
    want = dms_decode_plain_weights(*fixed, BP)
    want_split = dms_decode_plain_split(*fixed, BP, splits=splits,
                                        need_weights=True)
    for ref in (want, want_split):
        torch.testing.assert_close(out_f.float(), ref[0].float(), **BF16)
        for a, b in zip(raw(got_f)[1:], raw(ref)[1:]):
            torch.testing.assert_close(a, b, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,g,dh,nb", [(1, 10, 256, 129), (64, 1, 64, 20)],
                         ids=["one row: recurrentgemma's ring",
                              "64 rows: seamless's G 1"])
def test_decode_split_rule_shapes(cuda_device, bh, g, dh, nb):
    """The split count follows B*Hkv: one row (recurrentgemma's 2064-slot
    ring, G 10 at Dh 256) takes 16 splits, a non-portable cluster; 64 rows
    (seamless's G 1 at Dh 64) fewer than 8.  Fixed and shared layouts give
    the same bits, a second launch too, and both agree with the plain
    version and with the plain version of the split."""
    from repro_torch.kernels.dms_decode.ref import dms_decode_plain_split
    fixed, shared = _split_case(cuda_device, g, dh, nb, seed=bh, front_only=False,
                                bh=bh)
    splits = ops.launch_splits(fixed[0], nb)
    if ops.sm_count(cuda_device) >= 128:
        assert splits == 16 if bh == 1 else splits < 8
    runs = [(ops.decode_rows(*fixed, BP), ops.decode_rows(*shared, BP,
                                                          shared_kv=True))
            for _ in range(2)]
    torch.cuda.synchronize()
    (out_f, out_s), (again_f, again_s) = runs
    assert torch.equal(out_f, out_s)
    assert torch.equal(out_f, again_f) and torch.equal(out_s, again_s)
    assert torch.isfinite(out_f.float()).all()
    torch.testing.assert_close(out_f.float(), dms_decode_plain(
        *fixed, BP).float(), **BF16)
    torch.testing.assert_close(out_f.float(), dms_decode_plain_split(
        *fixed, BP, splits=splits).float(), **BF16)


# (B·Hkv, G, Dh, table entries) of phase 5l: qwen-r1-32b's G 5 at Dh 128 and
# llama32-1b's G 4 at Dh 64 on 4 lanes of 8 kv heads, at their served
# arenas (48 and 64 slots) and over a 40-entry table
PAPER_SHAPES = [(32, 5, 128, 3), (32, 4, 64, 4), (32, 5, 128, 40),
                (32, 4, 64, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,g,dh,nb", PAPER_SHAPES,
                         ids=[f"G{g}-Dh{dh}-nb{nb}"
                              for _, g, dh, nb in PAPER_SHAPES])
def test_decode_paper_groupings_match_plain(cuda_device, bh, g, dh, nb):
    """The paper's models' head groupings, served in phase 5l: G 5 leaves
    11 of the tensor-core tile's 16 rows empty, G 4 runs at Dh 64.  Fixed
    arenas and the shared pool (NaN in every unlisted block and page, rows
    of n = 0, 1 and NB_tbl) give the same bits, on a second launch too,
    and agree with the plain version and with the plain version of the
    kernel's split."""
    from repro_torch.kernels.dms_decode.ref import dms_decode_plain_split
    fixed, shared = _split_case(cuda_device, g, dh, nb, seed=g * nb,
                                front_only=False, bh=bh)
    splits = ops.launch_splits(fixed[0], nb)
    before = (ops.launches, ops.shared_launches)
    runs = [(ops.decode_rows(*fixed, BP), ops.decode_rows(*shared, BP,
                                                          shared_kv=True))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert (ops.launches, ops.shared_launches) == (before[0] + 2,
                                                   before[1] + 2)
    (out_f, out_s), (again_f, again_s) = runs
    assert torch.equal(out_f, out_s)
    assert torch.equal(out_f, again_f) and torch.equal(out_s, again_s)
    assert torch.isfinite(out_f.float()).all() and not out_f[0].float().any()
    torch.testing.assert_close(out_f.float(), dms_decode_plain(
        *fixed, BP).float(), **BF16)
    torch.testing.assert_close(out_f.float(), dms_decode_plain_split(
        *fixed, BP, splits=splits).float(), **BF16)


# (B·Hkv, table entries) of phase 5m's trained reasoner, G 2 at Dh 16:
# vanilla's one lane (48 slots), dms's four chains (32) and the
# teacher-forced trace's two lanes (32)
REASONER_SHAPES = [(2, 3), (8, 2), (4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,nb", REASONER_SHAPES,
                         ids=[f"BH{bh}-nb{nb}" for bh, nb in REASONER_SHAPES])
def test_decode_reasoner_shapes_match_plain(cuda_device, bh, nb):
    """The demo's reasoner (qwen-r1-1.5b's smoke width at vocab 64): G 2
    at Dh 16, one k-step of the ``mma.sync`` tile, on 5m's fixed arenas of
    ``nb`` blocks: row 0 lists no block and comes out zero, row 1 every
    block, the others a random count, in shuffled order, NaN in every
    unlisted block; bit-equal on a second launch and within bf16 rounding
    of the plain version and of the plain version of the kernel's split."""
    from repro_torch.kernels.dms_decode.ref import dms_decode_plain_split
    g, dh, p = 2, 16, nb * BP
    gen = torch.Generator().manual_seed(bh * nb)
    q = torch.randn((bh, g, dh), generator=gen).bfloat16()
    k = torch.randn((bh, p, dh), generator=gen).bfloat16()
    v = torch.randn((bh, p, dh), generator=gen).bfloat16()
    valid = torch.rand((bh, p), generator=gen) < 0.6
    valid[:, ::BP] = True                        # every block holds a slot
    counts = [0, nb] + torch.randint(1, nb + 1, (bh - 2,),
                                     generator=gen).tolist()
    tbl = torch.stack([torch.randperm(nb, generator=gen) for _ in range(bh)])
    listed = torch.zeros((bh, nb), dtype=torch.bool)
    for r in range(bh):
        listed[r, tbl[r, :counts[r]]] = True
    dead = ~listed.repeat_interleave(BP, dim=1)
    k[dead] = float("nan")
    v[dead] = float("nan")
    args = [x.to(cuda_device) for x in (q, k, v, valid, tbl.int(),
                                        torch.tensor(counts).int())]
    before = ops.launches
    out, again = (ops.decode_rows(*args, BP) for _ in range(2))
    torch.cuda.synchronize()
    assert ops.launches == before + 2
    assert torch.equal(out, again)
    assert torch.isfinite(out.float()).all() and not out[0].float().any()
    torch.testing.assert_close(out.float(), dms_decode_plain(
        *args, BP).float(), **BF16)
    torch.testing.assert_close(out.float(), dms_decode_plain_split(
        *args, BP, splits=ops.launch_splits(args[0], nb)).float(), **BF16)


# -- flash attention: fwd, dq, dkv -------------------------------------------


def _flash_operands(device, dtype, b=2, t=200, hq=6, hkv=2, dh=64, delay=32,
                    window=None, cap=None, skip=False, seed=0, causal=True):
    """Folded flash operands; ``delay`` 0 is vanilla (log-survival 0,
    padding too, as ``dms_flash_attention`` builds it)."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention.ref import FlashConfig
    gen = torch.Generator(device=device).manual_seed(seed)
    bk, tp = fops.padded_blocks(t)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    qf = fops.fold_heads(rnd(b, t, hq, dh), tp)
    kf, vf = fops.fold_heads(rnd(b, t, hkv, dh), tp), fops.fold_heads(
        rnd(b, t, hkv, dh), tp)
    u = torch.rand((b, hkv, t), generator=gen, device=device)
    alpha = u * 0.88 + 0.02
    if skip:                    # the first 128-key block holds no retained key
        alpha = (u < 0.8).float()
        alpha[:, :, :128] = 1.0
    ls = (fops.kernel_log_survival(alpha, tp) if delay else
          torch.zeros((b * hkv, tp), device=device))
    cfg = FlashConfig(t=t, orig_dh=dh, hq=hq, hkv=hkv, window=window,
                      dms_delay=delay, causal=causal, logit_cap=cap,
                      block_k=bk, skip_blocks=skip)
    hr = fops.prep_tables(ls, cfg)
    do = rnd(*qf.shape)
    do[:, t:] = 0
    return qf, kf, vf, ls, hr, cfg, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kw", [
    (torch.bfloat16, {}), (torch.float32, {}),
    (torch.float32, dict(window=48, cap=30.0)),
    (torch.float32, dict(skip=True)), (torch.float32, dict(t=33, dh=8)),
    # bf16 runs fwd, dq and dkv on the tensor cores: each case moves the
    # accumulator fragments' (row, key) coordinates or a tile edge
    (torch.bfloat16, dict(window=48, cap=30.0)),
    (torch.bfloat16, dict(skip=True, t=300)),
    (torch.bfloat16, dict(t=1000, dh=128, delay=256)),
    (torch.bfloat16, dict(t=33, dh=8, delay=4)),       # Dh padded to 64
    (torch.bfloat16, dict(hq=8, hkv=2, dh=128)),       # G = 4
    # phi3-mini's shape: Dh 96 padded to 128, G = 1 (dkv in clusters of 1)
    (torch.bfloat16, dict(hq=4, hkv=4, dh=96)),
])
def test_flash_kernels_match_plain(cuda_device, dtype, kw):
    """fwd, dq and dkv against their plain versions: each output within
    1e-2 (bf16: 8 significant bits) or 1e-5 (fp32: sums in another order)
    of the plain output's largest magnitude."""
    _flash_vs_plain(cuda_device, dtype, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kw", [
    # seamless's encoder: vanilla, G 1 at Dh 64 (dkv in clusters of 1),
    # on the 64-row tile and off it (padded keys hidden by the guards alone)
    (torch.bfloat16, dict(hq=16, hkv=16, t=1024, delay=0)),
    (torch.bfloat16, dict(hq=16, hkv=16, t=1000, delay=0)),
    (torch.float32, dict(hq=16, hkv=16, t=1000, delay=0)),
    # a DMS mask without causality, G 3
    (torch.bfloat16, dict(t=300)),
], ids=["bf16-G1-T1024", "bf16-G1-T1000", "fp32-G1-T1000", "bf16-dms-T300"])
def test_flash_kernels_noncausal_match_plain(cuda_device, dtype, kw):
    """``causal=False`` (the bidirectional encoder): fwd, dq and dkv
    against their plain versions, as above."""
    _flash_vs_plain(cuda_device, dtype, dict(kw, causal=False))


def _flash_vs_plain(cuda_device, dtype, kw, twice=False):
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention import ref as fref
    qf, kf, vf, ls, hr, cfg, do = _flash_operands(cuda_device, dtype, **kw)
    out_p, lse_p = fref.flash_fwd_plain(qf, kf, vf, ls, hr, cfg)
    delta = (do.float() * out_p.float()).sum(-1)
    before = dict(fops.launches)
    runs = []
    for _ in range(2 if twice else 1):
        runs.append(fops.flash_fwd(qf, kf, vf, ls, hr, cfg)
                    + (fops.flash_dq(qf, kf, vf, ls, do, lse_p, delta, hr, cfg),)
                    + fops.flash_dkv(qf, kf, vf, ls, do, lse_p, delta, hr, cfg))
    torch.cuda.synchronize()
    assert {k: fops.launches[k] - before[k] for k in before} == {
        "flash_fwd": len(runs), "flash_dq": len(runs), "flash_dkv": len(runs)}
    for a, b in zip(runs[0], runs[-1]):
        assert torch.equal(a, b)
    out, lse, dq, dk, dv, dls = runs[0]
    dq_p = fref.flash_dq_plain(qf, kf, vf, ls, do, lse_p, delta, hr, cfg)
    dk_p, dv_p, dls_p = fref.flash_dkv_plain(qf, kf, vf, ls, do, lse_p, delta,
                                             hr, cfg)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    t = cfg.t
    for got, want in ((out[:, :t], out_p[:, :t]), (dq, dq_p), (dk, dk_p),
                      (dv, dv_p), (dls, dls_p)):
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= tol * want.abs().max() + 1e-30
    assert (lse[:, :t] - lse_p[:, :t]).abs().max() <= tol * 10


@pytest.mark.cuda
@pytest.mark.parametrize("delay", [0, 4], ids=["vanilla", "dms_train"])
def test_flash_kernels_at_the_reasoner_shape_match_plain(cuda_device, delay):
    """Phase 5m's training shape: B 32, T 32 (shorter than one 64-row tile
    and one key block), Hq 4, Hkv 2, Dh 16 padded to 64, bf16; vanilla (the
    pretrain and the teacher) and relaxed α with the DMS window 4 (the
    retrofit student): fwd, dq and dkv against their plain versions within
    1e-2 of the largest plain output, bit-equal on a second launch."""
    _flash_vs_plain(cuda_device, torch.bfloat16, dict(
        b=32, t=32, hq=4, hkv=2, dh=16, delay=delay), twice=True)


@pytest.mark.cuda
def test_flash_autograd_matches_dense_oracle(cuda_device):
    """Gradients in q, k, v and α of the autograd Function against autograd
    through the dense oracle, fp32, within 1e-4 of their largest magnitude."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention.ref import dms_attention_plain
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, t, hq, hkv, dh = 2, 300, 6, 2, 64
    base = [torch.randn(s, generator=gen, device=cuda_device)
            for s in ((b, t, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh))]
    a0 = torch.rand((b, hkv, t), generator=gen, device=cuda_device) * 0.9
    tgt = torch.randn((b, t, hq, dh), generator=gen, device=cuda_device)
    grads = []
    for kernel in (True, False):
        xs = [x.clone().requires_grad_() for x in base + [a0]]
        if kernel:
            out = fops.dms_flash_attention(*xs, dms_window=40)
        else:
            out = dms_attention_plain(*xs[:3], torch.log1p(-xs[3]),
                                      dms_window=40)
        (out * tgt).sum().backward()
        grads.append([x.grad for x in xs])
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_flash_bf16_kernels_are_deterministic(cuda_device):
    """The tensor-core fwd, dq and dkv use no atomics (dq writes each row
    from its own block, dkv sums its cluster's partials in rank order): two
    launches give the same bits."""
    from repro_torch.kernels.dms_attention import ops as fops
    qf, kf, vf, ls, hr, cfg, do = _flash_operands(
        cuda_device, torch.bfloat16, t=1000, dh=128, delay=256)
    runs = []
    for _ in range(2):
        out, lse = fops.flash_fwd(qf, kf, vf, ls, hr, cfg)
        delta = (do.float() * out.float()).sum(-1)
        runs.append((out, lse, fops.flash_dq(qf, kf, vf, ls, do, lse, delta,
                                             hr, cfg))
                    + fops.flash_dkv(qf, kf, vf, ls, do, lse, delta, hr, cfg))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kw", [
    # gemma2: G 2, a local window (4096, cut to 48) and the softcap 50
    (torch.bfloat16, dict(hq=4, hkv=2, dh=256, t=300, window=48, cap=50.0)),
    (torch.float32, dict(hq=4, hkv=2, dh=256, t=300, window=48, cap=50.0)),
    # recurrentgemma: G 10 over one kv head (dkv in clusters of 2)
    (torch.bfloat16, dict(hq=10, hkv=1, dh=256, t=200)),
    (torch.float32, dict(hq=10, hkv=1, dh=256, t=200)),
    # T off the 64-row tile with the DMS delay; without causality
    (torch.bfloat16, dict(hq=4, hkv=2, dh=256, t=1000, delay=256)),
    (torch.bfloat16, dict(hq=4, hkv=2, dh=256, t=300, causal=False)),
    (torch.float32, dict(hq=4, hkv=2, dh=256, t=300, causal=False)),
    # Dh 160: padded to 256 in bf16; in fp32 two panels, the second narrower
    (torch.bfloat16, dict(hq=4, hkv=2, dh=160, t=100)),
    (torch.float32, dict(hq=4, hkv=2, dh=160, t=100)),
])
def test_flash_kernels_at_head_dim_256_match_plain(cuda_device, dtype, kw):
    """gemma2's and recurrentgemma's head dim: fwd, dq and dkv against
    their plain versions as above (bf16 on the tensor cores, dkv in two
    128-column halves; fp32 with K/V or Q/dO in column panels), each the
    same bits on a second launch."""
    _flash_vs_plain(cuda_device, dtype, kw, twice=True)


def _kernel_and_reference(arch, params, batch, make):
    """``make(use_kernel)``'s step on ``batch`` both ways; the flash
    launches the kernel path made."""
    from repro_torch.kernels.dms_attention import ops as fops
    before = dict(fops.launches)
    got = make(True)(params, batch)
    launched = {k: fops.launches[k] - before[k] for k in before}
    return got, make(False)(params, batch), launched


@pytest.mark.cuda
def test_gemma2_prefill_export_at_head_dim_256(cuda_device):
    """gemma2's head dim (256) on the flash kernels: the prefill export
    through the kernel launches ``flash_fwd`` once per attention layer and
    its last logits come within 0.05 x max |logit| of the reference
    attention path's (bf16 weights)."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tfm
    arch = get_smoke("gemma2-2b")
    arch = dataclasses.replace(arch, attn=dataclasses.replace(arch.attn,
                                                              head_dim=256))
    params = tfm.init_model(arch, seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tokens = torch.randint(0, arch.vocab_size, (2, 64), generator=gen,
                           device=cuda_device, dtype=torch.int32)
    (got, _), (want, _), launched = _kernel_and_reference(
        arch, params, {"tokens": tokens},
        lambda k: make_prefill_step(arch, dms=True, use_kernel=k))
    torch.cuda.synchronize()
    assert launched == {"flash_fwd": arch.num_layers, "flash_dq": 0,
                        "flash_dkv": 0}
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 0.05 * want.abs().max()


@pytest.mark.cuda
def test_recurrentgemma_kernel_path_at_head_dim_256(cuda_device):
    """recurrentgemma's local layers at Dh 256, G 4 over one kv head: the
    prefill export's last logits and one retrofit step's metrics through
    the flash kernels against the reference attention path (fp32 weights
    and compute: the fp32 kernels, sums in another order), with fwd, dq
    and dkv launched."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.steps import make_prefill_step, make_retrofit_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    arch = get_smoke("recurrentgemma-2b")
    arch = dataclasses.replace(arch, dtype="float32", attn=dataclasses.replace(
        arch.attn, head_dim=256))
    params = tfm.init_model(arch, seed=0, device=cuda_device,
                            dtype=torch.float32)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tokens = torch.randint(0, arch.vocab_size, (2, 64), generator=gen,
                           device=cuda_device, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    (got, _), (want, _), launched = _kernel_and_reference(
        arch, params, batch,
        lambda k: make_prefill_step(arch, dms=True, use_kernel=k))
    assert launched["flash_fwd"] > 0
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()

    def retrofit(k):
        step = make_retrofit_step(arch, adamw.AdamWConfig(), use_kernel=k,
                                  remat=False)
        return lambda p, b: step(tree_map(torch.clone, p), p, adamw.init(p),
                                 b, 3)[2]

    got, want, launched = _kernel_and_reference(arch, params, batch, retrofit)
    torch.cuda.synchronize()
    assert min(launched.values()) > 0
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-3,
                                                abs=1e-6), key


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_the_kernels_cannot_take(cuda_device):
    from repro_torch.kernels.dms_attention import ops as fops
    qf, kf, vf, ls, hr, cfg, _ = _flash_operands(cuda_device, torch.float32)
    with pytest.raises(TypeError, match="share one dtype"):
        fops.flash_fwd(qf.half(), kf.half(), vf.half(), ls, hr, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fops.flash_fwd(qf.transpose(1, 2).contiguous().transpose(1, 2), kf,
                       vf, ls, hr, cfg)
    big = torch.zeros((qf.shape[0], qf.shape[1], 320), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fops.flash_fwd(big, big[:kf.shape[0]], big[:kf.shape[0]], ls, hr,
                       cfg._replace(orig_dh=320))


# -- the prefill export's shapes and the prefix cache's slab ------------------


@pytest.mark.cuda
@pytest.mark.parametrize("t,mask,hq", [
    pytest.param(512, "binary", 12, id="512-binary"),
    pytest.param(512, "vanilla", 12, id="512-vanilla"),
    pytest.param(288, "binary", 12, id="288-binary"),
    pytest.param(512, "binary", 32, id="512-binary-chatglm3")])
def test_flash_fwd_prefill_shapes_match_plain(cuda_device, t, mask, hq):
    """``flash_fwd`` at the prefill export's shapes (B 4, Hkv 2, Dh 128,
    bf16; Hq 12, and chatglm3-6b's 32, G 16): binarised α as a
    log-survival of -1e30 for evicted keys with delay 256, or vanilla (zero
    log-survival, delay 0); T 288 pads to 384.  Within 1e-2 of the plain
    output's scale, and the same bits on a second launch."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention import ref as fref
    from repro_torch.kernels.dms_attention.ref import FlashConfig
    b, hkv, dh = 4, 2, 128
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    bk, tp = fops.padded_blocks(t)
    qf, kf, vf = (fops.fold_heads(torch.randn(
        (b, t, h, dh), generator=gen, device=cuda_device).bfloat16(), tp)
        for h in (hq, hkv, hkv))
    if mask == "binary":
        alpha = (torch.rand((b, hkv, t), generator=gen,
                            device=cuda_device) < 0.6).float()
        ls, delay = fops.kernel_log_survival(alpha, tp), 256
    else:
        ls = torch.zeros((b * hkv, tp), device=cuda_device)
        delay = 0
    cfg = FlashConfig(t=t, orig_dh=dh, hq=hq, hkv=hkv, window=None,
                      dms_delay=delay, causal=True, logit_cap=None,
                      block_k=bk, skip_blocks=False)
    runs = [fops.flash_fwd(qf, kf, vf, ls, None, cfg) for _ in range(2)]
    want, _ = fref.flash_fwd_plain(qf, kf, vf, ls, None, cfg)
    torch.cuda.synchronize()
    got = runs[0][0][:, :t].float()
    assert torch.isfinite(got).all()
    want = want[:, :t].float()
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.cuda
def test_prefix_cache_slab_roundtrip_on_card(cuda_device):
    """A hot hit on the card: the slab lives on the device, the hit moves
    no host<->device snapshot bytes, and the warm request's tokens equal a
    cold prefill's."""
    import numpy as np
    from repro_torch.configs import get_smoke
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    arch = get_smoke("qwen-r1-1.5b")
    params = tfm.init_model(arch, seed=0, device=cuda_device)
    cfg = KVPolicyConfig(kind="dms", cr=2.0, window=arch.dms.window,
                         block_p=16)
    r = np.random.default_rng(0)
    prefix = r.integers(3, arch.vocab_size, size=(16,)).astype(np.int32)
    prompts = [np.concatenate([prefix, r.integers(
        3, arch.vocab_size, size=(n,)).astype(np.int32)]) for n in (5, 9)]

    def serve(eng):
        out = []
        for p in prompts:
            sched = eng.scheduler(num_lanes=1, max_len=40)
            sched.submit(Request(uid=0, prompt=p, max_new=6))
            out.append(sched.run()[0])
        return out

    warm = Engine(arch, params, cfg, chunk=8, device=cuda_device,
                  prefix_cache_mb=64, prefix_cache_device_mb=64)
    got = serve(warm)
    want = serve(Engine(arch, params, cfg, chunk=8, device=cuda_device))
    st = warm.prefix_cache.stats()
    assert st["hot_hits"] == 1 and st["h2d_bytes"] == st["d2h_bytes"] == 0
    slab = next(iter(warm.prefix_cache._hot.values())).slab
    assert all(a.is_cuda for a in tree_leaves(slab))
    assert got[1].prefill_meter.kv_reads_saved > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


# -- the decode-path auditor: the sync debug mode behind the tripwire -------


@pytest.mark.cuda
def test_tripwire_arms_the_sync_debug_mode(cuda_device):
    """Armed, the tripwire sets CUDA's sync debug mode to error: a read of
    a device value outside a sanctioned region is recorded and then
    raises; inside one the mode is lowered and the read goes through; the
    mode comes back on exit."""
    from repro_torch.analysis.hostsync import HostSyncTripwire, sanctioned
    x = torch.arange(4, device=cuda_device)
    torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == 0
    with HostSyncTripwire() as tw:
        assert torch.cuda.get_sync_debug_mode() == 2
        with pytest.raises(RuntimeError):
            x[0].item()
        with sanctioned("tick-boundary"):
            assert torch.cuda.get_sync_debug_mode() == 0
            assert x.cpu().tolist() == [0, 1, 2, 3]
        assert torch.cuda.get_sync_debug_mode() == 2
    assert torch.cuda.get_sync_debug_mode() == 0
    assert [e[:2] for e in tw.events] == [(".item()", None),
                                          (".cpu()", "tick-boundary"),
                                          (".tolist()", "tick-boundary")]


@pytest.mark.cuda
def test_tripwire_catches_a_blocking_upload_on_the_card(cuda_device):
    """A blocking host-to-device copy inside an armed region is a sync the
    Python hooks do not see; the card's own check raises on it."""
    from repro_torch.analysis.hostsync import HostSyncTripwire, sanctioned
    host = torch.arange(4)
    with HostSyncTripwire():
        with pytest.raises(RuntimeError):
            host.to(cuda_device)
        with sanctioned("tick-boundary"):
            host.to(cuda_device)


@pytest.mark.cuda
def test_audit_kernel_combo_on_the_card(cuda_device):
    """A kernel-mode combo on the card: its kernel events equal the growth
    of the decode kernel's launch counters, one per attention layer."""
    from repro_torch.analysis import audit
    from repro_torch.analysis.passes import gating
    from repro_torch.models import transformer as tfm
    arch = audit.tiny_arch()
    params = tfm.init_model(arch, seed=0, device=cuda_device)
    for paged in (False, True):
        rep = audit.audit_combo(arch, params, "dms", paged, True,
                                device=cuda_device)
        assert not gating(rep.findings), [str(f) for f in rep.findings]
        assert rep.kernel_events == rep.launches == rep.attn_layers
