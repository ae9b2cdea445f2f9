#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve, train.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. device   — a CUDA device must be present; prints the card's name and
              power limit as nvidia-smi reports them.
2. build    — compiles every hand-written kernel source from
              ``src/repro_torch`` (one nvcc per source, all started together,
              sm_90a) and prints the build seconds and ptxas report.
3. kernels  — each kernel against its plain PyTorch version on the same CUDA
              tensors.  Decode, fixed arenas: the main-path shape, a
              fragmented table, a partial table, empty rows (n = 0), a
              160-entry table (several chunks in every split), a tiny shape
              and a softcap; the K/V of blocks the table does not list is
              NaN, so a finite, equal output shows that unlisted blocks are
              never read; each also against the plain version of the
              kernel's split of the table (``dms_decode_plain_split`` at the
              kernel's split count) and bit-equal on a second launch.
              Decode, shared pool (paged): the main-path shape with pages
              scattered over a pool twice the size needed, NaN in every
              unlisted page, a stale table tail with phys = -1 past n, a row
              with n = 0 and a 160-entry table — each also bitwise equal to
              the fixed-arena mode on the same logical contents.  Flash
              attention (fwd, dq, dkv): the retrofit shape, T = 1000
              (padding), window 64 with softcap 30, vanilla, binarised α
              with block skipping, each in bf16 (on the tensor cores) and in
              fp32, a tiny shape in fp32 and in bf16 (Dh 8 padded to 64),
              Dh 64 with T = 300 and G = 4 in bf16, each bf16 case launched
              twice for the same bits; then the autograd
              Function's gradients (q, k, v, log_surv, α) against autograd
              through the dense oracle.  Decode, weights-out mode (both
              layouts, at the weights phase's arena): the main-path shape,
              a fragmented table, NaN in unlisted pages with a stale tail,
              an n = 0 row, a listed block that a window hides and a
              160-entry table — the output and the raw outputs (per-entry
              weights and maxima, final max and denominator) against the
              plain version and the plain split, the group-summed weights
              zero off the visible listed slots and summing to G, the
              shared-pool layout bitwise equal to the fixed one.
4. serve    — qwen-r1-1.5b at full width (d_model 1536, 12/2 heads of 128,
              random weights from a seed, bf16) and half its depth (the
              first 14 of its 28 layers: the script's time limit) served
              by ``Engine`` with the ``dms`` policy at CR 8 on fixed
              arenas: four staggered requests (prompts 512/384/256/128,
              new 64/48/32/64), then one width-4
              hyperscale request (prompt 256, 64 new).  Every request must
              end ``ok`` with its full token count, and the decode kernel
              must have launched once per layer per decode step.  A short
              teacher-forced trace then holds the kernel path's logits
              against the reference path's.
5. paged    — the same trace on the paged KV block pool (shared-pool
              kernel, 14 launches per decode step): tokens equal to phase
              4's, no page copied at the fork and copies once the chains
              write, every page back at the end.  Then two of its requests
              oversubscribe a pool of 1.5x one lane's worst case
              (``oversub`` 2, preemption): all ``ok``, preemptions equal
              resumes and are > 0, the pool never exhausted, tokens equal.
5b. weights — the same model at 7 layers (``WEIGHTS_LAYERS``) serving
              requests 2 and 3 of the trace with the weight-driven
              policies at CR 8 (budget 72, 80-slot arenas):
              TOVA on fixed arenas and on the pool, H2O and Keyformer on
              fixed arenas, through the weights-out kernel (7 launches per
              decode step): all ok, live tokens within the budget, the
              pool's tokens equal to the fixed arenas'.  A teacher-forced
              trace per policy holds the kernel path's logits against the
              reference path's and every weights-out call against the
              plain version; then a profiled step of each beside dms.
5c. hyperscale — the same model at phase 4's depth: (a) the paper's
              comparison through ``evaluate_hyperscale`` at temperature 0.7
              on one 288-token needle problem: ``vanilla`` at L-W-CR
              320-1-1, ``dms`` at 320-4-8, ``dms_masked`` at 320-4, each
              beside ``analytic_budget``, with the modeled K/V bytes a
              decode step; (b) request 3 greedy on ``vanilla`` fixed, paged
              and at ``block_p`` 0, ``window`` (a recycling ring) and
              ``dms_masked`` paged, the pool's vanilla tokens equal to the
              fixed arenas'; (c) the kernel path's logits against the
              reference path's, teacher-forced, for ``vanilla``, ``window``
              and ``dms_masked`` (delay 16: holed tables); (d)
              ``threefry.categorical`` on the card against the CPU.
5d. quest/dmc — the same model at phase 4's depth: (a) ``quest`` and
              ``dmc`` at 320-4-8 through ``evaluate_hyperscale`` at
              temperature 0.7 on 5c's problem, beside 5c's vanilla and dms:
              Quest's ``kv_reads`` equal to the count by hand and below
              vanilla's, its peak tokens a chain equal to vanilla's, DMC's
              below, the modeled K/V bytes a decode step; (b) request 3
              greedy on Quest and DMC, fixed and paged: the pool's tokens
              equal the fixed arenas', every page back at the end; (c)
              their kernel path against the reference path, teacher-forced
              (Quest with 8- and 4-slot pages, DMC with 16- and 8-slot
              blocks); a profiled step of each beside dms, with the device
              time of Quest's page scoring and of DMC's cast a layer.
6. train    — qwen-r1-1.5b at full width, fp32 weights from seed 0, DMS
              retrofit (one phase-1 step, three distillation steps) on the
              synthetic stream at (B 2, T 1024) through the flash kernels:
              finite metrics, 56/28/28 launches of fwd/dq/dkv per step, step
              time, tokens/s and peak memory; then one step's loss and
              gradient norm held against the reference attention path's.
7. timing   — the timing method's own floor (one tiny kernel), then per
              kernel at the main-path shape: the median device time of one
              call (a CUDA-graph replay after an L2 flush) beside its bound,
              its plain version's and one library call's; for the decode
              kernel also its split count and its floor (the same launch
              with n = 0 on every row); for the vanilla cache's prefix
              table (every block of a P 384 arena listed) the same, and
              logged beside it at the arena phase 5c (a) serves vanilla on
              (one lane, P 320); for Quest's page tables (fixed, at 5d
              (a)'s arena; shared, at (b)'s pool) and DMC's prefix table
              over its cast accumulators (at (a)'s arena) the same, on
              phase 3's operands.

Phase 3 also holds the fixed-arena mode on the vanilla cache's operands
(prefix tables at the main-path shape, at the decode shapes of llama32-1b,
minitron-4b and phi3-mini and at the arenas phase 5c serves vanilla on, and
``block_p`` 0) against the plain version; every shape at which 5c then
launches the kernel for vanilla must be one of those checked.  It holds
the fixed and shared modes on Quest's and DMC's operands too, on caches
built from the configs phase 5d serves and filled by their own steps:
Quest's top-k page tables (NaN in every unselected page, a tied row that
lists more than ``top_pages`` pages, pages of 16, 8 and 4 slots) and DMC's
prefix table over the bf16 cast of its fp32 accumulators; every shape at
which 5d launches the kernel must be one of those checked.  The last
four lines are the script's total seconds, the ``kernels`` JSON line, the
card's name and power limit (again) and the result line ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
KERNEL_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 output: ~3 significant digits
# weights-out's fp32 outputs (weights, maxima, denominators): scores summed
# over Dh in another order, then exponentiated; rtol is of the output's scale
WEIGHTS_TOL = dict(atol=1e-4, rtol=1e-4)
# flash kernels vs plain, max |kernel - plain| / max |plain| per output:
# bf16 outputs round to 8 significant bits (2^-8 = 0.4%), so 1e-2; fp32
# outputs differ only by the order of fp32 sums over <= 6 x 1024 terms, so 1e-5
FLASH_REL_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
# the autograd Function's gradients vs autograd through the dense oracle, fp32
# (the reference's own kernel-vs-autodiff test uses the same 1e-4)
GRAD_REL_TOL = 1e-4


def log(*args) -> None:
    print(*args, flush=True)


# -- phase 1 ---------------------------------------------------------------


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs an NVIDIA GPU")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; run "
                         "from a checkout of the repository")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return smi.splitlines()[0]


# -- phase 2 ---------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_decode import ops
    t0 = time.perf_counter()
    _build.build([ops.SOURCE, fops.SOURCE])       # one nvcc each, in parallel
    ops.build()
    fops.build()
    log(f"build: dms_decode, dms_attention in {time.perf_counter() - t0:.2f} s")
    for src in (ops.SOURCE, fops.SOURCE):
        report = _build.library_path(src).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "Compiling entry" in line:
                    log(f"  ptxas {src.name}:", line.split("'")[1][:90])
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"  ptxas {src.name}:", line.strip())


# -- phase 3 ---------------------------------------------------------------


def make_case(torch, gen, *, bh, g, dh, p, bp, density, table="full",
              empty_rows=(), device="cuda"):
    """Random decode operands.  ``table``: "full" lists every block holding
    a visible slot in shuffled order; "partial" lists only every other one.
    K/V of every block the table does not list is NaN."""
    nb = p // bp
    q = torch.randn((bh, g, dh), generator=gen, device=device).to(torch.bfloat16)
    k = torch.randn((bh, p, dh), generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn((bh, p, dh), generator=gen, device=device).to(torch.bfloat16)
    valid = torch.rand((bh, p), generator=gen, device=device) < density
    blk_live = valid.reshape(bh, nb, bp).any(-1).cpu()
    tbl = torch.zeros((bh, nb), dtype=torch.int32)
    n = torch.zeros((bh,), dtype=torch.int32)
    listed = torch.zeros((bh, nb), dtype=torch.bool)
    cpu_gen = torch.Generator().manual_seed(int(torch.randint(
        0, 2 ** 31, (1,), generator=gen, device=device).item()))
    for r in range(bh):
        ids = torch.nonzero(blk_live[r]).flatten()
        ids = ids[torch.randperm(len(ids), generator=cpu_gen)]
        if table == "partial":
            ids = ids[::2]
        if r in empty_rows:
            ids = ids[:0]
        n[r] = len(ids)
        tbl[r, :len(ids)] = ids.to(torch.int32)
        listed[r, ids] = True
    dead = ~listed.repeat_interleave(bp, dim=1).to(device)
    k[dead] = float("nan")
    v[dead] = float("nan")
    return q, k, v, valid, tbl.to(device), n.to(device)


# a table of this many 16-slot entries: several chunks in every split
LONG_TABLE = 160


def phase_kernels(torch, main_shape):
    """The fixed-arena mode against its plain version and against the plain
    version of its split of the table (``dms_decode_plain_split``); each
    case launched twice for the same bits."""
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode.ref import (dms_decode_plain,
                                                    dms_decode_plain_split)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    bh, g, dh, p, bp = main_shape
    cases = {
        "main-path shape": dict(bh=bh, g=g, dh=dh, p=p, bp=bp, density=0.85),
        "fragmented table": dict(bh=bh, g=g, dh=dh, p=p, bp=bp, density=0.03),
        "partial table": dict(bh=bh, g=g, dh=dh, p=p, bp=bp, density=0.5,
                              table="partial"),
        "n = 0 rows": dict(bh=bh, g=g, dh=dh, p=p, bp=bp, density=0.5,
                           empty_rows=(0, 3)),
        f"long table ({LONG_TABLE} entries)": dict(
            bh=bh, g=g, dh=dh, p=LONG_TABLE * bp, bp=bp, density=0.85),
        "tiny shape": dict(bh=6, g=2, dh=16, p=64, bp=16, density=0.5),
        "softcap": dict(bh=4, g=4, dh=64, p=128, bp=16, density=0.6),
    }
    before = ops.launches
    errs = {}
    for name, kw in cases.items():
        q, k, v, valid, tbl, n = make_case(torch, gen, **kw)
        cap = 30.0 if name == "softcap" else None
        out = ops.decode_rows(q, k, v, valid, tbl, n, kw["bp"], cap)
        again = ops.decode_rows(q, k, v, valid, tbl, n, kw["bp"], cap)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"kernel [{name}]: a second launch gave "
                                 "other bits")
        ref = dms_decode_plain(q, k, v, valid, tbl, n, kw["bp"], cap)
        splits = ops.splits(tbl.shape[1])
        ref_split = dms_decode_plain_split(q, k, v, valid, tbl, n, kw["bp"],
                                           cap, splits=splits)
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"kernel [{name}]: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), **KERNEL_TOL)
        torch.testing.assert_close(out.float(), ref_split.float(), **KERNEL_TOL)
        for r in kw.get("empty_rows", ()):
            if out[r].abs().max().item() != 0.0:
                raise AssertionError(f"kernel [{name}]: row {r} with n = 0 "
                                     "is not zero")
        errs[name] = err
        log(f"kernel vs plain [{name}] ({int(n.sum())} listed blocks, "
            f"{splits} splits a row): max_abs_err {err:.3e} (tolerance atol "
            f"{KERNEL_TOL['atol']}, rtol {KERNEL_TOL['rtol']}); within it of "
            "the plain split too; bit-equal on a second launch")
    if ops.launches - before != 2 * len(cases):
        raise AssertionError(f"launch counter moved {ops.launches - before}, "
                             f"expected {2 * len(cases)}")
    return errs["main-path shape"]


def make_pool_case(torch, gen, *, bh, g, dh, nb, bp, density, nan=False,
                   stale=False, empty_rows=(), hidden_rows=(), device="cuda"):
    """Random shared-pool decode operands, and the same logical contents as
    fixed arenas.  Each row lists its live blocks in shuffled order; their
    pages are scattered in shuffled order over a pool twice the pages
    needed.  ``nan``: every page the table does not list is NaN (else it
    holds random stale data).  ``stale``: a row lists only half of its live
    blocks and its table past n names unmapped blocks (phys = -1).
    ``hidden_rows``: the first listed block of these rows has every slot
    hidden, as a local window hides old slots.  Returns a dict: ``shared``
    = (q, k, v, valid, tbl, n) for the kernel's shared mode, ``fixed`` = the
    same for its fixed mode."""
    cpu = torch.Generator().manual_seed(int(torch.randint(
        0, 2 ** 31, (1,), generator=gen, device=device).item()))
    valid = torch.rand((bh, nb * bp), generator=cpu) < density
    live = valid.reshape(bh, nb, bp).any(-1)
    tbl = torch.zeros((bh, nb), dtype=torch.int64)
    n = torch.zeros((bh,), dtype=torch.int32)
    phys = torch.full((bh, nb), -1, dtype=torch.int64)
    need = int(live.sum())
    npool = 2 * max(need, 1)
    pages = iter(torch.randperm(npool, generator=cpu).tolist())
    for r in range(bh):
        ids = torch.nonzero(live[r]).flatten()
        ids = ids[torch.randperm(len(ids), generator=cpu)]
        listed = ids[:len(ids) // 2] if stale else ids
        if r in empty_rows:
            listed = ids[:0]
        n[r] = len(listed)
        rest = torch.tensor([b for b in range(nb) if b not in set(listed.tolist())],
                            dtype=torch.int64)
        tbl[r] = torch.cat([listed, rest])    # stale tail: unmapped blocks
        for blk in listed.tolist():
            phys[r, blk] = next(pages)
    for r in hidden_rows:
        blk = int(tbl[r, 0])
        if n[r] < 1:
            raise AssertionError(f"row {r} lists no block to hide")
        valid[r, blk * bp:(blk + 1) * bp] = False
    pk = torch.randn((npool, bp, dh), generator=cpu)
    pv = torch.randn((npool, bp, dh), generator=cpu)
    if nan:
        unlisted = torch.ones(npool, dtype=torch.bool)
        unlisted[phys[phys >= 0]] = False
        pk[unlisted] = float("nan")
        pv[unlisted] = float("nan")
    q = torch.randn((bh, g, dh), generator=cpu)
    # the same contents as per-row arenas: listed blocks hold their pages
    mapped = phys >= 0
    ka = torch.where(mapped[..., None, None], pk[phys.clamp(min=0)], 0.0)
    va = torch.where(mapped[..., None, None], pv[phys.clamp(min=0)], 0.0)
    tbl_pages = phys.gather(1, tbl).clamp(0, npool - 1)
    valid_tbl = valid.reshape(bh, nb, bp).gather(
        1, tbl[..., None].expand(-1, -1, bp)).reshape(bh, nb * bp)

    def dev(*xs):
        return [x.to(device) for x in xs]

    q, pk, pv, ka, va = (x.to(torch.bfloat16) for x in (q, pk, pv, ka, va))
    return {
        "shared": dev(q, pk.reshape(1, npool * bp, dh),
                      pv.reshape(1, npool * bp, dh), valid_tbl,
                      tbl_pages.to(torch.int32), n),
        "fixed": dev(q, ka.reshape(bh, nb * bp, dh), va.reshape(bh, nb * bp, dh),
                     valid, tbl.to(torch.int32), n),
        "npool": npool, "n_blocks": int(n.sum()),
    }


POOL_CASES = {
    "main-path shape": dict(density=0.85),
    "NaN in every unlisted page": dict(density=0.85, nan=True),
    "stale tail, phys -1 past n": dict(density=0.5, nan=True, stale=True),
    "n = 0 row": dict(density=0.5, nan=True, empty_rows=(2,)),
    f"long table ({LONG_TABLE} entries)": dict(density=0.85, nan=True,
                                              nb=LONG_TABLE),
}


def phase_pool_kernels(torch, main_shape):
    """The shared-pool mode against its plain version, and bitwise against
    the fixed-arena mode on the same logical contents in the same table
    order; returns the main case's max abs error."""
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode.ref import (dms_decode_plain_shared,
                                                    dms_decode_plain_split)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    bh, g, dh, p, bp = main_shape
    before = (ops.launches, ops.shared_launches)
    errs = {}
    for name, kw in POOL_CASES.items():
        kw = dict(kw)
        case = make_pool_case(torch, gen, bh=bh, g=g, dh=dh,
                              nb=kw.pop("nb", p // bp), bp=bp, **kw)
        shared = case["shared"]
        out = ops.decode_rows(*shared, bp, None, shared_kv=True)
        fixed = ops.decode_rows(*case["fixed"], bp, None)
        torch.cuda.synchronize()
        ref = dms_decode_plain_shared(*shared, bp, None)
        ref_split = dms_decode_plain_split(
            *shared, bp, None, shared_kv=True,
            splits=ops.splits(shared[4].shape[1]))
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"shared-pool kernel [{name}]: non-finite")
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), **KERNEL_TOL)
        torch.testing.assert_close(out.float(), ref_split.float(), **KERNEL_TOL)
        if not torch.equal(out, fixed):
            raise AssertionError(f"shared-pool kernel [{name}]: not bitwise "
                                 "equal to the fixed-arena kernel")
        for r in kw.get("empty_rows", ()):
            if out[r].abs().max().item() != 0.0:
                raise AssertionError(f"shared-pool kernel [{name}]: row {r} "
                                     "with n = 0 is not zero")
        errs[name] = err
        log(f"shared-pool kernel vs plain [{name}] (pool {case['npool']} pages,"
            f" {case['n_blocks']} listed): max_abs_err {err:.3e} (tolerance "
            f"atol {KERNEL_TOL['atol']}, rtol {KERNEL_TOL['rtol']}; the plain "
            "split too); bitwise equal to the fixed-arena kernel")
    moved = (ops.launches - before[0], ops.shared_launches - before[1])
    if moved != (len(POOL_CASES), len(POOL_CASES)):
        raise AssertionError(f"launch counters moved {moved}")
    return errs["main-path shape"]


WEIGHTS_CASES = {
    "main-path shape": dict(density=0.85),
    "fragmented table": dict(density=0.03),
    "NaN in unlisted pages, stale tail": dict(density=0.5, nan=True,
                                                         stale=True),
    "n = 0 row": dict(density=0.5, nan=True, empty_rows=(2,)),
    "window-hidden block": dict(density=0.85, nan=True, hidden_rows=(1, 5)),
    f"long table ({LONG_TABLE} entries)": dict(density=0.85, nan=True,
                                              nb=LONG_TABLE),
}


def weights_errors(torch, got, want, n, ltbl, nb):
    """The weights-out mode's outputs against its plain version's: each
    raw output (entries < n only: the kernel leaves the rest unwritten) and
    the group-summed weights the wrapper makes of them
    (``ops.table_weights_to_arena``).  Raises beyond KERNEL_TOL (the bf16
    output) or WEIGHTS_TOL (the fp32 rest); returns ({name: max abs err},
    the kernel's weights)."""
    from repro_torch.kernels.dms_decode import ops
    listed = (torch.arange(got[1].shape[1], device=n.device)[None, :]
              < n[:, None])
    weights = ops.table_weights_to_arena(*got[1:], n, ltbl, nb)
    pairs = {"out": (got[0].float(), want[0].float()),
             "w_blk": (got[1][listed], want[1][listed]),
             "m_blk": (got[2][listed], want[2][listed]),
             "m_out": (got[3], want[3]), "l_out": (got[4], want[4]),
             "weights": (weights,
                         ops.table_weights_to_arena(*want[1:], n, ltbl, nb))}
    errs = {}
    for key, (a, b) in pairs.items():
        if not bool(torch.isfinite(a[b > -1e29]).all()):
            raise AssertionError(f"weights-out {key}: non-finite values")
        errs[key] = (a - b).abs().max().item() if a.numel() else 0.0
        torch.testing.assert_close(a, b, **(KERNEL_TOL if key == "out"
                                            else WEIGHTS_TOL))
    return errs, weights


def phase_weights_kernels(torch, main_shape, device="cuda"):
    """The weights-out mode in both layouts against its plain version on
    the same tensors (output within KERNEL_TOL, the fp32 raw outputs and the
    group-summed weights within WEIGHTS_TOL), the shared-pool layout bitwise
    equal to the fixed one, zero weight off the visible listed slots, every
    row that sees a slot summing to G; returns the main case's max abs
    error over all outputs."""
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode.ref import (dms_decode_plain_split,
                                                    dms_decode_plain_weights)
    gen = torch.Generator(device=device).manual_seed(2468)
    bh, g, dh, p, bp = main_shape
    before = (ops.launches, ops.shared_launches, ops.weights_launches)
    main_err = None
    for name, kw in WEIGHTS_CASES.items():
        kw = dict(kw)
        nb = kw.pop("nb", p // bp)
        case = make_pool_case(torch, gen, bh=bh, g=g, dh=dh, nb=nb, bp=bp,
                              device=device, **kw)
        fixed, shared = case["fixed"], case["shared"]
        got = ops.decode_rows(*fixed, bp, None, need_weights=True)
        got_s = ops.decode_rows(*shared, bp, None, shared_kv=True,
                                need_weights=True)
        if device == "cuda":
            torch.cuda.synchronize()
        want = dms_decode_plain_weights(*shared, bp, None, shared_kv=True)
        # the CPU rehearsal has no kernel to ask its split count
        splits = ops.splits(nb) if device == "cuda" else 1
        weights_errors(torch, got, dms_decode_plain_split(
            *shared, bp, None, shared_kv=True, splits=splits,
            need_weights=True), fixed[5], fixed[4], nb)
        n, ltbl = fixed[5], fixed[4]
        listed = (torch.arange(nb, device=n.device)[None, :] < n[:, None])
        for a, b, what in zip(got, got_s, ("out", "w_blk", "m_blk", "m_out",
                                           "l_out")):
            same = (torch.equal(a[listed], b[listed]) if what in ("w_blk",
                                                                  "m_blk")
                    else torch.equal(a, b))
            if not same:
                raise AssertionError(f"weights-out [{name}]: shared-pool {what}"
                                     " not bitwise equal to the fixed layout's")
        errs, weights = weights_errors(torch, got, want, n, ltbl, nb)
        # the table rows are permutations of the blocks: entry flags -> blocks
        blk = torch.zeros_like(listed).scatter_(1, ltbl.long(), listed)
        seen = fixed[3] & blk.repeat_interleave(bp, dim=1)
        if weights[~seen].any():
            raise AssertionError(f"weights-out [{name}]: weight off the "
                                 "visible listed slots")
        sums = weights.sum(-1)
        rows = seen.any(-1)
        if not torch.allclose(sums[rows], torch.full_like(sums[rows], g),
                              rtol=WEIGHTS_TOL["rtol"]) or sums[~rows].any():
            raise AssertionError(f"weights-out [{name}]: row sums {sums}")
        for r in kw.get("hidden_rows", ()):
            if got[1][r, 0].any():
                raise AssertionError(f"weights-out [{name}]: a hidden block "
                                     "emitted weight")
        if name == "main-path shape":
            main_err = max(errs.values())
        log(f"weights-out kernel vs plain [{name}] (both layouts, "
            f"{int(n.sum())} listed blocks, {splits} splits a row; within "
            "tolerance of the plain split too): max abs err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" (tolerance: out {KERNEL_TOL}, fp32 outputs {WEIGHTS_TOL}); "
            "shared-pool bitwise equal to fixed; rows sum to G")
    moved = (ops.launches - before[0], ops.shared_launches - before[1],
             ops.weights_launches - before[2])
    # the CPU rehearsal runs the plain version, which launches nothing
    if moved != (0, 0, 2 * len(WEIGHTS_CASES) if device == "cuda" else 0):
        raise AssertionError(f"launch counters moved {moved}")
    return main_err


# (G, Dh) of the decode shapes the vanilla cache's prefix tables are checked
# at: the main path's, then those of the other registered dense decoders
PREFIX_SHAPES = {"main-path shape": (6, 128), "llama32-1b": (4, 64),
                 "minitron-4b": (3, 128), "phi3-mini-3.8b": (1, 96)}
PREFIX_P = 384
# (P, block_p) of the vanilla arenas phase 5c serves, one lane of Hkv 2
# (B·Hkv 2): (a)'s L 320, and (b)'s request of 128 + 64 tokens with prefix
# tables and with block_p 0.  ``main`` holds the shapes 5c launched to the
# ones checked here.
PREFIX_SERVED = ((320, 16), (192, 16), (192, 0))


def prefix_case(torch, gen, *, b, hkv, g, dh, p, block_p, lengths,
                device="cuda"):
    """The vanilla cache's decode operands: the length prefix ``lengths[i]``
    of lane i, its mask materialised, and its table from
    ``prefix_block_spec`` (``block_p`` 0: no table, the wrapper's legacy
    dense mode, whose derived blocks are 128 slots).  K/V past the last
    listed block are NaN."""
    from repro_torch.core.kv_cache import prefix_block_spec
    from repro_torch.kernels.dms_decode import ops
    q = torch.randn((b, 1, hkv * g, dh), generator=gen, device=device)
    k = torch.randn((b, hkv, p, dh), generator=gen, device=device)
    v = torch.randn((b, hkv, p, dh), generator=gen, device=device)
    length = torch.tensor(lengths, dtype=torch.int32, device=device)
    valid = (torch.arange(p, device=device)
             < length[:, None, None]).expand(b, hkv, p).contiguous()
    blk = block_p or min(ops.DEFAULT_BLOCK_P, p)
    listed = -(-length // blk) * blk
    dead = torch.arange(p, device=device) >= listed[:, None]
    k[dead[:, None].expand(b, hkv, p)] = float("nan")
    v[dead[:, None].expand(b, hkv, p)] = float("nan")
    tbl, n = prefix_block_spec(length, p, block_p, hkv)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    return (q, k, v, valid), dict(block_tbl=tbl, block_n=n,
                                  block_p=block_p or None)


def launch_key(qf, kf, tblf, block_p, shared_kv):
    """A decode launch's shape: (rows, G, Dh, arena P, block_p) in fixed-
    arena mode; (rows, G, Dh, pool slots, block_p, table width, "shared")
    in shared-pool mode."""
    key = (*qf.shape, kf.shape[1], block_p)
    return key + (tblf.shape[1], "shared") if shared_kv else key


def recording_decode_rows(torch, device, shared=None):
    """``ops.decode_rows`` that also adds each call's listed blocks
    (``sum(n)``) to a device counter, with no host read, and keeps the
    ``launch_key`` of each fixed-arena call (and, into the set ``shared``
    if one is given, of each shared-pool call); returns (the wrapper, the
    counter, the set of fixed-arena shapes, the real function)."""
    from repro_torch.kernels.dms_decode import ops
    real = ops.decode_rows
    listed = torch.zeros((), dtype=torch.int64, device=device)
    shapes = set()

    def decode_rows(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw):
        listed.add_(nf.sum())
        key = launch_key(qf, kf, tblf, block_p, kw.get("shared_kv"))
        if not kw.get("shared_kv"):
            shapes.add(key)
        elif shared is not None:
            shared.add(key)
        return real(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw)
    return decode_rows, listed, shapes, real


def phase_prefix_kernels(torch, main_shape):
    """The fixed-arena mode on the vanilla cache's operands: prefix tables
    at the main-path shape, at the three new configs' decode shapes and at
    the arenas phase 5c serves (``PREFIX_SERVED``, one lane a launch, its
    length from 1 to the full arena), and the legacy dense mode
    (``block_p`` 0) at the main-path shape and at 5c's; the kernel through
    the wrapper against the same wrapper on the CPU (the plain version),
    finite, zero where the length is 0, bit-equal on a second launch.
    Returns (the largest max abs error of the prefix tables at the
    main-path shape and at 5c's, the set of launch shapes checked)."""
    from repro_torch.kernels.dms_decode import ops
    gen = torch.Generator(device="cuda").manual_seed(1357)
    bh, g_main, dh_main, _, bp = main_shape
    cases = []             # (name, G, Dh, lanes, P, block_p, lengths a launch)
    for name, (g, dh) in PREFIX_SHAPES.items():
        for block_p in ((bp, 0) if name == "main-path shape" else (bp,)):
            cases.append((name, g, dh, bh // 2, PREFIX_P, block_p,
                          [[0, 1, 160, PREFIX_P] * (bh // 8)]))
    for p, block_p in PREFIX_SERVED:
        cases.append(("phase 5c's vanilla arena", g_main, dh_main, 1, p,
                      block_p, [[1], [bp + 1], [p - bp + 1], [p]]))
    before = ops.launches
    recording, _, checked, real = recording_decode_rows(torch, "cuda")
    errs, launched = {}, 0
    ops.decode_rows = recording
    try:
        for name, g, dh, b, p, block_p, runs in cases:
            what = f"{name} (G={g}, Dh={dh}, B·Hkv={2 * b}), " + (
                f"prefix table, block_p {block_p}" if block_p
                else "block_p 0 (dense mode)")
            err = 0.0
            for lengths in runs:
                ops_in, kw = prefix_case(torch, gen, b=b, hkv=2, g=g, dh=dh,
                                         p=p, block_p=block_p, lengths=lengths)
                out = ops.dms_decode_attention(*ops_in, **kw)
                again = ops.dms_decode_attention(*ops_in, **kw)
                launched += 2
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"kernel [{what}]: a second launch "
                                         "gave other bits")
                want = ops.dms_decode_attention(
                    *(x.cpu() for x in ops_in),
                    **{key: x.cpu() if torch.is_tensor(x) else x
                       for key, x in kw.items()})
                empty = ~ops_in[3][:, 0].any(dim=-1)             # length 0
                if not bool(torch.isfinite(out.float()).all()) \
                        or out[empty].float().abs().sum().item() != 0.0:
                    raise AssertionError(f"kernel [{what}]: non-finite "
                                         "output, or a row of length 0 is "
                                         "not zero")
                torch.testing.assert_close(out.float().cpu(), want.float(),
                                           **KERNEL_TOL)
                err = max(err, (out.float().cpu() - want.float())
                          .abs().max().item())
            errs[(name, p, block_p)] = err
            lens = ", ".join("/".join(map(str, x)) for x in runs)
            each = " (one launch each)" if len(runs) > 1 else ""
            log(f"kernel vs plain [{what}, P={p}, lengths {lens}{each}]: "
                f"max_abs_err {err:.3e} (tolerance atol "
                f"{KERNEL_TOL['atol']}, rtol {KERNEL_TOL['rtol']}); bit-equal "
                "on a second launch")
    finally:
        ops.decode_rows = real
    if ops.launches - before != launched:
        raise AssertionError(f"launch counter moved {ops.launches - before}, "
                             f"expected {launched}")
    row = [e for (name, _, block_p), e in errs.items() if block_p
           and name in ("main-path shape", "phase 5c's vanilla arena")]
    return max(row), checked


def qd_layouts(*, eval_len=320, req_len=192, trace_len=64):
    """Phase 5d's layouts, name -> (policy config, lanes, max_len): (a)'s
    W = 4 chains at L ``eval_len``, (b)'s request 3 on one lane
    (``req_len``, its prompt plus new tokens), (c)'s two-lane traces
    (arenas of ``trace_len``).  Quest's pages are 16 slots (the config's
    default) at CR 8 (``top_pages`` = L / 8 / 16) in (a) and (b), 8 and 4
    slots with ``top_pages`` 2 in (c).  Phase 3 checks the decode kernel on
    caches built from these same configs."""
    return {
        "(a) quest": (dict(kind="quest", cr=8.0), 4, eval_len),
        "(a) dmc": (dict(kind="dmc", cr=8.0, block_p=16), 4, eval_len),
        "(b) quest fixed": (dict(kind="quest", cr=8.0), 1, req_len),
        "(b) quest paged": (dict(kind="quest", cr=8.0, paged=True), 1,
                            req_len),
        "(b) dmc fixed": (dict(kind="dmc", cr=8.0, block_p=16), 1, req_len),
        "(b) dmc paged": (dict(kind="dmc", cr=8.0, block_p=16, paged=True),
                          1, req_len),
        "(c) quest fixed, 8-slot pages": (
            dict(kind="quest", quest_page_size=8, quest_top_pages=2), 2,
            trace_len),
        "(c) quest paged, 4-slot pages": (
            dict(kind="quest", quest_page_size=4, quest_top_pages=2,
                 paged=True), 2, trace_len),
        "(c) dmc fixed": (dict(kind="dmc", cr=8.0, block_p=16), 2, trace_len),
        "(c) dmc paged, 8-slot blocks": (
            dict(kind="dmc", cr=8.0, block_p=8, paged=True), 2, trace_len),
    }


def filled_cache(torch, arch, kw, lanes, max_len, gen, device):
    """One layer's Quest or DMC cache of a ``qd_layouts`` entry, filled
    through its own step with random bf16 tokens: lane i takes a few tokens
    fewer than lane i - 1 (an ``active`` mask freezes it).  Quest's lane 0
    stops one short of its arena (a partial last page); DMC merges at the
    rate that leaves its lane 0 at about 0.8 of its arena.  Returns (cache,
    policy)."""
    from repro_torch.core import policy as policy_lib
    from repro_torch.core.config import KVPolicyConfig
    cfg = KVPolicyConfig(**kw)
    pol = policy_lib.get_policy(cfg.kind)
    cache = policy_lib.init_policy_cache(arch, lanes, max_len, cfg,
                                         device=device).cache
    a = arch.attn
    quest = cfg.kind == "quest"
    if quest:
        steps = cache.kmin.shape[2] * cache.page_size - 1
        merge = 0.0
    else:
        steps = max_len
        merge = min(max(1.0 - 0.8 * cache.z.shape[-1] / steps, 0.0), 0.9)
    lengths = torch.tensor([steps - 5 * i for i in range(lanes)],
                           device=device)
    shape = (lanes, a.num_kv_heads, 1, a.head_dim)
    for t in range(steps):
        act = t < lengths
        k, v = (torch.randn(shape, generator=gen, device=device)
                .to(torch.bfloat16) for _ in range(2))
        if quest:
            cache.append(k, v, act)
        else:
            alpha = torch.rand(shape[:2], generator=gen, device=device) < merge
            cache.step(k, v, alpha, active=act)
    return cache, pol


def qd_case(torch, arch, kw, lanes, max_len, gen, device):
    """Decode operands of one ``qd_layouts`` entry from a ``filled_cache``,
    as the policy's ``attend_spec`` builds them.  Quest: in lane 0, head 0
    ``top_pages + 1`` pages tie at the best score, so the row lists more
    than ``top_pages`` pages; every unselected page is NaN (in the arena,
    or every pool page the table does not list).  DMC: the prefix table
    over the bf16 cast of the fp32 accumulators, NaN past the listed
    blocks.  Returns (q, k, v, visible, the wrapper's keywords, the dense
    (k, v, visible) the spec reads, a note)."""
    from repro_torch.core import block_pool
    cache, pol = filled_cache(torch, arch, kw, lanes, max_len, gen, device)
    a = arch.attn
    q = torch.randn((lanes, 1, a.num_heads, a.head_dim), generator=gen,
                    device=device).to(torch.bfloat16)
    if kw["kind"] == "quest":
        top = cache.top_pages
        q_pool = q[:, 0].reshape(lanes, a.num_kv_heads, a.q_per_kv,
                                 a.head_dim).mean(dim=2)
        tie = 100.0 * torch.sign(q_pool[0, 0].float())
        cache.kmin[0, 0, :top + 1] = tie
        cache.kmax[0, 0, :top + 1] = tie
        spec = pol.attend_spec(cache, q, a)
        n, tbl = spec.block_n, spec.block_tbl
        if int(n[0, 0]) != top + 1 or int(n.max()) > top + 1:
            raise AssertionError(f"quest {kw}: table counts {n.tolist()}, "
                                 f"want {top + 1} in the tied row")
        npg = tbl.shape[-1]
        listed = torch.zeros_like(tbl, dtype=torch.bool).scatter_(
            2, tbl.long(), torch.arange(npg, device=device) < n[..., None])
        if spec.pool is None:
            dead = ~listed.repeat_interleave(spec.block_p, dim=-1)
            k, v = spec.k.clone(), spec.v.clone()
            k[dead] = float("nan")
            v[dead] = float("nan")
        else:
            k = v = None
            keep = torch.zeros(spec.pool.k_buf.shape[0], dtype=torch.bool,
                               device=device)
            keep[spec.phys[listed].long()] = True
            spec.pool.k_buf[~keep] = float("nan")
            spec.pool.v_buf[~keep] = float("nan")
        note = (f"top_pages {top}, page {spec.block_p}, n per row "
                f"{sorted(set(n.flatten().tolist()))} (a tie lists "
                f"{top + 1}), unselected pages NaN")
    else:
        spec = pol.attend_spec(cache, torch.bfloat16)
        n = spec.block_n
        p = spec.k.shape[2]
        dead = (torch.arange(p, device=device)
                >= (n * spec.block_p)[..., None])
        k, v = spec.k.clone(), spec.v.clone()
        k[dead] = float("nan")
        v[dead] = float("nan")
        note = (f"block_p {spec.block_p}, count per row "
                f"{sorted(set(cache.count.flatten().tolist()))} of {p} slots, "
                "bf16 cast of fp32 accumulators, NaN past the listed blocks")
    kw_ops = dict(block_tbl=spec.block_tbl, block_n=spec.block_n,
                  block_p=spec.block_p, pool_k=spec.pool_k,
                  pool_v=spec.pool_v, phys=spec.phys)
    if spec.pool is None:
        dense = (k, v, spec.visible)
    else:
        kd, vd = block_pool.dense_kv(spec.pool, spec.phys)
        dense = (kd, vd, spec.visible)
    return q, k, v, spec.visible, kw_ops, dense, note


def phase_quest_dmc_kernels(torch, arch, layouts, device="cuda"):
    """The decode kernel on Quest's and DMC's operands at every launch
    shape phase 5d serves (``qd_layouts``, caches built and filled by the
    policies' own code, ``qd_case``): Quest's top-k page tables in the
    fixed and shared modes (a new ascending subset of pages, a tied row
    over ``top_pages``, pages of 16, 8 and 4 slots, NaN in every unselected
    page) and DMC's prefix table over the bf16 cast of its fp32
    accumulators.  Each through the wrapper against the same wrapper on the
    CPU (the plain version) and against the plain version of the kernel's
    split of the table, finite, bit-equal on a second launch.  Returns
    (the largest max abs error per table kind, the checked launch shapes
    per kind, the flattened operands of (a)'s Quest and DMC and (b)'s
    paged Quest, for the timing phase)."""
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode.ref import dms_decode_plain_split
    gen = torch.Generator(device=device).manual_seed(2468)
    real = ops.decode_rows
    calls = []

    def capture(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    before = (ops.launches, ops.shared_launches)
    errs = {"quest": 0.0, "dmc": 0.0}
    checked = {"quest": set(), "dmc": set()}
    timed = {}
    for name, (kw, lanes, max_len) in layouts.items():
        q, k, v, vis, kw_ops, dense, note = qd_case(
            torch, arch, kw, lanes, max_len, gen, device)
        calls.clear()
        ops.decode_rows = capture
        try:
            out = ops.dms_decode_attention(q, k, v, vis, **kw_ops)
            again = ops.dms_decode_attention(q, k, v, vis, **kw_ops)
        finally:
            ops.decode_rows = real
        if device == "cuda":
            torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: a second launch gave other bits")
        want = ops.dms_decode_attention(
            *(None if x is None else x.cpu() for x in (q, k, v, vis)),
            **{key: x.cpu() if torch.is_tensor(x) else x
               for key, x in kw_ops.items()})
        args, ckw = calls[0]
        shared = bool(ckw.get("shared_kv"))
        split = dms_decode_plain_split(
            *args[:7], None, shared_kv=shared,
            splits=ops.splits(args[4].shape[1]) if device == "cuda" else 1)
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{name}: non-finite output")
        torch.testing.assert_close(out.float().cpu(), want.float(),
                                   **KERNEL_TOL)
        torch.testing.assert_close(out.float().reshape(split.shape),
                                   split.float(), **KERNEL_TOL)
        err = (out.float().cpu() - want.float()).abs().max().item()
        kind = kw["kind"]
        errs[kind] = max(errs[kind], err)
        checked[kind].add(launch_key(args[0], args[1], args[4], args[6],
                                     shared))
        if name in ("(a) quest", "(b) quest paged", "(a) dmc"):
            kd, vd, vald = dense
            bh, p = args[0].shape[0], kd.shape[2]
            timed[name] = {"kernel": args[:6],
                           "dense": tuple(x.reshape(bh, p, *x.shape[3:])
                                          for x in (kd, vd, vald)),
                           "shape": (*args[0].shape, p, args[6]),
                           "mode": "shared" if shared else "fixed"}
        log(f"kernel vs plain [phase 5d {name}, "
            f"{'shared-pool' if shared else 'fixed-arena'} mode, launch "
            f"{launch_key(args[0], args[1], args[4], args[6], shared)}; "
            f"{note}]: max_abs_err {err:.3e} (tolerance atol "
            f"{KERNEL_TOL['atol']}, rtol {KERNEL_TOL['rtol']}; the plain "
            "split too); bit-equal on a second launch")
    moved = (ops.launches - before[0], ops.shared_launches - before[1])
    n_shared = sum(2 for kw, _, _ in layouts.values()
                   if kw.get("paged") and kw["kind"] == "quest")
    want = ((2 * len(layouts) - n_shared, n_shared) if device == "cuda"
            else (0, 0))
    if moved != want:
        raise AssertionError(f"launch counters moved {moved}, want {want}")
    return errs, checked, timed


def flash_case(torch, *, b, t, hq, hkv, dh, dtype, alpha="relaxed",
               delay=256, window=None, cap=None, skip=False, seed=0,
               device="cuda"):
    """Folded flash-attention operands as ``dms_flash_attention`` builds them
    (q/k/v ~ N(0, 1); α uniform in [0.02, 0.9], or binarised: 1 with
    probability 0.9 and on every key of [128, 640), so that four whole
    128-key blocks hold no retained key and their tiles below the diagonal
    are skipped), with a random dO (zero on padded rows):
    (qf, kf, vf, ls, hr, cfg, do)."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention.ref import FlashConfig
    gen = torch.Generator(device=device).manual_seed(seed)
    bk, tp = fops.padded_blocks(t)
    qf = fops.fold_heads(torch.randn((b, t, hq, dh), generator=gen,
                                     device=device).to(dtype), tp)
    kf = fops.fold_heads(torch.randn((b, t, hkv, dh), generator=gen,
                                     device=device).to(dtype), tp)
    vf = fops.fold_heads(torch.randn((b, t, hkv, dh), generator=gen,
                                     device=device).to(dtype), tp)
    u = torch.rand((b, hkv, t), generator=gen, device=device)
    if alpha is None:
        ls = torch.zeros((b * hkv, tp), device=device)
        delay, skip = 0, False
    else:
        if alpha == "relaxed":
            a = u * 0.88 + 0.02
        else:
            a = (u < 0.9).float()
            a[:, :, 128:640] = 1.0
        ls = fops.kernel_log_survival(a, tp)
    cfg = FlashConfig(t=t, orig_dh=dh, hq=hq, hkv=hkv, window=window,
                      dms_delay=delay, causal=True, logit_cap=cap,
                      block_k=bk, skip_blocks=skip)
    hr = fops.prep_tables(ls, cfg)
    do = torch.randn(qf.shape, generator=gen, device=device).to(dtype)
    do[:, t:] = 0
    return qf, kf, vf, ls, hr, cfg, do


MAIN_FLASH = dict(b=2, t=1024, hq=12, hkv=2, dh=128, dtype="bfloat16")


def phase_flash_kernels(torch):
    """fwd, dq and dkv against their plain versions on the same CUDA
    tensors; returns each kernel's max abs error at the main shape."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention import ref as fref
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in fp32
    torch.backends.cudnn.allow_tf32 = False
    variants = {
        "retrofit shape": {},
        "T = 1000 (padding)": dict(t=1000),
        "window 64, softcap 30": dict(window=64, cap=30.0),
        "vanilla (alpha None)": dict(alpha=None),
        "binarised alpha, skip": dict(alpha="bin", skip=True),
    }
    # each in bf16 (the path) and in fp32, where the tolerance is tight
    cases = {f"{name}, {short}": dict(MAIN_FLASH, dtype=dtype, **kw)
             for name, kw in variants.items()
             for short, dtype in (("bf16", "bfloat16"), ("fp32", "float32"))}
    cases["tiny shape, fp32"] = dict(b=2, t=33, hq=6, hkv=3, dh=8,
                                     dtype="float32", delay=4)
    # the edges of the bf16 tensor-core fwd and dkv: Dh padded to 64, Dh 64
    # with a ragged last tile, another cluster size (G = 4)
    cases["tiny shape, bf16 (Dh 8 padded to 64)"] = dict(
        b=2, t=33, hq=6, hkv=3, dh=8, dtype="bfloat16", delay=4)
    cases["Dh 64, T = 300, bf16"] = dict(MAIN_FLASH, t=300, dh=64)
    cases["G = 4 (Hq 8, Hkv 2), bf16"] = dict(MAIN_FLASH, hq=8)
    before = dict(fops.launches)
    main_err = {}
    repeats = 0
    for name, kw in cases.items():
        dtype = getattr(torch, kw.pop("dtype"))
        qf, kf, vf, ls, hr, cfg, do = flash_case(torch, dtype=dtype, **kw)
        t = cfg.t
        out, lse = fops.flash_fwd(qf, kf, vf, ls, hr, cfg)
        torch.cuda.synchronize()
        out_p, lse_p = fref.flash_fwd_plain(qf, kf, vf, ls, hr, cfg)
        delta = (do.float() * out_p.float()).sum(-1)
        dq = fops.flash_dq(qf, kf, vf, ls, do, lse_p, delta, hr, cfg)
        dk, dv, dls = fops.flash_dkv(qf, kf, vf, ls, do, lse_p, delta, hr, cfg)
        torch.cuda.synchronize()
        dq_p = fref.flash_dq_plain(qf, kf, vf, ls, do, lse_p, delta, hr, cfg)
        dk_p, dv_p, dls_p = fref.flash_dkv_plain(qf, kf, vf, ls, do, lse_p,
                                                 delta, hr, cfg)
        tol = FLASH_REL_TOL[str(dtype).removeprefix("torch.")]
        pairs = {"out": (out[:, :t], out_p[:, :t]),
                 "lse": (lse[:, :t], lse_p[:, :t]), "dq": (dq, dq_p),
                 "dk": (dk, dk_p), "dv": (dv, dv_p), "dls": (dls, dls_p)}
        parts = []
        for key, (got, want) in pairs.items():
            got, want = got.float(), want.float()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash [{name}]: non-finite {key}")
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            # lse is an absolute log-scale quantity: hold it to tol x max(1, |lse|)
            if err > tol * max(scale, 1.0 if key == "lse" else 0.0) + 1e-30:
                raise AssertionError(f"flash [{name}] {key}: max abs err {err:.3e}"
                                     f" > {tol} x max |plain| {scale:.3e}")
            parts.append(f"{key} {err:.2e}/{scale:.2e}")
            if name == "retrofit shape, bf16":
                main_err[key] = err
        if dtype == torch.bfloat16:
            # no atomics anywhere: a second launch gives the same bits
            again = (fops.flash_fwd(qf, kf, vf, ls, hr, cfg)
                     + (fops.flash_dq(qf, kf, vf, ls, do, lse_p, delta, hr,
                                      cfg),)
                     + fops.flash_dkv(qf, kf, vf, ls, do, lse_p, delta, hr,
                                      cfg))
            torch.cuda.synchronize()
            repeats += 1
            if not all(torch.equal(a, b) for a, b in
                       zip(again, (out, lse, dq, dk, dv, dls))):
                raise AssertionError(f"flash [{name}]: a second launch of "
                                     "fwd, dq or dkv gave other bits")
            parts.append("fwd, dq and dkv bit-equal on a second launch")
        if hr is not None:
            parts.append(f"{int((hr == 0).sum())} of {hr.numel()} key blocks "
                         "hold no retained key")
        log(f"flash vs plain [{name}]: max abs err / max |plain|: "
            + ", ".join(parts) + f" (tolerance {tol} relative: {dtype})")
    n = len(cases)
    got = {k: fops.launches[k] - before[k] for k in fops.launches}
    want = {k: n + repeats for k in fops.launches}
    if got != want:
        raise AssertionError(f"flash launch counters moved {got}, expected "
                             f"{want}")
    return {"flash_fwd": max(main_err["out"], main_err["lse"]),
            "flash_dq": main_err["dq"],
            "flash_dkv": max(main_err["dk"], main_err["dv"], main_err["dls"])}


def phase_flash_grads(torch):
    """The autograd Function on the card (fp32, retrofit shape) against
    torch.autograd through the dense oracle: grads in q, k, v, log_surv
    and, through the α -> log_surv chain, α."""
    import torch.nn.functional as F
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention.ref import NEG_INF, dms_attention_plain
    b, t, hq, hkv, dh = 2, 1024, 12, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    leaves = [torch.randn(shape, generator=gen, device="cuda")
              for shape in ((b, t, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh))]
    alpha0 = torch.rand((b, hkv, t), generator=gen, device="cuda") * 0.88 + 0.02
    tgt = torch.randn((b, t, hq, dh), generator=gen, device="cuda")

    def grads(kernel):
        q, k, v = (x.clone().requires_grad_() for x in leaves)
        alpha = alpha0.clone().requires_grad_()
        ls = torch.clamp(torch.log1p(-torch.clamp(alpha, 0.0, 1.0)), min=NEG_INF)
        ls.retain_grad()
        if kernel:
            bk, tp = fops.padded_blocks(t)
            cfg = fops.FlashConfig(t=t, orig_dh=dh, hq=hq, hkv=hkv, window=None,
                                   dms_delay=256, causal=True, logit_cap=None,
                                   block_k=bk, skip_blocks=False)
            lsf = F.pad(ls.reshape(b * hkv, t), (0, tp - t), value=NEG_INF)
            out = fops.FlashAttention.apply(
                fops.fold_heads(q, tp), fops.fold_heads(k, tp),
                fops.fold_heads(v, tp), lsf, cfg)
            out = out[:, :t].reshape(b, hq, t, dh).transpose(1, 2)
        else:
            out = dms_attention_plain(q, k, v, ls, dms_window=256)
        (out * tgt).sum().backward()
        return {"q": q.grad, "k": k.grad, "v": v.grad, "log_surv": ls.grad,
                "alpha": alpha.grad}

    before = dict(fops.launches)
    got, want = grads(True), grads(False)
    torch.cuda.synchronize()
    moved = {k: fops.launches[k] - before[k] for k in before}
    if moved != {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}:
        raise AssertionError(f"autograd Function launched {moved}")
    parts = []
    for key in want:
        rel = ((got[key] - want[key]).abs().max()
               / want[key].abs().max().clamp_min(1e-30)).item()
        if not rel < GRAD_REL_TOL:
            raise AssertionError(f"flash grad {key}: relative error {rel:.3e}")
        parts.append(f"d{key} {rel:.2e}")
    log(f"flash autograd vs dense oracle (fp32, B={b} T={t} Hq={hq} Hkv={hkv} "
        f"Dh={dh}, delay 256): max |diff| / max |oracle|: " + ", ".join(parts)
        + f" (tolerance {GRAD_REL_TOL}: fp32 sums in another order)")


# -- phase 4 ---------------------------------------------------------------


def serving_setup(torch, device="cuda", arch_name="qwen-r1-1.5b",
                  lens=(512, 384, 256, 128), news=(64, 48, 32, 64),
                  hs=(256, 64, 4)):
    """The served model (random weights from seed 0) and the trace phases 4
    and 7 share: staggered requests and one width-W hyperscale prompt."""
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.models import transformer as tfm
    arch = get_arch(arch_name) if device == "cuda" else get_smoke(arch_name)
    # random weights almost never evict at the trained bias of -5; a bias of
    # Phi^-1(7/8) makes P(alpha = 1) = 7/8 for an N(0, 1) neuron, the
    # eviction rate of an 8x-trained model
    bias = statistics.NormalDist().inv_cdf(7 / 8)
    arch = dataclasses.replace(arch, dms=dataclasses.replace(arch.dms,
                                                             logit_bias=bias))
    t0 = time.perf_counter()
    params = tfm.init_model(arch, seed=0, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"serve: {arch.name} L={arch.num_layers} d={arch.d_model} "
        f"Hq={arch.attn.num_heads} Hkv={arch.attn.num_kv_heads} "
        f"Dh={arch.attn.head_dim} d_ff={arch.mlp.d_ff} V={arch.padded_vocab}; "
        f"init {time.perf_counter() - t0:.1f} s; dms logit_bias {bias:.4f}")
    rng = torch.Generator().manual_seed(7)

    def prompt(t):
        return torch.randint(3, arch.vocab_size, (t,), generator=rng,
                             dtype=torch.int32).numpy()

    prompts = [prompt(t) for t in lens]
    return {"arch": arch, "params": params, "device": device,
            "prompts": prompts, "news": list(news), "hs": hs,
            "hs_prompt": prompt(hs[0]),
            "max_len": max(len(p) + m for p, m in zip(prompts, news))}


# phases 4, 5, 5b and 5c serve the first SERVE_LAYERS layers of the model:
# the script's time limit (the eager decode step costs ~3.5 ms of host time
# a layer)
SERVE_LAYERS = 14
# phase 5b serves half of those: the time phase 5d takes (its checks are per
# layer and per step, and 7 layers keep a layer below the top one)
WEIGHTS_LAYERS = 7


def cut_depth(setup, layers):
    """``setup`` with its model cut to its first ``layers`` layers (views
    of the same weights, and of their noise salts)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.transformer import Params
    params = setup["params"]
    cut = Params(params)
    cut["blocks"] = {"0": tree_map(lambda a: a[:layers],
                                   params["blocks"]["0"])}
    cut.layer_salt = params.layer_salt[:layers]
    arch = dataclasses.replace(setup["arch"], num_layers=layers)
    return dict(setup, arch=arch, params=cut)


def serve_trace(torch, engine, setup, *, on_fork=None):
    """Phase 4's trace through ``engine``: the staggered requests on one
    lane per request, then the width-W hyperscale request on W lanes.
    ``on_fork(sched)`` runs right after the hyperscale prefill is forked.
    Returns (results by uid, hyperscale result, wall s, decode steps,
    staggered scheduler)."""
    from repro_torch.serving.scheduler import Request
    arch, device = setup["arch"], setup["device"]
    prompts, news, hs = setup["prompts"], setup["news"], setup["hs"]
    engine.chunk_fn.steps = 0
    t_serve = time.perf_counter()
    sched = engine.scheduler(num_lanes=len(prompts), max_len=setup["max_len"])
    for i, (p, m) in enumerate(zip(prompts, news)):
        sched.submit(Request(uid=i, prompt=p, max_new=m, arrival=i))
    results = {r.uid: r for r in sched.run()}
    hs_sched = engine.scheduler(num_lanes=hs[2], max_len=hs[0] + hs[1])
    hs_sched.submit(Request(uid=0, prompt=setup["hs_prompt"], max_new=hs[1],
                            width=hs[2]))
    if on_fork is not None:
        fork_ready = hs_sched._fork_ready

        def hooked():
            forked = [len(r.lanes) for r in hs_sched.active_reqs]
            fork_ready()
            if [len(r.lanes) for r in hs_sched.active_reqs] != forked:
                on_fork(hs_sched)
        hs_sched._fork_ready = hooked
    hres = hs_sched.run()[0]
    if on_fork is not None:
        del hs_sched._fork_ready     # the hook refers to the scheduler: a cycle
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_serve

    for i, m in enumerate(news):
        res = results[i]
        if res.status != "ok" or res.tokens.shape != (1, m) \
                or int(res.lengths[0]) != m:
            raise AssertionError(f"request {i}: status {res.status}, "
                                 f"lengths {res.lengths}, want {m}")
    if hres.status != "ok" or hres.tokens.shape != (hs[2], hs[1]) \
            or not (hres.lengths == hs[1]).all():
        raise AssertionError(f"hyperscale: status {hres.status}, "
                             f"lengths {hres.lengths}")
    for res in list(results.values()) + [hres]:
        if ((res.tokens < 0) | (res.tokens >= arch.vocab_size)).any():
            raise AssertionError(f"request {res.uid}: token outside the vocab")
    if hres.prefill_meter.kv_reads <= 0:
        raise AssertionError("hyperscale prefill metered no reads")
    return results, hres, wall, engine.chunk_fn.steps, sched


def phase_serve(torch, setup, short=32):
    """Serve the main path on fixed arenas; returns what the later phases
    compare with and print."""
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Engine
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    lens = [len(p) for p in setup["prompts"]]
    news, hs = setup["news"], setup["hs"]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    policy = KVPolicyConfig(kind="dms", cr=8.0, block_p=setup.get("block_p", 16))
    engine = Engine(arch, params, policy, use_kernel=True, device=device)
    ops.launches = ops.shared_launches = 0
    results, hres, wall, steps, sched = serve_trace(torch, engine, setup)
    launches = ops.launches
    # the CPU rehearsal runs the plain version, which launches nothing
    if launches != (arch.num_layers * steps if device == "cuda" else 0) \
            or ops.shared_launches:
        raise AssertionError(f"kernel launches {launches} (shared-pool "
                             f"{ops.shared_launches}) != {arch.num_layers} x "
                             f"{steps} decode steps")
    generated = sum(int(r.lengths.sum()) for r in results.values()) \
        + int(hres.lengths.sum())
    live_frac = results[0].meter.peak_tokens / (
        arch.num_layers * (lens[0] + news[0]))
    peak_mem = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    log(f"serve: {len(lens)} staggered requests (prompts {lens}, new "
        f"{news}) + hyperscale W={hs[2]} (prompt {hs[0]}, new {hs[1]}): "
        f"all ok; {generated} tokens in {wall:.2f} s = "
        f"{generated / wall:.2f} tokens/s; {steps} decode steps, "
        f"{1e3 * wall / steps:.2f} ms/step; kernel launches {launches} = "
        f"{arch.num_layers} x {steps}")
    log(f"serve: live fraction at the end of the {lens[0]}+{news[0]} request "
        f"{live_frac:.4f}; KV arena {int(sched.peak_bytes)} B for {len(lens)} "
        f"lanes; peak device memory {peak_mem} B; hyperscale prefill reads "
        f"{hres.prefill_meter.kv_reads:.0f}, decode reads "
        f"{hres.decode_meter.kv_reads:.0f}")

    # the kernel path against the reference path on a short teacher-forced
    # trace (launches here are not the main path's)
    rng = torch.Generator().manual_seed(8)
    tokens = torch.randint(3, arch.vocab_size, (2, short), generator=rng)
    states = [tfm.init_decode_state(arch, 2, short + 1, policy, device=device)
              for _ in range(2)]
    worst = 0.0
    scale = 0.0
    for t in range(short):
        tok = tokens[:, t:t + 1].to(device)
        lk, states[0], _ = tfm.decode_step(params, tok, states[0], arch, t,
                                           use_kernel=True)
        lr, states[1], _ = tfm.decode_step(params, tok, states[1], arch, t,
                                           use_kernel=False)
        live = torch.arange(arch.padded_vocab, device=lk.device) < arch.vocab_size
        if not bool(torch.isfinite(lk[:, live]).all()):
            raise AssertionError(f"non-finite kernel-path logits at step {t}")
        worst = max(worst, (lk - lr)[:, live].abs().max().item())
        scale = max(scale, lr[:, live].abs().max().item())
    # bf16 activations through 28 layers: the two attention paths round at
    # different places (fp32 online softmax vs one softmax, bf16 weights cast
    # before PV); hold the gap to 5% of the logits' largest magnitude
    log(f"serve: kernel vs reference logits over {short} steps: max abs diff "
        f"{worst:.4e}, max |logit| {scale:.4e} (tolerance 0.05 x max |logit|)")
    if not worst <= 0.05 * scale:
        raise AssertionError("kernel-path logits disagree with the reference")
    phase_profile(torch, params, arch, {"fixed": policy}, lanes=len(lens),
                  max_len=setup["max_len"], device=device)
    return {"launches": launches, "steps": steps, "ms_step": 1e3 * wall / steps,
            "layers": arch.num_layers,
            "arena": tuple(sched.state["0"].cache.k.shape),
            "tokens": {uid: r.tokens for uid, r in results.items()},
            "hs_tokens": hres.tokens}


def phase_paged_serve(torch, setup, fixed, pair=(3, 1)):
    """The same trace on the paged pool, then an oversubscribed pair.

    (a) Phase 4's requests and hyperscale fork with ``paged=True`` and the
    default pool (the fixed arenas' bytes): tokens equal to phase 4's, no
    page copied at the fork, copies once the chains write, every page back
    at the end.  (b) Requests ``pair`` = (A, B) of (a) on the same lanes,
    the pool at 1.5x one lane's worst-case demand, ``oversub`` 2 and
    preemption: B arrives once A holds more pages than the pool can spare
    for B, so B is preempted at admission and resumed once A is done; every
    request ok, tokens equal to (a)'s, the pool never exhausted."""
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    bp = setup.get("block_p", 16)
    base = dict(kind="dms", cr=8.0, block_p=bp, paged=True)
    engine = Engine(arch, params, KVPolicyConfig(**base), use_kernel=True,
                    device=device)
    at_fork = {}

    def on_fork(hs_sched):
        at_fork.update(hs_sched.pool_stats(), sched=hs_sched)

    ops.launches = ops.shared_launches = 0
    results, hres, wall, steps, sched = serve_trace(torch, engine, setup,
                                                    on_fork=on_fork)
    launches_a = ops.shared_launches
    if ops.launches or launches_a != (arch.num_layers * steps
                                      if device == "cuda" else 0):
        raise AssertionError(f"paged serving launched {launches_a} shared-pool"
                             f" and {ops.launches} fixed-arena kernels for "
                             f"{steps} decode steps")
    for uid, toks in fixed["tokens"].items():
        if not (results[uid].tokens == toks).all():
            raise AssertionError(f"paged request {uid}: tokens differ from "
                                 "the fixed arenas'")
    if not (hres.tokens == fixed["hs_tokens"]).all():
        raise AssertionError("paged hyperscale: tokens differ from the fixed "
                             "arenas'")
    stats = sched.pool_stats()
    if at_fork.get("cow_copies") != 0 or at_fork.get("shared_blocks", 0) <= 0:
        raise AssertionError(f"the fork copied pages or shared none: {at_fork}")
    hs_stats = at_fork["sched"].pool_stats()
    if hs_stats["cow_copies"] <= 0:
        raise AssertionError("the forked chains wrote without a CoW copy")
    for st in (stats, hs_stats):
        if st["allocated_blocks"] != 0 or st["exhausted"]:
            raise AssertionError(f"pool not empty at the end: {st}")
    h, nb = sched._pool_descs[0][:2]
    provisioned = arch.num_layers * len(setup["prompts"]) * h * nb
    generated = sum(int(r.lengths.sum()) for r in results.values()) \
        + int(hres.lengths.sum())
    log(f"paged (a): phase 4's trace on the pool: tokens equal to the fixed "
        f"arenas'; {generated} tokens in {wall:.2f} s = {generated / wall:.2f}"
        f" tokens/s; {steps} decode steps, {1e3 * wall / steps:.2f} ms/step "
        f"(fixed {fixed['ms_step']:.2f}); shared-pool kernel launches "
        f"{launches_a} = {launches_a / max(steps, 1):.1f} per decode step")
    log(f"paged (a): pool high water {stats['high_water_blocks']} blocks "
        f"(summed over {arch.num_layers} layers) against {provisioned} blocks "
        f"the fixed arenas provision for {len(setup['prompts'])} lanes "
        f"({stats['high_water_blocks'] / provisioned:.4f}); at the "
        f"hyperscale fork: {at_fork['shared_blocks']} shared blocks, "
        f"cow_copies {at_fork['cow_copies']}, at its end "
        f"{hs_stats['cow_copies']}")

    # (b) oversubscribed: A runs, B arrives when A holds more than the pool
    # can spare for B's worst case, and waits out A as a preempted request
    ia, ib = pair
    prompts, news = setup["prompts"], setup["news"]
    demand = sched._lane_pool_demand(setup["max_len"])[0]
    pool_blocks = int(1.5 * demand)
    tok_a, tok_b = (len(prompts[i]) + news[i] for i in pair)
    need_b = sched._lane_pool_demand(tok_b)[0]
    chunk = engine.chunk
    # A's pages after T tokens, before its first delayed eviction (T <=
    # window): H * ceil(T / bp); B's first resume attempt is one tick after
    # its arrival, and must find fewer than need_b pages free
    t_need = bp * ((pool_blocks - need_b) // h) + 1
    arrival_b = max(0, min(-(-t_need // chunk) - 1, tok_a // chunk - 2))
    if t_need > min(arch.dms.window, tok_a - chunk) and device == "cuda":
        raise AssertionError(f"pair {pair} cannot block B's resume: needs A at"
                             f" {t_need} tokens")
    engine_b = Engine(arch, params,
                      KVPolicyConfig(**base, pool_blocks=pool_blocks),
                      use_kernel=True, device=device)
    engine_b.chunk_fn.steps = 0
    t_b = time.perf_counter()
    sched_b = engine_b.scheduler(num_lanes=len(prompts),
                                 max_len=setup["max_len"], oversub=2.0,
                                 on_pressure="preempt")
    for uid, arr in ((ia, 0), (ib, arrival_b)):
        sched_b.submit(Request(uid=uid, prompt=prompts[uid],
                               max_new=news[uid], arrival=arr))
    res_b = {r.uid: r for r in sched_b.run()}
    if device == "cuda":
        torch.cuda.synchronize()
    wall_b = time.perf_counter() - t_b
    steps_b = engine_b.chunk_fn.steps
    launches = ops.shared_launches
    stats_b = sched_b.pool_stats()
    life = stats_b["lifecycle"]
    if ops.launches or launches - launches_a != (
            arch.num_layers * steps_b if device == "cuda" else 0):
        raise AssertionError(f"oversubscribed run launched "
                             f"{launches - launches_a} for {steps_b} steps")
    if any(r.status != "ok" for r in res_b.values()) \
            or not life["preemptions"] == life["resumes"] > 0 \
            or stats_b["exhausted"] or stats_b["allocated_blocks"] != 0:
        raise AssertionError(f"oversubscribed run: statuses "
                             f"{ {u: r.status for u, r in res_b.items()} }, "
                             f"pool {stats_b}")
    for uid in pair:
        if not (res_b[uid].tokens == results[uid].tokens).all():
            raise AssertionError(f"oversubscribed request {uid}: tokens differ"
                                 " from (a)'s")
    log(f"paged (b): requests {ia} ({tok_a} tokens, arrival 0) and {ib} "
        f"({tok_b} tokens, arrival {arrival_b}) on {len(prompts)} lanes, pool "
        f"{pool_blocks} blocks a layer (1.5 x one lane's worst case {demand};"
        f" together {sched._lane_pool_demand(tok_a)[0] + need_b}), oversub 2:"
        f" all ok, tokens equal to (a)'s; preemptions {life['preemptions']}, "
        f"resumes {life['resumes']} (preempt_count, latency ticks: "
        f"{ {u: (r.preempt_count, r.latency_ticks) for u, r in res_b.items()} });"
        f" cow_copies {stats_b['cow_copies']}, high water "
        f"{stats_b['high_water_blocks']} blocks, never exhausted; {steps_b} "
        f"decode steps in {wall_b:.2f} s = {1e3 * wall_b / steps_b:.2f} "
        f"ms/step; shared-pool kernel launches {launches - launches_a}")
    phase_profile(torch, params, arch,
                  {"fixed": KVPolicyConfig(**dict(base, paged=False)),
                   "paged": KVPolicyConfig(**base)},
                  lanes=len(prompts), max_len=setup["max_len"], device=device)
    return {"launches": launches, "steps": steps + steps_b}


# the weight-driven policies the weights phase serves: (kind, paged)
WEIGHT_RUNS = (("tova", False), ("tova", True), ("h2o", False),
               ("keyformer", False))


def checked_weights(torch, real, worst):
    """``ops.decode_rows`` that also runs each weights-out call's plain
    version on the same inputs (fixed arenas) and holds the kernel's
    outputs and group-summed weights against it (``weights_errors``),
    recording the largest errors in ``worst``; every row that sees a slot
    must sum to G within 2e-2 (bf16 activations upstream).  The plain
    version launches nothing, so the launch counters stay the path's."""
    from repro_torch.kernels.dms_decode.ref import dms_decode_plain_weights

    def decode_rows(qf, kf, vf, valf, tblf, nf, block_p, logit_cap=None,
                    shared_kv=False, need_weights=False):
        got = real(qf, kf, vf, valf, tblf, nf, block_p, logit_cap,
                   shared_kv=shared_kv, need_weights=need_weights)
        if not need_weights or shared_kv:
            return got
        want = dms_decode_plain_weights(qf, kf, vf, valf, tblf, nf, block_p,
                                        logit_cap)
        errs, weights = weights_errors(torch, got, want, nf, tblf,
                                       kf.shape[1] // block_p)
        for key, err in errs.items():
            worst[key] = max(worst.get(key, 0.0), err)
        sums = weights.sum(-1)
        live = got[4].sum(-1) > 0
        g = qf.shape[1]
        if not torch.allclose(sums[live], torch.full_like(sums[live], g),
                              rtol=2e-2) or sums[~live].any():
            raise AssertionError(f"weights-out rows do not sum to G = {g}: "
                                 f"{sums.tolist()}")
        worst["rows"] = worst.get("rows", 0) + int(live.sum())
        return got
    return decode_rows


def phase_weights_serve(torch, setup, fixed, reqs=(2, 3), short=24,
                        short_len=128):
    """The weight-driven policies through the weights-out kernel.

    Requests ``reqs`` of phase 4's trace (at their phase-4 arrivals) on the
    same lanes and model, at CR 8: TOVA on fixed arenas and on the paged
    pool, H2O and Keyformer on fixed arenas.  Every request ends ok with
    its full token count, the weights-out kernel launches once per layer per
    decode step (and no other mode launches), ``live_tokens`` never exceeds
    the budget, and the pool's TOVA tokens equal the fixed arenas'.  Then
    for each policy a teacher-forced trace (``short`` steps, ``short_len``
    arenas, so that it evicts) holds the kernel path's logits against the
    reference path's from the same cache at each step, and every
    weights-out call in it against the plain version
    (``checked_weights``); the greedy tokens of the two paths and the
    evictions that differ are reported, not required equal (near-tied
    evictions may flip)."""
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    bp = setup.get("block_p", 16)
    lanes, max_len = len(setup["prompts"]), setup["max_len"]
    budget = int(max_len / 8.0)
    cuda = device == "cuda"
    runs = {}
    for kind, paged in WEIGHT_RUNS:
        policy = KVPolicyConfig(kind=kind, cr=8.0, block_p=bp, paged=paged)
        engine = Engine(arch, params, policy, use_kernel=True, device=device)
        engine.chunk_fn.steps = 0
        ops.launches = ops.shared_launches = ops.weights_launches = 0
        t0 = time.perf_counter()
        sched = engine.scheduler(num_lanes=lanes, max_len=max_len)
        for uid in reqs:
            sched.submit(Request(uid=uid, prompt=setup["prompts"][uid],
                                 max_new=setup["news"][uid], arrival=uid))
        res = {r.uid: r for r in sched.run()}
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps, launches = engine.chunk_fn.steps, ops.weights_launches
        name = f"{kind} ({'paged' if paged else 'fixed'})"
        if ops.launches or ops.shared_launches \
                or launches != (arch.num_layers * steps if cuda else 0):
            raise AssertionError(f"{name}: weights-out launches {launches}, "
                                 f"other modes {ops.launches}, "
                                 f"{ops.shared_launches}, for {steps} steps")
        for uid in reqs:
            r, m = res[uid], setup["news"][uid]
            if r.status != "ok" or r.tokens.shape != (1, m) \
                    or int(r.lengths[0]) != m \
                    or ((r.tokens < 0) | (r.tokens >= arch.vocab_size)).any():
                raise AssertionError(f"{name} request {uid}: status {r.status},"
                                     f" lengths {r.lengths}, want {m}")
            if r.meter.peak_tokens > arch.num_layers * budget:
                raise AssertionError(f"{name} request {uid}: peak live tokens "
                                     f"{r.meter.peak_tokens} over "
                                     f"{arch.num_layers} x {budget}")
        cache = sched.state["0"].cache
        nb = (cache.phys if paged else cache.valid).shape[-1]
        runs[(kind, paged)] = {
            "tokens": {uid: res[uid].tokens for uid in reqs},
            "launches": launches, "steps": steps,
            "ms_step": 1e3 * wall / steps, "arena": cache.valid.shape[-1]}
        log(f"weights: {name}, requests {list(reqs)} (prompts "
            f"{[len(setup['prompts'][u]) for u in reqs]}, new "
            f"{[setup['news'][u] for u in reqs]}) on {lanes} lanes, CR 8 "
            f"(budget {budget}, arena {cache.valid.shape[-1]} slots, "
            f"{nb if paged else nb // bp} blocks a head): all ok; {steps} "
            f"decode steps in {wall:.2f} s = {1e3 * wall / steps:.2f} ms/step "
            f"({1e3 * wall / steps / arch.num_layers:.2f} a layer; phase 4's "
            f"dms {fixed['ms_step'] / fixed['layers']:.2f} a layer); "
            f"weights-out launches "
            f"{launches} = {launches / max(steps, 1):.1f} per decode step; "
            f"peak live tokens {[res[u].meter.peak_tokens for u in reqs]} "
            f"<= {arch.num_layers} x {budget}")
    for uid, toks in runs[("tova", False)]["tokens"].items():
        if not (runs[("tova", True)]["tokens"][uid] == toks).all():
            raise AssertionError(f"tova request {uid}: pool tokens differ from "
                                 "the fixed arenas'")

    # kernel path against reference path, teacher-forced: each step runs
    # both paths from the same cache (a copy), so the logits differ only by
    # this step's attention; the trace goes on from the kernel path's cache.
    # An eviction that differs between the two is a near tie flipped by
    # rounding (ROADMAP C): counted, not failed.  Launches here are not the
    # main path's.
    from repro_torch.core.tree import tree_map
    rng = torch.Generator().manual_seed(9)
    tokens = torch.randint(3, arch.vocab_size, (2, short), generator=rng)
    live = torch.arange(arch.padded_vocab, device=device) < arch.vocab_size
    real = ops.decode_rows
    for kind in ("tova", "h2o", "keyformer"):
        policy = KVPolicyConfig(kind=kind, cr=8.0, block_p=bp)
        state = tfm.init_decode_state(arch, 2, short_len, policy,
                                      device=device)
        small = int(short_len / 8.0)
        worst, gap, scale, agree, flips, evictions = {}, 0.0, 0.0, 0, 0, 0
        ops.decode_rows = checked_weights(torch, real, worst)
        try:
            for t in range(short):
                tok = tokens[:, t:t + 1].to(device)
                before = state["0"].cache.valid.clone()
                ref_state = tree_map(torch.clone, state)
                lk, _, _ = tfm.decode_step(params, tok, state, arch, t,
                                           use_kernel=True)
                lr, _, _ = tfm.decode_step(params, tok, ref_state, arch, t,
                                           use_kernel=False)
                if not bool(torch.isfinite(lk[:, live]).all()):
                    raise AssertionError(f"{kind}: non-finite kernel-path "
                                         f"logits at step {t}")
                valid = state["0"].cache.valid
                if int(valid.sum(-1).max()) > small:
                    raise AssertionError(f"{kind}: a layer holds more than "
                                         f"its budget {small}")
                evicted = (before & ~valid).any(-1)
                evictions += int(evicted.sum())
                flips += int((valid != ref_state["0"].cache.valid)
                             .any(-1).sum())
                gap = max(gap, (lk - lr)[:, live].abs().max().item())
                scale = max(scale, lr[:, live].abs().max().item())
                agree += int((lk[:, live].argmax(-1)
                              == lr[:, live].argmax(-1)).sum())
        finally:
            ops.decode_rows = real
        log(f"weights: {kind} kernel vs reference path over {short} "
            f"teacher-forced steps, both from the same cache each step (arena "
            f"budget {small}): max abs logit diff {gap:.4e}, max |logit| "
            f"{scale:.4e} (tolerance 0.05 x max |logit|); greedy tokens agree "
            f"at {agree} of {2 * short} positions and evictions differ in "
            f"{flips} of {evictions} (layer, lane, head) rows (reported only);"
            f" {worst.get('rows', 0)} weights-out rows against the plain "
            "version: max abs err "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items() if k != "rows"))
        if not gap <= 0.05 * scale:
            raise AssertionError(f"{kind}: kernel-path logits disagree with "
                                 "the reference path")
    phase_profile(torch, params, arch,
                  {"dms": KVPolicyConfig(kind="dms", cr=8.0, block_p=bp),
                   **{k: KVPolicyConfig(kind=k, cr=8.0, block_p=bp)
                      for k in ("tova", "h2o", "keyformer")}},
                  lanes=lanes, max_len=max_len, device=device, pairs=2)
    return {"fixed": sum(r["launches"] for (k, paged), r in runs.items()
                         if not paged),
            "shared": runs[("tova", True)]["launches"],
            "arena": runs[("tova", False)]["arena"],
            "ms_step": {f"{k}{' paged' if p else ''}": r["ms_step"]
                        for (k, p), r in runs.items()}}


def eval_runs(torch, setup, runs, *, prompt_len, max_len, shared=False):
    """``evaluate_hyperscale(..., seed=0)`` at temperature 0.7 on one
    needle problem (``make_eval_set``) for each of ``runs``: name ->
    (policy config, W, CR, DMS delay for ``analytic_budget``).  Every
    request ends ok with its full length, the decode kernel launches once
    per layer per decode step in one mode (the shared-pool mode where
    ``shared`` names the run, else the fixed-arena mode) and the W > 1
    chains are not all equal (sampling happened).  Returns per run the
    result, W, steps, launches, modeled K/V bytes a decode step, chain 0's
    tokens and the launch shapes."""
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.hyperscale import ScalingConfig, analytic_budget
    from repro_torch.data import tasks
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.serving.engine import Engine, evaluate_hyperscale
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    cuda = device == "cuda"
    task = tasks.TaskConfig(kind="needle", vocab_size=64,
                            prompt_len=prompt_len, seed=0)
    prompts, answers = tasks.make_eval_set(task, 1)
    pooled = set()
    recording, listed, shapes, real = recording_decode_rows(torch, device,
                                                            pooled)
    out = {}
    ops.decode_rows = recording
    try:
        for name, (kw, width, cr, window) in runs.items():
            engine = Engine(arch, params, KVPolicyConfig(**kw),
                            use_kernel=True, temperature=0.7, device=device)
            seen = []

            def record(prompt, cfg, seed=0, _real=engine.hyperscale_generate):
                seen.append(_real(prompt, cfg, seed=seed))
                return seen[-1]
            engine.hyperscale_generate = record
            cfg = ScalingConfig(max_len, width, cr)
            engine.chunk_fn.steps = 0
            listed.zero_()
            shapes.clear()
            pooled.clear()
            ops.launches = ops.shared_launches = ops.weights_launches = 0
            t0 = time.perf_counter()
            res = evaluate_hyperscale(engine, prompts, answers, cfg, seed=0)
            del engine.hyperscale_generate     # the hook holds the engine
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = engine.chunk_fn.steps
            want = arch.num_layers * steps if cuda else 0
            got = (ops.launches, ops.shared_launches, ops.weights_launches)
            mode = "shared-pool" if name == shared else "fixed-arena"
            if got != ((0, want, 0) if name == shared else (want, 0, 0)):
                raise AssertionError(
                    f"{name}: launches (fixed, shared, weights-out) {got} for "
                    f"{steps} decode steps")
            launches = max(got)
            new = max_len - prompt_len
            for r in seen:
                req = r.requests[0]
                if req.status != "ok" or not (req.lengths == new).all():
                    raise AssertionError(f"{name}: status {req.status}, "
                                         f"lengths {req.lengths}")
                if width > 1 and len({tuple(c) for c in r.tokens.tolist()}) < 2:
                    raise AssertionError(f"{name}: the {width} chains are "
                                         "identical: no sampling")
            reads, peak = analytic_budget(max_len, width, cr, arch.num_layers,
                                          window)
            # the table's blocks: Quest's are its pages
            tbl_bp = kw.get("quest_page_size", 16) if kw["kind"] == "quest" \
                else kw.get("block_p", 16)
            kv_bytes = ops.modeled_hbm_bytes(listed, tbl_bp,
                                             arch.attn.head_dim,
                                             torch.bfloat16, torch.bfloat16)
            out[name] = dict(res=res, width=width, steps=steps,
                             launches=launches,
                             bytes_step=kv_bytes / max(steps, 1),
                             tokens=seen[0].tokens,
                             shapes=set(shapes) | set(pooled))
            log(f"hyperscale (a): {name} at {max_len}-{width}-{cr:g} on one "
                f"needle problem (prompt {prompt_len}), temperature 0.7, seed "
                f"0: all ok; accuracy {res['accuracy']} (random weights: "
                f"reported, not judged); kv_reads {res['kv_reads']:.1f} "
                f"(analytic {reads:.1f}), peak_tokens {res['peak_tokens']:.1f}"
                f" (analytic {peak:.1f}), peak_bytes {res['peak_bytes']:.0f};"
                f" {steps} decode steps in {wall:.2f} s = "
                f"{1e3 * wall / max(steps, 1):.2f} ms/step; {mode} "
                f"launches {launches} = {arch.num_layers} x {steps}; modeled "
                f"K/V bytes a decode step {kv_bytes / max(steps, 1):.0f} "
                f"(listed blocks {int(listed.item())})")
    finally:
        ops.decode_rows = real
    return out


def phase_hyperscale_eval(torch, setup, *, prompt_len=288, max_len=320):
    """(a) The paper's comparison through ``evaluate_hyperscale`` at
    temperature 0.7 (``eval_runs``): ``vanilla`` at L-W-CR 320-1-1, ``dms``
    at 320-4-8 and ``dms_masked`` at 320-4; ``dms`` holds fewer peak tokens
    a chain than ``vanilla``.  Accuracy, meters, ``analytic_budget`` and
    the modeled K/V bytes a decode step are printed."""
    arch = setup["arch"]
    bp = setup.get("block_p", 16)
    runs = {"vanilla": (dict(kind="vanilla", block_p=bp), 1, 1.0, 0),
            "dms": (dict(kind="dms", cr=8.0, block_p=bp), 4, 8.0,
                    arch.dms.window),
            "dms_masked": (dict(kind="dms_masked", block_p=bp), 4, 8.0,
                           arch.dms.window)}
    out = eval_runs(torch, setup, runs, prompt_len=prompt_len,
                    max_len=max_len)
    per_chain = {k: v["res"]["peak_tokens"] / v["width"] for k, v in out.items()}
    if not per_chain["dms"] < per_chain["vanilla"]:
        raise AssertionError(f"dms peak tokens a chain {per_chain['dms']} not "
                             f"below vanilla's {per_chain['vanilla']}")
    same = float((out["dms"]["tokens"] == out["dms_masked"]["tokens"]).mean())
    b_dms, b_mask, b_van = (out[k]["bytes_step"]
                            for k in ("dms", "dms_masked", "vanilla"))
    log(f"hyperscale (a): peak tokens a chain: vanilla {per_chain['vanilla']:.1f},"
        f" dms {per_chain['dms']:.1f}, dms_masked "
        f"{per_chain['dms_masked']:.1f}; modeled K/V bytes a decode step: dms "
        f"{b_dms:.0f}, dms_masked {b_mask:.0f} ({b_mask / max(b_dms, 1):.4f}x"
        f" dms; both four chains after one prefill), vanilla {b_van:.0f} (one "
        f"chain); dms and dms_masked tokens equal at {same:.4f} of positions "
        "(reported only: their bf16 sums run in another slot order)")
    return out


def serve_layouts(torch, setup, layouts, *, uid=3, what="layouts (b)"):
    """Request ``uid`` of phase 4's trace, greedy, on each of ``layouts``
    (name -> policy config) on one lane.  Each ok with its full token
    count; the decode kernel launches once per layer per decode step, in
    the shared-pool mode where the layout streams pool pages (paged, but
    not ``dmc``, whose pool holds fp32 accumulators: its kernel reads a
    dense cast), else the fixed-arena mode; a paged layout has every page
    back in the pool at the end.  Returns each layout's tokens, launches
    (fixed, shared, weights-out) and launch shapes (``launch_key``)."""
    from repro_torch.core import policy as policy_lib
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    cuda = device == "cuda"
    prompt, new = setup["prompts"][uid], setup["news"][uid]
    tokens, launched, shaped = {}, {}, {}
    pooled = set()
    recording, _, shapes, real = recording_decode_rows(torch, device, pooled)
    for name, kw in layouts.items():
        engine = Engine(arch, params, KVPolicyConfig(**kw), use_kernel=True,
                        device=device)
        engine.chunk_fn.steps = 0
        ops.launches = ops.shared_launches = ops.weights_launches = 0
        shapes.clear()
        pooled.clear()
        t0 = time.perf_counter()
        sched = engine.scheduler(num_lanes=1, max_len=len(prompt) + new)
        sched.submit(Request(uid=uid, prompt=prompt, max_new=new))
        ops.decode_rows = recording
        try:
            res = sched.run()[0]
        finally:
            ops.decode_rows = real
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        shaped[name] = set(shapes) | set(pooled)
        steps = engine.chunk_fn.steps
        want = arch.num_layers * steps if cuda else 0
        paged = kw.get("paged", False)
        streams = paged and kw["kind"] != "dmc"
        got = (ops.launches, ops.shared_launches, ops.weights_launches)
        if got != ((0, want, 0) if streams else (want, 0, 0)):
            raise AssertionError(f"{what}: {name}: launches (fixed, shared, "
                                 f"weights-out) {got} for {steps} steps")
        if res.status != "ok" or int(res.lengths[0]) != new:
            raise AssertionError(f"{what}: {name}: status {res.status}, "
                                 f"lengths {res.lengths}")
        pool = ""
        if paged:
            stats = policy_lib.state_pool_stats(sched.state)
            if stats["allocated_blocks"] or stats["exhausted"]:
                raise AssertionError(f"{what}: {name}: pages left allocated "
                                     f"at the end: {stats}")
            pool = (f"; pool high water {stats['high_water_blocks']} of "
                    f"{stats['pool_blocks']} pages, every page back at the "
                    "end")
        tokens[name] = res.tokens
        launched[name] = got
        log(f"{what}: {name}, request {uid} (prompt {len(prompt)}, {new} "
            f"new), greedy: ok; {steps} decode steps in {wall:.2f} s = "
            f"{1e3 * wall / steps:.2f} ms/step; launches (fixed, shared, "
            f"weights-out) {got}; peak_tokens {res.meter.peak_tokens:.1f}, "
            f"kv_reads {res.meter.kv_reads:.1f}{pool}")
    return tokens, launched, shaped


def phase_layouts(torch, setup, *, uid=3, window_budget=128):
    """(b) Request ``uid`` of phase 4's trace, greedy, on five layouts
    (``serve_layouts``): ``vanilla`` on fixed arenas, on the pool and with
    ``block_p`` 0 (the kernel's legacy dense mode), ``window`` with a ring
    of ``window_budget + 1`` slots (it recycles past it) and ``dms_masked``
    on the pool; the pool's vanilla tokens equal the fixed arenas'.
    Returns each layout's launches (fixed, shared, weights-out) and the
    launch shapes of its runs."""
    bp = setup.get("block_p", 16)
    layouts = {
        "vanilla fixed": dict(kind="vanilla", block_p=bp),
        "vanilla paged": dict(kind="vanilla", block_p=bp, paged=True),
        "vanilla block_p 0": dict(kind="vanilla", block_p=0),
        f"window budget {window_budget}": dict(kind="window",
                                               budget=window_budget,
                                               block_p=bp),
        "dms_masked paged": dict(kind="dms_masked", block_p=bp, paged=True),
    }
    tokens, launched, shaped = serve_layouts(torch, setup, layouts, uid=uid)
    if not (tokens["vanilla paged"] == tokens["vanilla fixed"]).all():
        raise AssertionError("vanilla: the pool's tokens differ from the "
                             "fixed arenas'")
    same = float((tokens["vanilla block_p 0"] == tokens["vanilla fixed"]).mean())
    log(f"layouts (b): vanilla paged tokens equal to fixed; block_p 0 tokens "
        f"equal to fixed at {same:.4f} of positions (reported only: the "
        "dense mode's 128-slot blocks sum in another order)")
    return launched, shaped


def quest_spy(torch, attn_lib, tables, worst):
    """``attn_lib._masked_decode`` that keeps each call's (table, n) in
    ``tables``, and on the kernel path also runs the reference attention on
    the same operands, holds the output within ``KERNEL_TOL`` and keeps the
    largest difference in ``worst[0]``.  Returns (the wrapper, the real
    function)."""
    real = attn_lib._masked_decode

    def masked_decode(q, spec, window, cfg, use_kernel, pos_t=None,
                      need_weights=False):
        tables.append((spec.block_tbl.clone(), spec.block_n.clone()))
        out = real(q, spec, window, cfg, use_kernel, pos_t, need_weights)
        if use_kernel:
            ref = real(q, spec, window, cfg, False, pos_t, need_weights)[0]
            torch.testing.assert_close(out[0].float(), ref.float(),
                                       **KERNEL_TOL)
            worst[0] = max(worst[0],
                           (out[0].float() - ref.float()).abs().max().item())
        return out
    return masked_decode, real


def policy_paths(torch, setup, traces, *, steps=48, what="paths (c)"):
    """Kernel path against reference path, teacher-forced: each step runs
    both paths from the same cache (a copy), so the logits differ only by
    this step's attention, for each of ``traces`` (name -> (arch, policy
    config)), two lanes of arenas of ``steps + 16``; the logits
    within 0.05 x max |logit|.  Quest selects pages by scores that the
    layers below feed: where an ulp of theirs flips a near tie of page
    scores, the two paths attend over other pages.  So for Quest every
    layer's kernel output is also held against the reference attention on
    the same operands (``KERNEL_TOL``), a step whose page tables differ
    between the paths in any layer is counted and its logits not held,
    and at least half of the steps must be held.  Returns the launch
    shapes of the kernel path (``launch_key``) by trace.  Launches here are
    not the main path's."""
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import transformer as tfm
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    bp = setup.get("block_p", 16)
    rng = torch.Generator().manual_seed(10)
    tokens = torch.randint(3, arch.vocab_size, (2, steps), generator=rng)
    live = torch.arange(arch.padded_vocab, device=device) < arch.vocab_size
    pooled = set()
    recording, _, shapes, real = recording_decode_rows(torch, device, pooled)
    shaped = {}
    for name, (a, kw) in traces.items():
        state = tfm.init_decode_state(a, 2, steps + 16, KVPolicyConfig(**kw),
                                      device=device)
        shapes.clear()
        pooled.clear()
        gap = scale = 0.0
        agree = flips = 0
        tables, worst = [], [0.0]
        quest = kw["kind"] == "quest"
        spy, real_attn = quest_spy(torch, attn_lib, tables, worst)
        for t in range(steps):
            tok = tokens[:, t:t + 1].to(device)
            ref_state = tree_map(torch.clone, state)
            tables.clear()
            ops.decode_rows = recording
            if quest:
                attn_lib._masked_decode = spy
            try:
                lk, _, aux = tfm.decode_step(params, tok, state, a, t,
                                             use_kernel=True)
                lr, _, _ = tfm.decode_step(params, tok, ref_state, a, t,
                                           use_kernel=False)
            finally:
                ops.decode_rows = real
                attn_lib._masked_decode = real_attn
            if not bool(torch.isfinite(lk[:, live]).all()):
                raise AssertionError(f"{name}: non-finite kernel-path logits "
                                     f"at step {t}")
            half = len(tables) // 2
            if any(not (torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]))
                   for x, y in zip(tables[:half], tables[half:])):
                flips += 1
                continue
            gap = max(gap, (lk - lr)[:, live].abs().max().item())
            scale = max(scale, lr[:, live].abs().max().item())
            agree += int((lk[:, live].argmax(-1) == lr[:, live].argmax(-1)).sum())
        cache = state["0"].cache
        note = ""
        if kw["kind"] == "window":
            if not bool(cache.overflowed.all()):
                raise AssertionError(f"{name}: the ring never recycled")
            note = "; the ring recycled in every layer and lane"
        if kw["kind"] == "dms_masked":
            # a holed block: listed (a retained slot) but missing an evicted one
            nb = cache.blocks.count.shape[-1]
            written = torch.clamp(steps - bp * torch.arange(nb, device=device),
                                  0, bp)
            count = cache.blocks.count
            holed = int(((count > 0) & (count < written)).sum())
            if not holed:
                raise AssertionError(f"{name}: no listed block has a hole")
            note = (f"; {holed} listed blocks hold evicted slots (summed over "
                    "layers, lanes and heads)")
        if quest:
            reads, held = (float(aux[k].sum()) for k in ("reads_tokens",
                                                         "live_tokens"))
            if not reads < held:
                raise AssertionError(f"{name}: reads {reads} not below the "
                                     f"{held} tokens held")
            if 2 * flips > steps:
                raise AssertionError(f"{name}: {flips} of {steps} steps chose "
                                     "other pages on the two paths")
            note = (f"; last step reads {reads:.0f} of {held:.0f} tokens "
                    f"held; every layer's kernel output within "
                    f"{worst[0]:.3e} of the reference attention on the same "
                    f"pages; {flips} of {steps} steps chose other pages on "
                    "the two paths (a near tie of page scores after the "
                    "layers below rounded apart): their logits not held")
        if kw["kind"] == "dmc":
            count = cache.count
            full = int((count > cache.z.shape[-1]).sum())
            note = (f"; {int(count.sum())} entries hold the {steps} tokens of "
                    f"each of {count.numel()} (layer, lane, head) rows (at "
                    f"most {int(count.max())}; {full} rows outgrew their "
                    f"{cache.z.shape[-1]}-slot arena, whose writes drop, as "
                    "the reference's do)")
            if not int(count.sum()) < count.numel() * steps:
                raise AssertionError(f"{name}: no token merged")
        log(f"{what}: {name} kernel vs reference path over {steps} "
            f"teacher-forced steps from the same cache: max abs logit diff "
            f"{gap:.4e}, max |logit| {scale:.4e} (tolerance 0.05 x max "
            f"|logit|); greedy tokens agree at {agree} of "
            f"{2 * (steps - flips)}{note}")
        if not gap <= 0.05 * scale:
            raise AssertionError(f"{name}: kernel-path logits disagree with "
                                 "the reference path")
        shaped[name] = set(shapes) | set(pooled)
    return shaped


def phase_policy_paths(torch, setup, *, steps=48, window_budget=32):
    """(c) ``policy_paths`` for ``vanilla`` fixed and paged, ``window`` (a
    ring of ``window_budget + 1`` slots, so that it recycles) and
    ``dms_masked`` fixed and paged with the DMS delay window cut to 16 (so
    that it evicts within the trace and the kernel reads holed tables)."""
    arch = setup["arch"]
    bp = setup.get("block_p", 16)
    arch16 = dataclasses.replace(arch, dms=dataclasses.replace(arch.dms,
                                                               window=16))
    traces = {
        "vanilla fixed": (arch, dict(kind="vanilla", block_p=bp)),
        "vanilla paged": (arch, dict(kind="vanilla", block_p=bp, paged=True)),
        "window": (arch, dict(kind="window", budget=window_budget,
                              block_p=bp)),
        "dms_masked fixed (delay 16)": (arch16, dict(kind="dms_masked",
                                                     block_p=bp)),
        "dms_masked paged (delay 16)": (arch16, dict(kind="dms_masked",
                                                     block_p=bp, paged=True)),
    }
    policy_paths(torch, setup, traces, steps=steps)


def phase_sampling(torch, setup, seeds=8):
    """(d) ``threefry.categorical`` over a (4, padded vocab) fp32 logits
    tensor on the device against the CPU, for ``seeds`` seeds: the
    Threefry bits equal, the drawn indices equal; every Gumbel value that
    differs by more than 1 ulp is counted and printed (each log may round
    an ulp apart, and the outer log amplifies the inner one's)."""
    import numpy as np
    from repro_torch.core import threefry
    from repro_torch.serving.scheduler import sample
    arch, device = setup["arch"], setup["device"]
    gen = torch.Generator().manual_seed(11)
    logits = torch.randn((4, arch.padded_vocab), generator=gen) * 4.0
    logits[:, arch.vocab_size:] = -1e30
    off, n_off = [], 0
    for seed in range(seeds):
        _, sub_c = threefry.split(threefry.prng_key(seed))
        _, sub_d = threefry.split(threefry.prng_key(seed, device=device))
        if not torch.equal(threefry.random_bits(sub_d, logits.shape).cpu(),
                           threefry.random_bits(sub_c, logits.shape)):
            raise AssertionError(f"seed {seed}: Threefry bits differ")
        g_c = threefry.gumbel(sub_c, logits.shape)
        g_d = threefry.gumbel(sub_d, logits.shape).cpu()
        ulp = torch.from_numpy(np.spacing(g_c.abs().numpy()))
        beyond = torch.nonzero((g_d - g_c).abs() > ulp)
        n_off += len(beyond)
        off += [(seed, *map(int, ix), float(g_c[tuple(ix)]),
                 float(g_d[tuple(ix)])) for ix in beyond[:2]]
        got = sample(sub_d, logits.to(device), 0.7).cpu()
        want = sample(sub_c, logits, 0.7)
        if not torch.equal(got, want):
            raise AssertionError(f"seed {seed}: drawn indices {got.tolist()} "
                                 f"on {device}, {want.tolist()} on the CPU")
    log(f"sampling (d): categorical over (4, {arch.padded_vocab}) fp32 logits "
        f"at temperature 0.7 on {device} against the CPU, {seeds} seeds: "
        f"Threefry bits equal, drawn indices equal; Gumbel values more than "
        f"1 ulp apart: {n_off} of {seeds * logits.numel()} (seed, row, col, "
        f"cpu, device; the first 2 a seed): {off}")


def phase_hyperscale_serve(torch, setup, **kw):
    """Phase 5c: (a) the hyper-scaling evaluation, (b) the layouts, (c) the
    kernel path against the reference path, (d) sampling on the device.
    Returns the prefix-table launches of the main path's runs (the
    fixed-arena launches of ``vanilla`` in (a) and on fixed arenas in (b)),
    the shapes of every fixed-arena launch of ``vanilla`` in (a) and (b),
    ``block_p`` 0 included, and (a)'s results."""
    evals = phase_hyperscale_eval(torch, setup, **kw.get("eval", {}))
    layouts, shaped = phase_layouts(torch, setup, **kw.get("layouts", {}))
    phase_policy_paths(torch, setup, **kw.get("paths", {}))
    phase_sampling(torch, setup)
    fixed = [shape for k, v in shaped.items() if k.startswith("vanilla")
             for shape in v if "shared" not in shape]
    return {"prefix": evals["vanilla"]["launches"]
            + layouts["vanilla fixed"][0],
            "vanilla_shapes": evals["vanilla"]["shapes"].union(fixed),
            "evals": evals}


def quest_reads_by_hand(prompt_len, max_len, width, layers, page, top):
    """Quest's ``kv_reads`` on one hyperscale problem, counted by hand: a
    step reads ``min(ceil(length / page), top)`` whole pages a layer, its
    own token counted in ``length``; the prompt's steps on one lane
    (lengths 1 .. prompt_len), then W chains at lengths prompt_len + 1 ..
    max_len - 1 (the first new token is drawn from the prefill's logits
    and the last one is never fed back)."""
    def reads(length):
        return min(-(-length // page), top) * page
    prefill = sum(reads(t) for t in range(1, prompt_len + 1))
    decode = sum(reads(t) for t in range(prompt_len + 1, max_len))
    return layers * (prefill + width * decode)


def phase_quest_dmc_serve(torch, setup, base, layouts, *, prompt_len=288,
                          uid=3, steps=48):
    """Phase 5d, Quest and DMC on the same model (``layouts`` from
    ``qd_layouts``): (a) ``evaluate_hyperscale`` at temperature 0.7 on 5c's
    needle problem (``eval_runs``), ``quest`` and ``dmc`` at 320-4-8 beside
    ``base``, 5c (a)'s results: Quest's ``kv_reads`` equal to
    ``quest_reads_by_hand`` and below vanilla's, its peak tokens a chain
    equal to vanilla's, DMC's below; (b) request ``uid`` greedy on Quest
    and DMC, fixed and paged (``serve_layouts``): the pool's tokens equal
    the fixed arenas'; (c) the kernel path against the reference path
    (``policy_paths``); then a profiled step of each beside dms, and the
    device time of Quest's page scoring and of DMC's cast a layer.
    Returns the main path's launches by table kind and mode, and the
    launch shapes of (a)-(c) by policy."""
    from repro_torch.core import policy as policy_lib
    from repro_torch.core.config import KVPolicyConfig
    arch, device = setup["arch"], setup["device"]
    layers = arch.num_layers
    (qkw, width, max_len), (dkw, _, _) = (layouts["(a) quest"],
                                          layouts["(a) dmc"])
    runs = {"quest": (qkw, width, 8.0, 0), "dmc": (dkw, width, 8.0, 0)}
    out = eval_runs(torch, setup, runs, prompt_len=prompt_len,
                    max_len=max_len)
    quest = policy_lib.init_policy_cache(arch, width, max_len,
                                         KVPolicyConfig(**qkw),
                                         device=device).cache
    hand = quest_reads_by_hand(prompt_len, max_len, width, layers,
                               quest.page_size, quest.top_pages)
    van = base["vanilla"]
    chain = {k: v["res"]["peak_tokens"] / v["width"]
             for k, v in dict(out, vanilla=van, dms=base["dms"]).items()}
    reads = out["quest"]["res"]["kv_reads"]
    log(f"quest/dmc (a): quest kv_reads {reads:.1f}, by hand "
        f"({layers} layers x (prefill + {width} chains) x min(pages, "
        f"{quest.top_pages}) pages of {quest.page_size}) {hand}; vanilla "
        f"{van['res']['kv_reads']:.1f}, dms {base['dms']['res']['kv_reads']:.1f}"
        f"; peak tokens a chain: quest {chain['quest']:.1f}, vanilla "
        f"{chain['vanilla']:.1f}, dmc {chain['dmc']:.1f}, dms "
        f"{chain['dms']:.1f}; modeled K/V bytes a decode step: quest "
        f"{out['quest']['bytes_step']:.0f}, dmc {out['dmc']['bytes_step']:.0f}"
        f", dms {base['dms']['bytes_step']:.0f} (four chains each; dmc's "
        "kernel reads the bf16 cast, its fp32 arena is read whole by the "
        "cast)")
    if reads != hand or not reads < van["res"]["kv_reads"]:
        raise AssertionError(f"quest kv_reads {reads}: not the hand count "
                             f"{hand}, or not below vanilla's")
    if chain["quest"] != chain["vanilla"] or not chain["dmc"] < chain["vanilla"]:
        raise AssertionError(f"peak tokens a chain {chain}: quest must equal "
                             "vanilla's and dmc lie below it")

    tokens, launched, shaped = serve_layouts(
        torch, setup, {k[4:]: v[0] for k, v in layouts.items()
                       if k.startswith("(b)")}, uid=uid, what="quest/dmc (b)")
    for kind in ("quest", "dmc"):
        if not (tokens[f"{kind} paged"] == tokens[f"{kind} fixed"]).all():
            raise AssertionError(f"{kind}: the pool's tokens differ from the "
                                 "fixed arenas'")
    log("quest/dmc (b): quest's and dmc's pool tokens equal their fixed "
        "arenas'")
    traced = policy_paths(torch, setup, {k[4:]: (arch, v[0]) for k, v in
                                         layouts.items()
                                         if k.startswith("(c)")},
                          steps=steps, what="quest/dmc (c)")
    shapes = {kind: out[kind]["shapes"].union(
        *(v for k, v in list(shaped.items()) + list(traced.items())
          if k.startswith(kind))) for kind in ("quest", "dmc")}
    qd_profile(torch, setup, layouts, width=width, max_len=max_len)
    return {"quest": out["quest"]["launches"] + launched["quest fixed"][0],
            "quest_shared": launched["quest paged"][1],
            "dmc": out["dmc"]["launches"] + launched["dmc fixed"][0]
            + launched["dmc paged"][0],
            "shapes": shapes}


def qd_profile(torch, setup, layouts, *, width, max_len):
    """A profiled decode step of Quest and DMC beside dms at (a)'s arenas,
    then the device time of one layer's Quest page scoring (select, table,
    token mask: ``QuestPolicy.attend_spec``) and of one layer's DMC cast of
    its fp32 arena to bf16, each times the layers, against the profiled
    step's device time."""
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.policy import DMCPolicy, QuestPolicy
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    policies = {"dms": KVPolicyConfig(kind="dms", cr=8.0, block_p=16),
                "quest": KVPolicyConfig(**layouts["(a) quest"][0]),
                "dmc": KVPolicyConfig(**layouts["(a) dmc"][0])}
    prof = phase_profile(torch, params, arch, policies, lanes=width,
                         max_len=max_len, device=device, pairs=2)
    if device != "cuda":
        return
    gen = torch.Generator(device=device).manual_seed(13)
    a = arch.attn
    qcache, _ = filled_cache(torch, arch, layouts["(a) quest"][0], width,
                             max_len, gen, device)
    q = torch.randn((width, 1, a.num_heads, a.head_dim), generator=gen,
                    device=device).to(torch.bfloat16)
    dcache, _ = filled_cache(torch, arch, layouts["(a) dmc"][0], width,
                             max_len, gen, device)
    parts = {
        "quest page scoring (select_pages, table, token mask)":
            ("quest", lambda: QuestPolicy.attend_spec(qcache, q, a)),
        "dmc cast of the fp32 arena to bf16":
            ("dmc", lambda: (dcache.k.to(torch.bfloat16),
                             dcache.v.to(torch.bfloat16))),
        "dmc operands (prefix table, cast, mask)":
            ("dmc", lambda: DMCPolicy.attend_spec(dcache, torch.bfloat16)),
    }
    for what, (name, fn) in parts.items():
        ms = time_cuda(torch, fn)
        dev_ms = prof[name]["device_ms"]
        share = (f"{arch.num_layers * ms / dev_ms:.4f} of its profiled "
                 f"step's {dev_ms:.3f} ms device time" if dev_ms else
                 "device time of the step not measured")
        log(f"profile: {what}, one layer at (a)'s arena ({width} lanes, "
            f"{max_len} tokens): {ms:.4f} ms device time (graph replay); x "
            f"{arch.num_layers} layers = {arch.num_layers * ms:.4f} ms a "
            f"step, {share}")


def device_events(torch, prof):
    """The profiler's device-side entries (kernels, copies, memsets).  A
    host op's own entry carries the device time of the kernels it launched
    as well, so summing every entry would count each kernel twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_profile(torch, params, arch, policies, *, lanes, max_len, device,
                  steps=4, pairs=4):
    """Where a decode step's time goes, for each named policy: host-
    dispatched ATen ops per step (counted with a dispatch mode), wall time
    per step, and the device's busy time under torch.profiler (its device-
    side entries, summed).  With several policies the wall times are taken
    in ``pairs`` alternating turns (A B ..., ... B A), since the host's
    speed drifts between runs; a line gives each pair's ratio to the
    first policy.  Returns per policy the median wall ms, the ATen ops and
    the device ms of a step (0 where not measured)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import transformer as tfm
    tok = torch.full((lanes, 1), 7, dtype=torch.int32, device=device)
    pos = torch.zeros((lanes,), dtype=torch.int32, device=device)
    act = torch.ones((lanes,), dtype=torch.bool, device=device)
    states = {name: tfm.init_decode_state(arch, lanes, max_len, pol,
                                          device=device)
              for name, pol in policies.items()}

    def run(name, n):
        for _ in range(n):
            tfm.decode_step(params, tok, states[name], arch, pos,
                            use_kernel=True, active=act)
        if device == "cuda":
            torch.cuda.synchronize()

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))

    names = list(policies)
    ops = {}
    for name in names:
        run(name, 2)                                # warm
        Count.ops = 0
        with Count():
            run(name, 1)
        ops[name] = Count.ops
    walls = {name: [] for name in names}
    for i in range(pairs if len(names) > 1 else 1):
        for name in (names if i % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            run(name, steps)
            walls[name].append((time.perf_counter() - t0) * 1e3 / steps)
    result = {}
    for name in names:
        wall_ms = statistics.median(walls[name])
        busy = "not measured"
        result[name] = {"wall_ms": wall_ms, "ops": ops[name], "device_ms": 0.0}
        if device == "cuda":
            # a step that syncs the host could not be captured in a CUDA
            # graph (ROADMAP E1); the debug mode raises on the syncs it sees
            torch.cuda.set_sync_debug_mode("error")
            try:
                tfm.decode_step(params, tok, states[name], arch, pos,
                                use_kernel=True, active=act)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                run(name, steps)
            dev_us = sum(e.self_device_time_total
                         for e in device_events(torch, prof))
            launched = sum(e.count for e in prof.key_averages()
                           if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                        "cuLaunchKernelEx"))
            result[name]["device_ms"] = dev_us / 1e3 / steps
            if dev_us > 0:
                busy = (f"{dev_us / 1e3 / steps:.3f} ms device time per step,"
                        f" busy share {dev_us / 1e3 / steps / wall_ms:.4f}, "
                        f"{launched / steps:.0f} kernel launches per step; no "
                        "host sync seen in a step (sync debug mode)")
        log(f"profile: {name}, {lanes} lanes, one decode step = {ops[name]} "
            f"ATen ops dispatched from the host ({ops[name] / arch.num_layers:.1f}"
            f" per layer); {wall_ms:.2f} ms wall per step (median of "
            f"{[round(w, 2) for w in walls[name]]}); {busy}")
    a = names[0]
    for b in names[1:]:
        ratios = [round(y / x, 3) for x, y in zip(walls[a], walls[b])]
        log(f"profile: {b} / {a} wall per step in alternating pairs: {ratios}"
            f" (median {statistics.median(ratios):.3f}); ATen ops "
            f"{ops[b] / ops[a]:.3f}x")
    return result


# -- phase 5 ---------------------------------------------------------------


def phase_train(torch, device="cuda", arch_name="qwen-r1-1.5b", seq_len=1024,
                batch=2, steps=4):
    """DMS retrofit of the main path through the flash kernels; returns the
    launch counts of the run."""
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainConfig, train

    arch = get_arch(arch_name) if device == "cuda" else get_smoke(arch_name)
    data = DataConfig(vocab_size=arch.vocab_size, seq_len=seq_len,
                      global_batch=batch)
    cfg = TrainConfig(retrofit=True, phase1_steps=1, total_steps=steps,
                      use_kernel=True, log_every=1, ckpt_every=10 ** 9)
    log(f"train: {arch.name} L={arch.num_layers} d={arch.d_model} "
        f"V={arch.padded_vocab}, fp32 weights (seed 0), retrofit "
        f"(phase-1 steps {cfg.phase1_steps}, {steps} steps), B={batch} "
        f"T={seq_len}, use_kernel=True")
    per_step, stamps = [], []
    last = {}

    def log_fn(m):
        # metrics were read to the host: the step's device work is done
        stamps.append(time.perf_counter())
        per_step.append({k: fops.launches[k] - last.get(k, 0)
                         for k in fops.launches})
        last.update(fops.launches)
        log("train: step " + json.dumps(m))

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for k in fops.launches:
        fops.launches[k] = 0
    t0 = time.perf_counter()
    out = train(arch, data, cfg, log_fn=log_fn, device=device)
    launches = dict(fops.launches)
    peak_mem = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    for m in out["history"]:
        for key in ("loss", "loss_aux", "alpha_mean", "grad_norm"):
            if not math.isfinite(m[key]):
                raise AssertionError(f"train step {m['step']}: {key} = {m[key]}")
    # per step: teacher forward + student forward (fwd), student backward
    want = ({"flash_fwd": 2 * arch.num_layers, "flash_dq": arch.num_layers,
             "flash_dkv": arch.num_layers} if device == "cuda" else
            {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0})
    for i, got in enumerate(per_step):
        if got != want:
            raise AssertionError(f"train step {i}: launches {got}, want {want}")
    # step 0 carries the first-call set-up (cuBLAS handles, allocator)
    warm = [b - a for a, b in zip(stamps, stamps[1:])]
    s_step = statistics.mean(warm) if warm else stamps[0] - t0
    log(f"train: {steps} steps in {stamps[-1] - t0:.2f} s (first step "
        f"{stamps[0] - t0:.2f} s); {s_step:.3f} s/step over steps 1-{steps - 1}"
        f" = {batch * seq_len / s_step:.1f} tokens/s; launches {launches} = "
        f"{steps} x {want}; peak device memory {peak_mem} B")

    # the kernel path's loss and grad norm against the reference attention
    # path's, from the same params, teacher, batch and Gumbel noise (a step
    # seeds its noise from its index)
    step = steps
    batch_t = {k: torch.from_numpy(v).to(device)
               for k, v in make_batch(data, step).items()}
    res = {}
    for use_kernel in (True, False):
        loss, metrics, grads = steps_lib.retrofit_loss_and_grads(
            arch, out["params"], out["teacher"], batch_t, step,
            use_kernel=use_kernel)
        res[use_kernel] = (loss.item(), adamw.global_norm(grads).item(),
                           metrics["loss_main"].item())
        del grads
    if device == "cuda":
        profile_train_step(torch, arch, out, batch_t, step)
    (lk, gk, mk), (lr_, gr, mr) = res[True], res[False]
    # bf16 activations through 28 layers: the two attention paths round their
    # bf16 outputs after fp32 sums in another order, so logits, the loss and
    # the gradient drift apart by a few bf16 ulps
    loss_rel = abs(lk - lr_) / max(abs(lr_), 1e-12)
    g_rel = abs(gk - gr) / max(abs(gr), 1e-12)
    log(f"train: step {step} kernel vs reference attention path: loss "
        f"{lk:.6e} vs {lr_:.6e} (rel {loss_rel:.2e}, of which distillation "
        f"{mk:.3e} vs {mr:.3e}), grad norm {gk:.6e} vs {gr:.6e} (rel "
        f"{g_rel:.2e}); tolerance 1e-2 relative on both")
    if not (loss_rel < 1e-2 and g_rel < 1e-2):
        raise AssertionError("kernel-path training step disagrees with the "
                             "reference path")
    return {"launches": launches, "s_step": s_step, "peak_mem": peak_mem}



def profile_train_step(torch, arch, out, batch_t, step):
    """Where a retrofit step's time goes: wall time of the loss and
    gradient (teacher forward, student forward and backward; no optimizer
    update) beside the device's busy time under torch.profiler and the
    share of it in the three flash kernels."""
    from repro_torch.launch import steps as steps_lib
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps_lib.retrofit_loss_and_grads(arch, out["params"], out["teacher"],
                                          batch_t, step, use_kernel=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(torch, prof)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    flash_ms = sum(e.self_device_time_total for e in events
                   if "flash_" in e.key) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)
    if dev_ms <= 0:
        log(f"profile: retrofit loss + gradient {wall_ms:.1f} ms wall; device "
            "time not measured (the profiler recorded no device entries)")
        return
    log(f"profile: retrofit loss + gradient (no update) {wall_ms:.1f} ms wall "
        f"under the profiler; device busy {dev_ms:.1f} ms (share "
        f"{dev_ms / wall_ms:.4f}), of which flash kernels {flash_ms:.1f} ms "
        f"({flash_ms / dev_ms:.4f})")
    for e in top[:8]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")


# -- phase 6 ---------------------------------------------------------------


def time_cuda(torch, fn, *, iters=50):
    """Median device time (ms) of one call of ``fn``: the call is captured
    in a CUDA graph and each replay is timed with CUDA events, right after
    a 256 MB memset that empties the L2 and keeps the device busy while the
    host enqueues the replay, so no host gap lands inside the interval."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def log_method_floor(torch):
    """Print what ``time_cuda`` reads for one tiny kernel (a 4-byte
    ``zero_``): the floor under every time it reports."""
    tiny = torch.zeros(1, device="cuda")
    log(f"timing: the method's floor, one 4-byte zero_ kernel: "
        f"{time_cuda(torch, tiny.zero_):.4f} ms")


def decode_entry(torch, name, mode, operands, shape, launches, max_abs_err):
    """One decode-kernel row of the ``kernels`` line: the kernel (``mode``
    "fixed" or "shared") and its plain version timed on ``operands``, the
    bound, and SDPA over the dense per-row arenas ``dense`` = (k, v, valid)
    as the yardstick (for the shared pool, the dense view is built outside
    the timed call)."""
    import torch.nn.functional as F
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode import ref
    bh, g, dh, p, bp = shape
    q, k, v, valid, tbl, n = operands["kernel"]
    shared = mode == "shared"
    plain = ref.dms_decode_plain_shared if shared else ref.dms_decode_plain
    saved = (ops.launches, ops.shared_launches)
    ms = time_cuda(torch, lambda: ops.decode_rows(q, k, v, valid, tbl, n, bp,
                                                  shared_kv=shared))
    # the kernel's own floor: the same launch with no listed entry in any row
    n0 = torch.zeros_like(n)
    floor_ms = time_cuda(torch, lambda: ops.decode_rows(
        q, k, v, valid, tbl, n0, bp, shared_kv=shared))
    ops.launches, ops.shared_launches = saved     # timing is not the path's
    plain_ms = time_cuda(torch, lambda: plain(q, k, v, valid, tbl, n, bp))
    # yardstick only: one SDPA call over the whole arena with the bool mask
    kd, vd, vald = operands["dense"]
    b, hkv = bh // 2, 2
    qs = q.reshape(b, hkv * g, 1, dh)
    ks = torch.nan_to_num(kd).reshape(b, hkv, p, dh)
    vs = torch.nan_to_num(vd).reshape(b, hkv, p, dh)
    mask = vald.reshape(b, hkv, 1, p).repeat_interleave(g, dim=1)
    library_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True))
    # bound: each input byte read once (K/V, valid and table entries of the
    # listed blocks, q), the output written once; flops of QK^T and PV
    n_blocks = int(n.sum().item())
    kv_bytes = ops.modeled_hbm_bytes(n, bp, dh, k.dtype, v.dtype)
    other = (2 * q.numel() * q.element_size() + n_blocks * bp
             + 4 * (n_blocks + bh))
    bytes_ms = (kv_bytes + other) / HBM_BYTES_PER_S * 1e3
    ops_ms = 4.0 * g * dh * n_blocks * bp / BF16_FLOPS_PER_S * 1e3
    entry = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/dms_decode/csrc/dms_decode.cu",
        "replaces": "src/repro/kernels/dms_decode/dms_decode.py:118",
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }
    pool = f", pool {k.shape[1] // bp} pages" if shared else ""
    lib = " (over the dense view, gather not timed)" if shared else ""
    log(f"timing: {name} at (BH={bh}, G={g}, Dh={dh}, P={p}, block_p={bp}, "
        f"{n_blocks} listed blocks{pool}): kernel {ms:.4f} ms in clusters of "
        f"{ops.splits(tbl.shape[1])} splits a row (floor, n = 0 on every row:"
        f" {floor_ms:.4f} ms), bound {entry['bound_ms']:.5f} ms "
        f"({kv_bytes + other} B), plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms{lib}")
    return entry


def weights_entry(torch, name, mode, operands, shape, launches, max_abs_err):
    """One row of the ``kernels`` line for the weights-out mode (``mode``
    "fixed" or "shared"): the kernel's call (its raw outputs; the wrapper's
    rescale and scatter are separate ops, ROADMAP E4) and its plain
    version's, timed on ``operands``, and the bound.  No single PyTorch
    call returns the group-summed softmax weights, so there is no library
    time."""
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode import ref
    bh, g, dh, p, bp = shape
    q, k, v, valid, tbl, n = operands
    shared = mode == "shared"
    saved = (ops.launches, ops.shared_launches, ops.weights_launches)
    ms = time_cuda(torch, lambda: ops.decode_rows(
        q, k, v, valid, tbl, n, bp, shared_kv=shared, need_weights=True))
    n0 = torch.zeros_like(n)
    floor_ms = time_cuda(torch, lambda: ops.decode_rows(
        q, k, v, valid, tbl, n0, bp, shared_kv=shared, need_weights=True))
    ops.launches, ops.shared_launches, ops.weights_launches = saved
    plain_ms = time_cuda(torch, lambda: ref.dms_decode_plain_weights(
        q, k, v, valid, tbl, n, bp, shared_kv=shared))
    # bound: the listed blocks' K/V, valid and table entries, q and n read
    # once; the output, the listed entries' weights and maxima, and the
    # final max and denominator written once
    n_blocks = int(n.sum().item())
    kv_bytes = ops.modeled_hbm_bytes(n, bp, dh, k.dtype, v.dtype)
    other = (2 * q.numel() * q.element_size() + n_blocks * bp
             + 4 * (n_blocks + bh))
    written = 4 * (n_blocks * g * (bp + 1) + 2 * bh * g)
    moved = kv_bytes + other + written
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 4.0 * g * dh * n_blocks * bp / BF16_FLOPS_PER_S * 1e3
    entry = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/dms_decode/csrc/dms_decode.cu",
        "replaces": "src/repro/kernels/dms_decode/dms_decode.py:118",
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }
    pool = f", pool {k.shape[1] // bp} pages" if shared else ""
    log(f"timing: {name} at (BH={bh}, G={g}, Dh={dh}, P={p}, block_p={bp}, "
        f"{n_blocks} listed blocks{pool}): kernel {ms:.4f} ms in clusters of "
        f"{ops.splits(tbl.shape[1])} splits a row (floor, n = 0 on every row:"
        f" {floor_ms:.4f} ms), bound "
        f"{entry['bound_ms']:.5f} ms ({moved} B, of which {written} B "
        f"written weights and statistics), plain {plain_ms:.4f} ms; library: "
        "none (no single PyTorch call returns the group-summed softmax "
        "weights)")
    return entry


def phase_weights_timing(torch, shape, launches, err):
    """The weights-out mode in both layouts at the weights phase's arena."""
    bh, g, dh, p, bp = shape
    gen = torch.Generator(device="cuda").manual_seed(98)
    case = make_pool_case(torch, gen, bh=bh, g=g, dh=dh, nb=p // bp, bp=bp,
                          density=0.85)
    return [weights_entry(torch, "dms_decode_weights_out", "fixed",
                          case["fixed"], shape, launches["fixed"], err),
            weights_entry(torch, "dms_decode_weights_out_shared_kv", "shared",
                          case["shared"], shape, launches["shared"], err)]


def phase_timing(torch, main_shape, launches, errs):
    """The decode kernel in both modes at the main-path shape, after the
    timing method's own floor, then on the vanilla cache's prefix table
    (every block of a P 384 arena listed)."""
    log_method_floor(torch)
    bh, g, dh, p, bp = main_shape
    gen = torch.Generator(device="cuda").manual_seed(99)
    q, k, v, valid, tbl, n = make_case(torch, gen, bh=bh, g=g, dh=dh, p=p,
                                       bp=bp, density=0.85)
    fixed = decode_entry(torch, "dms_decode", "fixed",
                         {"kernel": (q, k, v, valid, tbl, n),
                          "dense": (k, v, valid)},
                         main_shape, launches["fixed"], errs["fixed"])
    case = make_pool_case(torch, gen, bh=bh, g=g, dh=dh, nb=p // bp, bp=bp,
                          density=0.85)
    kd, vd, vald = case["fixed"][1:4]
    shared = decode_entry(torch, "dms_decode_shared_kv", "shared",
                          {"kernel": case["shared"], "dense": (kd, vd, vald)},
                          main_shape, launches["shared"], errs["shared"])
    nb = PREFIX_P // bp
    pk, pv = (torch.randn((bh, PREFIX_P, dh), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    full = torch.ones((bh, PREFIX_P), dtype=torch.bool, device="cuda")
    tbl = torch.arange(nb, dtype=torch.int32, device="cuda").expand(bh, nb)
    n = torch.full((bh,), nb, dtype=torch.int32, device="cuda")
    prefix = decode_entry(torch, "dms_decode_prefix_table", "fixed",
                          {"kernel": (q, pk, pv, full, tbl.contiguous(), n),
                           "dense": (pk, pv, full)},
                          (bh, g, dh, PREFIX_P, bp), launches["prefix"],
                          errs["prefix"])
    # logged, not a row: the arena phase 5c (a) serves vanilla on, one lane
    sp = PREFIX_SERVED[0][0]
    cut = [x[:2, :sp].contiguous() for x in (pk, pv, full)]
    decode_entry(torch, "dms_decode_prefix_table at phase 5c (a)'s arena",
                 "fixed", {"kernel": (q[:2].contiguous(), *cut,
                                      tbl[:2, :sp // bp].contiguous(),
                                      n[:2] * sp // PREFIX_P),
                           "dense": cut},
                 (2, g, dh, sp, bp), launches["prefix"], errs["prefix"])
    return [fixed, shared, prefix]


def phase_quest_dmc_timing(torch, timed, launches, errs):
    """The decode kernel on Quest's page tables (fixed arenas at (a)'s W =
    4 arena, the shared pool at (b)'s) and on DMC's prefix table over the
    cast accumulators at (a)'s arena, on phase 3's operands: time, floor,
    bound, plain and SDPA over the same arena with the token mask."""
    rows = (("dms_decode_quest_page_table", "(a) quest", "quest"),
            ("dms_decode_quest_page_table_shared_kv", "(b) quest paged",
             "quest_shared"),
            ("dms_decode_dmc_prefix_table", "(a) dmc", "dmc"))
    return [decode_entry(torch, name, timed[case]["mode"], timed[case],
                         timed[case]["shape"], launches[key],
                         errs["dmc" if key == "dmc" else "quest"])
            for name, case, key in rows]


def sdpa_times(torch, qf, kf, vf, ls, do, cfg, *, b):
    """Yardsticks only: SDPA with the DMS mask materialised as a (B, Hq, T,
    T) additive tensor and K/V expanded to the query heads.  The forward is
    ``F.scaled_dot_product_attention``; the backward is the memory-efficient
    attention's backward op (the backend that takes an additive mask),
    called directly so that a graph replay times it with no host gap.  It
    gives dq, dk and dv but no d(log_surv), and is checked once against
    autograd through SDPA."""
    import torch.nn.functional as F
    hq, hkv, t, dh = cfg.hq, cfg.hkv, cfg.t, cfg.orig_dh
    g = hq // hkv
    qs = qf.reshape(b, hq, t, dh)
    ks = kf.reshape(b, hkv, t, dh).repeat_interleave(g, dim=1)
    vs = vf.reshape(b, hkv, t, dh).repeat_interleave(g, dim=1)
    i = torch.arange(t, device="cuda")[:, None]
    j = torch.arange(t, device="cuda")[None, :]
    lsb = ls.reshape(b, hkv, 1, t)
    mask = torch.where(j <= i, torch.where(i - j >= cfg.dms_delay, lsb, 0.0),
                       float("-inf")).repeat_interleave(g, dim=1).to(qf.dtype)
    do_lib = do.reshape(b, hq, t, dh)
    fwd = time_cuda(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask))
    aten = torch.ops.aten
    o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
        qs, ks, vs, mask, True)
    bwd_op = lambda: aten._scaled_dot_product_efficient_attention_backward(  # noqa: E731
        do_lib, qs, ks, vs, mask, o, lse, seed, offset, 0.0,
        [True, True, True, False])
    xs = [x.detach().requires_grad_() for x in (qs, ks, vs)]
    want = torch.autograd.grad(F.scaled_dot_product_attention(
        *xs, attn_mask=mask), xs, do_lib)
    for name, got, ref in zip("qkv", bwd_op()[:3], want):
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= 2e-2 * ref.float().abs().max().item():
            raise AssertionError(f"SDPA backward op d{name} disagrees with "
                                 f"autograd through SDPA: {err:.3e}")
    bwd = time_cuda(torch, bwd_op)
    return {"flash_fwd": fwd, "flash_dq": bwd, "flash_dkv": bwd}


def phase_flash_timing(torch, launches, errs):
    """fwd, dq and dkv at the retrofit shape (B 2, T 1024, Hq 12, Hkv 2,
    Dh 128, bf16, relaxed α, delay 256): kernel, plain version, bound and
    the SDPA yardstick."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention import ref as fref
    kw = dict(MAIN_FLASH)
    dtype = getattr(torch, kw.pop("dtype"))
    qf, kf, vf, ls, hr, cfg, do = flash_case(torch, dtype=dtype, seed=99, **kw)
    b, t, hq, hkv, dh = kw["b"], kw["t"], kw["hq"], kw["hkv"], kw["dh"]
    out, lse = fops.flash_fwd(qf, kf, vf, ls, hr, cfg)
    delta = (do.float() * out.float()).sum(-1)
    fwd = lambda: fops.flash_fwd(qf, kf, vf, ls, hr, cfg)  # noqa: E731
    dq = lambda: fops.flash_dq(qf, kf, vf, ls, do, lse, delta, hr, cfg)  # noqa: E731
    dkv = lambda: fops.flash_dkv(qf, kf, vf, ls, do, lse, delta, hr, cfg)  # noqa: E731
    saved = dict(fops.launches)
    ms = {"flash_fwd": time_cuda(torch, fwd), "flash_dq": time_cuda(torch, dq),
          "flash_dkv": time_cuda(torch, dkv)}
    fops.launches.update(saved)           # timing launches are not the path's
    plain = {
        "flash_fwd": time_cuda(torch, lambda: fref.flash_fwd_plain(
            qf, kf, vf, ls, hr, cfg)),
        "flash_dq": time_cuda(torch, lambda: fref.flash_dq_plain(
            qf, kf, vf, ls, do, lse, delta, hr, cfg)),
        "flash_dkv": time_cuda(torch, lambda: fref.flash_dkv_plain(
            qf, kf, vf, ls, do, lse, delta, hr, cfg)),
    }
    library = sdpa_times(torch, qf, kf, vf, ls, do, cfg, b=b)

    # bounds: live (i, j) pairs of this causal mask, each input byte read and
    # each output byte written once, bf16 tensor-core peak for the products
    pairs = b * hq * t * (t + 1) // 2
    nbytes = lambda *xs: sum(x.numel() * x.element_size() for x in xs)  # noqa: E731
    ins = nbytes(qf, kf, vf, ls)          # hr is read only when skipping
    grad_ins = ins + nbytes(do, lse, delta)
    work = {"flash_fwd": (4 * dh * pairs, ins + nbytes(out, lse)),
            "flash_dq": (6 * dh * pairs, grad_ins + nbytes(qf)),
            "flash_dkv": (8 * dh * pairs, grad_ins + nbytes(kf, vf, ls))}
    entries = []
    for name, (flops, moved) in work.items():
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        entry = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/dms_attention/csrc/dms_attention.cu",
            "replaces": {"flash_fwd": "src/repro/kernels/dms_attention/dms_attention.py:142",
                         "flash_dq": "src/repro/kernels/dms_attention/dms_attention.py:242",
                         "flash_dkv": "src/repro/kernels/dms_attention/dms_attention.py:343",
                         }[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms[name], "plain_ms": plain[name],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library[name],
        }
        entries.append(entry)
        log(f"timing: {name} at (B={b}, T={t}, Hq={hq}, Hkv={hkv}, Dh={dh}, "
            f"bf16): kernel {ms[name]:.4f} ms, bound {entry['bound_ms']:.5f} "
            f"ms ({flops} flop, {moved} B), plain {plain[name]:.4f} ms, "
            f"library {library[name]:.4f} ms "
            f"({'SDPA forward' if name == 'flash_fwd' else 'SDPA backward'})")
    return entries


def main() -> int:
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(what):
        now = time.perf_counter()
        log(f"seconds: {what} {now - t_lap[0]:.1f}")
        t_lap[0] = now

    import torch
    card = phase_device(torch)
    sys.path.insert(0, str(SRC))
    phase_build()
    from repro_torch.configs import get_arch
    from repro_torch.core.kv_cache import SlotDMSCache
    arch = get_arch("qwen-r1-1.5b")
    setup = serving_setup(torch)
    shallow = cut_depth(setup, SERVE_LAYERS)
    lanes, max_len, bp = len(setup["prompts"]), setup["max_len"], 16
    slots = min(SlotDMSCache.provision_slots(max_len, 8.0, arch.dms.window),
                max_len + 1)
    main_shape = (lanes * arch.attn.num_kv_heads, arch.attn.q_per_kv,
                  arch.attn.head_dim, (slots + bp - 1) // bp * bp, bp)
    # the weight-driven policies' arena at CR 8: budget + 1 slots, padded
    weights_shape = main_shape[:3] + ((int(max_len / 8.0) + bp) // bp * bp, bp)
    errs = {"fixed": phase_kernels(torch, main_shape),
            "shared": phase_pool_kernels(torch, main_shape),
            "weights": phase_weights_kernels(torch, weights_shape)}
    errs["prefix"], prefix_checked = phase_prefix_kernels(torch, main_shape)
    layouts = qd_layouts(eval_len=320, req_len=(len(setup["prompts"][3])
                                                + setup["news"][3]),
                         trace_len=48 + 16)
    qd_errs, qd_checked, qd_timed = phase_quest_dmc_kernels(
        torch, shallow["arch"], layouts)
    flash_errs = phase_flash_kernels(torch)
    phase_flash_grads(torch)
    lap("phases 1-3")
    served = phase_serve(torch, shallow)
    lap("phase 4")
    want = (SERVE_LAYERS, lanes, arch.attn.num_kv_heads, main_shape[3],
            arch.attn.head_dim)
    if served["arena"] != want:
        raise AssertionError(f"main-path arena {served['arena']} is not the "
                             f"checked shape {want}")
    paged = phase_paged_serve(torch, shallow, served)
    lap("phase 5")
    weighted = phase_weights_serve(torch, cut_depth(setup, WEIGHTS_LAYERS),
                                   served)
    if weighted["arena"] != weights_shape[3]:
        raise AssertionError(f"weights-phase arena {weighted['arena']} is not "
                             f"the checked {weights_shape[3]} slots")
    lap("phase 5b")
    scaled = phase_hyperscale_serve(torch, shallow)
    if not scaled["vanilla_shapes"] <= prefix_checked:
        raise AssertionError(
            f"phase 5c launched vanilla at (rows, G, Dh, P, block_p) "
            f"{sorted(scaled['vanilla_shapes'] - prefix_checked)}, not among "
            f"phase 3's checked {sorted(prefix_checked)}")
    log(f"phase 5c's vanilla launch shapes (rows, G, Dh, P, block_p) "
        f"{sorted(scaled['vanilla_shapes'])}: each checked in phase 3")
    lap("phase 5c")
    qd = phase_quest_dmc_serve(torch, shallow, scaled["evals"], layouts)
    for kind, got in qd["shapes"].items():
        if not got <= qd_checked[kind]:
            raise AssertionError(
                f"phase 5d launched {kind} at {sorted(got - qd_checked[kind])}"
                f", not among phase 3's checked {sorted(qd_checked[kind])}")
        log(f"phase 5d's {kind} launch shapes {sorted(got)}: each checked in "
            "phase 3")
    lap("phase 5d")
    del shallow, setup["params"]
    trained = phase_train(torch)
    lap("phase 6")
    kernels = phase_timing(torch, main_shape, {"fixed": served["launches"],
                                               "shared": paged["launches"],
                                               "prefix": scaled["prefix"]},
                           errs)
    kernels += phase_weights_timing(torch, weights_shape, weighted,
                                    errs["weights"])
    kernels += phase_quest_dmc_timing(torch, qd_timed, qd, qd_errs)
    kernels += phase_flash_timing(torch, trained["launches"], flash_errs)
    lap("phase 7")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)                   # again, beside the numbers at the output's end
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
