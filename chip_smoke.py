#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. device   — a CUDA device must be present; prints the card's name and
              power limit as nvidia-smi reports them.
2. build    — compiles every hand-written kernel from ``src/repro_torch``
              (nvcc, sm_90a) and prints the build seconds and ptxas report.
3. kernels  — each kernel against its plain PyTorch version on the same CUDA
              tensors: the main-path shape, a fragmented table, a partial
              table, empty rows (n = 0) and a tiny shape.  The K/V of blocks
              the table does not list is NaN, so a finite, equal output shows
              that unlisted blocks are never read.
4. serve    — qwen-r1-1.5b at full width (28 layers, d_model 1536, random
              weights from a seed, bf16) served by ``Engine`` with the ``dms``
              policy at CR 8: four staggered requests, then one width-4
              ``hyperscale_generate``.  Every request must end ``ok`` with its
              full token count, and the decode kernel must have launched once
              per layer per decode step.  A short teacher-forced trace then
              holds the kernel path's logits against the reference path's.
5. timing   — per kernel at the main-path shape: the median device time of
              one call (a CUDA-graph replay after an L2 flush) beside its
              bound, its plain version's and one library call's.

The last two lines are the ``kernels`` JSON line and the result line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
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
    from repro_torch.kernels.dms_decode import ops
    t0 = time.perf_counter()
    ops.build()
    log(f"build: dms_decode in {time.perf_counter() - t0:.2f} s")
    report = _build.library_path(ops.SOURCE).with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log("  ptxas:", line.strip())


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


def phase_kernels(torch, main_shape):
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode.ref import dms_decode_plain
    gen = torch.Generator(device="cuda").manual_seed(1234)
    bh, g, dh, p, bp = main_shape
    cases = {
        "main-path shape": dict(bh=bh, g=g, dh=dh, p=p, bp=bp, density=0.85),
        "fragmented table": dict(bh=bh, g=g, dh=dh, p=p, bp=bp, density=0.03),
        "partial table": dict(bh=bh, g=g, dh=dh, p=p, bp=bp, density=0.5,
                              table="partial"),
        "n = 0 rows": dict(bh=bh, g=g, dh=dh, p=p, bp=bp, density=0.5,
                           empty_rows=(0, 3)),
        "tiny shape": dict(bh=6, g=2, dh=16, p=64, bp=16, density=0.5),
        "softcap": dict(bh=4, g=4, dh=64, p=128, bp=16, density=0.6),
    }
    before = ops.launches
    errs = {}
    for name, kw in cases.items():
        q, k, v, valid, tbl, n = make_case(torch, gen, **kw)
        cap = 30.0 if name == "softcap" else None
        out = ops.decode_rows(q, k, v, valid, tbl, n, kw["bp"], cap)
        torch.cuda.synchronize()
        ref = dms_decode_plain(q, k, v, valid, tbl, n, kw["bp"], cap)
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"kernel [{name}]: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), **KERNEL_TOL)
        for r in kw.get("empty_rows", ()):
            if out[r].abs().max().item() != 0.0:
                raise AssertionError(f"kernel [{name}]: row {r} with n = 0 "
                                     "is not zero")
        errs[name] = err
        log(f"kernel vs plain [{name}]: max_abs_err {err:.3e} "
            f"(tolerance atol {KERNEL_TOL['atol']}, rtol {KERNEL_TOL['rtol']})")
    if ops.launches - before != len(cases):
        raise AssertionError(f"launch counter moved {ops.launches - before}, "
                             f"expected {len(cases)}")
    return errs["main-path shape"]


# -- phase 4 ---------------------------------------------------------------


def phase_serve(torch, device="cuda", arch_name="qwen-r1-1.5b", lens=None,
                news=None, hs=(512, 64, 4), short=32):
    """Serve the main path; returns the numbers the later phases print."""
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.hyperscale import ScalingConfig
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request

    arch = get_arch(arch_name) if device == "cuda" else get_smoke(arch_name)
    # random weights almost never evict at the trained bias of -5; a bias of
    # Phi^-1(7/8) makes P(alpha = 1) = 7/8 for an N(0, 1) neuron, the
    # eviction rate of an 8x-trained model
    bias = statistics.NormalDist().inv_cdf(7 / 8)
    arch = dataclasses.replace(arch, dms=dataclasses.replace(arch.dms,
                                                             logit_bias=bias))
    lens = lens or (1024, 768, 512, 256)
    news = news or (128, 96, 64, 128)
    t0 = time.perf_counter()
    params = tfm.init_model(arch, seed=0, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"serve: {arch.name} L={arch.num_layers} d={arch.d_model} "
        f"Hq={arch.attn.num_heads} Hkv={arch.attn.num_kv_heads} "
        f"Dh={arch.attn.head_dim} d_ff={arch.mlp.d_ff} V={arch.padded_vocab}; "
        f"init {time.perf_counter() - t0:.1f} s; dms logit_bias {bias:.4f}")
    policy = KVPolicyConfig(kind="dms", cr=8.0, block_p=16)
    engine = Engine(arch, params, policy, use_kernel=True, device=device)
    rng = torch.Generator().manual_seed(7)

    def prompt(t):
        return torch.randint(3, arch.vocab_size, (t,), generator=rng,
                             dtype=torch.int32).numpy()

    ops.launches = 0
    engine.chunk_fn.steps = 0
    t_serve = time.perf_counter()
    max_len = max(a + b for a, b in zip(lens, news))
    sched = engine.scheduler(num_lanes=len(lens), max_len=max_len)
    reqs = [Request(uid=i, prompt=prompt(t), max_new=m, arrival=i)
            for i, (t, m) in enumerate(zip(lens, news))]
    for r in reqs:
        sched.submit(r)
    results = {r.uid: r for r in sched.run()}
    hs_prompt = prompt(hs[0])
    hs_res = engine.hyperscale_generate(
        hs_prompt, ScalingConfig(max_len=hs[0] + hs[1], width=hs[2], cr=8.0))
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_serve
    launches, steps = ops.launches, engine.chunk_fn.steps

    for r in reqs:
        res = results[r.uid]
        if res.status != "ok" or res.tokens.shape != (1, r.max_new) \
                or int(res.lengths[0]) != r.max_new:
            raise AssertionError(f"request {r.uid}: status {res.status}, "
                                 f"lengths {res.lengths}, want {r.max_new}")
    hres = hs_res.requests[0]
    if hres.status != "ok" or hs_res.tokens.shape != (hs[2], hs[1]) \
            or not (hres.lengths == hs[1]).all():
        raise AssertionError(f"hyperscale: status {hres.status}, "
                             f"lengths {hres.lengths}")
    for res in list(results.values()) + [hres]:
        if ((res.tokens < 0) | (res.tokens >= arch.vocab_size)).any():
            raise AssertionError(f"request {res.uid}: token outside the vocab")
    # the CPU rehearsal runs the plain version, which launches nothing
    if launches != (arch.num_layers * steps if device == "cuda" else 0):
        raise AssertionError(f"kernel launches {launches} != "
                             f"{arch.num_layers} x {steps} decode steps")
    if hres.prefill_meter.kv_reads <= 0:
        raise AssertionError("hyperscale prefill metered no reads")

    generated = sum(int(r.lengths.sum()) for r in results.values()) \
        + int(hres.lengths.sum())
    longest = reqs[0]
    live_frac = results[longest.uid].meter.peak_tokens / (
        arch.num_layers * (len(longest.prompt) + longest.max_new))
    peak_mem = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    log(f"serve: {len(reqs)} staggered requests (prompts {list(lens)}, new "
        f"{list(news)}) + hyperscale W={hs[2]} (prompt {hs[0]}, new {hs[1]}): "
        f"all ok; {generated} tokens in {wall:.2f} s = "
        f"{generated / wall:.2f} tokens/s; {steps} decode steps, "
        f"{1e3 * wall / steps:.2f} ms/step; kernel launches {launches} = "
        f"{arch.num_layers} x {steps}")
    log(f"serve: live fraction at the end of the {len(longest.prompt)}+"
        f"{longest.max_new} request {live_frac:.4f}; KV arena "
        f"{int(sched.peak_bytes)} B for {len(lens)} lanes; peak device memory "
        f"{peak_mem} B; hyperscale prefill reads "
        f"{hres.prefill_meter.kv_reads:.0f}, decode reads "
        f"{hres.decode_meter.kv_reads:.0f}")

    # the kernel path against the reference path on a short teacher-forced
    # trace (launches here are not the main path's)
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
    phase_profile(torch, params, arch, policy, lanes=len(lens), max_len=max_len,
                  device=device)
    return {"launches": launches, "steps": steps,
            "arena": tuple(sched.state["0"].cache.k.shape)}


def phase_profile(torch, params, arch, policy, *, lanes, max_len, device,
                  steps=4):
    """Where a decode step's time goes: host-dispatched ATen ops per step
    (counted with a dispatch mode), wall time per step, and the device's
    busy time under torch.profiler (its self device time, summed)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import transformer as tfm
    state = tfm.init_decode_state(arch, lanes, max_len, policy, device=device)
    tok = torch.full((lanes, 1), 7, dtype=torch.int32, device=device)
    pos = torch.zeros((lanes,), dtype=torch.int32, device=device)
    act = torch.ones((lanes,), dtype=torch.bool, device=device)

    def run(n):
        for _ in range(n):
            tfm.decode_step(params, tok, state, arch, pos, use_kernel=True,
                            active=act)
        if device == "cuda":
            torch.cuda.synchronize()

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))

    run(2)                                          # warm
    with Count():
        run(1)
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy = "not measured"
    if device == "cuda":
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            run(steps)
        dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                     for e in prof.key_averages())
        if dev_us > 0:
            busy = (f"{dev_us / 1e3 / steps:.3f} ms device time per step, "
                    f"busy share {dev_us / 1e3 / steps / wall_ms:.4f}")
    log(f"profile: {lanes} lanes, one decode step = {Count.ops} ATen ops "
        f"dispatched from the host ({Count.ops / arch.num_layers:.1f} per "
        f"layer); {wall_ms:.2f} ms wall per step; {busy}")


# -- phase 5 ---------------------------------------------------------------


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


def phase_timing(torch, main_shape, launches, max_abs_err):
    import torch.nn.functional as F
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode.ref import dms_decode_plain
    bh, g, dh, p, bp = main_shape
    gen = torch.Generator(device="cuda").manual_seed(99)
    q, k, v, valid, tbl, n = make_case(torch, gen, bh=bh, g=g, dh=dh, p=p,
                                       bp=bp, density=0.85)
    saved = ops.launches
    ms = time_cuda(torch, lambda: ops.decode_rows(q, k, v, valid, tbl, n, bp))
    ops.launches = saved                  # timing launches are not the path's
    plain_ms = time_cuda(torch, lambda: dms_decode_plain(q, k, v, valid, tbl,
                                                         n, bp))
    # yardstick only: one SDPA call over the whole arena with the bool mask
    b, hkv = bh // 2, 2
    qs = q.reshape(b, hkv * g, 1, dh)
    ks = torch.nan_to_num(k).reshape(b, hkv, p, dh)
    vs = torch.nan_to_num(v).reshape(b, hkv, p, dh)
    mask = valid.reshape(b, hkv, 1, p).repeat_interleave(g, dim=1)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, attn_mask=mask, enable_gqa=True)
    library_ms = time_cuda(torch, lib)
    # bound: each input byte read once (K/V, valid and table entries of the
    # listed blocks, q), the output written once; flops of QK^T and PV
    n_blocks = int(n.sum().item())
    kv_bytes = ops.modeled_hbm_bytes(n, bp, dh, k.dtype, v.dtype)
    other = (2 * q.numel() * q.element_size() + n_blocks * bp
             + 4 * (n_blocks + bh))
    bytes_ms = (kv_bytes + other) / HBM_BYTES_PER_S * 1e3
    ops_ms = 4.0 * g * dh * n_blocks * bp / BF16_FLOPS_PER_S * 1e3
    entry = {
        "name": "dms_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/dms_decode/csrc/dms_decode.cu",
        "replaces": "src/repro/kernels/dms_decode/dms_decode.py:118",
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }
    log(f"timing: dms_decode at (BH={bh}, G={g}, Dh={dh}, P={p}, block_p={bp},"
        f" {n_blocks} listed blocks): kernel {ms:.4f} ms, bound {entry['bound_ms']:.5f}"
        f" ms ({kv_bytes + other} B), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms")
    return [entry]


def main() -> int:
    import torch
    phase_device(torch)
    sys.path.insert(0, str(SRC))
    phase_build()
    from repro_torch.configs import get_arch
    from repro_torch.core.kv_cache import SlotDMSCache
    arch = get_arch("qwen-r1-1.5b")
    lanes, max_len, bp = 4, 1024 + 128, 16
    slots = min(SlotDMSCache.provision_slots(max_len, 8.0, arch.dms.window),
                max_len + 1)
    main_shape = (lanes * arch.attn.num_kv_heads, arch.attn.q_per_kv,
                  arch.attn.head_dim, (slots + bp - 1) // bp * bp, bp)
    err = phase_kernels(torch, main_shape)
    served = phase_serve(torch)
    want = (arch.num_layers, lanes, arch.attn.num_kv_heads, main_shape[3],
            arch.attn.head_dim)
    if served["arena"] != want:
        raise AssertionError(f"main-path arena {served['arena']} is not the "
                             f"checked shape {want}")
    kernels = phase_timing(torch, main_shape, served["launches"], err)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
