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
              random weights from a seed, bf16) and the first 2 of its 28
              layers (``SERVE_LAYERS``: the script's time limit; 5l serves
              the paper's models at full depth) served
              by ``Engine`` with the ``dms`` policy at CR 8 on fixed
              arenas: four staggered requests (prompts 512/384/256/128,
              new 64/48/32/64), then one width-4
              hyperscale request (prompt 256, 64 new).  Every request must
              end ``ok`` with its full token count, and the decode kernel
              must have launched once per layer per decode step.  A short
              teacher-forced trace then holds the kernel path's logits
              against the reference path's.
5. paged    — the same trace on the paged KV block pool (shared-pool
              kernel, 4 launches per decode step): tokens equal to phase
              4's, no page copied at the fork and copies once the chains
              write, every page back at the end.  Then two of its requests
              oversubscribe a pool of 1.5x one lane's worst case
              (``oversub`` 2, preemption): all ``ok``, preemptions equal
              resumes and are > 0, the pool never exhausted, tokens equal.
5b. weights — the same model at ``SERVE_LAYERS`` (2) layers serving
              requests 2 and 3 of the trace with the weight-driven
              policies at CR 8 (budget 72, 80-slot arenas):
              TOVA on fixed arenas and on the pool, H2O and Keyformer on
              fixed arenas, through the weights-out kernel (4 launches per
              decode step): all ok, live tokens within the budget, the
              pool's tokens equal to the fixed arenas'.  A teacher-forced
              trace per policy holds the kernel path's logits against the
              reference path's and every weights-out call against the
              plain version; then a profiled step of each beside dms.
5c. hyperscale — the same model at 2 layers: (a) the
              paper's
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
5d. quest/dmc — the same model at 2 layers, as 5c: (a) ``quest`` and
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
5e. prefix/slo — the same model at 2 layers: (a) ``make_prefill_step``
              through ``flash_fwd`` on 4 prompts of 512 tokens, ``dms`` (CR
              8, delay 256) and ``vanilla``: one flash launch per layer,
              last logits within 0.05 x max |logit| of the reference
              path's, α flips counted; ``prefill_import`` into fixed arenas
              and the pool, 31 greedy decode steps from each through
              ``decode_fwd`` (the pool's tokens equal the fixed ones), dms
              importing fewer live tokens than vanilla; (b) a 256-token
              system prompt shared by 6 staggered requests (suffixes 8-64,
              16 new each) and a multi-turn trace (2 sessions x 3 turns) on
              2 lanes, served warm through one prefix cache (a 64 MB device
              slab over a 256 MB host tier) by ``dms`` fixed and paged and
              ``vanilla`` fixed, and cold: warm tokens and first-token
              logits equal to the cold ones, paid + saved prefill reads
              equal to the cold reads, reads saved, the shared prefix
              served from the slab with no host<->device snapshot byte and
              no host sync in a chunk, an import, an export or the slab,
              every page back at the end; (c) benchmarks/slo_harness.py's
              overload shape (12 requests of widths 1-2 in a 2x burst on 2
              lanes, TTFT 6 ticks, max_queue 4, 16 new tokens) without
              control and with the SLO ladder: the ladder's goodput above,
              every status definite, rejected requests read nothing, ok
              tokens equal a solo run at the served width; (d)
              ``python -m repro_torch.launch.serve`` on the card at the
              smoke config with the prefix cache: every request ok.
5f. families — gemma2-2b, chatglm3-6b, qwen2-vl-7b (its text path) and
              granite-moe-3b-a800m at full width, random bf16 weights from
              seed 0 and phase 4's DMS bias: (a) gemma2 at 2 layers (one
              superblock of a local and a global layer: the script's
              time) serving phase 4's
              prompts with 32/24/16/32 new tokens on 4 lanes under
              ``layer_map={"attn_local": "window", "attn": "dms"}`` (a
              4097-slot ring at its 4096-token window, dms at CR 8), fixed
              then paged: tokens equal, 2 launches a step; a 48-step
              kernel-vs-reference trace; (b) gemma2 at one superblock, one
              lane: a 4160-token prompt and 16 new tokens, the lane
              snapshot after the prompt (the local layer at its ring, the
              global one following DMS), then 16 teacher-forced steps from
              the snapshot on both paths; (c) chatglm3, qwen2-vl and
              granite at 2 layers: requests 3 and 1 with dms at CR 8,
              fixed and paged, tokens equal, a 48-step trace (granite's
              steps that send a token to another expert on the two paths
              not held), chatglm3's prefill export (4 x 512 tokens through
              ``flash_fwd``, 15 decode steps); a profiled step of each.
              Every decode step runs the kernel in every layer, and every
              launch shape must be one phase 3 checked.
5g. hybrids — recurrentgemma-2b (RG-LRU and local attention, G 10 at Dh
              256, a 2048-token window) and mamba2-2.7b (SSD, no
              attention) at full width, random bf16 weights from seed 0 and
              phase 4's DMS bias: (a) recurrentgemma at 2 layers (one
              superblock of an RG-LRU and a local layer: the script's
              time) serving phase 4's
              prompts with 32/24/16/32 new tokens on 4 lanes, dms at CR 8
              on the local layers, fixed then paged (tokens equal, 1
              launch a step), and requests 3 and 1 on its 2049-slot
              window rings; a 48-step kernel-vs-reference trace; (b)
              recurrentgemma at one superblock, one lane: a 2112-token
              prompt and 16 new under dms and under window (the RG-LRU
              state carried through the prompt, the ring recycled), then
              16 teacher-forced steps from the snapshot on both paths; (c)
              mamba2 at 2 layers: requests 3 and 1 with vanilla, fixed and
              paged, tokens equal, no pool, no decode launch; (d) three
              requests sharing a 256-token prefix through one prefix cache
              on recurrentgemma at one superblock: warm tokens and
              first-token logits equal to a cold engine's exactly (the
              snapshot carries the RG-LRU state); a profiled step of each
              model.  The depth cuts are printed on a line of their own.
5h. enc-dec — seamless-m4t-large-v2 at full width (24 + 24 layers, 16/16
              heads of 64, LayerNorm), random bf16 weights from seed 0 and
              phase 4's DMS bias: (a) 4 lanes of 1024 frames encoded once
              through ``flash_fwd`` with ``causal=False`` (24 launches), a
              320-token prompt a lane teacher-forced and 32 greedy tokens
              through ``make_serve_step`` with the encoder output, dms at CR
              8: two decode launches a decoder layer a step (self-attention
              on fixed arenas, the cross-attention through the wrapper's
              dense mode); a profiled step; (b) the same trace at 2 decoder
              layers (the encoder whole), fixed then paged: tokens equal;
              (c)
              48 teacher-forced steps at 2 layers, kernel against reference
              path, lane 1's last 200 frames hidden, and the encoder's output
              through the kernel against the reference path's; (d) one
              ``make_train_step`` at 2 + 2 layers (B 2, 1024 tokens, 1024
              frames), kernel against reference path: loss within 1e-2.
5i. Dh 256  — gemma2-2b and recurrentgemma-2b at full width, random bf16
              weights from seed 0 and phase 4's DMS bias, on the flash
              kernels at their head dim (256): (a) gemma2 at 4 layers:
              ``phase_prefill_export`` with dms (4 x 512 tokens through
              ``flash_fwd``, imported fixed and paged, 32 greedy tokens:
              tokens equal, alpha flips and the last logits' gap against
              the reference path within 0.05 x max |logit|, flash
              launches); (b) recurrentgemma at 4 layers: the prefill
              export's last logits against the reference path's; (c) one
              retrofit step of each at one superblock (B 2, T 1024, fp32
              weights) on the kernel path and on the reference path: loss
              and gradient norm within 1e-2, the fwd/dq/dkv launches and
              the step's seconds.
5j. audit   — run right after 5e on phase 4's model (full width, 2
              layers, random bf16 weights from seed 0, phase 4's bias):
              ``repro_torch.analysis.audit``'s sweep, every registered
              policy x {ref, kernel} x {fixed, paged} on phase 4's 4 lanes
              (64 tokens a lane, blocks of 16): the traffic lints over the
              op trace of a decode step (and in ref mode of the fork,
              reclaim, export and import programs), tree invariance, the
              lifecycle contracts, then the scheduler, preempt and SLO
              traces, fixed and paged, on 4 lanes under the retrace
              sentinel (one chunk signature) and the host-sync tripwire
              (CUDA's sync debug mode at error outside sanctioned tags).
              A line a combo; in kernel mode the kernel events must equal
              the launch counters' growth, one per attention layer; any
              gating finding fails.  Three planted faults must each be
              caught: a ``torch.cat`` of the arena, an ``.item()`` in a
              chunk step, the ref path forced in kernel mode.  Every decode
              launch shape of the sweep is then held against the plain
              version (weights-out mode included).
5k. mesh    — the multi-device modules on the card.  (a) A process group
              of world size 1 (NCCL) and ``make_local_mesh()``, a 1x1
              ``DeviceMesh("cuda")``: qwen-r1-1.5b at full width and 4
              layers placed with ``sharding.distribute``; one dms prefill
              (4 x 512, ``use_kernel``) launches ``flash_fwd`` once a layer
              through the attention core's ``local_map`` region, and its
              logits and per-layer KV equal the unsharded call's bit for
              bit; a checkpoint of the placed params restored onto the mesh
              through ``restore(..., shardings=)`` gives equal leaves; one
              retrofit step's gradients (B 2, T 1024, fp32) through
              ``all_reduce_compressed`` equal ``dequantize_int8(q, s)``
              bitwise, with ``x == dequantize(q) + residual`` exactly,
              beside the payload bytes (int8 + scales) and bf16's, and the
              time.  (b) One dry-run cell for real, in a subprocess (its own
              fake process group of 256): ``python -m
              repro_torch.launch.dryrun --arch qwen-r1-1.5b --shape
              prefill_32k --device cuda --memory-only`` runs rank 0's shard
              on the card; its measured peak (``max_memory_allocated``)
              must lie within ``MESH_PEAK_TOL`` of ``MemTracker``'s
              prediction; the roofline's compute, memory and collective
              terms of that run are printed beside them.
5l. paper   — the paper's own models at their published widths and full
              depth, random bf16 weights from seed 0 drawn on the card,
              each freed before the next loads: llama32-1b (16 layers,
              32/8 heads of 64, G 4, tied embeddings), qwen-r1-7b (28, 28/4
              of 128, G 7) and qwen-r1-32b (64, 40/8 of 128, G 5; 65.5 GB of
              weights).  ``dms`` at each config's target CR (llama 4, Qwen-R1
              8) with the bias Phi^-1(1 - 1/CR), delay window 16 (llama's
              own; the Qwen-R1 configs' 256 cut so that DMS evicts within
              the trace).  (a) Four staggered requests on four lanes
              (prompts 48/40/32/24; new 24/16/16/24, the 32B 16/8/8/16),
              greedy, through ``Engine.scheduler(...).run()`` with the
              kernel: every request ok, one launch a layer a decode step,
              every step on the kernel in every layer; (d) llama and the 7B
              again on the paged pool: tokens equal to the fixed arenas';
              (e) each request's peak live tokens below vanilla's count;
              (c) 16 teacher-forced steps, kernel path against reference
              path, logits within 0.05 x max |logit|; a profiled step of the
              7B and the 32B beside the weight-read floor; at the 32B the
              memory line: free memory after the load, the trace's peak,
              dms's decode state (CR 8, window 256) at 4 lanes x 32768
              tokens allocated beside the weights, vanilla's counted.
              Every launch shape must be one phase 3 checked.
5m. reasoner — ``python -m repro_torch.examples.hyperscale_serve``'s path
              with trained weights, at the demo's own width (the smoke
              qwen-r1-1.5b at vocab 64: 2 layers, d 64, 4/2 heads of 16).
              (b) ``trained_reasoner(200)`` on chain_arith (B 32, T 32)
              through the flash kernels: 200 pretrain and 100 DMS retrofit
              steps, every step's attention on the kernels (the launch
              counts), the first 10 losses of each stage within 2e-2 of
              the CPU plain path's from the same params and Gumbel draws.
              (c) The demo's evaluations at temperature 0.7 on 16 problems
              (vanilla 40-1-1, dms 40-4-4 under the model's learned α):
              every request ok, one decode launch a layer a step, dms's
              peak tokens a chain below vanilla's, the 4 chains' prefill
              reads equal to one chain's (one forked prefill), 40
              teacher-forced steps of each within 0.05 x max |logit| of
              the reference path.  (d) Reported: accuracies, kv_reads and
              peak tokens, the trained eviction rate per layer against
              1 - 1/CR, the same evaluations on the CPU's plain path, the
              seconds of each part.  Phase 3 checks the decode kernel at
              every shape 5m launches (G 2, Dh 16) and fwd, dq and dkv at
              T 32, Dh 16 (run at 64), vanilla and dms_train, before.
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
which 5d launches the kernel must be one of those checked.  It holds the
fixed-arena mode at every shape phase 5e launches it at, and ``flash_fwd``
at the prefill export's shapes (B 4, T 512, binarised α and vanilla; T
288, padded to 384) against its plain version, bit-equal on a second
launch; every fixed-arena shape 5e launches must be one of those.  It
holds both modes at every shape 5f launches (``arch_decode_keys``, with
gemma2's softcap 50; slot densities 0.5 and 0.05) and at granite-1b's G 2
at Dh 64, and ``flash_fwd`` at chatglm3's prefill shape (Hq 32, G 16);
and both modes at every shape 5g launches (``hybrid_decode_keys``:
recurrentgemma's G 10 at Dh 256); and at every shape 5h launches: the decode
kernel at G 1, Dh 64 (both modes), the dense mode at the cross-attention's
shape (every frame visible, and a hidden tail), and ``flash_fwd``,
``flash_dq`` and ``flash_dkv`` with ``causal=False`` at the encoder's shapes
(T 1024 and 1000, bf16 and fp32) and at the train step's (``encdec_flash_
cases``), with the autograd Function against the dense oracle.  Phase 7
also times ``flash_fwd`` at the prefill export's shapes and the decode
kernel at 5f's serving shapes, at recurrentgemma's serving shapes and (b)'s
window ring, and at 5h's (G 1, the cross-attention's dense mode), and the
three flash kernels at 5h's encoder shape beside SDPA with no mask.  Phase
3 also holds ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` at Dh 256
(``dh256_flash_cases``: gemma2's G 2 with the softcap 50, causal, with a
64-token window and T 1000; recurrentgemma's G 10 over one kv head, causal
and without causality; bf16 and fp32, each bit-equal on a second launch;
gemma2's prefill export shape) and the decode kernel at every shape 5i
launches (``dh256_decode_keys``); phase 7 times the three flash kernels at
gemma2's and recurrentgemma's retrofit shapes and ``flash_fwd`` at gemma2's
prefill export.  Phase 3 holds both decode modes at every shape 5l
launches (``paper_decode_keys``: G 4 at Dh 64, G 7 and G 5 at Dh 128), and
phase 7 times the kernel at 5l's serving shapes, and at 5m's (G 2, Dh
16) beside the three flash kernels at its retrofit shape.  The decode
kernel's split count follows ``ops.splits`` (B*Hkv and the SM count); ``decode_split_sweep`` times it at every count on
the shapes that lost to SDPA, beside an earlier kernel's source.  The last
four lines are the script's total seconds, the ``kernels`` JSON line, the
card's name and power limit (again) and the result line ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
        splits = ops.launch_splits(q, tbl.shape[1])
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
                   stale=False, empty_rows=(), hidden_rows=(), pages=None,
                   device="cuda"):
    """Random shared-pool decode operands, and the same logical contents as
    fixed arenas.  Each row lists its live blocks in shuffled order; their
    pages are scattered in shuffled order over the pool.  ``nan``: every page the table does not list is NaN (else it
    holds random stale data).  ``stale``: a row lists only half of its live
    blocks and its table past n names unmapped blocks (phys = -1).
    ``hidden_rows``: the first listed block of these rows has every slot
    hidden, as a local window hides old slots.  ``pages``: the pool's size
    (else twice the pages needed).  Returns a dict: ``shared``
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
    npool = pages or 2 * max(need, 1)
    if need > npool:
        raise AssertionError(f"{need} live blocks do not fit {npool} pages")
    order = iter(torch.randperm(npool, generator=cpu).tolist())
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
            phys[r, blk] = next(order)
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
            splits=ops.launch_splits(shared[0], shared[4].shape[1]))
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


def weights_cases(main_shape):
    """``phase_weights_kernels``' cases at phase 3's main shape: (name,
    (rows, G, Dh, P, block_p), ``make_pool_case`` keywords) for each of
    WEIGHTS_CASES."""
    return [(name, main_shape, kw) for name, kw in WEIGHTS_CASES.items()]


def weights_key_cases(keys, what):
    """``phase_weights_kernels``' cases at the weights-out launch shapes
    ``keys`` lists (``launch_key``): NaN in every unlisted page; a shared-
    pool key's table width and pool slots as launched."""
    cases = []
    for key in sorted(keys):
        kw = dict(density=0.5, nan=True)
        if len(key) == 7:
            kw.update(nb=key[5], pages=key[3] // key[4])
        mode = "shared-pool" if len(key) == 7 else "fixed-arena"
        cases.append((f"{what}'s {mode} launch {key[:6]}", key[:5], kw))
    return cases


def phase_weights_kernels(torch, cases, device="cuda"):
    """The weights-out mode in both layouts against its plain version on
    the same tensors (output within KERNEL_TOL, the fp32 raw outputs and the
    group-summed weights within WEIGHTS_TOL), the shared-pool layout bitwise
    equal to the fixed one, zero weight off the visible listed slots, every
    row that sees a slot summing to G, for each of ``cases``
    (``weights_cases``, ``weights_key_cases``); returns each case's max abs
    error over all outputs, by name."""
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode.ref import (dms_decode_plain_split,
                                                    dms_decode_plain_weights)
    gen = torch.Generator(device=device).manual_seed(2468)
    before = (ops.launches, ops.shared_launches, ops.weights_launches)
    worst = {}
    for name, (bh, g, dh, p, bp), kw in cases:
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
        # the CPU rehearsal's plain version takes the table whole
        splits = ops.launch_splits(shared[0], nb) if device == "cuda" else 1
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
        worst[name] = max(errs.values())
        log(f"weights-out kernel vs plain [{name}] (both layouts, "
            f"{int(n.sum())} listed blocks, {splits} splits a row; within "
            "tolerance of the plain split too): max abs err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" (tolerance: out {KERNEL_TOL}, fp32 outputs {WEIGHTS_TOL}); "
            "shared-pool bitwise equal to fixed; rows sum to G")
    moved = (ops.launches - before[0], ops.shared_launches - before[1],
             ops.weights_launches - before[2])
    # the CPU rehearsal runs the plain version, which launches nothing
    if moved != (0, 0, 2 * len(cases) if device == "cuda" else 0):
        raise AssertionError(f"launch counters moved {moved}")
    return worst


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
    over the bf16 cast of the fp32 accumulators (paged: of the pool's
    pages), NaN past the listed blocks (paged: in every page the table
    does not list).  Returns (q, k, v, visible, the wrapper's keywords, the dense
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
        p = spec.visible.shape[2]
        if spec.pool is None:
            dead = (torch.arange(p, device=device)
                    >= (n * spec.block_p)[..., None])
            k, v = spec.k.clone(), spec.v.clone()
            k[dead] = float("nan")
            v[dead] = float("nan")
        else:
            k = v = None
            listed = (torch.arange(spec.block_tbl.shape[-1], device=device)
                      < n[..., None])
            keep = torch.zeros(spec.pool.k_buf.shape[0], dtype=torch.bool,
                               device=device)
            keep[spec.phys.gather(2, spec.block_tbl.long())[listed]
                 .long()] = True
            spec.pool.k_buf[~keep] = float("nan")     # the spec's own cast
            spec.pool.v_buf[~keep] = float("nan")
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
            splits=(ops.launch_splits(args[0], args[4].shape[1])
                    if device == "cuda" else 1))
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
    n_shared = sum(2 for kw, _, _ in layouts.values() if kw.get("paged"))
    want = ((2 * len(layouts) - n_shared, n_shared) if device == "cuda"
            else (0, 0))
    if moved != want:
        raise AssertionError(f"launch counters moved {moved}, want {want}")
    return errs, checked, timed


def flash_case(torch, *, b, t, hq, hkv, dh, dtype, alpha="relaxed",
               delay=256, window=None, cap=None, skip=False, seed=0,
               device="cuda", causal=True):
    """Folded flash-attention operands as ``dms_flash_attention`` builds them
    (q/k/v ~ N(0, 1); α uniform in [0.02, 0.9], or binarised: 1 with
    probability 0.9 and on every key of [128, 640), so that four whole
    128-key blocks hold no retained key and their tiles below the diagonal
    are skipped; or None, vanilla), with a random dO (zero on padded rows):
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
                      dms_delay=delay, causal=causal, logit_cap=cap,
                      block_k=bk, skip_blocks=skip)
    hr = fops.prep_tables(ls, cfg)
    do = torch.randn(qf.shape, generator=gen, device=device).to(dtype)
    do[:, t:] = 0
    return qf, kf, vf, ls, hr, cfg, do


MAIN_FLASH = dict(b=2, t=1024, hq=12, hkv=2, dh=128, dtype="bfloat16")


def phase_flash_kernels(torch):
    """fwd, dq and dkv against their plain versions on the same CUDA
    tensors; returns each kernel's max abs error at the main shape."""
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
    return flash_vs_plain(torch, cases)["retrofit shape, bf16"]


# gemma2-2b's and recurrentgemma-2b's attention at full width: Dh 256, G 2
# over 4 kv heads with the softcap 50, and G 10 over one kv head
DH256_G2 = dict(hq=8, hkv=4, dh=256, cap=50.0)
DH256_G10 = dict(hq=10, hkv=1, dh=256)
DH256_FLASH = {
    "gemma2-2b retrofit shape (B 2, T 1024)": dict(DH256_G2, b=2, t=1024),
    "gemma2-2b, T 1000, window 64": dict(DH256_G2, b=2, t=1000, window=64),
    "recurrentgemma-2b retrofit shape (B 2, T 1024)": dict(DH256_G10, b=2,
                                                           t=1024),
    "recurrentgemma-2b, T 1000, no causality": dict(DH256_G10, b=2, t=1000,
                                                   causal=False),
}
# the prefill export's shape (EXPORT_LANES, EXPORT_PROMPT; bf16 only: the
# export runs the model in bf16)
DH256_EXPORT = {"gemma2-2b prefill export (B 4, T 512), binarised alpha, "
                "skip": dict(DH256_G2, b=4, t=512, alpha="bin", skip=True,
                             dtype="bfloat16")}


def dh256_flash_cases():
    """Phase 3's Dh-256 flash cases: each of DH256_FLASH in bf16 and fp32,
    and the prefill export's shape in bf16."""
    cases = {f"{name}, {short}": dict(kw, dtype=dtype)
             for name, kw in DH256_FLASH.items()
             for short, dtype in (("bf16", "bfloat16"), ("fp32", "float32"))}
    return {**cases, **DH256_EXPORT}


def flash_vs_plain(torch, cases, *, every_twice=False, device="cuda"):
    """fwd, dq and dkv on each of ``cases`` (``flash_case`` keywords and a
    dtype) against their plain versions on the same tensors, within
    FLASH_REL_TOL of the plain output's largest magnitude; every bf16 case
    (with ``every_twice`` every case) launched a second time for the same
    bits.  Returns {case: {kernel: max abs err}}."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention import ref as fref
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in fp32
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    before = dict(fops.launches)
    errs = {}
    repeats = 0
    for name, kw in cases.items():
        kw = dict(kw)
        dtype = getattr(torch, kw.pop("dtype"))
        qf, kf, vf, ls, hr, cfg, do = flash_case(torch, dtype=dtype,
                                                 device=device, **kw)
        t = cfg.t
        out, lse = fops.flash_fwd(qf, kf, vf, ls, hr, cfg)
        if cuda:
            torch.cuda.synchronize()
        out_p, lse_p = fref.flash_fwd_plain(qf, kf, vf, ls, hr, cfg)
        delta = (do.float() * out_p.float()).sum(-1)
        dq = fops.flash_dq(qf, kf, vf, ls, do, lse_p, delta, hr, cfg)
        dk, dv, dls = fops.flash_dkv(qf, kf, vf, ls, do, lse_p, delta, hr, cfg)
        if cuda:
            torch.cuda.synchronize()
        dq_p = fref.flash_dq_plain(qf, kf, vf, ls, do, lse_p, delta, hr, cfg)
        dk_p, dv_p, dls_p = fref.flash_dkv_plain(qf, kf, vf, ls, do, lse_p,
                                                 delta, hr, cfg)
        tol = FLASH_REL_TOL[str(dtype).removeprefix("torch.")]
        pairs = {"out": (out[:, :t], out_p[:, :t]),
                 "lse": (lse[:, :t], lse_p[:, :t]), "dq": (dq, dq_p),
                 "dk": (dk, dk_p), "dv": (dv, dv_p), "dls": (dls, dls_p)}
        parts, found = [], {}
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
            found[key] = err
        errs[name] = {"flash_fwd": max(found["out"], found["lse"]),
                      "flash_dq": found["dq"],
                      "flash_dkv": max(found["dk"], found["dv"], found["dls"])}
        if dtype == torch.bfloat16 or every_twice:
            # no atomics anywhere: a second launch gives the same bits
            again = (fops.flash_fwd(qf, kf, vf, ls, hr, cfg)
                     + (fops.flash_dq(qf, kf, vf, ls, do, lse_p, delta, hr,
                                      cfg),)
                     + fops.flash_dkv(qf, kf, vf, ls, do, lse_p, delta, hr,
                                      cfg))
            if cuda:
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
    n = len(cases) if cuda else 0
    got = {k: fops.launches[k] - before[k] for k in fops.launches}
    want = {k: n + (repeats if cuda else 0) for k in fops.launches}
    if got != want:
        raise AssertionError(f"flash launch counters moved {got}, expected "
                             f"{want}")
    return errs


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
                  hs=(256, 64, 4), layers=None, cr=8.0, dms_window=None):
    """The served model (random weights from seed 0; its first ``layers``
    layers if given; its DMS delay window cut to ``dms_window`` if given)
    and the trace phases 4 and 7 share: staggered requests and one width-W
    hyperscale prompt."""
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.models import transformer as tfm
    arch = get_arch(arch_name) if device == "cuda" else get_smoke(arch_name)
    if layers is not None:
        arch = dataclasses.replace(arch, num_layers=layers)
    # random weights almost never evict at the trained bias of -5; a bias of
    # Phi^-1(1 - 1/CR) makes P(alpha = 1) = 1 - 1/CR for an N(0, 1) neuron,
    # the eviction rate of a CR-x-trained model (7/8 at CR 8)
    bias = statistics.NormalDist().inv_cdf(1 - 1 / cr)
    arch = dataclasses.replace(arch, dms=dataclasses.replace(
        arch.dms, logit_bias=bias,
        window=arch.dms.window if dms_window is None else dms_window))
    t0 = time.perf_counter()
    params = tfm.init_model(arch, seed=0, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"serve: {arch.name} L={arch.num_layers} d={arch.d_model} "
        f"{widths(arch)} V={arch.padded_vocab}; init "
        f"{time.perf_counter() - t0:.1f} s; dms logit_bias {bias:.4f}")
    rng = torch.Generator().manual_seed(7)

    def prompt(t):
        return torch.randint(3, arch.vocab_size, (t,), generator=rng,
                             dtype=torch.int32).numpy()

    prompts = [prompt(t) for t in lens]
    return {"arch": arch, "params": params, "device": device,
            "prompts": prompts, "news": list(news), "hs": hs,
            "hs_prompt": prompt(hs[0]),
            "max_len": max(len(p) + m for p, m in zip(prompts, news))}


def widths(arch):
    """The widths of ``arch``'s layers, for a log line."""
    out = []
    if arch.attn is not None:
        a = arch.attn
        out.append(f"Hq={a.num_heads} Hkv={a.num_kv_heads} Dh={a.head_dim}")
    if arch.rglru is not None:
        out.append(f"lru_width={arch.rglru.lru_width or arch.d_model}")
    if arch.ssm is not None:
        m = arch.ssm
        out.append(f"d_inner={m.d_inner(arch.d_model)} "
                   f"ssm_heads={m.num_heads(arch.d_model)}x{m.head_dim} "
                   f"d_state={m.d_state}")
    if arch.mlp is not None:
        out.append(f"d_ff={arch.mlp.d_ff}")
    return " ".join(out) + f" pattern={'/'.join(arch.layer_pattern)}"


def attn_layers(arch):
    """The attention layers of ``arch`` (a decode step launches the decode
    kernel once in each): all of a dense model's, none of mamba2's."""
    return arch.num_superblocks * sum(kind in ("attn", "attn_local")
                                      for kind in arch.layer_pattern)


# phases 4-5e and 5j serve the first SERVE_LAYERS layers of the model: the
# script's time limit (the eager decode step costs 3.5-7 ms of host time a
# layer, by the host); phase 5l serves the paper's models at full depth
SERVE_LAYERS = 2


def cut_depth(setup, layers):
    """``setup`` with its model cut to its first ``layers`` layers, a
    whole number of superblocks (views of the same weights, and of their
    noise salts)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.transformer import Params
    params = setup["params"]
    nsb = layers // setup["arch"].pattern_period
    cut = Params(params)
    cut["blocks"] = {key: tree_map(lambda a: a[:nsb], blk)
                     for key, blk in params["blocks"].items()}
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
    the shared-pool mode where the layout streams pool pages (paged; for
    ``dmc``, whose pool holds fp32 accumulators, a bf16 cast of its
    pages), else the fixed-arena mode; a paged layout has every page
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
        got = (ops.launches, ops.shared_launches, ops.weights_launches)
        if got != ((0, want, 0) if paged else (want, 0, 0)):
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


def route_spy(layers_lib, routes):
    """``layers_lib.moe_apply`` that also keeps each call's expert ids
    (``moe_route``) in ``routes``.  Returns (the wrapper, the real
    function)."""
    real = layers_lib.moe_apply

    def moe_apply(p, x, cfg, dtype, *args, **kw):
        routes.append(layers_lib.moe_route(p, x.to(dtype), cfg.moe.top_k)[2])
        return real(p, x, cfg, dtype, *args, **kw)
    return moe_apply, real


def policy_paths(torch, setup, traces, *, steps=48, what="paths (c)"):
    """Kernel path against reference path, teacher-forced: each step runs
    both paths from the same cache (a copy), so the logits differ only by
    this step's attention, for each of ``traces`` (name -> (arch, policy
    config)), two lanes of arenas of ``steps + 16``; the logits
    within 0.05 x max |logit|.  Quest selects pages, and a MoE router
    experts, by scores that the layers below feed: where an ulp of theirs
    flips a near tie, the two paths attend over other pages or send a
    token to another expert.  So for Quest and for a MoE model every
    layer's kernel output is also held against the reference attention on
    the same operands (``KERNEL_TOL``), a step whose block tables or
    expert ids differ between the paths in any layer is counted and its
    logits not held, and at least half of the steps must be held.
    Returns the launch
    shapes of the kernel path (``launch_key``) by trace.  Launches here are
    not the main path's."""
    from repro_torch.core import policy as policy_lib
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import layers as layers_lib
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
        tables, routes, worst = [], [], [0.0]
        quest = kw["kind"] == "quest"
        moe = a.mlp is not None and a.mlp.moe is not None
        spy, real_attn = quest_spy(torch, attn_lib, tables, worst)
        routed, real_moe = route_spy(layers_lib, routes)
        for t in range(steps):
            tok = tokens[:, t:t + 1].to(device)
            ref_state = tree_map(torch.clone, state)
            tables.clear()
            routes.clear()
            ops.decode_rows = recording
            if quest or moe:
                attn_lib._masked_decode = spy
            if moe:
                layers_lib.moe_apply = routed
            try:
                lk, _, aux = tfm.decode_step(params, tok, state, a, t,
                                             use_kernel=True)
                lr, _, _ = tfm.decode_step(params, tok, ref_state, a, t,
                                           use_kernel=False)
            finally:
                ops.decode_rows = real
                attn_lib._masked_decode = real_attn
                layers_lib.moe_apply = real_moe
            if not bool(torch.isfinite(lk[:, live]).all()):
                raise AssertionError(f"{name}: non-finite kernel-path logits "
                                     f"at step {t}")
            half, rhalf = len(tables) // 2, len(routes) // 2
            if any(not (torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]))
                   for x, y in zip(tables[:half], tables[half:])) \
                    or any(not torch.equal(x, y) for x, y in
                           zip(routes[:rhalf], routes[rhalf:])):
                flips += 1
                continue
            gap = max(gap, (lk - lr)[:, live].abs().max().item())
            scale = max(scale, lr[:, live].abs().max().item())
            agree += int((lk[:, live].argmax(-1) == lr[:, live].argmax(-1)).sum())
        cache = next(policy_lib.iter_policy_caches(state)).cache
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
        if moe:
            if 2 * flips > steps:
                raise AssertionError(f"{name}: {flips} of {steps} steps "
                                     "routed or attended otherwise on the "
                                     "two paths")
            note = (f"; every layer's kernel output within {worst[0]:.3e} "
                    f"of the reference attention on the same operands; "
                    f"{flips} of {steps} steps sent a token to another "
                    "expert or listed other blocks on the two paths (a near"
                    " tie after the layers below rounded apart): their "
                    "logits not held")
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
            + launched["dmc paged"][1],
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
                  steps=4, pairs=4, step_kw=None):
    """Where a decode step's time goes, for each named policy: host-
    dispatched ATen ops per step (counted with a dispatch mode), wall time
    per step, and the device's busy time under torch.profiler (its device-
    side entries, summed).  With several policies the wall times are taken
    in ``pairs`` alternating turns (A B ..., ... B A), since the host's
    speed drifts between runs; a line gives each pair's ratio to the
    first policy.  ``step_kw`` goes to every ``decode_step`` (an encoder-
    decoder's ``enc_out``).  Returns per policy the median wall ms, the
    ATen ops and the device ms of a step (0 where not measured)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.analysis.hostsync import HostSyncTripwire
    from repro_torch.models import transformer as tfm
    tok = torch.full((lanes, 1), 7, dtype=torch.int32, device=device)
    pos = torch.zeros((lanes,), dtype=torch.int32, device=device)
    act = torch.ones((lanes,), dtype=torch.bool, device=device)
    states = {name: tfm.init_decode_state(arch, lanes, max_len, pol,
                                          device=device)
              for name, pol in policies.items()}

    step_kw = step_kw or {}

    def run(name, n):
        for _ in range(n):
            tfm.decode_step(params, tok, states[name], arch, pos,
                            use_kernel=True, active=act, **step_kw)
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
            # graph (ROADMAP E1): the tripwire's hooks record a host read,
            # and its sync debug mode raises on the syncs the card sees
            with HostSyncTripwire(allow=()) as tw:
                tfm.decode_step(params, tok, states[name], arch, pos,
                                use_kernel=True, active=act, **step_kw)
            if tw.violations():
                raise AssertionError(f"profile: {name}: host reads in a "
                                     f"decode step: "
                                     f"{[str(f) for f in tw.violations()]}")
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
                        "host sync seen in a step (the host-sync tripwire)")
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


# -- phase 5e: the prefix cache, the SLO ladder, the prefill export ----------

# (a) the prefill export: EXPORT_LANES prompts of EXPORT_PROMPT tokens, then
# EXPORT_DECODE greedy steps from the imported caches
EXPORT_LANES, EXPORT_PROMPT, EXPORT_DECODE = 4, 512, 32
# (b) a PREFIX_LEN-token system prompt shared by requests with suffixes of
# PREFIX_SUFFIXES tokens (PREFIX_NEW new each, one every PREFIX_GAP ticks),
# and a multi-turn trace; both on two lanes of PREFIX_MAX_LEN, one signature
PREFIX_LEN, PREFIX_SUFFIXES, PREFIX_NEW, PREFIX_GAP = 256, (8, 24, 40, 64,
                                                            16, 32), 16, 6
PREFIX_MAX_LEN, PREFIX_CHUNK, PREFIX_STRIDE = 512, 16, 4
PREFIX_MB, PREFIX_DEVICE_MB = 256, 64
# (c) benchmarks/slo_harness.py's overload shape, its tokens and chunk x4:
# 12 requests of widths 1-2 in a 2x burst on two lanes
OVERLOAD = dict(lanes=2, n=12, chunk=16, prompt_len=(24, 40), new=16,
                widths=(1, 2), deadline=12, rate=2.0, on_ticks=4, off_ticks=4)
OVERLOAD_SLO = dict(ttft_ticks=6, max_queue=4, min_width=1, cooldown_ticks=4)
# (d) the serving entry point, at the smoke config
SERVE_ARGV = ["--use-kernel", "--prefix-cache-mb", "64",
              "--prefix-cache-device-mb", "16", "--shared-prefix", "32",
              "--stagger"]
SERVE_SMOKE = dict(lanes=4, max_len=32 + 32 + 32, cr=4.0)   # serve's defaults


def state_keys(arch, kw, lanes, max_len):
    """The ``launch_key`` each pattern position's decode makes under a
    layout, read off a one-superblock state built on the CPU: fixed-arena
    (B·Hkv, G, Dh, P, block_p), or with ``kw["paged"]`` shared-pool (B·Hkv,
    G, Dh, pool slots, block_p, table width, "shared") (the kernel sees
    every page but the dump page)."""
    from repro_torch.core import policy as policy_lib
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.kv_cache import cache_block_p
    from repro_torch.models import transformer as tfm
    cfg = KVPolicyConfig(**kw)
    state = tfm.init_decode_state(
        dataclasses.replace(arch, num_layers=arch.pattern_period), lanes,
        max_len, cfg, device="cpu")
    a = arch.attn
    head = (lanes * a.num_kv_heads, a.q_per_kv, a.head_dim)
    keys = []
    for pc in policy_lib.iter_policy_caches(state):
        cache = pc.cache
        if cfg.paged:
            bp = cache_block_p(cache)
            keys.append(head + (cache.pool.ref.shape[-1] * bp, bp,
                                cache.phys.shape[-1], "shared"))
        else:
            keys.append(head + (cache.k.shape[-2], cfg.block_p))
    return keys


def decode_key(arch, kw, lanes, max_len):
    """The fixed-arena ``launch_key`` of a one-position layout."""
    return state_keys(arch, dict(kw, paged=False), lanes, max_len)[0]


def pool_key(arch, kw, lanes, max_len):
    """The shared-pool ``launch_key`` of a one-position paged layout."""
    return state_keys(arch, dict(kw, paged=True), lanes, max_len)[0]


def export_decode_keys(arch):
    """Every decode launch shape phase 5e makes: fixed-arena (``decode_key``)
    and shared-pool (``pool_key``) for (a) dms and vanilla on EXPORT_LANES
    lanes and (b) on two lanes of PREFIX_MAX_LEN (dms only paged); fixed-
    arena for (c) dms on the overload trace's arena and (d) the smoke
    config's dms."""
    from repro_torch.configs import get_smoke
    keys = set()
    for kind in ("dms", "vanilla"):
        kw = dict(kind=kind, cr=8.0)
        keys.add(decode_key(arch, kw, EXPORT_LANES,
                            EXPORT_PROMPT + EXPORT_DECODE))
        keys.add(pool_key(arch, kw, EXPORT_LANES,
                          EXPORT_PROMPT + EXPORT_DECODE))
        keys.add(decode_key(arch, kw, 2, PREFIX_MAX_LEN))
    keys.add(pool_key(arch, PREFIX_LAYOUTS["dms paged"], 2, PREFIX_MAX_LEN))
    keys.add(decode_key(arch, dict(kind="dms", cr=8.0), OVERLOAD["lanes"],
                        OVERLOAD["prompt_len"][1] + OVERLOAD["new"]))
    smoke = get_smoke("qwen-r1-1.5b")
    keys.add(decode_key(smoke, dict(kind="dms", cr=SERVE_SMOKE["cr"],
                                    window=smoke.dms.window),
                        SERVE_SMOKE["lanes"], SERVE_SMOKE["max_len"]))
    return keys


def prefill_flash_case(torch, *, b, t, binary, seed, hq=12, device="cuda"):
    """The prefill export's folded flash operands (bf16, Hq ``hq``: 12 for
    qwen-r1-1.5b, 32 for chatglm3-6b; Hkv 2, Dh 128): binarised α (1 with
    probability 7/8, the served model's rate) as a log-survival of -1e30
    for evicted keys, delay 256, no block skipping (the reference's
    default); or vanilla (zero log-survival, delay 0)."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention.ref import FlashConfig
    hkv, dh = 2, 128
    gen = torch.Generator(device=device).manual_seed(seed)
    bk, tp = fops.padded_blocks(t)
    qf, kf, vf = (fops.fold_heads(torch.randn(
        (b, t, h, dh), generator=gen, device=device).to(torch.bfloat16), tp)
        for h in (hq, hkv, hkv))
    if binary:
        alpha = (torch.rand((b, hkv, t), generator=gen, device=device)
                 < 7 / 8).float()
        ls, delay = fops.kernel_log_survival(alpha, tp), 256
    else:
        ls, delay = torch.zeros((b * hkv, tp), device=device), 0
    cfg = FlashConfig(t=t, orig_dh=dh, hq=hq, hkv=hkv, window=None,
                      dms_delay=delay, causal=True, logit_cap=None,
                      block_k=bk, skip_blocks=False)
    return qf, kf, vf, ls, cfg


PREFILL_FLASH = {
    "prefill export, binarised alpha": dict(t=EXPORT_PROMPT, binary=True),
    "prefill export, vanilla": dict(t=EXPORT_PROMPT, binary=False),
    "prefill export, T = 288 (padded to 384)": dict(t=288, binary=True),
}


def check_decode_keys(torch, keys, *, what, caps=None):
    """The decode kernel at every launch shape ``keys`` lists, in fixed-
    arena mode (random tables, NaN in unlisted blocks) and in shared-pool
    mode (``make_pool_case`` on a pool of the key's pages, NaN in every page
    no table lists), at slot densities 0.5, which lists nearly every
    block, and 0.05, which lists about half of them in fragmented tables;
    ``caps`` maps a key to its logit softcap (default none).  Each against
    the plain version and the plain split, bit-equal on a second launch.
    Returns (the largest max abs error, the errors by key); the launches
    made here are checked against the counters."""
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode.ref import (dms_decode_plain,
                                                    dms_decode_plain_shared,
                                                    dms_decode_plain_split)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    before = (ops.launches, ops.shared_launches)
    errs = {}
    cases = [(key, density) for key in sorted(keys)
             for density in (0.5, 0.05)]
    for key, density in cases:
        shared = len(key) == 7
        cap = (caps or {}).get(key)
        if shared:
            bh, g, dh, slots, bp, nb, _ = key
            case = make_pool_case(torch, gen, bh=bh, g=g, dh=dh, nb=nb, bp=bp,
                                  density=density, nan=True,
                                  pages=slots // bp)
            args = case["shared"]
            plain, mode = dms_decode_plain_shared, "shared-pool"
        else:
            bh, g, dh, p, bp = key
            args = make_case(torch, gen, bh=bh, g=g, dh=dh, p=p, bp=bp,
                             density=density)
            plain, mode = dms_decode_plain, "fixed-arena"
        q, k, v, valid, tbl, n = args
        got = launch_key(q, k, tbl, bp, shared)
        if got != key:
            raise AssertionError(f"{what} case {got} is not the shape {key}")
        out = ops.decode_rows(*args, bp, cap, shared_kv=shared)
        again = ops.decode_rows(*args, bp, cap, shared_kv=shared)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"kernel [{what} shape {key}]: a second "
                                 "launch gave other bits")
        ref = plain(*args, bp, cap)
        split = dms_decode_plain_split(*args, bp, cap, shared_kv=shared,
                                       splits=ops.launch_splits(
                                           args[0], tbl.shape[1]))
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"kernel [{what} shape {key}]: non-finite "
                                 "output")
        torch.testing.assert_close(out.float(), ref.float(), **KERNEL_TOL)
        torch.testing.assert_close(out.float(), split.float(), **KERNEL_TOL)
        err = (out.float() - ref.float()).abs().max().item()
        errs[key] = max(err, errs.get(key, 0.0))
        shape = ("(B·Hkv, G, Dh, pool slots, block_p, table width)" if shared
                 else "(B·Hkv, G, Dh, P, block_p)")
        log(f"kernel vs plain [{what}'s {mode} launch {shape} {key[:6]}, "
            f"{int(n.sum())} listed blocks, slot density {density}, NaN in "
            f"every unlisted {'page' if shared else 'block'}"
            f"{f', softcap {cap:g}' if cap else ''}]: max_abs_err {err:.3e} "
            f"(tolerance atol {KERNEL_TOL['atol']}, rtol "
            f"{KERNEL_TOL['rtol']}; the plain split too); bit-equal on a "
            "second launch")
    moved = (ops.launches - before[0], ops.shared_launches - before[1])
    n_shared = sum(len(key) == 7 for key, _ in cases)
    if moved != (2 * (len(cases) - n_shared), 2 * n_shared):
        raise AssertionError(f"launch counters moved {moved}")
    return max(errs.values(), default=0.0), errs


def check_flash_cases(torch, cases, *, b=EXPORT_LANES):
    """``flash_fwd`` on ``prefill_flash_case`` operands for each of
    ``cases`` (name -> keywords) against its plain version within
    FLASH_REL_TOL, bit-equal on a second launch; returns the first case's
    max abs error."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention import ref as fref
    before = fops.launches["flash_fwd"]
    tol = FLASH_REL_TOL["bfloat16"]
    flash_err = None
    for name, kw in cases.items():
        qf, kf, vf, ls, cfg = prefill_flash_case(
            torch, b=b, seed=kw["t"] + kw["binary"], **kw)
        t = cfg.t
        out, lse = fops.flash_fwd(qf, kf, vf, ls, None, cfg)
        again = fops.flash_fwd(qf, kf, vf, ls, None, cfg)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"flash_fwd [{name}]: a second launch gave "
                                 "other bits")
        out_p, lse_p = fref.flash_fwd_plain(qf, kf, vf, ls, None, cfg)
        parts, errs = [], []
        for key, got, want in (("out", out, out_p), ("lse", lse, lse_p)):
            got, want = got[:, :t].float(), want[:, :t].float()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash_fwd [{name}]: non-finite {key}")
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if err > tol * max(scale, 1.0 if key == "lse" else 0.0):
                raise AssertionError(f"flash_fwd [{name}] {key}: max abs err "
                                     f"{err:.3e} > {tol} x {scale:.3e}")
            parts.append(f"{key} {err:.2e}/{scale:.2e}")
            errs.append(err)
        if flash_err is None:
            flash_err = max(errs)
        log(f"flash_fwd vs plain [{name}, B={b} T={t} Hq={cfg.hq} "
            f"Hkv={cfg.hkv} Dh={cfg.orig_dh} bf16, Tp={qf.shape[1]}, delay "
            f"{cfg.dms_delay}, no block skipping]: max abs err / max |plain|:"
            f" {', '.join(parts)} (tolerance {tol} relative); bit-equal on a "
            "second launch")
    if fops.launches["flash_fwd"] - before != 2 * len(cases):
        raise AssertionError("flash_fwd launch counter moved "
                             f"{fops.launches['flash_fwd'] - before}")
    return flash_err


def phase_export_kernels(torch, keys):
    """Phase 3's checks at phase 5e's launch shapes: the decode kernel at
    every shape ``keys`` lists (``check_decode_keys``), and ``flash_fwd``
    at the prefill export's shapes (``PREFILL_FLASH``, B = EXPORT_LANES).
    Returns (the decode kernel's largest max abs error, the checked decode
    shapes, flash_fwd's max abs error at the main prefill case)."""
    worst, errs = check_decode_keys(torch, keys, what="phase 5e")
    return worst, set(errs), check_flash_cases(torch, PREFILL_FLASH)


def tripwired(fn, seen):
    """``fn`` run under a ``HostSyncTripwire`` that allows no tag (on the
    card also CUDA's sync debug mode at error, so a sync the hooks miss
    raises); each call's findings go to ``seen``."""
    from repro_torch.analysis.hostsync import HostSyncTripwire

    def wrapped(*args, **kw):
        with HostSyncTripwire(allow=()) as tw:
            try:
                return fn(*args, **kw)
            finally:
                seen.append(tw.findings())
    for attr in ("steps", "temperature"):
        if hasattr(fn, attr):
            setattr(wrapped, attr, getattr(fn, attr))
    return wrapped


def phase_prefill_export(torch, setup, *, t=EXPORT_PROMPT,
                         steps=EXPORT_DECODE, what="5e (a)",
                         kinds=("dms", "vanilla")):
    """(a) ``make_prefill_step`` through ``flash_fwd`` on EXPORT_LANES
    prompts of ``t`` tokens, ``dms`` (CR 8, delay 256) and ``vanilla``:
    one flash launch per layer, the last logits within 0.05 x max |logit|
    of the reference path's, α flips between the two paths counted; then
    ``prefill_import`` into fixed arenas and the pool and ``steps`` greedy
    decode steps through ``decode_fwd`` (one launch per layer per step, in
    the fixed or the shared mode): the pool's tokens equal the fixed
    arenas', and dms imports fewer live tokens than vanilla (``kinds``: the
    policies to run; a model with local layers has no vanilla import).
    Returns flash_fwd's launches, per policy the imported live tokens and α
    flips."""
    from repro_torch.core import policy as policy_lib
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tfm
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    cuda = device == "cuda"
    rng = torch.Generator().manual_seed(11)
    tokens = torch.randint(3, arch.vocab_size, (EXPORT_LANES, t),
                           generator=rng, dtype=torch.int32).to(device)
    live_v = torch.arange(arch.padded_vocab, device=device) < arch.vocab_size
    out = {"flash": 0, "live": {}, "flips": {}}
    for kind in kinds:
        dms = kind == "dms"
        fops.launches["flash_fwd"] = 0
        t0 = time.perf_counter()
        logits, kv = make_prefill_step(arch, dms=dms, use_kernel=True)(
            params, {"tokens": tokens})
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = fops.launches["flash_fwd"]
        if launched != (arch.num_layers if cuda else 0):
            raise AssertionError(f"prefill export ({kind}): flash_fwd launched "
                                 f"{launched} times, want {arch.num_layers}")
        out["flash"] += launched
        ref_logits, ref_kv = make_prefill_step(arch, dms=dms,
                                               use_kernel=False)(
            params, {"tokens": tokens})
        diff = (logits - ref_logits)[:, live_v].abs().max().item()
        scale = ref_logits[:, live_v].abs().max().item()
        if not bool(torch.isfinite(logits[:, live_v]).all()) \
                or not diff <= 0.05 * scale:
            raise AssertionError(f"prefill export ({kind}): kernel-path "
                                 f"logits off by {diff:.4e} (max |logit| "
                                 f"{scale:.4e})")
        flips = 0
        if dms:
            a_k, a_r = kv["0"]["alpha_bin"], ref_kv["0"]["alpha_bin"]
            flips = int((a_k != a_r).sum())
            evicted = 1.0 - kv["0"]["retained"].float().mean().item()
            note = (f"alpha flips between the paths {flips} of "
                    f"{a_k.numel()}; {evicted:.4f} of the prompt evicted at "
                    "the import")
        else:
            note = "no alpha"
        out["flips"][kind] = flips
        del ref_kv
        tokens_by = {}
        for paged in (False, True):
            cfg = KVPolicyConfig(kind=kind, cr=8.0, paged=paged)
            state = tfm.state_from_prefill(arch, cfg, kv, t + steps)
            pc = state["0"]
            live = float(policy_lib.get_policy(pc.policy).metrics(
                pc.cache)["live_tokens"].sum())
            ops.launches = ops.shared_launches = 0
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            gen = [tok]
            for i in range(steps - 1):
                lg, state, _ = tfm.decode_step(params, tok[:, None], state,
                                               arch, t + i, use_kernel=True)
                tok = torch.argmax(lg, dim=-1).to(torch.int32)
                gen.append(tok)
            got = (ops.launches, ops.shared_launches)
            want = arch.num_layers * (steps - 1) if cuda else 0
            if got != ((0, want) if paged else (want, 0)):
                raise AssertionError(f"prefill export ({kind}, paged "
                                     f"{paged}): decode launches (fixed, "
                                     f"shared) {got}, want {want}")
            tokens_by[paged] = torch.stack(gen, dim=1).cpu()
            if paged:
                pool_pages = int(policy_lib.state_pool_stats(state)[
                    "allocated_blocks"])
            else:
                out["live"][kind] = live
        if not torch.equal(tokens_by[False], tokens_by[True]):
            raise AssertionError(f"prefill export ({kind}): the pool's tokens "
                                 "differ from the fixed arenas'")
        log(f"{what} prefill export, {kind}: {EXPORT_LANES} prompts of {t} "
            f"tokens through flash_fwd ({launched} launches = "
            f"{arch.num_layers} layers) in {wall:.3f} s; last logits vs the "
            f"reference path: max abs diff {diff:.4e}, max |logit| "
            f"{scale:.4e} (tolerance 0.05 x max |logit|); {note}; imported "
            f"live tokens {live:.1f} (summed over layers and lanes, mean "
            f"over heads); {steps} greedy tokens a lane ({steps - 1} decode "
            f"steps through decode_fwd, {want} launches a layout): the "
            f"pool's ({pool_pages} pages mapped) equal to the fixed "
            "arenas'")
        del kv, logits, ref_logits
    if "vanilla" in kinds and not out["live"]["dms"] < out["live"]["vanilla"]:
        raise AssertionError(f"dms imported {out['live']['dms']} live tokens,"
                             f" vanilla {out['live']['vanilla']}")
    return out


def prefix_traces(arch, vocab_seed=12):
    """(b)'s two traces as (prompt, max_new, arrival) lists: the shared
    system prompt with its suffixes, one request every PREFIX_GAP ticks,
    and ``multi_turn_trace``'s 2 sessions x 3 turns (each turn's prompt
    extends the last turn's context)."""
    import numpy as np
    from repro_torch.serving import workload
    rng = np.random.default_rng(vocab_seed)

    def prompt(n):
        return rng.integers(3, arch.vocab_size, size=(n,)).astype(np.int32)

    system = prompt(PREFIX_LEN)
    shared = [(np.concatenate([system, prompt(n)]), PREFIX_NEW,
               i * PREFIX_GAP) for i, n in enumerate(PREFIX_SUFFIXES)]
    spec = workload.WorkloadSpec(vocab=arch.vocab_size,
                                 max_len=PREFIX_MAX_LEN, prompt_len=(32, 64),
                                 max_new=(PREFIX_NEW, PREFIX_NEW))
    turns = [(r.prompt, r.max_new, r.arrival) for r in workload.multi_turn_trace(
        vocab_seed, sessions=2, turns=3, spec=spec, think_ticks=8)]
    return {"shared prefix": shared, "multi-turn": turns}


def serve_prefix_trace(torch, engine, trace, *, sync_check=False):
    """A trace on two lanes of PREFIX_MAX_LEN; with ``sync_check`` the chunk
    step, the lane export and import and the slab's store and fetch run
    under ``tripwired`` (a host read in any of them fails the trace).  The
    decode kernel must launch once per layer per decode step, in the
    shared-pool mode when the engine is paged.  Returns (results by uid,
    scheduler, wall s, each request's first-token logits by uid)."""
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.scheduler import Request
    cuda = engine.device.type == "cuda"
    seen = []
    names = ("import_lane_state", "export_lane_state", "store_lane_snapshot",
             "fetch_lane_snapshot")
    real = {n: getattr(tfm, n) for n in names}
    sched = engine.scheduler(num_lanes=2, max_len=PREFIX_MAX_LEN)
    for uid, (p, n, arr) in enumerate(trace):
        sched.submit(Request(uid=uid, prompt=p, max_new=n, arrival=arr))
    first = {}
    start = sched._start_decode

    def start_decode(r):
        first[r.req.uid] = r.hold_logits.copy()
        start(r)
    sched._start_decode = start_decode
    if sync_check:
        sched._chunk_fn = tripwired(sched._chunk_fn, seen)
        for n in names:
            setattr(tfm, n, tripwired(real[n], seen))
    engine.chunk_fn.steps = 0
    ops.launches = ops.shared_launches = 0
    t0 = time.perf_counter()
    try:
        results = {r.uid: r for r in sched.run()}
    finally:
        for n in names:
            setattr(tfm, n, real[n])
    if cuda:
        torch.cuda.synchronize()
    del sched._start_decode          # the hook refers to the scheduler
    reads = [str(f) for calls in seen for f in calls]
    if sync_check and (not seen or reads):
        raise AssertionError(f"host reads in {len(seen)} tripwired calls: "
                             f"{reads}")
    want = attn_layers(engine.arch) * engine.chunk_fn.steps if cuda else 0
    got = (ops.launches, ops.shared_launches)
    if got != ((0, want) if engine.policy.paged else (want, 0)):
        raise AssertionError(f"decode launches (fixed, shared) {got} for "
                             f"{engine.chunk_fn.steps} steps")
    return results, sched, time.perf_counter() - t0, first


PREFIX_LAYOUTS = {"dms fixed": dict(kind="dms", cr=8.0),
                  "dms paged": dict(kind="dms", cr=8.0, paged=True),
                  "vanilla fixed": dict(kind="vanilla")}


def phase_shared_prefix(torch, setup):
    """(b) Each trace of ``prefix_traces`` served warm by each
    PREFIX_LAYOUTS engine (one prefix cache for both traces: a
    PREFIX_DEVICE_MB slab over a PREFIX_MB host tier, chunk PREFIX_CHUNK,
    export stride PREFIX_STRIDE) and cold (no prefix cache; dms paged's
    cold tokens are dms fixed's, checked in (a) and phase 5): every
    request ok with the cold request's tokens, paid + saved prefill reads
    equal to the cold reads, reads saved; the shared-prefix trace served
    from the slab with no host<->device snapshot byte and no host sync in a
    chunk, an import, an export or the slab; every page back at the end.
    The first token's logits of every warm request (``hold_logits``: the
    cached boundary row on a whole-prompt hit) are held against the cold
    request's; the largest gap is logged.  Returns each layout's prefix
    cache stats."""
    from repro_torch.core import policy as policy_lib
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.serving.engine import Engine
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    traces = prefix_traces(arch)
    kw = dict(use_kernel=True, device=device, chunk=PREFIX_CHUNK)
    cold = {}
    for kind in ("dms", "vanilla"):
        eng = Engine(arch, params, KVPolicyConfig(**PREFIX_LAYOUTS[
            f"{kind} fixed"]), **kw)
        cold[kind] = {}
        for name, trace in traces.items():
            res, _, wall, first = serve_prefix_trace(torch, eng, trace)
            cold[kind][name] = (res, wall, first)
    out = {}
    for layout, pkw in PREFIX_LAYOUTS.items():
        eng = Engine(arch, params, KVPolicyConfig(**pkw),
                     prefix_cache_mb=PREFIX_MB,
                     prefix_cache_device_mb=PREFIX_DEVICE_MB,
                     export_stride=PREFIX_STRIDE, **kw)
        pc = eng.prefix_cache
        for name, trace in traces.items():
            before = pc.traffic()
            res, sched, wall, first = serve_prefix_trace(
                torch, eng, trace, sync_check=name == "shared prefix")
            traffic = {k: v - before[k] for k, v in pc.traffic().items()}
            ref, cold_wall, cold_first = cold[pkw["kind"]][name]
            saved = paid = cold_paid = gap = 0.0
            for uid, r in res.items():
                c = ref[uid]
                gap = max(gap, float(abs(first[uid] - cold_first[uid]).max()))
                if r.status != "ok" or not (r.tokens == c.tokens).all():
                    raise AssertionError(f"5e (b) {layout}, {name}, request "
                                         f"{uid}: status {r.status}, or "
                                         "tokens differ from the cold serve's")
                got = r.prefill_meter.kv_reads + r.prefill_meter.kv_reads_saved
                if got != c.prefill_meter.kv_reads:
                    raise AssertionError(f"5e (b) {layout}, {name}, request "
                                         f"{uid}: paid + saved {got} != cold "
                                         f"{c.prefill_meter.kv_reads}")
                saved += r.prefill_meter.kv_reads_saved
                paid += r.prefill_meter.kv_reads
                cold_paid += c.prefill_meter.kv_reads
            if saved <= 0:
                raise AssertionError(f"5e (b) {layout}, {name}: no read saved")
            if name == "shared prefix" and (
                    pc.hot_hits <= 0 or traffic["h2d_bytes"]
                    or traffic["d2h_bytes"]):
                raise AssertionError(f"5e (b) {layout}: the shared prefix was "
                                     f"not served from the slab: {traffic}, "
                                     f"hot hits {pc.hot_hits}")
            pages = ""
            if pkw.get("paged"):
                st = policy_lib.state_pool_stats(sched.state)
                if st["allocated_blocks"] or st["exhausted"]:
                    raise AssertionError(f"5e (b) {layout}, {name}: pool not "
                                         f"empty at the end: {st}")
                pages = "; every page back at the end"
            sync = ("; no host sync in a chunk, an import, an export or the "
                    "slab (the host-sync tripwire and the sync debug mode; "
                    "the wall includes the tripwire's hooks)"
                    if name == "shared prefix" else "")
            log(f"5e (b) {layout}, {name} ({len(trace)} requests, prompts "
                f"{sorted(len(p) for p, _, _ in trace)}, {trace[0][1]} new "
                f"each): all ok, tokens equal to the cold serve's (first-token"
                f" logits: max abs gap {gap:.4e}); prefill "
                f"reads paid {paid:.0f} + saved {saved:.0f} = cold "
                f"{cold_paid:.0f}; {sched.ticks} ticks, {eng.chunk_fn.steps} "
                f"decode steps (one decode_fwd launch a layer each) in "
                f"{wall:.2f} s (cold {cold_wall:.2f} s); traffic "
                f"{traffic}; paged imports degraded to a cold prefill "
                f"{sched.prefix_import_degrades}{pages}{sync}")
        st = pc.stats()
        out[layout] = st
        log(f"5e (b) {layout}: prefix cache stats {json.dumps(st)}")
    return out


def phase_overload(torch, setup):
    """(c) OVERLOAD's burst trace served without control and with
    OVERLOAD_SLO's ladder, both scored against that SLO: the ladder's
    goodput above no control's, every status definite, shed and rejected
    requests read nothing, every ok request's tokens equal a solo run at
    its served width.  Returns both runs' stats."""
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.serving import workload
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import SLOSpec, compute_slo_stats
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    o = OVERLOAD
    max_len = o["prompt_len"][1] + o["new"]
    spec = workload.WorkloadSpec(vocab=arch.vocab_size, max_len=max_len,
                                 prompt_len=o["prompt_len"],
                                 max_new=(o["new"], o["new"]),
                                 widths=o["widths"], deadline=o["deadline"])
    reqs = workload.burst_trace(0, o["n"], rate=o["rate"],
                                on_ticks=o["on_ticks"],
                                off_ticks=o["off_ticks"], spec=spec)
    eng = Engine(arch, params, KVPolicyConfig(kind="dms", cr=8.0),
                 use_kernel=True, device=device, chunk=o["chunk"])
    slo = SLOSpec(**OVERLOAD_SLO)
    runs = {}
    for name, ctl in (("uncontrolled", None), ("controlled", slo)):
        t0 = time.perf_counter()
        sched = eng.scheduler(num_lanes=o["lanes"], max_len=max_len, slo=ctl)
        for r in reqs:
            sched.submit(r)
        eng.chunk_fn.steps = ops.launches = 0
        res = sched.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if ops.launches != (arch.num_layers * eng.chunk_fn.steps
                            if device == "cuda" else 0):
            raise AssertionError(f"5e (c) {name}: {ops.launches} decode "
                                 f"launches for {eng.chunk_fn.steps} steps")
        stats = compute_slo_stats(res, slo, offered=len(reqs),
                                  timeline=sched._timeline,
                                  num_lanes=o["lanes"])
        stats["lifecycle"] = sched.lifecycle_stats()
        runs[name] = (res, stats)
        log(f"5e (c) overload, {name}: {len(reqs)} requests "
            f"({workload.trace_summary(reqs)}) in {sched.ticks} ticks, "
            f"{wall:.2f} s: goodput {stats['goodput']:.4f}, statuses "
            f"{stats['statuses']}, lifecycle {stats['lifecycle']}, TTFT "
            f"{stats['ttft']}, queue depth {stats['queue_depth']}")
    base, ctrl = runs["uncontrolled"][1], runs["controlled"][1]
    if not ctrl["goodput"] > base["goodput"]:
        raise AssertionError(f"5e (c): controlled goodput {ctrl['goodput']} "
                             f"not above uncontrolled {base['goodput']}")
    definite = {"ok", "failed", "timeout", "rejected"}
    by_uid = {r.uid: r for r in reqs}
    solos = 0
    for name, (res, _) in runs.items():
        for r in res:
            if r.status not in definite:
                raise AssertionError(f"5e (c) {name}: status {r.status}")
            if r.status == "rejected" and (r.prefill_meter.kv_reads
                                           or r.admitted_tick != -1):
                raise AssertionError(f"5e (c): rejected request {r.uid} read "
                                     "or took a lane")
    for r in runs["controlled"][0]:
        if r.status != "ok":
            continue
        w = len(r.lengths)
        solo = eng.scheduler(num_lanes=max(o["lanes"], w), max_len=max_len)
        solo.submit(dataclasses.replace(by_uid[r.uid], width=w, arrival=0,
                                        deadline=None))
        s = solo.run()[0]
        solos += 1
        if not ((r.tokens == s.tokens).all() and (r.lengths
                                                  == s.lengths).all()):
            raise AssertionError(f"5e (c): request {r.uid}'s tokens differ "
                                 f"from a solo run at width {w}")
    log(f"5e (c) overload: controlled goodput {ctrl['goodput']:.4f} > "
        f"uncontrolled {base['goodput']:.4f}; every status definite; shed "
        f"and rejected requests read 0 prefill tokens; {solos} ok requests' "
        "tokens equal a solo run at the served width")
    return {"uncontrolled": base, "controlled": ctrl}


def phase_serve_cli(torch):
    """(d) ``repro_torch.launch.serve.main`` on the card at the smoke
    config (SERVE_ARGV): every request ok, ``decode_fwd`` launched, the
    prefix cache hit."""
    import contextlib
    import io
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.launch import serve
    ops.launches = ops.shared_launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    reqs = [x for x in lines if "uid" in x]
    cache = next(x["prefix_cache"] for x in lines if "prefix_cache" in x)
    if not reqs or any(x["status"] != "ok" for x in reqs) or not ops.launches \
            or cache["hits"] <= 0:
        raise AssertionError(f"5e (d) serve: requests {reqs}, decode_fwd "
                             f"launches {ops.launches}, cache {cache}")
    log(f"5e (d) python -m repro_torch.launch.serve {' '.join(SERVE_ARGV)}: "
        f"{len(reqs)} requests ok in {wall:.2f} s, decode_fwd launched "
        f"{ops.launches} times; prefix cache hits {cache['hits']} (hot "
        f"{cache['hot_hits']}), h2d {cache['h2d_bytes']} B, d2h "
        f"{cache['d2h_bytes']} B; first request {json.dumps(reqs[0])}")
    return {"requests": len(reqs), "launches": ops.launches}


def phase_prefix_serve(torch, setup, checked):
    """Phase 5e: (a) the prefill export, (b) the shared prefix and
    multi-turn traces through the prefix cache, (c) the overload ladder,
    (d) the serving entry point.  Every decode launch, fixed-arena or
    shared-pool, must be at a shape phase 3 checked (``checked``).
    Returns flash_fwd's launches in (a) and the decode kernel's launch
    shapes."""
    from repro_torch.kernels.dms_decode import ops
    cuda = setup["device"] == "cuda"
    pooled = set()
    recording, _, shapes, real = recording_decode_rows(torch, setup["device"],
                                                       pooled)
    ops.decode_rows = recording
    try:
        exported = phase_prefill_export(torch, setup)
        phase_shared_prefix(torch, setup)
        phase_overload(torch, setup)
        if cuda:
            phase_serve_cli(torch)
    finally:
        ops.decode_rows = real
    launched = shapes | pooled
    if cuda and not launched <= checked:
        raise AssertionError(f"phase 5e launched the decode kernel at "
                             f"{sorted(launched - checked)}, not among phase "
                             f"3's checked {sorted(checked)}")
    log(f"phase 5e's decode launch shapes: fixed-arena {sorted(shapes)}, "
        f"shared-pool {sorted(pooled)}: each checked in phase 3")
    return {"flash": exported["flash"], "shapes": launched}


def phase_prefill_timing(torch, launches, err,
                         case="prefill export, binarised alpha",
                         name="flash_fwd (prefill export)"):
    """``flash_fwd`` at a prefill export's shape (``case`` of PREFILL_FLASH
    or ARCH_FLASH: B EXPORT_LANES, T EXPORT_PROMPT, Hkv 2, Dh 128, bf16,
    binarised α, delay 256, no block skipping): kernel, plain version,
    bound (the causal product's flops at the bf16 tensor-core peak, or its
    bytes) and SDPA's forward over the same function (the DMS mask
    materialised, K/V expanded to the query heads); SDPA's plain causal
    forward (no DMS mask) is logged beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention import ref as fref
    kw = {**PREFILL_FLASH, **ARCH_FLASH}[case]
    qf, kf, vf, ls, cfg = prefill_flash_case(
        torch, b=EXPORT_LANES, seed=kw["t"] + kw["binary"], **kw)
    b, t, hq, hkv, dh = EXPORT_LANES, cfg.t, cfg.hq, cfg.hkv, cfg.orig_dh
    if qf.shape[1] != t:
        raise AssertionError("the timed prefill shape must need no padding")
    saved = dict(fops.launches)
    ms = time_cuda(torch, lambda: fops.flash_fwd(qf, kf, vf, ls, None, cfg))
    fops.launches.update(saved)           # timing launches are not the path's
    plain = time_cuda(torch, lambda: fref.flash_fwd_plain(qf, kf, vf, ls,
                                                          None, cfg))
    g = hq // hkv
    qs = qf.reshape(b, hq, t, dh)
    ks = kf.reshape(b, hkv, t, dh).repeat_interleave(g, dim=1)
    vs = vf.reshape(b, hkv, t, dh).repeat_interleave(g, dim=1)
    i = torch.arange(t, device="cuda")[:, None]
    j = torch.arange(t, device="cuda")[None, :]
    lsb = ls.reshape(b, hkv, 1, t)
    mask = torch.where(j <= i, torch.where(i - j >= cfg.dms_delay, lsb, 0.0),
                       float("-inf")).repeat_interleave(g, dim=1).to(qf.dtype)
    library = time_cuda(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask))
    causal = time_cuda(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True))
    out, lse = fops.flash_fwd(qf, kf, vf, ls, None, cfg)
    fops.launches.update(saved)
    nbytes = lambda *xs: sum(x.numel() * x.element_size() for x in xs)  # noqa: E731
    flops = 4 * dh * (b * hq * t * (t + 1) // 2)
    moved = nbytes(qf, kf, vf, ls, out, lse)
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/dms_attention/csrc/dms_attention.cu",
             "replaces": "src/repro/kernels/dms_attention/dms_attention.py:142",
             "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain, "bound_ms": max(ops_ms, bytes_ms),
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
             "library_ms": library}
    log(f"timing: {name} at (B={b}, T={t}, "
        f"Hq={hq}, Hkv={hkv}, Dh={dh}, bf16, binarised alpha, delay "
        f"{cfg.dms_delay}): kernel {ms:.4f} ms, bound {entry['bound_ms']:.5f}"
        f" ms ({flops} flop, {moved} B), plain {plain:.4f} ms, library "
        f"{library:.4f} ms (SDPA forward, DMS mask); SDPA causal forward, no "
        f"DMS mask: {causal:.4f} ms")
    return entry


# -- phase 5f: gemma2, chatglm3, qwen2-vl and granite ------------------------

# the families 5f serves and the layers it serves of each (the time limit):
# one superblock of gemma2's local and global layers, two layers else
ARCH_LAYERS = {"gemma2-2b": 2, "chatglm3-6b": 2, "qwen2-vl-7b": 2,
               "granite-moe-3b-a800m": 2}
# checked in phase 3 and timed in phase 7, not served: granite-1b's G 2 at
# Dh 64 (granite-3b's G 3 serves)
ARCH_CHECKED = ("granite-moe-1b-a400m",)
ARCH_NEWS = (32, 24, 16, 32)     # new tokens of phase 4's four prompts
ARCH_PAIR = (3, 1)               # (c): phase 4's requests 3 and 1
ARCH_TRACE = 48                  # teacher-forced kernel-vs-reference steps
# (b): a prompt past gemma2's 4096-token local window, then new tokens
WINDOW_PROMPT, WINDOW_NEW = 4160, 16
# (c): chatglm3's prefill export, EXPORT_LANES prompts of EXPORT_PROMPT
# tokens and 15 decode steps
EXPORT_ARCH, ARCH_EXPORT_DECODE = "chatglm3-6b", 16
ARCH_FLASH = {"chatglm3-6b prefill export, binarised alpha": dict(
    t=EXPORT_PROMPT, binary=True, hq=32)}


def arch_policy(arch):
    """5f's and 5g's policy keywords for ``arch``: ``dms`` at CR 8, and for
    gemma2's local layers a window ring of its local window
    (``layer_map``); ``vanilla`` for a model with no attention (mamba2)."""
    if arch.attn is None:
        return dict(kind="vanilla")
    if {"attn_local", "attn"} <= set(arch.layer_pattern):
        return dict(kind="dms", cr=8.0, budget=arch.attn.window,
                    layer_map={"attn_local": "window", "attn": "dms"})
    return dict(kind="dms", cr=8.0)


def arch_uids(arch):
    """The requests of phase 4's trace that 5f serves with ``arch``."""
    return (0, 1, 2, 3) if "attn_local" in arch.layer_pattern else ARCH_PAIR


def arch_layouts(arch, lens, news=ARCH_NEWS, window=(WINDOW_PROMPT,
                                                    WINDOW_NEW),
                 trace=ARCH_TRACE, export=(EXPORT_PROMPT, ARCH_EXPORT_DECODE)):
    """Every (policy keywords, lanes, max_len) 5f builds a decode state for
    with ``arch``: serving fixed and paged (the profile's too), the
    kernel-vs-reference trace, gemma2's one-lane window run and chatglm3's
    prefill export."""
    kw, uids = arch_policy(arch), arch_uids(arch)
    max_len = max(lens[u] + news[u] for u in uids)
    out = [(kw, len(uids), max_len), (dict(kw, paged=True), len(uids), max_len),
           (kw, 2, trace + 16)]
    if "attn_local" in arch.layer_pattern:
        out.append((kw, 1, sum(window)))
    if arch.name == EXPORT_ARCH:
        out += [(dict(kind=kind, cr=8.0, paged=paged), EXPORT_LANES,
                 sum(export)) for kind in ("dms", "vanilla")
                for paged in (False, True)]
    return out


def arch_decode_keys(archs=None, lens=(512, 384, 256, 128), **kw):
    """{launch key: logit softcap} of every decode launch 5f makes, from
    ``arch_layouts`` of each family at full width (or of ``archs``)."""
    from repro_torch.configs import get_arch
    keys = {}
    for arch in archs or [get_arch(name) for name in (*ARCH_LAYERS,
                                                      *ARCH_CHECKED)]:
        for pol, lanes, max_len in arch_layouts(arch, lens, **kw):
            for key in state_keys(arch, pol, lanes, max_len):
                keys[key] = arch.attn.logit_softcap
    return keys


def serve_requests(torch, engine, setup, uids):
    """Requests ``uids`` of the setup's trace, one tick apart, on one lane
    each: every request ok with its full token count.  Returns (results by
    uid, wall s, decode steps, scheduler)."""
    from repro_torch.serving.scheduler import Request
    arch, prompts, news = setup["arch"], setup["prompts"], setup["news"]
    engine.chunk_fn.steps = 0
    t0 = time.perf_counter()
    sched = engine.scheduler(num_lanes=len(uids), max_len=max(
        len(prompts[u]) + news[u] for u in uids))
    for i, u in enumerate(uids):
        sched.submit(Request(uid=u, prompt=prompts[u], max_new=news[u],
                             arrival=i))
    results = {r.uid: r for r in sched.run()}
    if setup["device"] == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for u in uids:
        res = results[u]
        if res.status != "ok" or res.tokens.shape != (1, news[u]) \
                or ((res.tokens < 0) | (res.tokens >= arch.vocab_size)).any():
            raise AssertionError(f"{arch.name} request {u}: status "
                                 f"{res.status}, tokens {res.tokens.shape}")
    return results, wall, engine.chunk_fn.steps, sched


def arch_serve(torch, setup, what, kw=None, uids=None,
               layouts=(False, True)):
    """Serve ``uids`` (``arch_uids``) under the policy keywords ``kw``
    (``arch_policy``) on fixed arenas, then on the paged pool (``layouts``
    says which), through the decode kernel: every request ok, one launch an
    attention layer a decode step (fixed-arena, then shared-pool mode), the
    pool's tokens equal the fixed arenas' and every page back at the end.
    A model with no attention layer (mamba2) launches nothing and builds no
    pool.  Returns the first layout's results by uid."""
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.serving.engine import Engine
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    kw, uids = kw or arch_policy(arch), uids or arch_uids(arch)
    fixed = fixed_results = None
    for paged in layouts:
        engine = Engine(arch, params, KVPolicyConfig(**dict(kw, paged=paged)),
                        use_kernel=True, device=device)
        ops.launches = ops.shared_launches = 0
        results, wall, steps, sched = serve_requests(torch, engine, setup,
                                                     uids)
        got = (ops.launches, ops.shared_launches)
        want = attn_layers(arch) * steps if device == "cuda" else 0
        if got != ((0, want) if paged else (want, 0)):
            raise AssertionError(f"{what}: launches (fixed, shared) {got} for"
                                 f" {steps} decode steps, want {want}")
        tokens = {u: r.tokens for u, r in results.items()}
        note = ""
        if paged:
            for u in uids:
                if not (tokens[u] == fixed[u]).all():
                    raise AssertionError(f"{what} request {u}: the pool's "
                                         "tokens differ from the fixed "
                                         "arenas'")
            st = sched.pool_stats()
            if attn_layers(arch) == 0:
                if st is not None or sched.peak_bytes:
                    raise AssertionError(f"{what}: a pool or an arena for a "
                                         "model with no attention layer")
                note = ("; tokens equal to the fixed arenas'; no pool built, "
                        "no arena, no decode launch")
            elif st["allocated_blocks"] != 0 or st["exhausted"]:
                raise AssertionError(f"{what}: pool not empty at the end: {st}")
            else:
                note = (f"; tokens equal to the fixed arenas'; pool high "
                        f"water {st['high_water_blocks']} blocks, every page "
                        "back")
        fixed_results = fixed_results or results
        fixed = fixed or tokens
        generated = sum(int(r.lengths.sum()) for r in results.values())
        pols = {key: getattr(node, "policy", type(node).__name__)
                for key, node in sched.state.items()}
        log(f"{what}: requests {list(uids)} (prompts "
            f"{[len(setup['prompts'][u]) for u in uids]}, new "
            f"{[setup['news'][u] for u in uids]}) on "
            f"{'the paged pool' if paged else 'fixed arenas'}, policies "
            f"{pols}: all "
            f"ok; {generated} tokens in {wall:.2f} s, {steps} decode steps, "
            f"{1e3 * wall / steps:.2f} ms/step; decode launches {want} = "
            f"{attn_layers(arch)} x {steps}{note}")
    return fixed_results


def gemma2_window_check(arch, snap, prompt_len, kw):
    """5f (b)'s snapshot: gemma2's local layer holds at most its window ring
    (recycled), its global layer follows DMS (at least its delay window,
    fewer than the ring holds).  Returns what it found, for the log."""
    from repro_torch.core import policy as policy_lib
    live = {}
    for key, pc in snap.items():
        m = policy_lib.get_policy(pc.policy).metrics(pc.cache)["live_tokens"]
        live[key] = (pc.policy, float(m.min()), float(m.max()))
    ring = arch.attn.window + 1
    local, glob = live["0"], live["1"]
    if not (local[0] == "window" and local[2] <= ring < prompt_len
            and bool(snap["0"].cache.overflowed.all())):
        raise AssertionError(f"5f (b): the local layer holds {local} tokens, "
                             f"its ring {ring}")
    if not (glob[0] == "dms" and arch.dms.window <= glob[1]
            and glob[2] < local[1]):
        raise AssertionError(f"5f (b): the global layer holds {glob} tokens")
    return (f"live tokens (min, max over heads): local layer ({local[0]}) "
            f"{local[1]:.0f}-{local[2]:.0f}, its ring {ring} slots recycled; "
            f"global layer ({glob[0]}) {glob[1]:.0f}-{glob[2]:.0f}")


def hybrid_window_check(arch, snap, prompt_len, kw):
    """5g (b)'s snapshot: recurrentgemma's RG-LRU state has carried every
    prompt token (its length), its local layer holds at most its ring
    (``window``: the ring recycled) or follows DMS (``dms``: at least its
    delay window, fewer than the prompt).  Returns what it found."""
    from repro_torch.core import policy as policy_lib
    rec, pc = snap["0"], snap["1"]
    carried = rec.length.unique().tolist()
    if carried != [prompt_len]:
        raise AssertionError(f"5g (b): the RG-LRU state carried {carried} "
                             f"tokens of the {prompt_len}-token prompt")
    m = policy_lib.get_policy(pc.policy).metrics(pc.cache)["live_tokens"]
    lo, hi = float(m.min()), float(m.max())
    ring = arch.attn.window + 1
    if kw["kind"] == "window":
        ok = hi <= ring < prompt_len and bool(pc.cache.overflowed.all())
        held = f"at most its ring of {ring} slots, recycled"
    else:
        ok = arch.dms.window <= lo and hi < prompt_len
        held = f"DMS at CR {kw['cr']:g} (delay window {arch.dms.window})"
    if not ok:
        raise AssertionError(f"5g (b): the local layer holds {lo}-{hi} "
                             f"tokens under {kw['kind']}")
    return (f"the RG-LRU state has carried {prompt_len} tokens and the local "
            f"layer holds {lo:.0f}-{hi:.0f} live tokens (min, max over "
            f"heads): {held}")


def arch_window(torch, setup, kw, prompt_len, new, what, check, flag):
    """(b) A model at one superblock on one lane under the policy keywords
    ``kw``: a ``prompt_len``-token prompt and ``new`` tokens.  The lane is
    snapshot (``export_lane_state``) when its prefill ends and ``check``
    holds the snapshot to the layout (``gemma2_window_check``,
    ``hybrid_window_check``).  Then ``new`` teacher-forced steps of the
    served tokens from two imports of the snapshot, one on the kernel path
    and one on the reference path: logits within 0.05 x max |logit|.  The
    check's launches are not the main path's: ``flag["main"]`` is off
    while it runs."""
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    cfg = KVPolicyConfig(**kw)
    max_len = prompt_len + new
    engine = Engine(arch, params, cfg, use_kernel=True, device=device)
    rng = torch.Generator().manual_seed(13)
    prompt = torch.randint(3, arch.vocab_size, (prompt_len,), generator=rng,
                           dtype=torch.int32).numpy()
    sched = engine.scheduler(num_lanes=1, max_len=max_len)
    snap = {}
    start = sched._start_decode

    def snapshot_then_start(r):
        snap["state"] = tfm.export_lane_state(sched.state, r.lanes[0])
        start(r)
    sched._start_decode = snapshot_then_start
    sched.submit(Request(uid=0, prompt=prompt, max_new=new))
    ops.launches = ops.shared_launches = 0
    engine.chunk_fn.steps = 0
    t0 = time.perf_counter()
    res = sched.run()[0]
    del sched._start_decode          # the hook refers to the scheduler
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = engine.chunk_fn.steps
    want = attn_layers(arch) * steps if device == "cuda" else 0
    if res.status != "ok" or res.tokens.shape != (1, new) \
            or (ops.launches, ops.shared_launches) != (want, 0):
        raise AssertionError(f"{what}: status {res.status}, tokens "
                             f"{res.tokens.shape}, launches {ops.launches}")
    found = check(arch, snap["state"], prompt_len, kw)
    # the kernel path against the reference path from the snapshot
    states = [tfm.import_lane_state(
        tfm.init_decode_state(arch, 1, max_len, cfg, device=device),
        snap["state"], 0) for _ in range(2)]
    tokens = torch.from_numpy(res.tokens[0].astype("int64")).to(device)
    vocab = torch.arange(arch.padded_vocab, device=device) < arch.vocab_size
    gap = scale = 0.0
    flag["main"] = False
    try:
        for i in range(new):
            tok = tokens[i].reshape(1, 1)
            lk, _, aux = tfm.decode_step(params, tok, states[0], arch,
                                         prompt_len + i, use_kernel=True)
            lr, _, _ = tfm.decode_step(params, tok, states[1], arch,
                                       prompt_len + i, use_kernel=False)
            if aux["attn_impl_kernel"] != 1 or \
                    not bool(torch.isfinite(lk[:, vocab]).all()):
                raise AssertionError(f"{what}: step {i} left the kernel or "
                                     "is not finite")
            gap = max(gap, (lk - lr)[:, vocab].abs().max().item())
            scale = max(scale, lr[:, vocab].abs().max().item())
    finally:
        flag["main"] = True
    log(f"{what}: {arch.name} at {arch.num_layers} layers, one lane, "
        f"{kw['kind']}, prompt {prompt_len} + {new} new: ok in {wall:.2f} s, "
        f"{steps} decode steps ({1e3 * wall / steps:.2f} ms/step), {want} "
        f"decode launches; after the prompt {found}; {new} teacher-forced "
        f"steps from the snapshot, kernel vs reference path (launches not "
        f"counted on the main path): max abs logit diff {gap:.4e}, max "
        f"|logit| {scale:.4e} (tolerance 0.05 x max |logit|)")
    if not gap <= 0.05 * scale:
        raise AssertionError(f"{what}: kernel-path logits disagree with the "
                             "reference path")


def phase_archs(torch, device="cuda", checked=None, *,
                lens=(512, 384, 256, 128), news=ARCH_NEWS,
                window=(WINDOW_PROMPT, WINDOW_NEW), trace=ARCH_TRACE,
                export=(EXPORT_PROMPT, ARCH_EXPORT_DECODE)):
    """Phase 5f: each family of ``ARCH_LAYERS`` at full width (random bf16
    weights from seed 0, the DMS bias of phase 4) and the layers it lists:
    (a)/(c) ``arch_serve``, then a ``policy_paths`` trace of ``trace``
    steps; gemma2's (b) ``arch_window`` at one superblock; chatglm3's
    prefill export (``phase_prefill_export``, dms and vanilla, fixed and
    paged); a profiled decode step of each.  Every decode step must run the
    kernel in every layer (``attn_impl_kernel``), and every decode launch
    must be at a shape phase 3 checked (``checked``; on the CPU, the shapes
    ``arch_layouts`` predicts).  Returns the main path's decode launches by
    shape (the serving runs and the export) and the export's flash
    launches."""
    import collections
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.models import transformer as tfm
    layouts = dict(news=news, window=window, trace=trace, export=export)
    main = collections.Counter()
    seen, flag = set(), {"main": True}
    real_rows, real_step = ops.decode_rows, tfm.decode_step

    def counting(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw):
        key = launch_key(qf, kf, tblf, block_p, kw.get("shared_kv"))
        seen.add(key)
        if flag["main"]:
            main[key] += 1
        return real_rows(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw)

    def kernel_step(*args, **kw):
        out = real_step(*args, **kw)
        if kw.get("use_kernel") and out[2]["attn_impl_kernel"] != 1:
            raise AssertionError("phase 5f: a decode step left the kernel")
        return out

    out = {"flash": 0}
    expected = {}
    ops.decode_rows, tfm.decode_step = counting, kernel_step
    try:
        for name, layers in ARCH_LAYERS.items():
            t0 = time.perf_counter()
            setup = serving_setup(torch, device=device, arch_name=name,
                                  lens=lens, news=news, layers=layers)
            arch = setup["arch"]
            if device != "cuda":
                expected.update(arch_decode_keys([arch], lens, **layouts))
            what = "5f (a)" if "attn_local" in arch.layer_pattern else "5f (c)"
            flag["main"] = True
            arch_serve(torch, setup, f"{what} {name}")
            if arch.name == EXPORT_ARCH:
                exported = phase_prefill_export(torch, setup, t=export[0],
                                                steps=export[1],
                                                what=f"5f (c) {name}")
                out["flash"] += exported["flash"]
            if "attn_local" in arch.layer_pattern:
                arch_window(torch, cut_depth(setup, arch.pattern_period),
                            arch_policy(arch), *window, what="5f (b)",
                            check=gemma2_window_check, flag=flag)
            flag["main"] = False
            policy_paths(torch, setup, {f"{name} ({arch.num_layers} layers)":
                                        (arch, arch_policy(arch))},
                         steps=trace, what=what)
            uids = arch_uids(arch)
            phase_profile(torch, setup["params"], arch,
                          {f"{name} {what}": KVPolicyConfig(
                              **arch_policy(arch))},
                          lanes=len(uids), max_len=max(
                              lens[u] + news[u] for u in uids),
                          device=device)
            del setup
            if device == "cuda":
                torch.cuda.empty_cache()
            log(f"seconds: 5f {name} {time.perf_counter() - t0:.1f}")
    finally:
        ops.decode_rows, tfm.decode_step = real_rows, real_step
    checked = checked if checked is not None else expected
    if not seen <= set(checked):
        raise AssertionError(f"phase 5f launched the decode kernel at "
                             f"{sorted(seen - set(checked))}, not among phase"
                             f" 3's checked {sorted(checked)}")
    log(f"phase 5f's decode launch shapes {sorted(seen)}: each checked in "
        "phase 3")
    out["launches"] = main
    return out


def layout_rows(torch, gen, arch, layouts, launches, errs, tag=""):
    """``decode_entry`` rows for the decode kernel at every launch shape of
    ``layouts`` ((policy keywords, lanes, max_len) of ``arch``): fixed-
    arena and shared-pool, on random operands at slot density 0.85, each
    with its launches and its phase-3 error; ``tag`` ends each name."""
    cap, hkv = arch.attn.logit_softcap, arch.attn.num_kv_heads
    rows = []
    for pol, lanes, max_len in layouts:
        for pi, key in enumerate(state_keys(arch, pol, lanes, max_len)):
            kind = (pol.get("layer_map") or {}).get(
                arch.layer_pattern[pi], pol["kind"])
            shared = len(key) == 7
            bh, g, dh = key[:3]
            bp = key[4]
            if shared:
                nb = key[5]
                case = make_pool_case(torch, gen, bh=bh, g=g, dh=dh, nb=nb,
                                      bp=bp, density=0.85, pages=key[3] // bp)
                operands = {"kernel": case["shared"],
                            "dense": case["fixed"][1:4]}
                shape = (bh, g, dh, nb * bp, bp)
            else:
                args = make_case(torch, gen, bh=bh, g=g, dh=dh, p=key[3],
                                 bp=bp, density=0.85)
                operands = {"kernel": args, "dense": args[1:4]}
                shape = key
            rows.append(decode_entry(
                torch, f"dms_decode{'_shared_kv' if shared else ''} "
                f"({arch.name} {kind}, G {g}, Dh {dh}"
                f"{f', cap {cap:g}' if cap else ''}{tag})",
                "shared" if shared else "fixed", operands, shape,
                launches.get(key, 0), errs.get(key, 0.0), hkv=hkv, cap=cap))
    return rows


def phase_arch_timing(torch, launches, errs, flash_launches, flash_err):
    """Phase 7's rows for 5f's serving shapes: the decode kernel at each
    family's fixed-arena and shared-pool serving shapes (``arch_layouts``'
    first two), each with its launches in 5f and the softcap the family
    runs, then ``flash_fwd`` at chatglm3's prefill export shape."""
    from repro_torch.configs import get_arch
    gen = torch.Generator(device="cuda").manual_seed(97)
    rows = []
    for name in (*ARCH_LAYERS, *ARCH_CHECKED):
        arch = get_arch(name)
        rows += layout_rows(torch, gen, arch, arch_layouts(
            arch, (512, 384, 256, 128))[:2], launches, errs)
    rows.append(phase_prefill_timing(
        torch, flash_launches, flash_err, case=next(iter(ARCH_FLASH)),
        name="flash_fwd (chatglm3-6b prefill export)"))
    return rows


# -- phase 5g: the hybrids recurrentgemma-2b and mamba2-2.7b -----------------

# the hybrids 5g serves and the layers it serves of each (the script's time;
# both fit one card whole): one superblock of recurrentgemma's (rglru,
# attn_local), two of mamba2's 64 SSD layers
HYBRID_LAYERS = {"recurrentgemma-2b": 2, "mamba2-2.7b": 2}
# (b): a prompt past recurrentgemma's 2048-token local window, then new tokens
HYBRID_WINDOW = (2048 + 64, 16)
# (d): three requests sharing a PREFIX_LEN-token prefix, PREFIX_NEW new each
HYBRID_SUFFIXES = (8, 24, 40)


def hybrid_window_policy(arch):
    """recurrentgemma's ``window`` layout: a ring of its local window."""
    return dict(kind="window", budget=arch.attn.window)


def hybrid_layouts(arch, lens, news=ARCH_NEWS, window=HYBRID_WINDOW,
                   trace=ARCH_TRACE):
    """Every (policy keywords, lanes, max_len) 5g builds a decode state for
    with recurrentgemma: (a) dms on 4 lanes fixed and paged (the profile's
    too) and ``window`` on requests 3 and 1, the kernel-vs-reference trace,
    (b)'s one lane under dms and ``window`` and (d)'s two prefix lanes."""
    kw, win = arch_policy(arch), hybrid_window_policy(arch)
    max_len = max(lens[u] + news[u] for u in range(4))
    pair = max(lens[u] + news[u] for u in ARCH_PAIR)
    return [(kw, 4, max_len), (dict(kw, paged=True), 4, max_len),
            (win, len(ARCH_PAIR), pair), (kw, 2, trace + 16),
            (kw, 1, sum(window)), (win, 1, sum(window)),
            (kw, 2, PREFIX_MAX_LEN)]


def hybrid_decode_keys(arch=None, lens=(512, 384, 256, 128), **kw):
    """{launch key: logit softcap} of every decode launch 5g makes (mamba2
    makes none), from ``hybrid_layouts`` of recurrentgemma at full width
    (or of ``arch``)."""
    from repro_torch.configs import get_arch
    arch = arch or get_arch("recurrentgemma-2b")
    return {key: arch.attn.logit_softcap
            for pol, lanes, max_len in hybrid_layouts(arch, lens, **kw)
            for key in state_keys(arch, pol, lanes, max_len)}


def hybrid_prefix(torch, setup, *, prefix_len=PREFIX_LEN,
                  suffixes=HYBRID_SUFFIXES, new=PREFIX_NEW, what="5g (d)"):
    """(d) Requests sharing a ``prefix_len``-token prefix, one every
    PREFIX_GAP ticks, served cold and warm through one prefix cache (5e's
    slab, host tier, chunk and stride) with dms at CR 8 on recurrentgemma:
    the snapshots carry the RG-LRU state, so warm tokens and first-token
    logits equal the cold ones exactly; paid + saved prefill reads equal
    the cold reads, and the warm trace reads from the slab with no host
    sync in a chunk, an import, an export or the slab."""
    import numpy as np
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.serving.engine import Engine
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    rng = np.random.default_rng(21)

    def prompt(n):
        return rng.integers(3, arch.vocab_size, size=(n,)).astype(np.int32)

    system = prompt(prefix_len)
    trace = [(np.concatenate([system, prompt(n)]), new, i * PREFIX_GAP)
             for i, n in enumerate(suffixes)]
    cfg = KVPolicyConfig(**arch_policy(arch))
    kw = dict(use_kernel=True, device=device, chunk=PREFIX_CHUNK)
    cold, _, cold_wall, cold_first = serve_prefix_trace(
        torch, Engine(arch, params, cfg, **kw), trace)
    eng = Engine(arch, params, cfg, prefix_cache_mb=PREFIX_MB,
                 prefix_cache_device_mb=PREFIX_DEVICE_MB,
                 export_stride=PREFIX_STRIDE, **kw)
    warm, sched, wall, first = serve_prefix_trace(torch, eng, trace,
                                                  sync_check=True)
    paid = saved = cold_paid = 0.0
    for uid, r in warm.items():
        c = cold[uid]
        if r.status != "ok" or not (r.tokens == c.tokens).all() \
                or not (first[uid] == cold_first[uid]).all():
            raise AssertionError(f"{what} request {uid}: status {r.status}, "
                                 "or tokens or first-token logits differ "
                                 "from the cold serve's")
        got = r.prefill_meter.kv_reads + r.prefill_meter.kv_reads_saved
        if got != c.prefill_meter.kv_reads:
            raise AssertionError(f"{what} request {uid}: paid + saved {got} "
                                 f"!= cold {c.prefill_meter.kv_reads}")
        paid += r.prefill_meter.kv_reads
        saved += r.prefill_meter.kv_reads_saved
        cold_paid += c.prefill_meter.kv_reads
    pc = eng.prefix_cache
    if saved <= 0 or pc.hot_hits <= 0:
        raise AssertionError(f"{what}: no read saved or no hot hit")
    log(f"{what}: {arch.name} at {arch.num_layers} layers, {len(trace)} "
        f"requests sharing a {prefix_len}-token prefix (suffixes "
        f"{list(suffixes)}, {new} new each), dms at CR 8: warm tokens and "
        f"first-token logits equal to the cold serve's exactly; prefill "
        f"reads paid {paid:.0f} + saved {saved:.0f} = cold {cold_paid:.0f}; "
        f"{pc.hot_hits} hot hits; the snapshot carries the RG-LRU state "
        f"({snapshot_parts(sched)}); {eng.chunk_fn.steps} decode steps "
        f"in {wall:.2f} s (cold {cold_wall:.2f} s); no host sync in a chunk,"
        " an import, an export or the slab (the host-sync tripwire and the "
        "sync debug mode; the warm wall includes the tripwire's hooks)")


def snapshot_parts(sched):
    """A lane snapshot's bytes by pattern position, for a log line."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import transformer as tfm
    snap = tfm.export_lane_state(sched.state, 0)
    return ", ".join(
        f"position {key} ({getattr(node, 'policy', type(node).__name__)}) "
        f"{sum(a.numel() * a.element_size() for a in tree_leaves(node))} B"
        for key, node in snap.items())


def ops_by_kind(torch, params, arch, cfg, *, lanes, max_len, device):
    """Host-dispatched ATen ops of one decode step by where they run: the
    recurrent layers (norm, RG-LRU or SSD, MLP), the attention calls
    (``decode_attention``: projections, RoPE, the cache step, the kernel's
    wrapper) and the rest (embedding, the attention layers' norms and
    MLPs, the policies' step preparation, the head); logged a layer."""
    import collections
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import transformer as tfm
    counts, where = collections.Counter(), ["rest"]

    def tagged(fn, tag):
        def run(*args, **kw):
            where[0] = tag
            try:
                return fn(*args, **kw)
            finally:
                where[0] = "rest"
        return run

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[where[0]] += 1
            return func(*args, **(kwargs or {}))

    state = tfm.init_decode_state(arch, lanes, max_len, cfg, device=device)
    tok = torch.full((lanes, 1), 7, dtype=torch.int32, device=device)
    pos = torch.zeros((lanes,), dtype=torch.int32, device=device)
    real = (tfm._recurrent_layer, attn_lib.decode_attention)
    tfm._recurrent_layer = tagged(real[0], "recurrent")
    attn_lib.decode_attention = tagged(real[1], "attention")
    try:
        tfm.decode_step(params, tok, state, arch, pos, use_kernel=True)
        with Count():
            tfm.decode_step(params, tok, state, arch, pos, use_kernel=True)
    finally:
        tfm._recurrent_layer, attn_lib.decode_attention = real
    n_attn = attn_layers(arch)
    n_rec = arch.num_layers - n_attn
    per = [f"{counts['recurrent'] / n_rec:.1f} a recurrent layer "
           f"({'/'.join(sorted(set(arch.layer_pattern) - {'attn', 'attn_local'}))})"]
    if n_attn:
        per.append(f"{counts['attention'] / n_attn:.1f} a decode_attention "
                   "call")
    log(f"profile: {arch.name}, {lanes} lanes, ATen ops of one decode step "
        f"by kind: {'; '.join(per)}; {counts['rest']} elsewhere (embedding, "
        f"the attention layers' norms and MLPs, step preparation, head); "
        f"{sum(counts.values())} in all")
    return counts


def phase_hybrids(torch, device="cuda", checked=None, *,
                  lens=(512, 384, 256, 128), news=ARCH_NEWS,
                  window=HYBRID_WINDOW, trace=ARCH_TRACE,
                  prefix=(PREFIX_LEN, HYBRID_SUFFIXES, PREFIX_NEW)):
    """Phase 5g: recurrentgemma-2b and mamba2-2.7b at full width (random
    bf16 weights from seed 0, phase 4's DMS bias), at the layers of
    ``HYBRID_LAYERS``.  recurrentgemma: (a) ``arch_serve`` of phase 4's four
    prompts under dms at CR 8, fixed then paged, and requests 3 and 1
    under ``window``; (b) ``arch_window`` at one superblock under dms and
    ``window``; (d) ``hybrid_prefix`` at one superblock; a
    ``policy_paths`` trace of ``trace`` steps; a profiled decode step.
    mamba2: (c) ``arch_serve`` of requests 3 and 1 under vanilla, fixed
    and paged (no pool, no launch); a profiled step.  Every decode step
    runs the kernel in every attention layer (``attn_impl_kernel`` 1;
    mamba2's 0, with no launch at all), and every decode launch must be at
    a shape phase 3 checked (``checked``; on the CPU, the shapes
    ``hybrid_layouts`` predicts).  Returns the main path's decode launches
    by shape ((a), (b), (c) and (d))."""
    import collections
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.models import transformer as tfm
    main = collections.Counter()
    seen, flag = set(), {"main": True}
    real_rows, real_step = ops.decode_rows, tfm.decode_step

    def counting(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw):
        key = launch_key(qf, kf, tblf, block_p, kw.get("shared_kv"))
        seen.add(key)
        if flag["main"]:
            main[key] += 1
        return real_rows(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw)

    def kernel_step(params, token, state, arch, *args, **kw):
        out = real_step(params, token, state, arch, *args, **kw)
        want = int(attn_layers(arch) > 0)
        if kw.get("use_kernel") and out[2]["attn_impl_kernel"] != want:
            raise AssertionError(f"phase 5g: a {arch.name} decode step "
                                 f"reported attn_impl_kernel "
                                 f"{out[2]['attn_impl_kernel']}, want {want}")
        return out

    expected = {}
    ops.decode_rows, tfm.decode_step = counting, kernel_step
    try:
        for name, layers in HYBRID_LAYERS.items():
            t0 = time.perf_counter()
            setup = serving_setup(torch, device=device, arch_name=name,
                                  lens=lens, news=news, layers=layers)
            arch = setup["arch"]
            full = (get_arch if device == "cuda" else get_smoke)(name)
            params = setup["params"]
            nsb = arch.num_superblocks
            embed = params["embed"].numel() * params["embed"].element_size()
            layer_bytes = sum(a.numel() * a.element_size()
                              for a in tree_leaves(params["blocks"])) // nsb
            whole = embed + layer_bytes * full.num_superblocks
            cuts = (f"{arch.num_layers} in (a), {arch.pattern_period} in (b) "
                    "and (d)" if arch.attn is not None else
                    f"{arch.num_layers} in (c)")
            log(f"5g depth cut: {name} serves {cuts} of its "
                f"{full.num_layers} layers (the script's time; its bf16 "
                f"weights take {whole / 1e9:.2f} GB whole, {embed / 1e9:.2f} "
                f"GB of them the tied embedding: one card holds it whole)")
            flag["main"] = True
            ops.launches = ops.shared_launches = 0
            if arch.attn is None:
                before = sum(main.values())
                arch_serve(torch, setup, f"5g (c) {name}")
                if sum(main.values()) != before:
                    raise AssertionError(f"5g (c): {name} called the decode "
                                         "kernel's wrapper")
            else:
                if device != "cuda":
                    expected.update(hybrid_decode_keys(
                        arch, lens, news=news, window=window, trace=trace))
                arch_serve(torch, setup, f"5g (a) {name}")
                arch_serve(torch, setup, f"5g (a) {name}",
                           kw=hybrid_window_policy(arch), uids=ARCH_PAIR,
                           layouts=(False,))
                one = cut_depth(setup, arch.pattern_period)
                for kw in (arch_policy(arch), hybrid_window_policy(arch)):
                    arch_window(torch, one, kw, *window,
                                what=f"5g (b) {kw['kind']}",
                                check=hybrid_window_check, flag=flag)
                hybrid_prefix(torch, one, prefix_len=prefix[0],
                              suffixes=prefix[1], new=prefix[2])
                flag["main"] = False
                policy_paths(torch, setup, {
                    f"{name} ({arch.num_layers} layers)":
                        (arch, arch_policy(arch))}, steps=trace,
                    what="5g (a)")
            flag["main"] = False
            uids = arch_uids(arch)
            shape = dict(lanes=len(uids), max_len=max(lens[u] + news[u]
                                                      for u in uids),
                         device=device)
            cfg = KVPolicyConfig(**arch_policy(arch))
            phase_profile(torch, setup["params"], arch, {f"{name} 5g": cfg},
                          **shape)
            ops_by_kind(torch, setup["params"], arch, cfg, **shape)
            del setup, params
            if device == "cuda":
                torch.cuda.empty_cache()
            log(f"seconds: 5g {name} {time.perf_counter() - t0:.1f}")
    finally:
        ops.decode_rows, tfm.decode_step = real_rows, real_step
    checked = checked if checked is not None else expected
    if not seen <= set(checked):
        raise AssertionError(f"phase 5g launched the decode kernel at "
                             f"{sorted(seen - set(checked))}, not among phase"
                             f" 3's checked {sorted(checked)}")
    log(f"phase 5g's decode launch shapes {sorted(seen)}: each checked in "
        "phase 3")
    return main


def phase_hybrid_timing(torch, launches, errs):
    """Phase 7's rows for 5g: the decode kernel at recurrentgemma's (a)
    fixed-arena and shared-pool serving shapes and at (b)'s window ring
    (P 2064, one lane), each with its launches in 5g."""
    from repro_torch.configs import get_arch
    gen = torch.Generator(device="cuda").manual_seed(98)
    arch = get_arch("recurrentgemma-2b")
    layouts = hybrid_layouts(arch, (512, 384, 256, 128))
    rows = []
    for pol, lanes, max_len in (layouts[0], layouts[1], layouts[5]):
        (key,) = state_keys(arch, pol, lanes, max_len)
        shared = len(key) == 7
        bh, g, dh, p, bp = key[:5]
        if shared:
            nb = key[5]
            case = make_pool_case(torch, gen, bh=bh, g=g, dh=dh, nb=nb, bp=bp,
                                  density=0.85, pages=p // bp)
            operands = {"kernel": case["shared"], "dense": case["fixed"][1:4]}
            shape = (bh, g, dh, nb * bp, bp)
        else:
            args = make_case(torch, gen, bh=bh, g=g, dh=dh, p=p, bp=bp,
                             density=0.85)
            operands = {"kernel": args, "dense": args[1:4]}
            shape = key
        rows.append(decode_entry(
            torch, f"dms_decode{'_shared_kv' if shared else ''} "
            f"(recurrentgemma-2b {pol['kind']}, {lanes} lane"
            f"{'s' if lanes > 1 else ''}, G {g}, Dh {dh})",
            "shared" if shared else "fixed", operands, shape,
            launches.get(key, 0), errs.get(key, 0.0),
            hkv=arch.attn.num_kv_heads))
    return rows


# -- phase 5h: the encoder–decoder seamless-m4t-large-v2 ----------------------

ENCDEC = "seamless-m4t-large-v2"
# (a) lanes, encoder frames a lane, teacher-forced prompt tokens and greedy
# new tokens a lane (dms evicts past its 256-token delay)
ENCDEC_LANES, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW = 4, 1024, 320, 32
# (b) and (c): the decoder layers served (the encoder stays whole; the
# script's time)
ENCDEC_SHALLOW = 2
# (c): teacher-forced kernel-vs-reference steps; lane 1's hidden tail frames
ENCDEC_TRACE, ENCDEC_TAIL = 48, 200
# (d): one train step: encoder and decoder layers each, batch, decoder
# tokens and frames
ENCDEC_TRAIN = dict(layers=2, batch=2, tokens=1024, frames=1024)


def encdec_policy(arch):
    """5h's decoder self-attention layout: dms at CR 8."""
    from repro_torch.core.config import KVPolicyConfig
    return KVPolicyConfig(kind="dms", cr=8.0)


def cross_key(arch, lanes, frames):
    """The ``launch_key`` of one decoder layer's cross-attention over
    ``frames`` encoder frames a lane: the dense mode derives a table over
    blocks of ``min(DEFAULT_BLOCK_P, round_up(frames, 8))`` slots."""
    from repro_torch.kernels.dms_decode import ops
    a = arch.attn
    bp = min(ops.DEFAULT_BLOCK_P, -(-frames // 8) * 8)
    return (lanes * a.num_kv_heads, a.q_per_kv, a.head_dim,
            -(-frames // bp) * bp, bp)


def encdec_decode_keys(arch=None, lanes=ENCDEC_LANES, frames=ENCDEC_FRAMES,
                       max_len=ENCDEC_PROMPT + ENCDEC_NEW):
    """Every decode launch shape 5h makes: the self-attention's fixed-arena
    and shared-pool keys of its layout (the trace's and the profile's too)
    and the cross-attention's dense-mode key."""
    from repro_torch.configs import get_arch
    arch = arch or get_arch(ENCDEC)
    kw = dataclasses.asdict(encdec_policy(arch))
    return {*state_keys(arch, kw, lanes, max_len),
            *state_keys(arch, dict(kw, paged=True), lanes, max_len),
            cross_key(arch, lanes, frames)}


def flash_key(q, cfg):
    """A flash launch's shape: (causal, B, T, Hq, Hkv, Dh, dtype, DMS
    delay)."""
    return (cfg.causal, q.shape[0] // cfg.hq, cfg.t, cfg.hq, cfg.hkv,
            cfg.orig_dh, str(q.dtype).removeprefix("torch."), cfg.dms_delay)


def encdec_flash_cases(arch=None, lanes=ENCDEC_LANES, frames=ENCDEC_FRAMES,
                       train=ENCDEC_TRAIN):
    """{name: ``flash_case`` keywords} of every flash launch shape 5h makes
    — (a)'s encoder (non-causal, no α, bf16), (d)'s encoder and decoder (the
    LM train step runs vanilla) — and (a)'s encoder 24 frames short (off
    the 64-row tile) and in fp32."""
    from repro_torch.configs import get_arch
    a = (arch or get_arch(ENCDEC)).attn
    head = dict(hq=a.num_heads, hkv=a.num_kv_heads, dh=a.head_dim, alpha=None)
    cases = {f"encoder (a), T {t}, {dtype}": dict(
        head, b=lanes, t=t, dtype=dtype, causal=False)
        for t in (frames, frames - 24) for dtype in ("bfloat16", "float32")}
    cases["encoder (d)"] = dict(head, b=train["batch"], t=train["frames"],
                                dtype="bfloat16", causal=False)
    cases["decoder (d)"] = dict(head, b=train["batch"], t=train["tokens"],
                                dtype="bfloat16", causal=True)
    return cases


def encdec_flash_keys(torch, cases, device="cuda"):
    """The ``flash_key`` of each of ``cases``."""
    keys = set()
    for kw in cases.values():
        kw = dict(kw)
        dtype = getattr(torch, kw.pop("dtype"))
        qf, *_, cfg, _ = flash_case(torch, dtype=dtype, device=device, **kw)
        keys.add(flash_key(qf, cfg))
    return keys


def check_encdec_flash(torch, cases, device="cuda"):
    """Phase 3's flash checks at 5h's shapes: for each of ``cases``
    (``encdec_flash_cases``) fwd, dq and dkv against their plain versions
    within FLASH_REL_TOL, each bit-equal on a second launch, d(log_surv)
    zero; then the autograd Function at the first non-causal fp32 case
    against autograd through the dense oracle (``causal=False``) within
    GRAD_REL_TOL.  Returns each kernel's max abs error at the first case."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention import ref as fref
    before = dict(fops.launches)
    errs = {}
    for name, kw in cases.items():
        kw = dict(kw)
        dtype = getattr(torch, kw.pop("dtype"))
        qf, kf, vf, ls, hr, cfg, do = flash_case(torch, dtype=dtype, seed=7,
                                                 device=device, **kw)
        t = cfg.t
        out_p, lse_p = fref.flash_fwd_plain(qf, kf, vf, ls, hr, cfg)
        delta = (do.float() * out_p.float()).sum(-1)
        runs = []
        for _ in range(2):
            out, lse = fops.flash_fwd(qf, kf, vf, ls, hr, cfg)
            dq = fops.flash_dq(qf, kf, vf, ls, do, lse_p, delta, hr, cfg)
            runs.append((out, lse, dq) + tuple(fops.flash_dkv(
                qf, kf, vf, ls, do, lse_p, delta, hr, cfg)))
        if device == "cuda":
            torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(*runs)):
            raise AssertionError(f"flash [{name}]: a second launch of fwd, "
                                 "dq or dkv gave other bits")
        out, lse, dq, dk, dv, dls = runs[0]
        dq_p = fref.flash_dq_plain(qf, kf, vf, ls, do, lse_p, delta, hr, cfg)
        dk_p, dv_p, dls_p = fref.flash_dkv_plain(qf, kf, vf, ls, do, lse_p,
                                                 delta, hr, cfg)
        tol = FLASH_REL_TOL[str(dtype).removeprefix("torch.")]
        parts, case = [], {}
        for key, got, want in (("out", out[:, :t], out_p[:, :t]),
                               ("lse", lse[:, :t], lse_p[:, :t]),
                               ("dq", dq, dq_p), ("dk", dk, dk_p),
                               ("dv", dv, dv_p)):
            got, want = got.float(), want.float()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash [{name}]: non-finite {key}")
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if err > tol * max(scale, 1.0 if key == "lse" else 0.0) + 1e-30:
                raise AssertionError(f"flash [{name}] {key}: max abs err "
                                     f"{err:.3e} > {tol} x {scale:.3e}")
            case[key] = err
            parts.append(f"{key} {err:.2e}/{scale:.2e}")
        if dls.abs().max().item() != 0.0 or dls_p.abs().max().item() != 0.0:
            raise AssertionError(f"flash [{name}]: d(log_surv) is not zero "
                                 "with no DMS mask")
        errs = errs or {"flash_fwd": max(case["out"], case["lse"]),
                        "flash_dq": case["dq"],
                        "flash_dkv": max(case["dk"], case["dv"])}
        log(f"flash vs plain [phase 5h's {name}: causal {cfg.causal}, "
            f"B={kw['b']} T={t} Hq={cfg.hq} Hkv={cfg.hkv} Dh={cfg.orig_dh}, "
            f"no alpha, Tp={qf.shape[1]}]: max abs err / max |plain|: "
            + ", ".join(parts) + f" (tolerance {tol} relative: {dtype}); "
            "d(log_surv) zero on both; fwd, dq and dkv bit-equal on a second "
            "launch")
    moved = {k: fops.launches[k] - before[k] for k in before}
    want = {k: 2 * len(cases) if device == "cuda" else 0 for k in before}
    if moved != want:
        raise AssertionError(f"flash launch counters moved {moved}, want "
                             f"{want}")
    # the autograd Function, non-causal, against the dense oracle
    kw = next(kw for kw in cases.values()
              if not kw["causal"] and kw["dtype"] == "float32")
    b, t, hq, hkv, dh = (kw[k] for k in ("b", "t", "hq", "hkv", "dh"))
    gen = torch.Generator(device=device).manual_seed(6)
    leaves = [torch.randn(shape, generator=gen, device=device)
              for shape in ((b, t, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh))]
    tgt = torch.randn((b, t, hq, dh), generator=gen, device=device)
    grads = []
    for attend in (fops.dms_flash_attention, fref.dms_attention_plain):
        xs = [x.clone().requires_grad_() for x in leaves]
        (attend(*xs, None, causal=False) * tgt).sum().backward()
        grads.append([x.grad for x in xs])
    parts = []
    for key, got, want in zip("qkv", *grads):
        rel = ((got - want).abs().max()
               / want.abs().max().clamp_min(1e-30)).item()
        if not rel < GRAD_REL_TOL:
            raise AssertionError(f"non-causal flash grad d{key}: relative "
                                 f"error {rel:.3e}")
        parts.append(f"d{key} {rel:.2e}")
    log(f"flash autograd vs dense oracle (fp32, causal False, no alpha, "
        f"B={b} T={t} Hq={hq} Hkv={hkv} Dh={dh}): max |diff| / max |oracle|:"
        f" {', '.join(parts)} (tolerance {GRAD_REL_TOL})")
    return errs


def check_cross_dense(torch, arch=None, lanes=ENCDEC_LANES,
                      frames=ENCDEC_FRAMES, tail=ENCDEC_TAIL, device="cuda"):
    """Phase 3's check of the cross-attention's dense mode at 5h's shape,
    through the wrapper as the decode step calls it (K/V transposed views,
    the valid mask expanded over the heads): every frame visible, then lane
    1's last ``tail`` frames hidden (its last block dropped from the
    derived table, the one before it masked within); against the same
    wrapper on the CPU (the plain version) within KERNEL_TOL, bit-equal on
    a second launch.  Returns the max abs error."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.dms_decode import ops
    arch = arch or get_arch(ENCDEC)
    a = arch.attn
    gen = torch.Generator(device=device).manual_seed(31)
    hkv, dh = a.num_kv_heads, a.head_dim
    q = torch.randn((lanes, 1, a.num_heads, dh), generator=gen,
                    device=device).to(torch.bfloat16)
    ek, ev = (torch.randn((lanes, frames, hkv, dh), generator=gen,
                          device=device).to(torch.bfloat16) for _ in range(2))
    worst = 0.0
    before = ops.launches
    for hidden in (0, tail):
        valid = torch.ones((lanes, frames), dtype=torch.bool, device=device)
        valid[1, frames - hidden:] = False
        args = (q, ek.transpose(1, 2), ev.transpose(1, 2),
                valid[:, None, :].expand(lanes, hkv, frames))
        out = ops.dms_decode_attention(*args)
        again = ops.dms_decode_attention(*args)
        want = ops.dms_decode_attention(*(x.cpu() for x in args))
        if not torch.equal(out, again):
            raise AssertionError("cross dense mode: a second launch gave "
                                 "other bits")
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError("cross dense mode: non-finite output")
        torch.testing.assert_close(out.cpu().float(), want.float(),
                                   **KERNEL_TOL)
        err = (out.cpu().float() - want.float()).abs().max().item()
        worst = max(worst, err)
        log(f"kernel vs plain [phase 5h's cross-attention, dense mode "
            f"{cross_key(arch, lanes, frames)} (B·Hkv, G, Dh, P, block_p), "
            f"{frames} frames a lane, lane 1's last {hidden} hidden]: "
            f"max_abs_err {err:.3e} (tolerance atol {KERNEL_TOL['atol']}, "
            f"rtol {KERNEL_TOL['rtol']}); bit-equal on a second launch")
    if ops.launches - before != (4 if device == "cuda" else 0):
        raise AssertionError(f"cross dense check launched "
                             f"{ops.launches - before}")
    return worst


def encdec_setup(torch, device="cuda", layers=None, dtype=None):
    """seamless at full width (the smoke config on the CPU), random weights
    from seed 0 (matmul weights in ``dtype``, default bf16) and phase 4's
    DMS bias, at ``layers`` encoder and decoder layers each if given."""
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.models import transformer as tfm
    arch = (get_arch if device == "cuda" else get_smoke)(ENCDEC)
    arch = dataclasses.replace(
        arch, num_layers=layers or arch.num_layers,
        encoder_layers=layers or arch.encoder_layers,
        dms=dataclasses.replace(
            arch.dms, logit_bias=statistics.NormalDist().inv_cdf(7 / 8)))
    t0 = time.perf_counter()
    params = tfm.init_model(arch, seed=0, device=device, dtype=dtype)
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"5h: {arch.name} encoder L={arch.encoder_layers}, decoder "
        f"L={arch.num_layers}, d={arch.d_model} {widths(arch)} "
        f"V={arch.padded_vocab}, {params['embed'].dtype} weights; init "
        f"{time.perf_counter() - t0:.1f} s")
    return arch, params


def encdec_frames(torch, arch, lanes, frames, device, seed=0):
    """Frame embeddings (lanes, frames, D) ~ N(0, 1) · 0.02, seeded."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((lanes, frames, arch.d_model), generator=gen,
                       device=device) * 0.02


def encdec_serve(torch, arch, params, enc_out, prompts, new, *, paged=False,
                 what="5h (a)"):
    """The prompts (lanes, P) teacher-forced, then ``new`` greedy tokens a
    lane, through ``make_serve_step`` with ``enc_out`` (dms at CR 8, fixed
    arenas or the paged pool): P + ``new`` steps, the last one feeding the
    last new token, every step's input on the device (no host read until
    the end).  Returns (the new tokens (lanes, new) on the host, wall s,
    steps, the last step's meters)."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm
    device = enc_out.device
    lanes, plen = prompts.shape
    cfg = dataclasses.replace(encdec_policy(arch), paged=paged)
    state = tfm.init_decode_state(arch, lanes, plen + new, cfg, device=device)
    step = steps_lib.make_serve_step(arch, use_kernel=True)
    live = torch.arange(arch.padded_vocab, device=device) < arch.vocab_size
    pos = torch.zeros((lanes,), dtype=torch.int32, device=device)
    tok, out = prompts[:, :1], []
    t0 = time.perf_counter()
    for i in range(plen + new):
        logits, state, meters = step(params, state, {
            "token": tok, "pos": pos, "enc_out": enc_out})
        nxt = torch.where(live, logits, -1e30).argmax(-1, keepdim=True)
        if i + 1 >= plen:
            out.append(nxt.to(torch.int32))
        tok = prompts[:, i + 1:i + 2] if i + 1 < plen else out[-1]
        pos = pos + 1
    tokens = torch.cat(out[:new], dim=1).cpu().numpy()
    wall = time.perf_counter() - t0
    if ((tokens < 0) | (tokens >= arch.vocab_size)).any():
        raise AssertionError(f"{what}: tokens outside the vocab")
    return tokens, wall, plen + new, meters


def encdec_trace(torch, arch, params, enc_out, tokens, tail, max_len):
    """(c) Teacher-forced steps of ``tokens`` (lanes, steps), kernel path
    against reference path from the same cache each step (a copy), with
    ``enc_out`` and lane 1's last ``tail`` frames hidden.  Returns (max abs
    logit diff, max |logit|) over the live vocab."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import transformer as tfm
    device = enc_out.device
    lanes, steps = tokens.shape
    frames = enc_out.shape[1]
    valid = torch.ones((lanes, frames), dtype=torch.bool, device=device)
    valid[1, frames - tail:] = False
    state = tfm.init_decode_state(arch, lanes, max_len, encdec_policy(arch),
                                  device=device)
    live = torch.arange(arch.padded_vocab, device=device) < arch.vocab_size
    kw = dict(enc_out=enc_out, enc_valid=valid)
    gap = scale = 0.0
    for t in range(steps):
        tok = tokens[:, t:t + 1]
        ref_state = tree_map(torch.clone, state)
        lk, _, aux = tfm.decode_step(params, tok, state, arch, t,
                                     use_kernel=True, **kw)
        lr, _, _ = tfm.decode_step(params, tok, ref_state, arch, t,
                                   use_kernel=False, **kw)
        if aux["attn_impl_kernel"] != 1 or \
                not bool(torch.isfinite(lk[:, live]).all()):
            raise AssertionError(f"5h (c): step {t} left the kernel or is "
                                 "not finite")
        gap = max(gap, (lk - lr)[:, live].abs().max().item())
        scale = max(scale, lr[:, live].abs().max().item())
    return gap, scale


def encoder_layer_gaps(torch, params, arch, x_enc):
    """Each encoder layer's self-attention (``causal=False``) from the same
    normed input on the kernel path and the reference path, the layers fed
    by the kernel path's stream: max |kernel - reference| / max
    |reference| a layer."""
    from repro_torch.core.tree import tree_map
    from repro_torch.device import torch_dtype
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import norm_apply
    dtype = torch_dtype(arch.dtype)
    acfg = dataclasses.replace(arch.attn, causal=False)
    gaps = []
    with torch.no_grad():
        x = x_enc.to(dtype)
        for sb in range(arch.encoder_layers // arch.pattern_period):
            p = tree_map(lambda a: a[sb], params["enc_blocks"]["0"])
            h = norm_apply(p["attn_norm"], x, arch.norm, arch.norm_eps)
            got, want = (attn_lib.full_attention(
                p["attn"], h, acfg, arch, use_kernel=kernel)[0].float()
                for kernel in (True, False))
            gaps.append(((got - want).abs().max()
                         / want.abs().max()).item())
            x, _ = tfm._apply_block(p, x, arch, "attn", dtype=dtype,
                                    causal=False, mode="vanilla",
                                    use_kernel=True)
    return gaps


def encdec_train(torch, device, train, flag):
    """(d) One ``make_train_step`` at ``train["layers"]`` encoder and
    decoder layers, full width, fp32 weights and bf16 compute, on a seeded
    batch with frames: the kernel path (its flash launches counted: the
    encoder's non-causal forward and backward, the decoder's causal
    forward, its remat recompute and backward), then the reference path on
    a copy of the same weights (``flag["main"]`` off).  Returns (launches,
    metrics by path)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw
    n = train["layers"]
    arch, params = encdec_setup(torch, device, layers=n, dtype=torch.float32)
    copy = tree_map(torch.clone, params)
    gen = torch.Generator().manual_seed(19)
    batch = {k: torch.randint(0, arch.vocab_size,
                              (train["batch"], train["tokens"]),
                              generator=gen).to(device)
             for k in ("tokens", "labels")}
    batch["enc_embeds"] = encdec_frames(torch, arch, train["batch"],
                                        train["frames"], device, seed=1)
    opt = adamw.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)
    metrics = {}
    for k in fops.launches:
        fops.launches[k] = 0
    for use_kernel, p in ((True, params), (False, copy)):
        flag["main"] = use_kernel
        step = steps_lib.make_train_step(arch, opt, use_kernel=use_kernel)
        _, _, m = step(p, adamw.init(p), batch, 0)
        metrics[use_kernel] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        if use_kernel:
            launches = dict(fops.launches)
    flag["main"] = True
    return launches, metrics


def phase_encdec(torch, device="cuda", checked=None, flash_checked=None, *,
                 lanes=ENCDEC_LANES, frames=ENCDEC_FRAMES,
                 prompt=ENCDEC_PROMPT, new=ENCDEC_NEW, shallow=ENCDEC_SHALLOW,
                 trace=ENCDEC_TRACE, tail=ENCDEC_TAIL, train=ENCDEC_TRAIN):
    """Phase 5h: seamless-m4t-large-v2 at full width (random bf16 weights
    from seed 0, phase 4's DMS bias).  (a) Full depth: ``lanes`` lanes of
    ``frames`` frames encoded once through ``flash_fwd`` (``causal=False``,
    one launch an encoder layer), ``prompt`` tokens teacher-forced then
    ``new`` greedy through ``make_serve_step`` with ``enc_out``: two decode
    launches a decoder layer a step (self-attention on fixed arenas, the
    cross-attention's dense mode); a profiled step.  (b) The same trace at
    ``shallow`` decoder layers (the encoder's output reused), fixed then
    paged: tokens equal.  (c) ``trace`` teacher-forced steps at ``shallow``
    layers, kernel path against reference path from the same cache with
    lane 1's last ``tail`` frames hidden: logits within 0.05 x max |logit|;
    each encoder layer's attention through the flash kernel against the
    reference path's from the same input within FLASH_REL_TOL
    (``encoder_layer_gaps``), and the encoder's output after every layer
    on each path within 0.05 x max |ref|.  (d) ``encdec_train``: loss within 1e-2
    relative.  Every decode and flash launch must be at a shape phase 3
    checked (``checked``, ``flash_checked``; on the CPU, the shapes
    ``encdec_decode_keys`` and ``encdec_flash_cases`` predict).  Returns
    the main path's ((a), (b), (d)) decode launches by shape and flash
    launches by (kernel, causal)."""
    import collections
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.models import transformer as tfm
    on_card = device == "cuda"
    main, flash_main = collections.Counter(), collections.Counter()
    seen, flash_seen, flag = set(), set(), {"main": True}
    real_rows = ops.decode_rows
    real_flash = {k: getattr(fops, k) for k in fops.launches}

    def counting(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw):
        key = launch_key(qf, kf, tblf, block_p, kw.get("shared_kv"))
        seen.add(key)
        if flag["main"]:
            main[key] += 1
        return real_rows(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw)

    def flash_counting(name):
        def run(q, *args):
            flash_seen.add(flash_key(q, args[-1]))
            if flag["main"]:
                flash_main[name, args[-1].causal] += 1
            return real_flash[name](q, *args)
        return run

    t0 = time.perf_counter()
    arch, params = encdec_setup(torch, device)
    rng = torch.Generator().manual_seed(17)
    prompts = torch.randint(3, arch.vocab_size, (lanes, prompt), generator=rng,
                            dtype=torch.int32).to(device)
    x_enc = encdec_frames(torch, arch, lanes, frames, device)
    ops.decode_rows = counting
    for k in real_flash:
        setattr(fops, k, flash_counting(k))
    try:
        # (a) full depth: the counts from 0 just before, read just after
        ops.launches = ops.shared_launches = 0
        for k in fops.launches:
            fops.launches[k] = 0
        t_enc = time.perf_counter()
        with torch.no_grad():
            enc_out = tfm.encode(params, x_enc, arch, use_kernel=True)
        if on_card:
            torch.cuda.synchronize()
        t_enc = time.perf_counter() - t_enc
        enc_launches = dict(fops.launches)
        if enc_launches != {"flash_fwd": arch.encoder_layers if on_card else 0,
                            "flash_dq": 0, "flash_dkv": 0}:
            raise AssertionError(f"5h (a): the encoder launched "
                                 f"{enc_launches}")
        if not bool(torch.isfinite(enc_out.float()).all()):
            raise AssertionError("5h (a): non-finite encoder output")
        tokens, wall, steps, meters = encdec_serve(
            torch, arch, params, enc_out, prompts, new)
        got = (ops.launches, ops.shared_launches)
        want = 2 * arch.num_layers * steps if on_card else 0
        if got != (want, 0):
            raise AssertionError(f"5h (a): decode launches (fixed, shared) "
                                 f"{got}, want ({want}, 0): 2 x "
                                 f"{arch.num_layers} layers x {steps} steps")
        live = [round(x, 1) for x in meters["live_tokens"].tolist()]
        log(f"5h (a): {arch.name} at full depth ({arch.encoder_layers} + "
            f"{arch.num_layers} layers), {lanes} lanes: {frames} frames a "
            f"lane encoded in {t_enc:.2f} s through flash_fwd (causal False, "
            f"{enc_launches['flash_fwd']} launches); {prompt} prompt tokens "
            f"teacher-forced and {new} greedy through make_serve_step with "
            f"enc_out: {steps} steps in {wall:.2f} s, "
            f"{1e3 * wall / steps:.2f} ms/step; decode launches {got[0]} = 2 "
            f"x {arch.num_layers} x {steps} (self-attention on fixed arenas, "
            f"cross-attention in dense mode); live tokens a lane after the "
            f"last step {live} (summed over layers and heads; dms at CR 8 "
            f"evicts past its {arch.dms.window}-token delay)")
        flag["main"] = False
        phase_profile(torch, params, arch, {f"{ENCDEC} 5h (a)":
                                            encdec_policy(arch)},
                      lanes=lanes, max_len=prompt + new, device=device,
                      step_kw={"enc_out": enc_out})
        flag["main"] = True
        log(f"seconds: 5h (a) {time.perf_counter() - t0:.1f}")

        # (b) the same trace at `shallow` decoder layers, fixed then paged
        t1 = time.perf_counter()
        cut = cut_depth({"arch": arch, "params": params}, shallow)
        s_arch, s_params = cut["arch"], cut["params"]
        fixed = None
        for paged in (False, True):
            ops.launches = ops.shared_launches = 0
            got_tok, wall, steps, _ = encdec_serve(
                torch, s_arch, s_params, enc_out, prompts, new, paged=paged,
                what="5h (b)")
            want = shallow * steps if on_card else 0
            got = (ops.launches, ops.shared_launches)
            if got != ((want, want) if paged else (2 * want, 0)):
                raise AssertionError(f"5h (b): decode launches (fixed, "
                                     f"shared) {got} for {steps} steps")
            if paged and not (got_tok == fixed).all():
                raise AssertionError("5h (b): the pool's tokens differ from "
                                     "the fixed arenas'")
            fixed = got_tok
            log(f"5h (b): {shallow} decoder layers, the encoder whole, "
                f"{'the paged pool' if paged else 'fixed arenas'}: {steps} "
                f"steps in {wall:.2f} s ({1e3 * wall / steps:.2f} ms/step), "
                f"decode launches (fixed or dense, shared) {got}"
                + ("; tokens equal to the fixed arenas'" if paged else ""))

        # (c) kernel path against reference path: not the main path's
        flag["main"] = False
        gap, scale = encdec_trace(torch, s_arch, s_params, enc_out,
                                  prompts[:, :trace], tail, prompt + new)
        layer_rel = encoder_layer_gaps(torch, params, arch, x_enc)
        with torch.no_grad():
            enc_ref = tfm.encode(params, x_enc, arch, use_kernel=False)
        e_err = (enc_out.float() - enc_ref.float()).abs().max().item()
        e_scale = enc_ref.float().abs().max().item()
        e_tol = FLASH_REL_TOL[str(enc_out.dtype).removeprefix("torch.")]
        log(f"5h (c): {trace} teacher-forced steps at {shallow} decoder "
            f"layers, kernel vs reference path from the same cache, lane 1's "
            f"last {tail} frames hidden (launches not counted on the main "
            f"path): max abs logit diff {gap:.4e}, max |logit| {scale:.4e} "
            f"(tolerance 0.05 x max |logit|); each encoder layer's attention "
            f"from the same input, flash_fwd vs the reference path: at most "
            f"{max(layer_rel):.4e} of max |ref| over {len(layer_rel)} layers "
            f"(tolerance {e_tol}); the encoder's output after "
            f"{arch.encoder_layers} layers on each path: max abs err "
            f"{e_err:.4e}, max |ref| {e_scale:.4e} (tolerance 0.05 x max "
            "|ref|, as the logits': bf16 roundings compound over the "
            "layers)")
        if not gap <= 0.05 * scale:
            raise AssertionError("5h (c): kernel-path logits disagree with "
                                 "the reference path")
        if not (max(layer_rel) <= e_tol and e_err <= 0.05 * e_scale):
            raise AssertionError("5h (c): the encoder through the flash "
                                 "kernel disagrees with the reference path")
        flag["main"] = True
        log(f"seconds: 5h (b), (c) {time.perf_counter() - t1:.1f}")
        del params, cut, s_params, enc_out, enc_ref
        if on_card:
            torch.cuda.empty_cache()

        # (d) one train step, kernel against reference path
        t2 = time.perf_counter()
        launches, metrics = encdec_train(torch, device, train, flag)
        n = train["layers"]
        want = ({"flash_fwd": 3 * n, "flash_dq": 2 * n, "flash_dkv": 2 * n}
                if on_card else {k: 0 for k in fops.launches})
        mk, mr = metrics[True], metrics[False]
        rel = abs(mk["loss"] - mr["loss"]) / max(abs(mr["loss"]), 1e-12)
        log(f"5h (d): make_train_step at {n} + {n} layers, full width, "
            f"B={train['batch']}, {train['tokens']} decoder tokens, "
            f"{train['frames']} frames, fp32 weights, bf16 compute: kernel "
            f"path loss {mk['loss']:.6e}, grad norm {mk['grad_norm']:.6e}; "
            f"reference path loss {mr['loss']:.6e}, grad norm "
            f"{mr['grad_norm']:.6e}; loss rel {rel:.2e} (tolerance 1e-2); "
            f"flash launches {launches}, want {want} (the encoder's "
            f"non-causal fwd, dq, dkv; the decoder's causal fwd, its remat "
            f"recompute, dq, dkv)")
        if launches != want:
            raise AssertionError("5h (d): train step flash launches")
        if not (math.isfinite(mk["loss"]) and rel < 1e-2):
            raise AssertionError("5h (d): the kernel-path train step "
                                 "disagrees with the reference path")
        if on_card:
            torch.cuda.empty_cache()
        log(f"seconds: 5h (d) {time.perf_counter() - t2:.1f}")
    finally:
        ops.decode_rows = real_rows
        for k, fn in real_flash.items():
            setattr(fops, k, fn)
    if checked is None:
        checked = encdec_decode_keys(arch, lanes, frames, prompt + new)
    if flash_checked is None:
        flash_checked = encdec_flash_keys(torch, encdec_flash_cases(
            arch, lanes, frames, train), device)
    if not seen <= set(checked):
        raise AssertionError(f"phase 5h launched the decode kernel at "
                             f"{sorted(seen - set(checked))}, not among phase"
                             f" 3's checked {sorted(checked)}")
    if not flash_seen <= set(flash_checked):
        raise AssertionError(f"phase 5h launched the flash kernels at "
                             f"{sorted(flash_seen - set(flash_checked))}, not "
                             f"among phase 3's checked {sorted(flash_checked)}")
    log(f"phase 5h's decode launch shapes {sorted(seen)} and flash launch "
        f"shapes {sorted(flash_seen)}: each checked in phase 3")
    return {"launches": main, "flash": flash_main}


def phase_encdec_timing(torch, out, errs, flash_errs):
    """Phase 7's rows for 5h: the decode kernel at the decoder's
    fixed-arena and shared-pool serving shapes (G 1, Dh 64) and the
    cross-attention's dense mode at (a)'s shape (every frame visible: a
    table of every block), each with its launches in 5h; then flash_fwd,
    flash_dq and flash_dkv at (a)'s encoder shape (B 4, T 1024, Hq = Hkv =
    16, Dh 64, bf16, causal False, no α) with their non-causal launches in
    5h, beside SDPA with no mask (exactly the same function)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention import ref as fref
    arch = get_arch(ENCDEC)
    gen = torch.Generator(device="cuda").manual_seed(96)
    kw = dataclasses.asdict(encdec_policy(arch))
    max_len = ENCDEC_PROMPT + ENCDEC_NEW
    keys = [("dms", key) for paged in (False, True)
            for key in state_keys(arch, dict(kw, paged=paged), ENCDEC_LANES,
                                  max_len)]
    keys.append(("cross-attention, dense mode",
                 cross_key(arch, ENCDEC_LANES, ENCDEC_FRAMES)))
    rows = []
    for what, key in keys:
        shared = len(key) == 7
        bh, g, dh, p, bp = key[:5]
        if shared:
            nb = key[5]
            case = make_pool_case(torch, gen, bh=bh, g=g, dh=dh, nb=nb, bp=bp,
                                  density=0.85, pages=p // bp)
            operands = {"kernel": case["shared"], "dense": case["fixed"][1:4]}
            shape = (bh, g, dh, nb * bp, bp)
        elif what == "dms":
            args = make_case(torch, gen, bh=bh, g=g, dh=dh, p=p, bp=bp,
                             density=0.85)
            operands, shape = {"kernel": args, "dense": args[1:4]}, key
        else:                     # every frame visible: every block listed
            q, k, v = (torch.randn((bh, n_, dh), generator=gen, device="cuda")
                       .to(torch.bfloat16) for n_ in (g, p, p))
            valid = torch.ones((bh, p), dtype=torch.bool, device="cuda")
            tbl = torch.arange(p // bp, dtype=torch.int32,
                               device="cuda").expand(bh, p // bp).contiguous()
            n = torch.full((bh,), p // bp, dtype=torch.int32, device="cuda")
            operands = {"kernel": (q, k, v, valid, tbl, n),
                        "dense": (k, v, valid)}
            shape = key
        rows.append(decode_entry(
            torch, f"dms_decode{'_shared_kv' if shared else ''} ({ENCDEC} "
            f"{what}, G {g}, Dh {dh})", "shared" if shared else "fixed",
            operands, shape, out["launches"].get(key, 0), errs.get(key, 0.0),
            hkv=arch.attn.num_kv_heads))
    # the encoder's flash kernels at (a)'s shape
    a = arch.attn
    b, t, hq, hkv, dh = (ENCDEC_LANES, ENCDEC_FRAMES, a.num_heads,
                         a.num_kv_heads, a.head_dim)
    qf, kf, vf, ls, hr, cfg, do = flash_case(
        torch, b=b, t=t, hq=hq, hkv=hkv, dh=dh, dtype=torch.bfloat16,
        alpha=None, causal=False, seed=95)
    o, lse = fops.flash_fwd(qf, kf, vf, ls, hr, cfg)
    delta = (do.float() * o.float()).sum(-1)
    grad_args = (qf, kf, vf, ls, do, lse, delta, hr, cfg)
    saved = dict(fops.launches)
    ms = {"flash_fwd": time_cuda(torch, lambda: fops.flash_fwd(
              qf, kf, vf, ls, hr, cfg)),
          "flash_dq": time_cuda(torch, lambda: fops.flash_dq(*grad_args)),
          "flash_dkv": time_cuda(torch, lambda: fops.flash_dkv(*grad_args))}
    fops.launches.update(saved)           # timing launches are not the path's
    plain = {"flash_fwd": time_cuda(torch, lambda: fref.flash_fwd_plain(
                 qf, kf, vf, ls, hr, cfg)),
             "flash_dq": time_cuda(torch, lambda: fref.flash_dq_plain(
                 *grad_args)),
             "flash_dkv": time_cuda(torch, lambda: fref.flash_dkv_plain(
                 *grad_args))}
    library = sdpa_times(torch, qf, kf, vf, ls, do, cfg, b=b)
    pairs = b * hq * t * t                # every (i, j) pair is live
    nbytes = lambda *xs: sum(x.numel() * x.element_size() for x in xs)  # noqa: E731
    ins = nbytes(qf, kf, vf, ls)
    grad_ins = ins + nbytes(do, lse, delta)
    work = {"flash_fwd": (4 * dh * pairs, ins + nbytes(o, lse)),
            "flash_dq": (6 * dh * pairs, grad_ins + nbytes(qf)),
            "flash_dkv": (8 * dh * pairs, grad_ins + nbytes(kf, vf, ls))}
    lines = {"flash_fwd": 142, "flash_dq": 242, "flash_dkv": 343}
    for name, (flops, moved) in work.items():
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        entry = {
            "name": f"{name} ({ENCDEC} encoder, non-causal)", "route": "cuda",
            "source": "src/repro_torch/kernels/dms_attention/csrc/dms_attention.cu",
            "replaces": "src/repro/kernels/dms_attention/dms_attention.py:"
                        f"{lines[name]}",
            "launches": out["flash"].get((name, False), 0),
            "max_abs_err": flash_errs[name], "ms": ms[name],
            "plain_ms": plain[name], "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library[name],
        }
        rows.append(entry)
        log(f"timing: {entry['name']} at (B={b}, T={t}, Hq={hq}, Hkv={hkv}, "
            f"Dh={dh}, bf16, no alpha): kernel {ms[name]:.4f} ms, bound "
            f"{entry['bound_ms']:.5f} ms ({flops} flop, {moved} B), plain "
            f"{plain[name]:.4f} ms, library {library[name]:.4f} ms "
            f"({'SDPA forward' if name == 'flash_fwd' else 'SDPA backward'}"
            ", no mask: the same function)")
    return rows


# -- phase 6 ---------------------------------------------------------------


# -- phase 5i: Dh 256 on the flash kernels (gemma2, recurrentgemma) ----------

DH256_ARCHS = ("gemma2-2b", "recurrentgemma-2b")
DH256_LAYERS = 4                 # (a), (b): two superblocks of each
DH256_TRAIN = dict(batch=2, tokens=1024)   # (c), at one superblock


def dh256_decode_keys(arch=None, lanes=EXPORT_LANES,
                      max_len=EXPORT_PROMPT + EXPORT_DECODE):
    """{launch key: logit softcap} of every decode launch 5i (a) makes:
    gemma2's prefill export imported into dms caches (CR 8; its local
    layers have no vanilla import), fixed and paged, both pattern
    positions."""
    from repro_torch.configs import get_arch
    arch = arch or get_arch(DH256_ARCHS[0])
    return {key: arch.attn.logit_softcap for paged in (False, True)
            for key in state_keys(arch, dict(kind="dms", cr=8.0, paged=paged),
                                  lanes, max_len)}


def dh256_export_logits(torch, setup, what):
    """(b) ``make_prefill_step`` (dms) through ``flash_fwd`` on EXPORT_LANES
    prompts against the reference attention path: the last logits within
    0.05 x max |logit|; one flash launch per attention layer.  Returns the
    launches and the gap."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.launch.steps import make_prefill_step
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    rng = torch.Generator().manual_seed(11)
    tokens = torch.randint(3, arch.vocab_size, (EXPORT_LANES, EXPORT_PROMPT),
                           generator=rng, dtype=torch.int32).to(device)
    live_v = torch.arange(arch.padded_vocab, device=device) < arch.vocab_size
    fops.launches["flash_fwd"] = 0
    logits, _ = make_prefill_step(arch, dms=True, use_kernel=True)(
        params, {"tokens": tokens})
    launched = fops.launches["flash_fwd"]
    ref, _ = make_prefill_step(arch, dms=True, use_kernel=False)(
        params, {"tokens": tokens})
    attn = sum(k.startswith("attn") for k in arch.layer_pattern) * (
        arch.num_layers // arch.pattern_period)
    if launched != (attn if device == "cuda" else 0):
        raise AssertionError(f"{what}: flash_fwd launched {launched} times, "
                             f"want {attn}")
    diff = (logits - ref)[:, live_v].abs().max().item()
    scale = ref[:, live_v].abs().max().item()
    if not bool(torch.isfinite(logits[:, live_v]).all()) or \
            not diff <= 0.05 * scale:
        raise AssertionError(f"{what}: kernel-path logits off by {diff:.4e} "
                             f"(max |logit| {scale:.4e})")
    log(f"{what}: {EXPORT_LANES} prompts of {EXPORT_PROMPT} tokens through "
        f"flash_fwd ({launched} launches = {attn} attention layers); last "
        f"logits vs the reference path: max abs diff {diff:.4e}, max |logit| "
        f"{scale:.4e} (tolerance 0.05 x max |logit|); the recurrent layers "
        "have no prefill import, in the reference as here")
    return launched, diff


def dh256_retrofit(torch, name, device, train=DH256_TRAIN, flag=None):
    """(c) One ``make_retrofit_step`` (the main phase, step 3) of ``name``
    at one superblock, full width, fp32 weights (the model computes in
    bf16), B x T tokens: on the kernel path (fwd, dq and dkv launches
    counted), then on the reference path from the same weights, teacher and
    Gumbel noise (a step seeds its noise from its index).  Loss and
    gradient norm within 1e-2 relative.  Returns (launches, metrics by
    path, seconds of the kernel step's first and second calls)."""
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    arch = get_arch(name) if device == "cuda" else get_smoke(name)
    arch = dataclasses.replace(arch, num_layers=arch.pattern_period)
    params = tfm.init_model(arch, seed=0, device=device, dtype=torch.float32)
    teacher = tree_map(torch.clone, params)
    gen = torch.Generator().manual_seed(29)
    batch = {k: torch.randint(0, arch.vocab_size,
                              (train["batch"], train["tokens"]),
                              generator=gen).to(device)
             for k in ("tokens", "labels")}
    opt = adamw.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)
    metrics, launches, secs = {}, None, None
    for use_kernel in (True, False):
        if flag is not None:
            flag["main"] = use_kernel
        p = tree_map(torch.clone, params)
        for k in fops.launches:
            fops.launches[k] = 0
        step = steps_lib.make_retrofit_step(arch, opt, use_kernel=use_kernel)
        t0 = time.perf_counter()
        _, _, m = step(p, teacher, adamw.init(p), batch, 3)
        metrics[use_kernel] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        if use_kernel:
            first = time.perf_counter() - t0
            launches = dict(fops.launches)
            # the same step again from a fresh copy: its time without the
            # first call's set-up (metrics read to the host end each step)
            p = tree_map(torch.clone, params)
            t0 = time.perf_counter()
            _, _, m = step(p, teacher, adamw.init(p), batch, 3)
            float(m["loss"])
            secs = (first, time.perf_counter() - t0)
        del p, step
    if flag is not None:
        flag["main"] = True
    attn = sum(k.startswith("attn") for k in arch.layer_pattern)
    if device == "cuda" and min(launches.values()) < attn:
        raise AssertionError(f"5i (c) {name}: flash launches {launches}, "
                             f"want each >= {attn}")
    k_, r_ = metrics[True], metrics[False]
    rel = {key: abs(k_[key] - r_[key]) / max(abs(r_[key]), 1e-12)
           for key in k_}
    log(f"5i (c) {name} retrofit step at {arch.num_layers} layers "
        f"({'/'.join(arch.layer_pattern)}), B={train['batch']} "
        f"T={train['tokens']}, fp32 weights: kernel path loss "
        f"{k_['loss']:.6e}, grad norm {k_['grad_norm']:.6e}; reference path "
        f"loss {r_['loss']:.6e}, grad norm {r_['grad_norm']:.6e} (rel "
        f"{rel['loss']:.2e}, {rel['grad_norm']:.2e}; tolerance 1e-2); flash "
        f"launches {launches} (the first call); the kernel step in "
        f"{secs[1]:.3f} s ({secs[0]:.3f} s at its first call)")
    if not (rel["loss"] < 1e-2 and rel["grad_norm"] < 1e-2):
        raise AssertionError(f"5i (c) {name}: the kernel path's retrofit "
                             "step disagrees with the reference path")
    return launches, metrics, secs


def phase_dh256(torch, device="cuda", checked=None, layers=DH256_LAYERS,
                train=DH256_TRAIN, decode_steps=EXPORT_DECODE):
    """Phase 5i: the flash kernels at Dh 256 on the main path.  (a)
    gemma2-2b at ``layers`` layers (random bf16 weights, phase 4's bias):
    ``phase_prefill_export`` (4 x 512 tokens through ``flash_fwd``, imported
    fixed and paged, greedy decode); every decode launch at a shape phase 3
    checked (``checked``).  (b) recurrentgemma-2b at ``layers`` layers: the
    prefill export's last logits against the reference path's.  (c) one
    retrofit step of each at one superblock (``dh256_retrofit``).  Returns
    the flash launches of (a) + (b) and of (c), and (c)'s seconds."""
    import collections
    from repro_torch.kernels.dms_decode import ops
    seen = collections.Counter()
    real_rows = ops.decode_rows
    flag = {"main": True}

    def counting(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw):
        if flag["main"]:
            seen[launch_key(qf, kf, tblf, block_p, kw.get("shared_kv"))] += 1
        return real_rows(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw)

    export = next(iter(DH256_EXPORT.values()))
    assert (export["b"], export["t"]) == (EXPORT_LANES, EXPORT_PROMPT)
    out = {"export_flash": 0, "train": {}}
    ops.decode_rows = counting
    try:
        t0 = time.perf_counter()
        setup = serving_setup(torch, device=device, arch_name=DH256_ARCHS[0],
                              layers=layers)
        exported = phase_prefill_export(torch, setup, steps=decode_steps,
                                        what=f"5i (a) {DH256_ARCHS[0]}",
                                        kinds=("dms",))
        out["export_flash"] += exported["flash"]
        del setup
        setup = serving_setup(torch, device=device, arch_name=DH256_ARCHS[1],
                              layers=layers)
        launched, _ = dh256_export_logits(torch, setup,
                                          f"5i (b) {DH256_ARCHS[1]}")
        out["export_flash"] += launched
        del setup
        if device == "cuda":
            torch.cuda.empty_cache()
        log(f"seconds: 5i (a)-(b) {time.perf_counter() - t0:.1f}")
        for name in DH256_ARCHS:
            t0 = time.perf_counter()
            launches, _, secs = dh256_retrofit(torch, name, device, train,
                                               flag)
            out["train"][name] = {"launches": launches, "s_step": secs}
            if device == "cuda":
                torch.cuda.empty_cache()
            log(f"seconds: 5i (c) {name} {time.perf_counter() - t0:.1f}")
    finally:
        ops.decode_rows = real_rows
    if checked is not None and not set(seen) <= set(checked):
        raise AssertionError(f"phase 5i launched the decode kernel at "
                             f"{sorted(set(seen) - set(checked))}, not among "
                             f"phase 3's checked {sorted(checked)}")
    log(f"phase 5i's decode launch shapes {sorted(seen)}: each checked in "
        "phase 3")
    return out


def phase_dh256_timing(torch, out, errs):
    """Phase 7's Dh-256 flash rows: fwd, dq and dkv at gemma2's and
    recurrentgemma's retrofit shapes (5i (c): B 2, T 1024, bf16), and
    ``flash_fwd`` at gemma2's prefill export (5i (a): B 4, T 512, binarised
    alpha), each beside its bound, plain version and SDPA."""
    entries = []
    for name, kw in (("gemma2-2b", DH256_G2), ("recurrentgemma-2b",
                                                DH256_G10)):
        case = f"{name} retrofit shape (B 2, T 1024), bf16"
        entries += phase_flash_timing(
            torch, out["train"][name]["launches"], errs[case],
            kw=dict(kw, b=DH256_TRAIN["batch"], t=DH256_TRAIN["tokens"],
                    dtype="bfloat16"),
            label=f" ({name} retrofit, Dh 256)")
    export = next(iter(DH256_EXPORT))
    entries += phase_flash_timing(
        torch, {"flash_fwd": out["export_flash"]}, errs[export],
        kw=DH256_EXPORT[export], label=" (gemma2-2b prefill export, Dh 256)",
        kernels=("flash_fwd",))
    return entries


# -- phase 5j: the decode-path auditor ---------------------------------------

# the blocks of 5j's combos (the main path's block size); a lane holds
# phase 4's max_len tokens, and the traces keep the audit's own 32
AUDIT_BLOCK_P = 16


def audit_planted(torch, arch, params, device, lanes, max_len):
    """Three planted faults, each of which the auditor must catch: a step
    that ``torch.cat``s a layer's K arena (arena-pad), a chunk step that
    reads a logit with ``.item()`` (the tripwire's hook, and on the card
    the sync debug mode, which raises), and a step that forces the
    reference path where the kernel was asked for (ref-fallback, and no
    kernel launch).  Returns a line each."""
    import numpy as np
    from repro_torch.analysis import audit
    from repro_torch.analysis.hostsync import HostSyncTripwire
    from repro_torch.analysis.passes import gating
    from repro_torch.core import policy as policy_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    kw = dict(lanes=lanes, max_len=max_len, block_p=AUDIT_BLOCK_P,
              device=device)

    def cat_step(params, tok, state, arch, pos, **kw):
        out = tfm.decode_step(params, tok, state, arch, pos, **kw)
        k = next(policy_lib.iter_policy_caches(state)).cache.k[0]
        torch.cat([k, k[:, :, :1]], dim=2)
        return out

    def forced_step(*args, use_kernel=False, **kw):
        return tfm.decode_step(*args, use_kernel=False, **kw)

    lines = []
    for what, step, want in (("torch.cat of the arena", cat_step,
                              {"arena-pad"}),
                             ("the ref path forced in kernel mode",
                              forced_step, {"ref-fallback",
                                            "kernel-launch"})):
        rep = audit.audit_combo(arch, params, "dms", False, True, step=step,
                                **kw)
        rules = {f.rule for f in gating(rep.findings)}
        if not want <= rules:
            raise AssertionError(f"planted {what}: rules {sorted(rules)}, "
                                 f"want {sorted(want)}")
        lines.append(f"{what}: caught ({', '.join(sorted(rules))})")

    eng = Engine(arch, params, audit.policy_cfg("dms", False), chunk=4,
                 use_kernel=True, device=device)
    sched = eng.scheduler(num_lanes=lanes, max_len=32)
    real = sched._chunk_fn

    def item_chunk(*args):
        out = real(*args)
        out[6][0, 0].item()                 # a host read inside the step
        return out
    sched._chunk_fn = item_chunk
    sched.submit(Request(uid=0, prompt=np.arange(3, 10, dtype=np.int32),
                         max_new=3))
    raised = None
    with HostSyncTripwire() as tw:
        try:
            sched.run()
        except RuntimeError as e:           # the card's sync debug mode
            raised = e
    items = [f for f in tw.violations() if ".item()" in f.message]
    if not items or (device == "cuda") != (raised is not None):
        raise AssertionError(f"planted .item(): violations "
                             f"{[str(f) for f in tw.violations()]}, raised "
                             f"{raised!r}")
    lines.append(f".item() in a chunk step: caught (host-sync at "
                 f"{items[0].path}" + (f"; the sync debug mode raised "
                                       f"{type(raised).__name__}" if raised
                                       else "") + ")")
    return lines


def phase_audit(torch, setup):
    """Phase 5j: ``repro_torch.analysis.audit``'s sweep on phase 4's model
    (``setup``: full width, ``SERVE_LAYERS`` layers, random bf16 weights
    from seed 0, phase 4's bias): every registered policy x {ref, kernel} x
    {fixed, paged} on phase 4's lanes (phase 4's max_len tokens a lane,
    blocks of AUDIT_BLOCK_P), the lifecycle contracts, then the scheduler,
    preempt and SLO traces, fixed and paged, on phase 4's lanes under the
    retrace sentinel and the host-sync tripwire (with CUDA's sync debug
    mode at error).  A line a combo (gating, allowlisted and info counts,
    ops recorded per step; in kernel mode the kernel events against the
    launch counters' growth); any gating finding raises.  Then the three
    planted faults of ``audit_planted``, each caught.  On the card every
    decode launch shape of the sweep is then checked against the plain
    version: fixed and shared modes with ``check_decode_keys``, the
    weights-out mode with ``phase_weights_kernels``.  Returns (the sweep's
    combo reports, the launch shapes by mode, the planted lines)."""
    from repro_torch.analysis import audit
    from repro_torch.analysis.passes import gating
    from repro_torch.kernels.dms_decode import ops
    arch, params, device = setup["arch"], setup["params"], setup["device"]
    lanes = len(setup["prompts"])
    real = ops.decode_rows
    shapes = {"decode": set(), "weights": set()}

    def recording(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw):
        key = launch_key(qf, kf, tblf, block_p, kw.get("shared_kv"))
        shapes["weights" if kw.get("need_weights") else "decode"].add(key)
        return real(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw)

    t0 = time.perf_counter()
    ops.decode_rows = recording
    try:
        findings, reports = audit.sweep(
            arch, params, device=device, lanes=lanes,
            max_len=setup["max_len"], block_p=AUDIT_BLOCK_P, trace_lanes=lanes,
            log=lambda s: log(f"audit (5j):{s}"))
    finally:
        ops.decode_rows = real
    bad = gating(findings)
    n_info = sum(f.severity == "info" for f in findings)
    kinds = sorted({(f.rule, f.path.split("/")[-1].split(" ")[0])
                    for f in findings if f.severity == "info"})
    log(f"audit (5j): {len(bad)} gating finding(s), {n_info} allowlisted "
        f"(by rule and entry point: {kinds}), {len(reports)} combos (9 "
        f"policies x {{ref,kernel}} x {{fixed,paged}}) and 6 traces at "
        f"{arch.name} d={arch.d_model} {widths(arch)}, {arch.num_layers} "
        f"layers, {lanes} lanes of {setup['max_len']} tokens; "
        f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError("phase 5j: gating findings:\n"
                             + "\n".join(str(f) for f in bad))
    if device == "cuda":
        gap = [r.tag for r in reports if r.tag.endswith("/kernel")
               and not r.kernel_events == r.launches == r.attn_layers]
        if gap:
            raise AssertionError(f"phase 5j: kernel events and launch "
                                 f"counters disagree in {gap}")
    planted = audit_planted(torch, arch, params, device, lanes,
                            setup["max_len"])
    for line in planted:
        log(f"audit (5j) planted fault: {line}")
    if device == "cuda":
        worst, _ = check_decode_keys(torch, shapes["decode"],
                                     what="phase 5j")
        wworst = max(phase_weights_kernels(torch, weights_key_cases(
            shapes["weights"], "phase 5j")).values(), default=0.0)
        log(f"phase 5j's decode launch shapes {sorted(shapes['decode'])} and "
            f"weights-out shapes {sorted(shapes['weights'])}: each checked "
            f"against the plain version here (largest max abs err {worst:.3e}"
            f", weights-out {wworst:.3e})")
    return reports, shapes, planted


# -- phase 5k: the mesh, the checkpoint re-shard, int8 gradients, a dry-run
# cell for real ---------------------------------------------------------------

MESH_PREFILL = (4, 512)            # lanes x tokens of (a)'s prefill
MESH_TRAIN = (2, 1024)             # batch x tokens of (a)'s gradients
# (b): the card's measured peak over MemTracker's prediction, stated before
# the first run: the caching allocator rounds blocks up and keeps cuBLAS
# workspaces the tracker does not see, and nothing else should differ
MESH_PEAK_TOL = (0.9, 1.25)
MESH_CELL = ("qwen-r1-1.5b", "prefill_32k")
MESH_LAYERS = 4                    # (a)'s depth


def phase_mesh(torch, card="", device="cuda", layers=MESH_LAYERS,
               prefill=MESH_PREFILL, train=MESH_TRAIN, dry_run=True):
    """Phase 5k (see the module docstring).  On the CPU (``device="cpu"``:
    a gloo group, the smoke config, the plain flash version) it rehearses
    (a); (b) runs on the card only.  Returns (a)'s launch counts."""
    import shutil
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import compress
    from repro_torch.parallel import sharding

    cuda = device == "cuda"
    name = MESH_CELL[0]
    arch = get_arch(name) if cuda else get_smoke(name)
    arch = dataclasses.replace(arch, num_layers=layers)
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    ckpt = ROOT / "artifacts" / "phase5k_checkpoint"
    try:
        mesh = mesh_lib.make_local_mesh(device=device)
        params = tfm.init_model(arch, seed=0, device=device)
        placed = sharding.distribute(
            params, sharding.param_shardings(params, arch, mesh), mesh)
        gen = torch.Generator().manual_seed(53)
        lanes, t = prefill
        batch = {"tokens": torch.randint(3, arch.vocab_size, (lanes, t),
                                         generator=gen,
                                         dtype=torch.int32).to(device)}
        step = steps_lib.make_prefill_step(arch, dms=True, use_kernel=True)
        want_logits, want_kv = step(params, batch)
        for k in fops.launches:
            fops.launches[k] = 0
        t0 = time.perf_counter()
        with implicit_replication():
            got_logits, got_kv = step(placed, batch)
        if cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(fops.launches)
        want = layers if cuda else 0
        if launches["flash_fwd"] != want:
            raise AssertionError(f"phase 5k (a): prefill on the mesh launched "
                                 f"flash_fwd {launches['flash_fwd']} times, "
                                 f"want one a layer ({want})")
        if not isinstance(got_logits, DTensor):
            raise AssertionError("phase 5k (a): the placed prefill returned "
                                 "no DTensor")
        pairs = [(got_logits, want_logits)] + list(zip(
            tree_leaves(got_kv), tree_leaves(want_kv)))
        for got, ref in pairs:
            if not torch.equal(got.full_tensor(), ref):
                raise AssertionError("phase 5k (a): prefill on the mesh "
                                     "differs from the unsharded call")
        log(f"phase 5k (a): {arch.name} L={layers} d={arch.d_model} on a "
            f"{'x'.join(str(mesh.size(i)) for i in range(mesh.ndim))} "
            f"DeviceMesh({mesh.device_type!r}); dms prefill {lanes} x {t} "
            f"through distribute + local_map: {secs:.3f} s, flash_fwd "
            f"{launches['flash_fwd']} launches ({layers} layers); logits and "
            f"{len(pairs) - 1} KV leaves equal to the unsharded call bit for "
            f"bit; {card}")

        shutil.rmtree(ckpt, ignore_errors=True)
        mgr = CheckpointManager(ckpt, keep_last=1)
        t0 = time.perf_counter()
        mgr.save(0, placed)
        specs = sharding.map_with_path(
            lambda _, x: (x.device_mesh, tuple(x.placements)), placed)
        restored, _, _ = mgr.restore(placed, shardings=specs)
        secs = time.perf_counter() - t0
        n = 0
        for (path, got), (_, ref) in zip(sharding.leaves_with_path(restored),
                                         sharding.leaves_with_path(params)):
            if not (isinstance(got, DTensor)
                    and tuple(got.placements) == dict(
                        sharding.leaves_with_path(specs))[path][1]
                    and torch.equal(got.full_tensor(), ref)):
                raise AssertionError(f"phase 5k (a): restored leaf {path} "
                                     "differs")
            n += 1
        log(f"phase 5k (a): checkpoint of the placed params saved and "
            f"restored onto the mesh (restore(..., shardings=)) in "
            f"{secs:.2f} s: {n} leaves equal; {card}")
        del restored, placed, params, got_kv, want_kv

        b, t = train
        p32 = tfm.init_model(arch, seed=0, device=device,
                             dtype=torch.float32)
        toks = torch.randint(3, arch.vocab_size, (b, t + 1), generator=gen,
                             dtype=torch.int32).to(device)
        _, _, grads = steps_lib.retrofit_loss_and_grads(
            arch, p32, p32, {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
            0, use_kernel=True)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, res = compress.all_reduce_compressed(grads)
        if cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        q, sc, _ = compress.compress_grads(grads, None)
        numel = 0
        for g, m, r, qi, si in zip(*(tree_leaves(x) for x in
                                     (grads, mean, res, q, sc))):
            deq = compress.dequantize_int8(qi, si)
            if not torch.equal(m, deq):
                raise AssertionError("phase 5k (a): the compressed mean is "
                                     "not dequantize(q, s)")
            if not torch.equal(g.float(), deq + r):
                raise AssertionError("phase 5k (a): x != dequantize(q) + "
                                     "residual")
            numel += g.numel()
        log(f"phase 5k (a): all_reduce_compressed of one retrofit step's "
            f"gradients ({b} x {t}, {len(tree_leaves(grads))} tensors, "
            f"{numel} values) over the world-1 group: {secs * 1e3:.2f} ms; "
            f"payload {compress.payload_bytes(q)} B (int8 + one fp32 scale a "
            f"tensor) vs {2 * numel} B in bf16; equal to dequantize(q, s) "
            f"bitwise, x == dequantize(q) + residual exactly; {card}")
        del grads, mean, res, q, p32
    finally:
        dist.destroy_process_group()
        shutil.rmtree(ckpt, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    if dry_run:
        phase_mesh_dryrun(torch, card)
    return launches


def phase_mesh_dryrun(torch, card=""):
    """Phase 5k (b): one dry-run cell for real on the card, in a
    subprocess; its measured peak against MemTracker's within
    ``MESH_PEAK_TOL``."""
    import os
    arch, shape = MESH_CELL
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--device", "cuda", "--memory-only"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    secs = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        log(f"phase 5k (b): {line}")
    if run.returncode != 0:
        log(run.stderr[-4000:])
        raise AssertionError(f"phase 5k (b): the dry-run exited "
                             f"{run.returncode}")
    rec = json.loads((ROOT / "artifacts" / "dryrun_torch"
                      / f"{arch}__{shape}__16x16.json").read_text())
    fit = rec["memory_fit"]
    ratio = fit["measured_peak_bytes"] / fit["peak_bytes"]
    log(f"phase 5k (b): {arch} x {shape} on 16x16, rank 0's shard on the "
        f"card ({secs:.1f} s with the process): measured peak "
        f"{fit['measured_peak_bytes']:.0f} B, MemTracker {fit['peak_bytes']:.0f}"
        f" B (ratio {ratio:.4f}, tolerance {MESH_PEAK_TOL}); argument bytes "
        f"{fit['argument_bytes']:.0f}; roofline ({rec['roofline_from']}): "
        f"compute {rec['compute_s']:.6f} s, memory {rec['memory_model_s']:.6f}"
        f" s, collective {rec['collective_s']:.6f} s, {rec['flops_per_device']:.4e}"
        f" FLOPs/card, {rec['collectives_recorded']} collectives -> "
        f"{rec['bottleneck']}-bound; {card}")
    if not MESH_PEAK_TOL[0] <= ratio <= MESH_PEAK_TOL[1]:
        raise AssertionError(f"phase 5k (b): measured peak / MemTracker = "
                             f"{ratio:.4f}, outside {MESH_PEAK_TOL}")
    return rec


# -- phase 5l: the paper's own models at full depth ---------------------------

# the paper's models 5l serves at their published widths and full depth, in
# this order (each freed before the next loads)
PAPER_SERVED = ("llama32-1b", "qwen-r1-7b", "qwen-r1-32b")
# the DMS delay window 5l serves at: llama's own 16; the Qwen-R1 configs'
# 256 cut to 16, so that DMS evicts within a trace the time limit allows
PAPER_WINDOW = 16
# (prompts, new tokens) of the four staggered requests on four lanes, one
# decode step a token: 72 decode steps for llama and the 7B, 64 for the
# 32B (the script's time: a 32B step costs ~0.35 s of host time)
PAPER_TRACE = {"llama32-1b": ((48, 40, 32, 24), (24, 16, 16, 24)),
               "qwen-r1-7b": ((48, 40, 32, 24), (24, 16, 16, 24)),
               "qwen-r1-32b": ((48, 40, 32, 24), (16, 8, 8, 16))}
PAPER_PAGED = ("llama32-1b", "qwen-r1-7b")      # (d): the 32B fixed only
PAPER_TF = 16             # (c): teacher-forced kernel-vs-reference steps
PAPER_PROFILED = ("qwen-r1-7b", "qwen-r1-32b")
# steps a profiled run: the profiler's cost grows with the ops, ~24 000 a
# step at the 32B
PAPER_PROFILE_STEPS = 1
# the memory line: dms's decode state at the config's own CR and window on
# 4 lanes of 32768 tokens, allocated beside the 32B's weights
PAPER_MEMORY = ("qwen-r1-32b", 4, 32768)
# what may stay allocated on the card when a model of 5l loads
PAPER_HELD = 1 << 30


def paper_arch(arch):
    """``arch`` with the DMS delay window 5l serves at."""
    return dataclasses.replace(arch, dms=dataclasses.replace(
        arch.dms, window=min(arch.dms.window, PAPER_WINDOW)))


def paper_policy(arch):
    """5l's policy keywords: ``dms`` at the config's target CR."""
    return dict(kind="dms", cr=arch.dms.target_cr)


def paper_layouts(arch, trace=None, tf=PAPER_TF):
    """Every (policy keywords, lanes, max_len) 5l builds a decode state for
    with ``arch`` (its served window): serving fixed (the profile's too)
    and, for ``PAPER_PAGED``, paged; the kernel-vs-reference trace."""
    lens, news = (trace or PAPER_TRACE)[arch.name]
    kw, max_len = paper_policy(arch), max(a + b for a, b in zip(lens, news))
    out = [(kw, len(lens), max_len)]
    if arch.name in PAPER_PAGED:
        out.append((dict(kw, paged=True), len(lens), max_len))
    return out + [(kw, 2, tf + 16)]


def paper_decode_keys(archs=None, **kw):
    """Every decode launch shape 5l makes (``paper_layouts`` of each model
    at full width, or of ``archs``)."""
    from repro_torch.configs import get_arch
    keys = set()
    for arch in archs or [paper_arch(get_arch(n)) for n in PAPER_SERVED]:
        for pol, lanes, max_len in paper_layouts(arch, **kw):
            keys.update(state_keys(arch, pol, lanes, max_len))
    return keys


def tree_bytes(tree):
    """(bytes, elements) of every tensor leaf of ``tree``."""
    from repro_torch.core.tree import tree_leaves
    leaves = tree_leaves(tree)
    return (sum(a.numel() * a.element_size() for a in leaves),
            sum(a.numel() for a in leaves))


def paper_memory(torch, setup, lanes, tokens, own_window, weight_bytes,
                 free_after_load):
    """The paper's memory axis beside the weights: ``dms`` at the config's
    CR and own delay window (``own_window``) on ``lanes`` lanes of
    ``tokens`` tokens, its decode state allocated with ``init_decode_state``
    next to the served weights; vanilla's arena for the same lanes and
    length counted on one layer and one lane of host memory, not
    allocated on the card."""
    from repro_torch.core import policy as policy_lib
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.kv_cache import SlotDMSCache
    from repro_torch.models import transformer as tfm
    arch, device = setup["arch"], setup["device"]
    cuda = device == "cuda"
    own = dataclasses.replace(arch, dms=dataclasses.replace(
        arch.dms, window=own_window))
    cfg = KVPolicyConfig(**paper_policy(own))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    before = torch.cuda.memory_allocated() if cuda else 0
    state = tfm.init_decode_state(own, lanes, tokens, cfg, device=device)
    grew = (torch.cuda.memory_allocated() - before) if cuda else 0
    free = torch.cuda.mem_get_info()[0] if cuda else 0
    dms_bytes = policy_lib.state_peak_bytes(state)
    del state
    one = tfm.init_decode_state(dataclasses.replace(own, num_layers=1), 1,
                                tokens, KVPolicyConfig(kind="vanilla"),
                                device="cpu")
    vanilla_bytes = (policy_lib.state_peak_bytes(one) * own.num_layers
                     * lanes)
    slots = SlotDMSCache.provision_slots(tokens, cfg.cr, own_window)

    def gb(x):
        return f"{x / 1e9:.2f} GB" if cuda else "not measured (CPU)"
    room = (f"; {'more' if vanilla_bytes > free_after_load else 'less'} than"
            f" the {gb(free_after_load)} free beside the weights"
            if cuda else "")
    log(f"5l memory ({arch.name}, {arch.num_layers} layers): bf16 weights "
        f"{weight_bytes / 1e9:.2f} GB; free after the weights loaded "
        f"{gb(free_after_load)} (mem_get_info); peak allocated since the "
        f"load {gb(peak)} (max_memory_allocated); dms decode state at CR "
        f"{cfg.cr:g}, delay window {own_window}, {lanes} lanes x {tokens} "
        f"tokens: {slots} slots a kv head, {dms_bytes / 1e9:.2f} GB "
        f"(state_peak_bytes; the allocator grew {gb(grew)}) allocated beside "
        f"the weights, {gb(free)} still free; vanilla at the same lanes and "
        f"length: {vanilla_bytes / 1e9:.2f} GB (counted, not allocated)"
        f"{room}")
    if not dms_bytes < vanilla_bytes:
        raise AssertionError(f"5l memory: dms's state {dms_bytes} B is not "
                             f"below vanilla's {vanilla_bytes} B")
    return {"dms_bytes": dms_bytes, "vanilla_bytes": vanilla_bytes,
            "slots": slots}


def phase_paper(torch, device="cuda", checked=None, *, trace=None,
                tf=PAPER_TF, memory=PAPER_MEMORY):
    """Phase 5l: llama32-1b, qwen-r1-7b and qwen-r1-32b at their published
    widths and full depth, random bf16 weights from seed 0 drawn on the
    device, ``dms`` at each config's target CR with the bias that evicts at
    that rate and the delay window ``paper_arch`` serves.  Each model: (a)
    ``arch_serve`` of four staggered requests (``trace``) on four lanes,
    greedy, through the decode kernel, fixed and, for ``PAPER_PAGED``,
    paged ((d): tokens equal); (e) each request's peak live tokens below
    vanilla's count; (c) a ``policy_paths`` trace of ``tf`` steps; a
    profiled step for ``PAPER_PROFILED``; the memory line for
    ``memory``'s model.  Every decode step must run the kernel in every
    layer (``attn_impl_kernel``), and every decode launch must be at a
    shape phase 3 checked (``checked``; on the CPU, the shapes
    ``paper_layouts`` predicts).  Each model is freed before the next
    loads.  Returns the main path's decode launches by shape and the
    profiles."""
    import collections
    import gc
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.models import transformer as tfm
    cuda = device == "cuda"
    trace = trace or PAPER_TRACE
    main = collections.Counter()
    seen, flag = set(), {"main": True}
    real_rows, real_step = ops.decode_rows, tfm.decode_step

    def counting(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw):
        key = launch_key(qf, kf, tblf, block_p, kw.get("shared_kv"))
        seen.add(key)
        if flag["main"]:
            main[key] += 1
        return real_rows(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw)

    def kernel_step(*args, **kw):
        out = real_step(*args, **kw)
        if kw.get("use_kernel") and out[2]["attn_impl_kernel"] != 1:
            raise AssertionError("phase 5l: a decode step left the kernel")
        return out

    out = {"launches": main, "profiles": {}}
    expected = set()
    t_lap = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        log(f"seconds: {what} {now - t_lap[0]:.1f}")
        t_lap[0] = now

    ops.decode_rows, tfm.decode_step = counting, kernel_step
    try:
        for name in PAPER_SERVED:
            t0 = time.perf_counter()
            full = (get_arch if cuda else get_smoke)(name)
            held = 0
            if cuda:
                gc.collect()
                torch.cuda.empty_cache()
                held = torch.cuda.memory_allocated()
                if held > PAPER_HELD:
                    raise AssertionError(f"5l: {held} B still allocated on "
                                         f"the card before {name} loads")
            lens, news = trace[name]
            setup = serving_setup(
                torch, device=device, arch_name=name, lens=lens, news=news,
                cr=full.dms.target_cr,
                dms_window=paper_arch(full).dms.window)
            arch, params = setup["arch"], setup["params"]
            weight_bytes, n_params = tree_bytes(params)
            free = torch.cuda.mem_get_info()[0] if cuda else 0
            floor_ms = 1e3 * weight_bytes / HBM_BYTES_PER_S
            log(f"5l {name}: full depth, {arch.num_layers} of its "
                f"{full.num_layers} layers; {n_params / 1e9:.2f} B params, "
                f"{weight_bytes / 1e9:.2f} GB of weights (a read of them "
                f"all {floor_ms:.2f} ms at 3.35 TB/s); "
                + (f"{held} B allocated before the load, {free / 1e9:.2f} "
                   "GB free on the card after it (mem_get_info); "
                   if cuda else "")
                + f"dms at CR {arch.dms.target_cr:g}, delay window "
                f"{arch.dms.window} (the config's {full.dms.window})")
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            else:
                expected |= paper_decode_keys([arch], trace=trace, tf=tf)
            kw = paper_policy(arch)
            flag["main"] = True
            results = arch_serve(
                torch, setup, f"5l (a) {name}", kw=kw, uids=(0, 1, 2, 3),
                layouts=(False, True) if name in PAPER_PAGED else (False,))
            peaks = [results[u].meter.peak_tokens for u in range(len(lens))]
            vanillas = [arch.num_layers * (a + b) for a, b in zip(lens, news)]
            if not all(p < v for p, v in zip(peaks, vanillas)):
                raise AssertionError(f"5l (e) {name}: peak live tokens "
                                     f"{peaks}, vanilla's {vanillas}")
            log(f"5l (e) {name}: peak live tokens a request (summed over "
                f"layers, mean over kv heads) {peaks}, below the "
                f"{vanillas} vanilla would hold (fractions "
                f"{[round(p / v, 4) for p, v in zip(peaks, vanillas)]})")
            lap(f"5l load, (a), (d), (e) {name}")
            flag["main"] = False
            policy_paths(torch, setup, {f"{name} ({arch.num_layers} "
                                        "layers)": (arch, kw)},
                         steps=tf, what="5l (c)")
            lap(f"5l (c) {name}")
            if name in PAPER_PROFILED:
                key = f"{name} 5l"
                prof = phase_profile(
                    torch, params, arch, {key: KVPolicyConfig(**kw)},
                    lanes=len(lens), max_len=setup["max_len"],
                    device=device, steps=PAPER_PROFILE_STEPS)[key]
                busy = (f"{prof['device_ms']:.3f} ms device time, busy "
                        f"share {prof['device_ms'] / prof['wall_ms']:.4f}"
                        if prof["device_ms"] else "device time not measured")
                log(f"5l profile: {name} at {arch.num_layers} layers, "
                    f"{len(lens)} lanes: {prof['wall_ms']:.2f} ms a decode "
                    f"step = {prof['wall_ms'] / arch.num_layers:.3f} ms a "
                    f"layer; {prof['ops'] / arch.num_layers:.1f} ATen ops a "
                    f"layer; {busy}; beside the weight-read floor "
                    f"{floor_ms:.2f} ms")
                out["profiles"][name] = dict(prof, floor_ms=floor_ms)
                lap(f"5l profile {name}")
            if name == memory[0]:
                out["memory"] = paper_memory(torch, setup, *memory[1:],
                                             full.dms.window, weight_bytes,
                                             free)
            del setup, params, results
            t_lap[0] = time.perf_counter()
            log(f"seconds: 5l {name} {t_lap[0] - t0:.1f}")
    finally:
        ops.decode_rows, tfm.decode_step = real_rows, real_step
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    checked = checked if checked is not None else expected
    if not seen <= set(checked):
        raise AssertionError(f"phase 5l launched the decode kernel at "
                             f"{sorted(seen - set(checked))}, not among phase"
                             f" 3's checked {sorted(checked)}")
    log(f"phase 5l's decode launch shapes {sorted(seen)}: each checked in "
        "phase 3")
    return out


def phase_paper_timing(torch, launches, errs):
    """Phase 7's rows for 5l: the decode kernel at each model's serving
    shapes (``paper_layouts``' serving layouts: fixed, and shared-pool for
    ``PAPER_PAGED``), each with its launches in 5l."""
    from repro_torch.configs import get_arch
    gen = torch.Generator(device="cuda").manual_seed(96)
    rows = []
    for name in PAPER_SERVED:
        arch = paper_arch(get_arch(name))
        rows += layout_rows(torch, gen, arch, paper_layouts(arch)[:-1],
                            launches, errs, tag=", 5l full depth")
    return rows


# -- phase 5m: the hyper-scaling demo with trained weights --------------------

# `python -m repro_torch.examples.hyperscale_serve`'s run: the recipe's
# steps (and half as many retrofit steps), its eval problems, and L = the
# prompt + REASONER_NEW tokens
REASONER_STEPS = 200
REASONER_EVAL = 16
REASONER_NEW = 8
REASONER_HELD = 10       # (b): the first steps of each stage held on the CPU
REASONER_TF = 40         # (c): teacher-forced kernel-vs-reference steps
# (b): a loss within this of the CPU plain path's, relative to the larger of
# |loss| and REASONER_LOSS_FLOOR: the first retrofit steps distil a student
# that still equals its teacher (loss ~1e-5), whose bf16 noise is absolute
REASONER_LOSS_TOL = 2e-2
REASONER_LOSS_FLOOR = 5e-3


def reasoner_setup(steps=REASONER_STEPS):
    """The demo's (arch, task, max_len)."""
    from repro_torch.examples.reasoner import reasoner_config
    arch, task = reasoner_config(steps)
    return arch, task, task.prompt_len + REASONER_NEW


def reasoner_runs(arch):
    """The demo's two evaluations: name -> (policy keywords, W, CR)."""
    return {"vanilla": (dict(kind="vanilla"), 1, 1.0),
            "dms": (dict(kind="dms", cr=arch.dms.target_cr,
                         window=arch.dms.window), 4, arch.dms.target_cr)}


def reasoner_layouts(arch, max_len, tf=REASONER_TF):
    """Every (policy keywords, lanes, max_len) 5m builds a decode state
    for: each evaluation on W lanes, dms's one-chain prefill check, and the
    teacher-forced trace (two lanes of ``tf + 16``)."""
    runs = reasoner_runs(arch)
    return ([(kw, width, max_len) for kw, width, _ in runs.values()]
            + [(runs["dms"][0], 1, max_len)]
            + [(kw, 2, tf + 16) for kw, _, _ in runs.values()])


def reasoner_decode_keys(tf=REASONER_TF):
    """Every decode launch shape 5m makes (fixed arenas, G 2, Dh 16)."""
    arch, _, max_len = reasoner_setup()
    return {key for pol, lanes, ml in reasoner_layouts(arch, max_len, tf)
            for key in state_keys(arch, pol, lanes, ml)}


def reasoner_flash_cases():
    """{name: ``flash_case`` keywords} of every flash launch shape 5m's
    training makes (B 32, T 32, Hq 4, Hkv 2, Dh 16, bf16, causal): the
    pretrain's and the teacher's vanilla attention, and the retrofit
    student's ``dms_train`` (relaxed α, delay = the DMS window 4)."""
    from repro_torch.examples.reasoner import BATCH
    arch, task, _ = reasoner_setup()
    a = arch.attn
    head = dict(b=BATCH, t=task.prompt_len, hq=a.num_heads,
                hkv=a.num_kv_heads, dh=a.head_dim, dtype=arch.dtype)
    return {"5m vanilla (pretrain, teacher)": dict(head, alpha=None),
            "5m dms_train (retrofit student)": dict(
                head, alpha="relaxed", delay=arch.dms.window)}


def reasoner_cpu_evals(path, steps, n_eval):
    """(d)'s CPU side, in a process of its own: the demo's two evaluations
    through the port's plain path on the CPU with the params saved at
    ``path``.  Returns {name: ``evaluate_hyperscale``'s dict}."""
    import torch
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.hyperscale import ScalingConfig
    from repro_torch.data import tasks
    from repro_torch.serving.engine import Engine, evaluate_hyperscale
    torch.set_num_threads(1)
    params = torch.load(path)
    arch, task, max_len = reasoner_setup(steps)
    prompts, answers = tasks.make_eval_set(task, n_eval)
    return {name: evaluate_hyperscale(
        Engine(arch, params, KVPolicyConfig(**kw), use_kernel=False,
               temperature=0.7, device="cpu"),
        prompts, answers, ScalingConfig(max_len, width, cr))
        for name, (kw, width, cr) in reasoner_runs(arch).items()}


def start_cpu_evals(torch, params, steps, n_eval, tmp):
    """Start ``reasoner_cpu_evals`` in a child process on the CPU alone (the
    card hidden from it), on a copy of ``params`` saved under ``tmp``, so
    that it runs while the card serves.  Returns the process; its stdout's
    last line is the JSON of the results."""
    from repro_torch.core.tree import tree_map
    path = Path(tmp) / "reasoner_params.pt"
    torch.save(tree_map(lambda x: x.detach().cpu(), params), path)
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import chip_smoke; print(json.dumps(chip_smoke.reasoner_cpu_evals("
            "sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))))")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), str(SRC), str(path),
         str(steps), str(n_eval)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)


def finish_cpu_evals(proc, timeout=300):
    """The results of ``start_cpu_evals``' process, once it has ended."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"5m (d): the CPU evaluations failed: "
                             f"{err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def held_losses(what, card, cpu):
    """(b)'s check: each step's loss on the card against the CPU plain
    path's, within REASONER_LOSS_TOL relative (floor REASONER_LOSS_FLOOR).
    Returns the largest relative gap."""
    worst = 0.0
    for s, (got, want) in enumerate(zip(card, cpu)):
        gap = abs(got - want) / max(abs(want), REASONER_LOSS_FLOOR)
        if not (math.isfinite(got) and gap <= REASONER_LOSS_TOL):
            raise AssertionError(f"5m (b) {what} step {s}: card loss {got!r}, "
                                 f"CPU plain path {want!r}")
        worst = max(worst, gap)
    return worst


def phase_reasoner(torch, device="cuda", checked=None, flash_checked=None, *,
                   steps=REASONER_STEPS, n_eval=REASONER_EVAL,
                   held=REASONER_HELD, tf=REASONER_TF):
    """Phase 5m: ``examples/hyperscale_serve.py``'s path with trained
    weights.  (b) ``trained_reasoner(steps)`` on ``device`` (the flash
    kernels on the card): each kernel launched as often as the steps'
    layers call it (fwd twice a layer a student step, the forward and
    remat's recompute, and once for the retrofit's teacher; dq and dkv
    once), and the first ``held`` steps of each stage against the port's
    plain path on the CPU from the same params (the card's pretrained ones
    for the retrofit) and Gumbel draws.  (c) The demo's two evaluations
    (``evaluate_hyperscale`` at temperature 0.7 on ``n_eval`` problems:
    vanilla L-W-CR 40-1-1, dms 40-4-4): every request ok, one decode
    launch a layer a decode step, dms's peak tokens a chain below
    vanilla's; the 4-chain request's prefill reads equal a 1-chain
    request's on the same prompt; a ``policy_paths`` trace of ``tf`` steps
    for each.  (d) Reported: the evaluations' meters, the eviction rate
    (decoded tokens whose α_bin is 1, per layer, against 1 − 1/CR), the
    same evaluations on the CPU's plain path with the card-trained params
    (``start_cpu_evals``: a child process that runs while the card
    serves), the seconds of each part.  Every decode and flash launch must
    be at a shape phase 3 checked (``checked``, ``flash_checked``; on the
    CPU the shapes ``reasoner_layouts`` and ``reasoner_flash_cases``
    predict).  Returns the main path's decode launches by shape, the
    training's flash launches by kernel, the evaluations, the eviction rate
    by layer and the last ``alpha_mean``."""
    import collections
    import itertools
    from repro_torch.core import dms as dms_lib
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.hyperscale import ScalingConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.data import tasks
    from repro_torch.examples import reasoner
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.launch.steps import step_generator
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Engine, evaluate_hyperscale
    cuda = device == "cuda"
    arch, task, max_len = reasoner_setup(steps)
    n_layers = arch.num_layers
    main, flash_calls = collections.Counter(), collections.Counter()
    seen, flash_seen, flag = set(), set(), {"main": True}
    real_rows, real_step = ops.decode_rows, tfm.decode_step
    real_flash = {k: getattr(fops, k) for k in fops.launches}
    real_infer, real_retrofit = dms_lib.infer_alphas, reasoner.retrofit_steps
    # (d)'s eviction count: α_bin of the active lanes, a layer at a time
    evicted = torch.zeros(n_layers, device=device)
    decoded = torch.zeros(n_layers, device=device)
    ctx = {"count": False, "layer": 0, "active": None}
    pretrained = {}
    t_lap = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        log(f"seconds: 5m {what} {now - t_lap[0]:.1f}")
        t_lap[0] = now

    def counting(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw):
        key = launch_key(qf, kf, tblf, block_p, kw.get("shared_kv"))
        seen.add(key)
        if flag["main"]:
            main[key] += 1
        return real_rows(qf, kf, vf, valf, tblf, nf, block_p, *args, **kw)

    def kernel_step(*args, **kw):
        ctx["layer"], ctx["active"] = 0, kw.get("active")
        out = real_step(*args, **kw)
        if kw.get("use_kernel") and out[2]["attn_impl_kernel"] != 1:
            raise AssertionError("phase 5m: a decode step left the kernel")
        return out

    def infer_counting(q_raw, num_kv_heads, cfg):
        alpha_bin, q = real_infer(q_raw, num_kv_heads, cfg)
        if ctx["count"]:
            a = alpha_bin[..., 0].float()                  # (B, Hkv)
            act = ctx["active"]
            act = (torch.ones(a.shape[0], device=a.device) if act is None
                   else act.float())
            layer = ctx["layer"]
            evicted[layer] += (a * act[:, None]).sum()
            decoded[layer] += act.sum() * a.shape[1]
            ctx["layer"] = layer + 1
        return alpha_bin, q

    def flash_recording(name):
        def run(q, *args):
            flash_seen.add(flash_key(q, args[-1]))
            flash_calls[name] += 1
            return real_flash[name](q, *args)
        return run

    def snapshotting(*args, **kw):
        # the pretrained params, before the retrofit updates them in place
        pretrained["params"] = tree_map(
            lambda x: x.detach().to("cpu", copy=True), args[2])
        yield from real_retrofit(*args, **kw)

    ops.decode_rows, tfm.decode_step = counting, kernel_step
    dms_lib.infer_alphas = infer_counting
    reasoner.retrofit_steps = snapshotting
    for k in real_flash:
        setattr(fops, k, flash_recording(k))
    cpu_evals = None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_5m_")
    try:
        # (b) train, the flash launches counted from 0
        for k in fops.launches:
            fops.launches[k] = 0
        # the card's default; on the CPU the kernels' plain versions
        _, params, _, alpha, hist = reasoner.trained_reasoner(
            steps, device=device, use_kernel=True)
        if cuda:
            torch.cuda.synchronize()
        flash = dict(fops.launches)
        lap(f"(b) train {steps} + {steps // 2} steps")
        for k in real_flash:
            setattr(fops, k, real_flash[k])
        reasoner.retrofit_steps = real_retrofit
        pre, ret = steps, steps // 2
        want = {"flash_fwd": n_layers * (2 * pre + 3 * ret),
                "flash_dq": n_layers * (pre + ret),
                "flash_dkv": n_layers * (pre + ret)}
        if dict(flash_calls) != want or flash != (
                want if cuda else dict.fromkeys(want, 0)):
            raise AssertionError(f"5m (b): flash calls {dict(flash_calls)}, "
                                 f"launches {flash}; want {want} of each")
        base = reasoner.pretrain_arch(arch)
        init = tree_map(lambda x: x.cpu(), tfm.init_model(
            base, seed=0, device=device, dtype=torch.float32))
        cpu = {"pretrain": [m for _, m in itertools.islice(
            reasoner.pretrain_steps(base, task, init, pre), held)]}

        def card_uniforms(s):
            # the draws the card's retrofit step s made (its generator)
            return [u.cpu() for u in tfm.layer_noise(
                arch, reasoner.BATCH, task.prompt_len,
                step_generator(23, s, device), device)]
        cpu["retrofit"] = [m for _, m in itertools.islice(
            reasoner.retrofit_steps(arch, task, pretrained["params"], ret,
                                    uniforms_fn=card_uniforms), held)]
        gaps = {}
        for stage in ("pretrain", "retrofit"):
            card_l = [m["loss"] for m in hist[stage][:held]]
            cpu_l = [float(m["loss"]) for m in cpu[stage]]
            gaps[stage] = held_losses(stage, card_l, cpu_l)
        last_pre, last_ret = hist["pretrain"][-1], hist["retrofit"][-1]
        cpu_pre, cpu_ret = cpu["pretrain"][-1], cpu["retrofit"][-1]
        log(f"5m (b) trained_reasoner({steps}) on {device}: {arch.name} at "
            f"vocab {arch.vocab_size}, {n_layers} layers, d {arch.d_model}, "
            f"{arch.attn.num_heads}/{arch.attn.num_kv_heads} heads of "
            f"{arch.attn.head_dim}; chain_arith B {reasoner.BATCH} x T "
            f"{task.prompt_len}; flash launches {flash} = fwd {n_layers} x (2"
            f" x {pre} + 3 x {ret}), dq and dkv {n_layers} x {pre + ret} "
            f"(remat recomputes each student forward; the retrofit's teacher "
            f"forward too); the first {held} losses of each stage against the"
            f" CPU plain path from the same params and draws: largest gap "
            f"{gaps['pretrain']:.3e} (pretrain), {gaps['retrofit']:.3e} "
            f"(retrofit) (tolerance {REASONER_LOSS_TOL} relative, floor "
            f"{REASONER_LOSS_FLOOR}); card vs CPU at step {held - 1}: CE "
            f"{hist['pretrain'][held - 1]['ce']:.6f} vs "
            f"{float(cpu_pre['ce']):.6f}, alpha_mean "
            f"{hist['retrofit'][held - 1]['alpha_mean']:.6f} vs "
            f"{float(cpu_ret['alpha_mean']):.6f}; last steps on the card "
            f"(reported): pretrain CE {last_pre['ce']:.6f}, retrofit loss "
            f"{last_ret['loss']:.6f}, alpha_mean {alpha:.6f} (the target "
            f"{1 - 1 / arch.dms.target_cr:.2f} at CR "
            f"{last_ret['cr_schedule']:g})")
        lap("(b) CPU plain path")
        # (d)'s CPU evaluations run in a child process while the card serves
        cpu_evals = start_cpu_evals(torch, params, steps, n_eval, tmp)

        # (c) the demo's two evaluations on the card
        prompts, answers = tasks.make_eval_set(task, n_eval)
        runs = reasoner_runs(arch)
        evals, engines = {}, {}
        for name, (kw, width, cr) in runs.items():
            engine = Engine(arch, params, KVPolicyConfig(**kw),
                            temperature=0.7, device=device)
            engines[name] = engine
            results = []

            def record(prompt, cfg, seed=0, _real=engine.hyperscale_generate):
                results.append(_real(prompt, cfg, seed=seed))
                return results[-1]
            engine.hyperscale_generate = record
            engine.chunk_fn.steps = 0
            ops.launches = ops.shared_launches = ops.weights_launches = 0
            ctx["count"] = name == "dms"
            t0 = time.perf_counter()
            res = evaluate_hyperscale(engine, prompts, answers,
                                      ScalingConfig(max_len, width, cr))
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ctx["count"] = False
            del engine.hyperscale_generate
            n_steps = engine.chunk_fn.steps
            got = (ops.launches, ops.shared_launches, ops.weights_launches)
            if got != ((n_layers * n_steps if cuda else 0), 0, 0):
                raise AssertionError(f"5m (c) {name}: launches (fixed, "
                                     f"shared, weights-out) {got} for "
                                     f"{n_steps} decode steps")
            for r in results:
                req = r.requests[0]
                if req.status != "ok" or not (
                        req.lengths == max_len - task.prompt_len).all():
                    raise AssertionError(f"5m (c) {name}: status "
                                         f"{req.status}, lengths "
                                         f"{req.lengths}")
            if width > 1 and all(len({tuple(c) for c in r.tokens.tolist()}) < 2
                                 for r in results):
                raise AssertionError(f"5m (c) {name}: every problem's "
                                     f"{width} chains are identical")
            evals[name] = dict(res=res, width=width, steps=n_steps,
                               launches=got[0], wall=wall)
            log(f"5m (c) {name} at {max_len}-{width}-{cr:g}, {n_eval} "
                f"problems, temperature 0.7: all ok; accuracy "
                f"{res['accuracy']:.4f}, kv_reads {res['kv_reads']:.1f}, "
                f"peak_tokens {res['peak_tokens']:.1f}, peak_bytes "
                f"{res['peak_bytes']:.0f}; {n_steps} decode steps in "
                f"{wall:.2f} s = {1e3 * wall / max(n_steps, 1):.2f} ms/step; "
                f"fixed-arena launches {got[0]} = {n_layers} x {n_steps}")
        per_chain = {k: v["res"]["peak_tokens"] / v["width"]
                     for k, v in evals.items()}
        if not per_chain["dms"] < per_chain["vanilla"]:
            raise AssertionError(f"5m (c): dms peak tokens a chain "
                                 f"{per_chain['dms']} not below vanilla's "
                                 f"{per_chain['vanilla']}")
        _, width, cr = runs["dms"]
        forked = engines["dms"].hyperscale_generate(
            prompts[0], ScalingConfig(max_len, width, cr)).requests[0]
        flag["main"] = False
        single = engines["dms"].hyperscale_generate(
            prompts[0], ScalingConfig(max_len, 1, cr)).requests[0]
        p4, p1 = forked.prefill_meter.kv_reads, single.prefill_meter.kv_reads
        if not (forked.status == single.status == "ok" and p4 == p1 > 0):
            raise AssertionError(f"5m (c): the {width} chains' prefill reads "
                                 f"{p4} are not one prefill's {p1}")
        log(f"5m (c): peak tokens a chain: vanilla {per_chain['vanilla']:.1f},"
            f" dms {per_chain['dms']:.1f}; shared prefill: {p4:.0f} prefill "
            f"reads for {width} chains = one chain's {p1:.0f} (one prefill, "
            f"forked), {forked.decode_meter.kv_reads:.0f} decode reads")
        lap("(c) serve")
        policy_paths(torch, dict(arch=arch, params=params, device=device),
                     {f"{name} (trained)": (arch, kw)
                      for name, (kw, _, _) in runs.items()},
                     steps=tf, what="5m (c)")
        lap("(c) teacher-forced trace")

        # (d) reported: the eviction rate, the CPU's evaluations
        rate = (evicted / decoded.clamp_min(1)).tolist()
        n_dec = decoded.tolist()
        log(f"5m (d) trained eviction rate (decoded tokens whose alpha_bin is"
            f" 1, active lanes, over the dms evaluation): "
            + ", ".join(f"layer {i} {r:.4f} of {n:.0f} (token, kv head) "
                        "pairs" for i, (r, n) in enumerate(zip(rate, n_dec)))
            + f"; the retrofit aimed at 1 - 1/CR = "
            f"{1 - 1 / arch.dms.target_cr:.2f}")
        on_cpu = finish_cpu_evals(cpu_evals)
        side = [f"{name} accuracy {evals[name]['res']['accuracy']:.4f} (CPU "
                f"{res['accuracy']:.4f}), kv_reads "
                f"{evals[name]['res']['kv_reads']:.1f} (CPU "
                f"{res['kv_reads']:.1f}), peak_tokens "
                f"{evals[name]['res']['peak_tokens']:.1f} (CPU "
                f"{res['peak_tokens']:.1f})" for name, res in on_cpu.items()]
        log(f"5m (d) the card's evaluations beside the CPU plain path's with "
            f"the card-trained params, run in a child process while the card "
            f"served (reported: sampled tokens may part where bf16 rounds "
            f"apart): " + "; ".join(side))
        lap("(d) the CPU evaluations' wait")
    finally:
        ops.decode_rows, tfm.decode_step = real_rows, real_step
        dms_lib.infer_alphas = real_infer
        reasoner.retrofit_steps = real_retrofit
        for k, fn in real_flash.items():
            setattr(fops, k, fn)
        if cpu_evals is not None and cpu_evals.poll() is None:
            cpu_evals.kill()
            cpu_evals.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    if checked is None:
        checked = reasoner_decode_keys(tf)
    if flash_checked is None:
        flash_checked = encdec_flash_keys(torch, reasoner_flash_cases(),
                                          device)
    if not seen <= set(checked):
        raise AssertionError(f"phase 5m launched the decode kernel at "
                             f"{sorted(seen - set(checked))}, not among phase"
                             f" 3's checked {sorted(checked)}")
    if not flash_seen <= set(flash_checked):
        raise AssertionError(f"phase 5m launched the flash kernels at "
                             f"{sorted(flash_seen - set(flash_checked))}, not "
                             "among phase 3's checked "
                             f"{sorted(flash_checked)}")
    log(f"phase 5m's decode launch shapes {sorted(seen)} and flash launch "
        f"shapes {sorted(flash_seen)}: each checked in phase 3")
    return {"launches": main, "flash": flash, "evals": evals, "rate": rate,
            "alpha": alpha}


def phase_reasoner_timing(torch, out, errs, flash_errs):
    """Phase 7's rows for 5m: the decode kernel at each evaluation's arena
    (vanilla's one lane, dms's four; G 2, Dh 16) with its launches in 5m,
    and fwd, dq and dkv at the retrofit student's shape (B 32, T 32, Dh 16
    run at 64; bound at Dh 16) with all of 5m's flash launches."""
    arch, _, max_len = reasoner_setup()
    gen = torch.Generator(device="cuda").manual_seed(95)
    rows = layout_rows(torch, gen, arch, reasoner_layouts(arch, max_len)[:2],
                       out["launches"], errs, tag=", 5m trained reasoner")
    name, kw = list(reasoner_flash_cases().items())[1]
    return rows + phase_flash_timing(
        torch, out["flash"], flash_errs[name], kw=kw,
        label=" (5m reasoner retrofit, T 32, Dh 16)")


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


# -- phase 7 ---------------------------------------------------------------


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


# (name, B*Hkv, G, Dh, P, block_p, cap) of the decode shapes that lost to
# SDPA before the tensor-core redesign, the main-path shape and granite's
SWEEP_SHAPES = (("main path", 8, 6, 128, 416, 16, None),
                ("recurrentgemma ring", 1, 10, 256, 2064, 16, None),
                ("gemma2 local ring", 16, 2, 256, 4112, 16, 50.0),
                ("seamless G 1", 64, 1, 64, 320, 16, None),
                ("chatglm3 G 16", 4, 16, 128, 336, 16, None),
                ("seamless dense mode", 64, 1, 64, 1024, 128, None),
                ("granite-moe-3b G 3", 16, 3, 64, 336, 16, None))


def decode_split_sweep(torch, parent=None, variants=None, shapes=SWEEP_SHAPES,
                       counts=(1, 2, 4, 8, 16)):
    """The decode kernel's time at each of ``shapes`` (every block listed)
    at every split count of ``counts`` and at ``ops.splits``' choice; with
    ``parent`` (the path of an earlier ``dms_decode.cu`` whose C interface
    lacks the split argument) that kernel's time beside it, in turns
    (parent, kernel, kernel, parent); with ``variants`` ({label: path of a
    ``dms_decode.cu`` with this interface}) each one's time at the same
    split count.  Prints one line a shape."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.dms_decode import ops
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}
    if parent is not None:
        fns["parent"] = _build.load(Path(parent)).dms_decode_fwd
        fns["parent"].argtypes = [ptr] * 11 + [i32] * 6 + [f32, i32, f32, i32,
                                                           ptr]
    for label, path in (variants or {}).items():
        fns[label] = _build.load(Path(path)).dms_decode_fwd
        fns[label].argtypes = [ptr] * 11 + [i32] * 6 + [f32, i32, f32, i32,
                                                        i32, ptr]
    for fn in fns.values():
        fn.restype = i32
    for name, bh, g, dh, p, bp, cap in shapes:
        gen = torch.Generator(device="cuda").manual_seed(bh * dh)
        q, k, v, valid, tbl, n = make_case(torch, gen, bh=bh, g=g, dh=dh, p=p,
                                           bp=bp, density=1.0)
        nb = tbl.shape[1]
        rule = ops.launch_splits(q, nb)

        def new(s=None):
            return ops._launch(q, k, v, valid, tbl, n, bp, cap, False,
                               nsplit=s)

        def other(label):
            def call():
                out = torch.empty_like(q)
                split = () if label == "parent" else (rule,)
                err = fns[label](
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    valid.data_ptr(), tbl.data_ptr(), n.data_ptr(),
                    out.data_ptr(), None, None, None, None, bh, g, dh, p, nb,
                    bp, float(dh ** -0.5), int(cap is not None),
                    float(cap or 0.0), 0, *split,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{label} decode kernel: CUDA error "
                                       f"{err}")
                return out
            return call

        saved = ops.launches
        parts = []
        if "parent" in fns:
            ref = other("parent")()
            torch.cuda.synchronize()
            err = (new().float() - ref.float()).abs().max().item()
            t_old = [time_cuda(torch, other("parent"))]
        t_rule = [time_cuda(torch, new), time_cuda(torch, new)]
        if "parent" in fns:
            t_old.append(time_cuda(torch, other("parent")))
            parts.append(f"parent {t_old[0]:.4f}/{t_old[1]:.4f} ms (max abs "
                         f"diff {err:.2e})")
        n0 = torch.zeros_like(n)
        floor = time_cuda(torch, lambda: ops._launch(q, k, v, valid, tbl, n0,
                                                     bp, cap, False))
        parts.append(f"rule S={rule} {t_rule[0]:.4f}/{t_rule[1]:.4f} ms "
                     f"(floor, n = 0: {floor:.4f})")
        for label in fns:
            if label != "parent":
                parts.append(f"{label} {time_cuda(torch, other(label)):.4f}")
        for s_ in counts:
            if s_ <= nb:
                parts.append(f"S={s_} {time_cuda(torch, lambda: new(s_)):.4f}")
        ops.launches = saved
        log(f"sweep: decode {name} (BH={bh}, G={g}, Dh={dh}, P={p}, "
            f"block_p={bp}, {nb} listed, ring "
            f"{ops.stages(g, dh, bp, nb, rule)} "
            f"stages): " + ", ".join(parts))


def log_method_floor(torch):
    """Print what ``time_cuda`` reads for one tiny kernel (a 4-byte
    ``zero_``): the floor under every time it reports."""
    tiny = torch.zeros(1, device="cuda")
    log(f"timing: the method's floor, one 4-byte zero_ kernel: "
        f"{time_cuda(torch, tiny.zero_):.4f} ms")


def decode_entry(torch, name, mode, operands, shape, launches, max_abs_err,
                 hkv=2, cap=None):
    """One decode-kernel row of the ``kernels`` line: the kernel (``mode``
    "fixed" or "shared") and its plain version timed on ``operands`` (rows
    of ``hkv`` kv heads a lane, logit softcap ``cap``), the bound, and SDPA
    over the dense per-row arenas ``dense`` = (k, v, valid) as the
    yardstick (for the shared pool, the dense view is built outside the
    timed call; SDPA takes no softcap)."""
    import torch.nn.functional as F
    from repro_torch.kernels.dms_decode import ops
    from repro_torch.kernels.dms_decode import ref
    bh, g, dh, p, bp = shape
    q, k, v, valid, tbl, n = operands["kernel"]
    shared = mode == "shared"
    plain = ref.dms_decode_plain_shared if shared else ref.dms_decode_plain
    saved = (ops.launches, ops.shared_launches)
    ms = time_cuda(torch, lambda: ops.decode_rows(q, k, v, valid, tbl, n, bp,
                                                  cap, shared_kv=shared))
    # the kernel's own floor: the same launch with no listed entry in any row
    n0 = torch.zeros_like(n)
    floor_ms = time_cuda(torch, lambda: ops.decode_rows(
        q, k, v, valid, tbl, n0, bp, cap, shared_kv=shared))
    ops.launches, ops.shared_launches = saved     # timing is not the path's
    plain_ms = time_cuda(torch, lambda: plain(q, k, v, valid, tbl, n, bp, cap))
    # yardstick only: one SDPA call over the whole arena with the bool mask
    kd, vd, vald = operands["dense"]
    b = bh // hkv
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
        f"{ops.launch_splits(q, tbl.shape[1])} splits a row (floor, n = 0 "
        f"on every row:"
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
        f"{ops.launch_splits(q, tbl.shape[1])} splits a row (floor, n = 0 "
        f"on every row:"
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
    T) additive tensor and K/V expanded to the query heads; with no DMS
    delay and no causality (the encoder) no mask at all, which is exactly
    the kernels' function.  The forward is
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
    mask = None
    if cfg.causal or cfg.dms_delay:
        live = (j <= i) if cfg.causal else torch.ones_like(i - j, dtype=bool)
        mask = torch.where(live, torch.where(i - j >= cfg.dms_delay, lsb, 0.0),
                           float("-inf")).repeat_interleave(g, dim=1).to(
                               qf.dtype)
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


def phase_flash_timing(torch, launches, errs, kw=MAIN_FLASH, label="",
                       kernels=("flash_fwd", "flash_dq", "flash_dkv")):
    """``kernels`` of fwd, dq and dkv at the shape ``kw`` (``flash_case``
    keywords; by default the retrofit shape: B 2, T 1024, Hq 12, Hkv 2, Dh
    128, bf16, relaxed α, delay 256): kernel, plain version, bound and the
    SDPA yardstick (which takes no softcap, and none where its backend
    refuses the shape).  ``label`` follows each row's kernel name."""
    from repro_torch.kernels.dms_attention import ops as fops
    from repro_torch.kernels.dms_attention import ref as fref
    kw = dict(kw, skip=False)                # the bound counts every pair
    dtype = getattr(torch, kw.pop("dtype"))
    qf, kf, vf, ls, hr, cfg, do = flash_case(torch, dtype=dtype, seed=99, **kw)
    b, t, hq, hkv, dh = kw["b"], kw["t"], kw["hq"], kw["hkv"], kw["dh"]
    out, lse = fops.flash_fwd(qf, kf, vf, ls, hr, cfg)
    delta = (do.float() * out.float()).sum(-1)
    fwd = lambda: fops.flash_fwd(qf, kf, vf, ls, hr, cfg)  # noqa: E731
    dq = lambda: fops.flash_dq(qf, kf, vf, ls, do, lse, delta, hr, cfg)  # noqa: E731
    dkv = lambda: fops.flash_dkv(qf, kf, vf, ls, do, lse, delta, hr, cfg)  # noqa: E731
    saved = dict(fops.launches)
    calls = {"flash_fwd": fwd, "flash_dq": dq, "flash_dkv": dkv}
    ms = {k: time_cuda(torch, calls[k]) for k in kernels}
    fops.launches.update(saved)           # timing launches are not the path's
    plain_calls = {
        "flash_fwd": lambda: fref.flash_fwd_plain(qf, kf, vf, ls, hr, cfg),
        "flash_dq": lambda: fref.flash_dq_plain(qf, kf, vf, ls, do, lse,
                                                delta, hr, cfg),
        "flash_dkv": lambda: fref.flash_dkv_plain(qf, kf, vf, ls, do, lse,
                                                  delta, hr, cfg),
    }
    plain = {k: time_cuda(torch, plain_calls[k]) for k in kernels}
    try:
        library = sdpa_times(torch, qf, kf, vf, ls, do, cfg, b=b)
    except RuntimeError as e:                # no SDPA backend takes it
        log(f"timing: SDPA at (B={b}, T={t}, Hq={hq}, Dh={dh}): {e}"[:300])
        library = dict.fromkeys(fops.launches)

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
        if name not in kernels:
            continue
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        entry = {
            "name": name + label, "route": "cuda",
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
        lib = ("none" if library[name] is None else f"{library[name]:.4f} ms "
               f"({'SDPA forward' if name == 'flash_fwd' else 'SDPA backward'}"
               f"{', no softcap' if cfg.logit_cap else ''})")
        log(f"timing: {name}{label} at (B={b}, T={t}, Hq={hq}, Hkv={hkv}, "
            f"Dh={dh}, bf16): kernel {ms[name]:.4f} ms, bound "
            f"{entry['bound_ms']:.5f} ms ({flops} flop, {moved} B), plain "
            f"{plain[name]:.4f} ms, library {lib}")
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
            "weights": phase_weights_kernels(
                torch, weights_cases(weights_shape))["main-path shape"]}
    errs["prefix"], prefix_checked = phase_prefix_kernels(torch, main_shape)
    layouts = qd_layouts(eval_len=320, req_len=(len(setup["prompts"][3])
                                                + setup["news"][3]),
                         trace_len=48 + 16)
    qd_errs, qd_checked, qd_timed = phase_quest_dmc_kernels(
        torch, shallow["arch"], layouts)
    flash_errs = phase_flash_kernels(torch)
    phase_flash_grads(torch)
    _, export_checked, prefill_err = phase_export_kernels(
        torch, export_decode_keys(arch))
    arch_keys = arch_decode_keys()
    _, arch_errs = check_decode_keys(torch, arch_keys, what="phase 5f",
                                     caps=arch_keys)
    arch_flash_err = check_flash_cases(torch, ARCH_FLASH)
    hybrid_keys = hybrid_decode_keys()
    _, hybrid_errs = check_decode_keys(torch, hybrid_keys, what="phase 5g",
                                       caps=hybrid_keys)
    encdec_keys = encdec_decode_keys()
    _, encdec_errs = check_decode_keys(torch, encdec_keys, what="phase 5h")
    cross = cross_key(get_arch(ENCDEC), ENCDEC_LANES, ENCDEC_FRAMES)
    encdec_errs[cross] = max(encdec_errs[cross], check_cross_dense(torch))
    flash_cases = encdec_flash_cases()
    encdec_flash_errs = check_encdec_flash(torch, flash_cases)
    dh256_keys = dh256_decode_keys()
    check_decode_keys(torch, dh256_keys, what="phase 5i", caps=dh256_keys)
    dh256_flash_errs = flash_vs_plain(torch, dh256_flash_cases(),
                                      every_twice=True)
    paper_keys = paper_decode_keys()
    _, paper_errs = check_decode_keys(torch, paper_keys, what="phase 5l")
    reasoner_keys = reasoner_decode_keys()
    _, reasoner_errs = check_decode_keys(torch, reasoner_keys,
                                         what="phase 5m")
    reasoner_flash = reasoner_flash_cases()
    reasoner_flash_errs = flash_vs_plain(torch, reasoner_flash)
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
    weighted = phase_weights_serve(torch, shallow, served)
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
    prefixed = phase_prefix_serve(torch, shallow, export_checked)
    lap("phase 5e")
    phase_audit(torch, shallow)
    lap("phase 5j")
    del shallow, setup["params"]
    torch.cuda.empty_cache()
    archs = phase_archs(torch, checked=set(arch_keys))
    lap("phase 5f")
    hybrids = phase_hybrids(torch, checked=set(hybrid_keys))
    lap("phase 5g")
    encdec = phase_encdec(torch, checked=encdec_keys,
                          flash_checked=encdec_flash_keys(torch, flash_cases))
    lap("phase 5h")
    dh256 = phase_dh256(torch, checked=set(dh256_keys))
    lap("phase 5i")
    phase_mesh(torch, card)
    lap("phase 5k")
    paper = phase_paper(torch, checked=paper_keys)
    lap("phase 5l")
    reasoned = phase_reasoner(torch, checked=reasoner_keys,
                              flash_checked=encdec_flash_keys(torch,
                                                              reasoner_flash))
    lap("phase 5m")
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
    kernels.append(phase_prefill_timing(torch, prefixed["flash"], prefill_err))
    kernels += phase_arch_timing(torch, archs["launches"], arch_errs,
                                 archs["flash"], arch_flash_err)
    kernels += phase_hybrid_timing(torch, hybrids, hybrid_errs)
    kernels += phase_encdec_timing(torch, encdec, encdec_errs,
                                   encdec_flash_errs)
    kernels += phase_dh256_timing(torch, dh256, dh256_flash_errs)
    kernels += phase_paper_timing(torch, paper["launches"], paper_errs)
    kernels += phase_reasoner_timing(torch, reasoned, reasoner_errs,
                                     reasoner_flash_errs)
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
