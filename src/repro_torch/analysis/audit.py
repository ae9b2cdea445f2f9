"""``python -m repro_torch.analysis.audit [--device cuda|cpu]`` — the
decode-path gate of the port (the reference's ``repro.analysis.audit``).

Sweeps every registered KV policy × {ref, kernel} × {fixed, paged}:

* traffic lints over the op traces of one decode step, and in ref mode of
  the fork, reclaim, export and import programs (full-arena pads/casts,
  KV upcasts, whole-arena gathers in table mode, and — in kernel mode —
  the ``ref-fallback`` lint proving the step really reached the decode
  kernel);
* in kernel mode, the kernel events of the step against the attention
  layers (one each) and, on the card, against the growth of the decode
  kernel's launch counters;
* tree invariance of ``decode_step`` (leaf shapes, dtypes and devices
  stable across a step);
* the KVPolicy lifecycle contract per policy.

Then drives real mini scheduler traces under the retrace sentinel (exactly
one chunk signature) and the host-sync tripwire (no unsanctioned host
read): a mixed-length width-2-fork trace, a forced preempt→resume
round-trip, and a generated burst workload through the SLO overload
ladder (shed + width-throttle coverage — the control projections are host
arithmetic and must add zero syncs and signatures).

The default device is ``cuda``, for the CLI and for every public function
here (``device=None`` resolves through ``device.resolve_device``);
``--device cpu`` or ``device="cpu"`` runs the sweep on the CPU (the decode
kernel's plain version stands in for it), and asking for CUDA without a
card raises.  Exits nonzero on any gating finding.
Intentional exceptions are declared in ``ALLOW`` and ``PATH_ALLOW`` below,
each with its reason.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import contracts
from repro_torch.analysis.hostsync import HostSyncTripwire
from repro_torch.analysis.optrace import trace_ops
from repro_torch.analysis.passes import Finding, LintContext, gating, run_passes
from repro_torch.analysis.retrace import RetraceSentinel, scheduler_jits
from repro_torch.configs import get_smoke
from repro_torch.core import policy as policy_lib
from repro_torch.core.config import KVPolicyConfig
from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.kernels.dms_decode import ops as dkops
from repro_torch.models import transformer as tfm

B, MAX_LEN, BLOCK_P = 2, 32, 8

#: rule allowlist per entry-point kind, with the reason it is intentional.
#: (An allowlisted rule is reported as info and does not gate.)
ALLOW: Dict[str, Tuple[str, ...]] = {
    "decode": (),
    "fork": (
        # the FIXED-arena fork legitimately gathers whole per-lane arenas
        # (that is the copy the paged CoW fork removes), so it stays
        # visible as info, not a failure
        "arena-pad",
    ),
    "reclaim": (),
    # preempt-snapshot/resume entry points: a preemption must move ONE
    # lane's state, never a full arena — any arena-sized pad/cast/gather in
    # these programs means eviction copies scale with the pool, not the lane
    "export": (),
    "import": (),
}

#: allowances of one kind on one path ("ref" | "kernel"), with the reason.
#: The kernel path keeps none.
PATH_ALLOW: Dict[Tuple[str, str], Tuple[str, ...]] = {
    # the reference path is the parity path: it casts the bf16 K/V arena
    # to fp32 in every layer to give fp32 products of bf16 operands, which
    # is how it reproduces the reference's ``preferred_element_type=f32``
    # (no torch product takes bf16 operands to an fp32 result without that
    # copy on the CPU); the kernel path reads the arena in place
    ("decode", "ref"): ("kv-upcast",),
}


def tiny_arch():
    arch = get_smoke("qwen-r1-1.5b")
    return dataclasses.replace(
        arch, dms=dataclasses.replace(arch.dms, window=4, target_cr=4.0,
                                      steps_per_cr_unit=5))


def policy_cfg(policy: str, paged: bool,
               block_p: int = BLOCK_P) -> KVPolicyConfig:
    return KVPolicyConfig(kind=policy, cr=2.0, window=4, block_p=block_p,
                          paged=paged, quest_page_size=block_p,
                          quest_top_pages=2)


def arena_elems(state, per_layer: bool = False) -> int:
    """Smallest fully-provisioned KV arena in the state: any op at this many
    elements (or more) touches a whole arena.  A state stacks each
    position's layers on a leading axis; ``per_layer`` counts one layer's
    arena.  The decode step runs layer by layer, so one layer's arena is
    what a step's op would copy (the reference's stacked threshold is blind
    to that: its scan body sees one layer too); the lane programs map
    whole stacked leaves."""
    sizes = []
    for pc in policy_lib.iter_policy_caches(state):
        pool = getattr(pc.cache, "pool", None)
        arr = pool.k if pool is not None else pc.cache.k
        sizes.append(arr[0].numel() if per_layer else arr.numel())
    return min(sizes)


def _kernel_launches() -> int:
    return dkops.launches + dkops.shared_launches + dkops.weights_launches


@dataclasses.dataclass
class ComboReport:
    """One (policy, layout, path) combo: its findings, the ops one decode
    step dispatched, and in kernel mode its kernel events beside the
    attention layers and (on the card) the launch counters' growth."""

    tag: str
    findings: List[Finding]
    ops_per_step: int = 0
    kernel_events: int = 0
    launches: Optional[int] = None
    attn_layers: int = 0

    def line(self) -> str:
        n_gate = len(gating(self.findings))
        n_info = sum(f.severity == "info" for f in self.findings)
        kern = ""
        if self.tag.endswith("/kernel"):
            kern = (f"; kernel events {self.kernel_events} for "
                    f"{self.attn_layers} attention layers, launch counters "
                    + ("not on the card" if self.launches is None
                       else f"+{self.launches}"))
        return (f"audited {self.tag}: {n_gate} gating, {n_info} allowlisted "
                f"(info), {self.ops_per_step} ops recorded per step{kern}")


def attn_layers(arch) -> int:
    return arch.num_superblocks * sum(kind in ("attn", "attn_local")
                                      for kind in arch.layer_pattern)


def audit_combo(arch, params, policy: str, paged: bool, use_kernel: bool, *,
                lanes: int = B, max_len: int = MAX_LEN,
                block_p: int = BLOCK_P, device=None,
                step: Optional[Callable] = None) -> ComboReport:
    """Traffic lints for one (policy, layout, path) combo.  ``step``
    replaces ``tfm.decode_step`` (a planted fault)."""
    device = resolve_device(device)
    step = step or tfm.decode_step
    cfg = policy_cfg(policy, paged, block_p)
    state = tfm.init_decode_state(arch, lanes, max_len, cfg, device=device)
    path = "kernel" if use_kernel else "ref"
    tag = f"{policy}/{'paged' if paged else 'fixed'}/{path}"
    dev = dict(device=device)
    tok = torch.zeros((lanes, 1), dtype=torch.int32, **dev)
    pos = torch.zeros((lanes,), dtype=torch.int32, **dev)
    act = torch.ones((lanes,), dtype=torch.bool, **dev)
    src = torch.zeros((lanes,), dtype=torch.int32, **dev)
    mask = torch.zeros((lanes,), dtype=torch.bool, **dev)
    report = ComboReport(tag, [], attn_layers=attn_layers(arch))

    def lint(kind: str, fn, *args, table_mode: bool = False,
             per_layer: bool = False):
        trace = trace_ops(fn, *args)
        ctx = LintContext(arena_elems=arena_elems(state, per_layer),
                          table_mode=table_mode,
                          allow=ALLOW.get(kind, ())
                          + PATH_ALLOW.get((kind, path), ()),
                          vocab=arch.padded_vocab)
        report.findings.extend(run_passes(trace, ctx, path=f"{tag}/{kind}"))
        return trace

    before = _kernel_launches()
    trace = lint("decode",
                 lambda s: step(params, tok, s, arch, pos,
                                use_kernel=use_kernel, active=act),
                 contracts.copy_tree(state), table_mode=use_kernel, per_layer=True)
    report.ops_per_step = len(trace.events)
    if use_kernel:
        report.kernel_events = len(trace.kernel_events)
        want = report.attn_layers
        if device.type == "cuda":
            torch.cuda.synchronize()
            report.launches = _kernel_launches() - before
        got = {report.kernel_events} | (
            set() if report.launches is None else {report.launches})
        if got != {want}:
            report.findings.append(Finding(
                "error", "kernel-launch",
                f"{report.kernel_events} kernel events and launch counters "
                f"+{report.launches} for {want} attention layers (one "
                "launch per attention layer per step)", path=f"{tag}/decode"))
    else:              # fork/reclaim/export/import/tree: kernel-independent
        lint("fork", tfm.gather_lanes, contracts.copy_tree(state), src)
        fresh = tfm.init_decode_state(arch, lanes, max_len, cfg, device=device)
        lint("reclaim", tfm.reclaim_lanes, contracts.copy_tree(state), mask, fresh)
        # preempt snapshot/resume programs (scheduler._preempt/_resume)
        export = lint("export", tfm.export_lane_state, contracts.copy_tree(state), 0)
        snap = tree_map(torch.zeros_like, export.result)
        lint("import", tfm.import_lane_state, contracts.copy_tree(state), snap, 0)
        report.findings.extend(contracts.check_tree_invariance(
            lambda s: step(params, tok, s, arch, pos, active=act)[1],
            state, path=f"{tag}/decode "))
    return report


def audit_contracts(arch, policy: str, paged: bool, *,
                    lanes: int = B, max_len: int = MAX_LEN,
                    block_p: int = BLOCK_P, device=None) -> List[Finding]:
    cfg = policy_cfg(policy, paged, block_p)
    findings = contracts.check_policy_lifecycle(
        policy, arch, cfg, batch=lanes, max_len=max_len,
        device=resolve_device(device))
    return [dataclasses.replace(
        f, path=f"{policy}/{'paged' if paged else 'fixed'} {f.path}")
        for f in findings]


def _engine(arch, params, paged, use_kernel, device):
    from repro_torch.serving.engine import Engine
    return Engine(arch, params, policy_cfg("dms", paged), chunk=4,
                  use_kernel=use_kernel, device=resolve_device(device))


def _run_guarded(sched, tag, exact, budget):
    """Run ``sched`` under the retrace sentinel and the host-sync
    tripwire; returns (results, findings, tripwire)."""
    with RetraceSentinel(scheduler_jits(sched), exact=exact,
                         budget=budget) as sentinel, \
            HostSyncTripwire() as tripwire:
        results = sched.run()
    findings = [dataclasses.replace(f, path=f"{tag}:{f.path}")
                for f in sentinel.findings() + tripwire.violations()]
    return results, findings, tripwire


def audit_scheduler(arch, params, paged: bool, *, use_kernel: bool = True,
                    device=None, lanes: int = 3,
                    max_len: int = MAX_LEN) -> List[Finding]:
    """Drive a real mini trace under the retrace sentinel + host-sync
    tripwire: mixed prompt lengths, a width-2 fork, budget exhaustion."""
    from repro_torch.serving.scheduler import Request

    sched = _engine(arch, params, paged, use_kernel, device).scheduler(
        num_lanes=lanes, max_len=max_len)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 50, size=n).astype(np.int32)
               for n in (3, 7, 5)]
    sched.submit(Request(uid=0, prompt=prompts[0], max_new=4))
    sched.submit(Request(uid=1, prompt=prompts[1], max_new=3, width=2,
                         arrival=1))
    sched.submit(Request(uid=2, prompt=prompts[2], max_new=4, arrival=3))
    tag = f"scheduler/{'paged' if paged else 'fixed'}"
    results, findings, _ = _run_guarded(
        sched, tag, {"chunk": 1},
        {"gather": 1, "reset": 1, "export": 0, "import": 0})
    if len(results) != 3:
        findings.append(Finding("error", "scheduler",
                                f"expected 3 results, got {len(results)}",
                                path=tag))
    return findings


def audit_preempt(arch, params, paged: bool, *, use_kernel: bool = True,
                  device=None, lanes: int = 2,
                  max_len: int = MAX_LEN) -> List[Finding]:
    """Drive a forced preempt→resume round-trip under the retrace sentinel
    and host-sync tripwire: the snapshot/resume path must run its export
    and import programs at one signature each, never add a chunk
    signature, and read device state only at sanctioned boundaries
    (``preempt-snapshot`` / ``pool-pressure`` / ``tick-boundary``)."""
    from repro_torch.serving.faults import Fault, FaultPlan
    from repro_torch.serving.scheduler import Request

    plan = FaultPlan([Fault("preempt", tick=1, lane=0)])
    sched = _engine(arch, params, paged, use_kernel, device).scheduler(
        num_lanes=lanes, max_len=max_len, faults=plan)
    prompt = np.random.default_rng(1).integers(
        1, 50, size=7).astype(np.int32)
    sched.submit(Request(uid=0, prompt=prompt, max_new=4))
    tag = f"preempt/{'paged' if paged else 'fixed'}"
    results, findings, _ = _run_guarded(
        sched, tag, {"chunk": 1},
        {"gather": 0, "reset": 1, "export": 1, "import": 1})
    if (len(results) != 1 or results[0].status != "ok"
            or results[0].preempt_count != 1):
        findings.append(Finding(
            "error", "scheduler",
            f"expected 1 ok result with preempt_count=1, got "
            f"{[(r.status, r.preempt_count) for r in results]}", path=tag))
    return findings


def audit_slo(arch, params, paged: bool, *, use_kernel: bool = True,
              device=None, lanes: int = 2,
              max_len: int = MAX_LEN) -> List[Finding]:
    """Drive a generated burst workload through the SLO overload ladder
    under the retrace sentinel + host-sync tripwire: the shed and
    width-throttle projections are pure host arithmetic, so an overloaded
    controlled trace must run the chunk step at one signature and add ZERO
    host reads beyond the sanctioned tick boundary."""
    from repro_torch.serving import workload
    from repro_torch.serving.scheduler import SLOSpec

    spec = workload.WorkloadSpec(
        vocab=50, max_len=max_len, prompt_len=(6, 10), max_new=(3, 6),
        widths=(1, 2), deadline=10)
    reqs = workload.burst_trace(0, 8, rate=2.0, on_ticks=3, off_ticks=5,
                                spec=spec)
    slo = SLOSpec(ttft_ticks=5, max_queue=4, min_width=1, cooldown_ticks=4)
    sched = _engine(arch, params, paged, use_kernel, device).scheduler(
        num_lanes=lanes, max_len=max_len, slo=slo)
    for r in reqs:
        sched.submit(r)
    tag = f"slo/{'paged' if paged else 'fixed'}"
    results, findings, _ = _run_guarded(
        sched, tag, {"chunk": 1},
        {"gather": 1, "reset": 1, "export": 0, "import": 0})
    life = sched.lifecycle_stats()
    # the trace must actually exercise the ladder, or the sync/signature
    # guarantee above is vacuous
    if len(results) != len(reqs) or life["shed"] < 1 \
            or life["degraded"] < 1:
        findings.append(Finding(
            "error", "scheduler",
            f"SLO trace lost coverage: {len(results)}/{len(reqs)} results, "
            f"shed={life['shed']}, degraded={life['degraded']} "
            "(need >=1 each)", path=tag))
    return findings


TRACES = (("scheduler", audit_scheduler), ("preempt", audit_preempt),
          ("slo", audit_slo))


def sweep(arch, params, *, device=None, policies=None, lanes: int = B,
          max_len: int = MAX_LEN, block_p: int = BLOCK_P,
          traces: bool = True, trace_lanes: Optional[int] = None,
          log: Callable[[str], None] = print
          ) -> Tuple[List[Finding], List[ComboReport]]:
    """The whole audit: every policy × {ref, kernel} × {fixed, paged}, the
    lifecycle contracts, then (``traces``) the scheduler, preempt and SLO
    traces, fixed and paged, on ``trace_lanes`` lanes each (default: the
    reference's 3, 2 and 2).  Logs one line a combo and a trace."""
    device = resolve_device(device)
    policies = tuple(policies or policy_lib.available_policies())
    kw = dict(lanes=lanes, max_len=max_len, block_p=block_p, device=device)
    findings: List[Finding] = []
    reports: List[ComboReport] = []
    for policy in policies:
        for paged in (False, True):
            for use_kernel in (False, True):
                rep = audit_combo(arch, params, policy, paged, use_kernel,
                                  **kw)
                reports.append(rep)
                findings += rep.findings
                log("  " + rep.line())
            findings += audit_contracts(arch, policy, paged, **kw)
    if traces:
        for paged in (False, True):
            for name, fn in TRACES:
                tkw = {} if trace_lanes is None else {"lanes": trace_lanes}
                got = fn(arch, params, paged, device=device, **tkw)
                findings += got
                log(f"  audited {name}/{'paged' if paged else 'fixed'}: "
                    f"{len(gating(got))} gating")
    return findings, reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--policies", default=None,
                    help="comma-separated subset (default: all registered)")
    ap.add_argument("--skip-scheduler", action="store_true",
                    help="op-trace/contract passes only (no traces)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print info-level (allowlisted) findings")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = tiny_arch()
    params = tfm.init_model(arch, seed=0, device=device)
    policies = (tuple(args.policies.split(","))
                if args.policies else policy_lib.available_policies())
    findings, _ = sweep(arch, params, device=device, policies=policies,
                        traces=not args.skip_scheduler,
                        log=lambda s: print(s, flush=True))
    bad = gating(findings)
    for f in (findings if args.verbose else bad):
        print(f)
    n_info = sum(1 for f in findings if f.severity == "info")
    print(f"audit: {len(bad)} gating finding(s), {n_info} allowlisted, "
          f"{len(policies)} policies x {{ref,kernel}} x {{fixed,paged}}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
