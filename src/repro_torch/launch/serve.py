"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Boots the :class:`~repro_torch.serving.engine.Engine` with the smoke-scale
config of ``--arch`` (random weights from seed 0) and serves synthetic
requests through the continuous-batching scheduler, as the reference's
``repro.launch.serve`` does, with the same flags and the same output: one
JSON line per request (statuses, budget meters, ticks), a summary table,
then the run's, the SLO's, the pool's and the prefix cache's counters;
the last also holds ``import_degrades``, the hits prefilled cold because
the pool could not take their pages, which the reference does not count.
It runs on the card (``--device cpu`` for the CPU)::

    python -m repro_torch.launch.serve --policy dms --requests 4 \\
        --prefix-cache-mb 64 --shared-prefix 32 --stagger --device cpu
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_smoke
from repro_torch.core.config import KVPolicyConfig
from repro_torch.core.policy import available_policies
from repro_torch.models import transformer as tfm
from repro_torch.serving import workload
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request, SLOSpec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen-r1-1.5b")
    ap.add_argument("--policy", default="dms",
                    choices=list(available_policies()))
    ap.add_argument("--cr", type=float, default=4.0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--num-lanes", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="max prompt length; --stagger mixes lengths")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--width", type=int, default=1,
                    help="hyper-scaling chains per request (shared prefill)")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--stagger", action="store_true",
                    help="staggered arrivals + mixed prompt lengths")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--prefix-cache-mb", type=float, default=0.0,
                    help="cross-request radix prefix cache host budget "
                         "(0 = off)")
    ap.add_argument("--prefix-cache-device-mb", type=float, default=0.0,
                    help="device-resident hot-tier slab budget: hot hits "
                         "import device-to-device (zero host bytes), exports "
                         "defer host materialization to demotion (0 = cold "
                         "tier only)")
    ap.add_argument("--export-policy", default="always",
                    choices=["always", "second-miss"],
                    help="boundary export gating: 'always' exports every new "
                         "chunk boundary; 'second-miss' exports only "
                         "boundaries earlier traffic missed on (unshared "
                         "prompts export nothing)")
    ap.add_argument("--export-stride", type=int, default=1,
                    help="snapshot stride: offer only every Nth prefill-chunk "
                         "boundary for export (the full-prompt boundary is "
                         "always offered) — bounds hot-tier slot churn on "
                         "very long shared prefixes")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens to "
                         "every request (exercises the prefix cache)")
    ap.add_argument("--paged", action="store_true",
                    help="back KV caches with the shared paged block pool "
                         "(on-demand lane arenas, copy-on-write fork); lane "
                         "footprint tracks live tokens, not provisioned "
                         "capacity")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="shared pool size in block_p pages per cache "
                         "(default: lanes*heads*arena_blocks — never binds; "
                         "shrink to oversubscribe lanes against live "
                         "footprint, admission then gates on pool blocks)")
    ap.add_argument("--oversub", type=float, default=1.0,
                    help="admission oversubscription factor: reserve only "
                         "worst-case-demand/oversub pool blocks per request "
                         "(1.0 = sound admission, pool can never exhaust; "
                         ">1 admits more and lets preemption absorb real "
                         "divergence)")
    ap.add_argument("--on-pressure", default="preempt",
                    choices=["preempt", "ignore"],
                    help="pool-pressure response: 'preempt' snapshots and "
                         "requeues the youngest request at the tick boundary; "
                         "'ignore' keeps the seed behaviour (silent dropped "
                         "writes) for demonstration only")
    ap.add_argument("--deadline", type=int, default=None,
                    help="per-request deadline in scheduler ticks from "
                         "arrival; exceeded -> status 'timeout'")
    ap.add_argument("--arrival", default=None,
                    choices=["poisson", "burst"],
                    help="draw the trace from the seeded workload generator "
                         "(repro_torch.serving.workload) instead of --stagger: "
                         "'poisson' open-loop arrivals at --rate, 'burst' "
                         "on/off windows (--burst-on/--burst-off) at --rate "
                         "inside each burst; prompt lengths mix over "
                         "[prompt_len/2, prompt_len]")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="workload arrival rate in requests/tick "
                         "(--arrival modes)")
    ap.add_argument("--burst-on", type=int, default=4,
                    help="burst window length in ticks (--arrival burst)")
    ap.add_argument("--burst-off", type=int, default=8,
                    help="silence between bursts in ticks (--arrival burst)")
    ap.add_argument("--slo-ttft", type=int, default=None,
                    help="TTFT SLO in ticks (arrival -> first token); also "
                         "enables SLO-aware queue shedding")
    ap.add_argument("--slo-tpot", type=float, default=None,
                    help="TPOT SLO in decode ticks per post-first token "
                         "(measured; counts against goodput)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded queue: when the live backlog of arrived, "
                         "never-admitted requests exceeds this depth, the "
                         "newest arrivals are rejected (backpressure)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    arch = get_smoke(args.arch)
    params = tfm.init_model(arch, seed=0, device=args.device)
    policy = KVPolicyConfig(kind=args.policy, cr=args.cr, window=arch.dms.window,
                            paged=args.paged, pool_blocks=args.pool_blocks)
    engine = Engine(arch, params, policy, use_kernel=args.use_kernel,
                    chunk=args.chunk, device=args.device,
                    prefix_cache_mb=args.prefix_cache_mb,
                    prefix_cache_device_mb=args.prefix_cache_device_mb,
                    export_policy=args.export_policy,
                    export_stride=args.export_stride)

    rng = np.random.default_rng(0)
    shared = rng.integers(3, arch.vocab_size,
                          size=(args.shared_prefix,)).astype(np.int32)
    max_len = args.shared_prefix + args.prompt_len + args.max_new
    slo = None
    if (args.slo_ttft is not None or args.slo_tpot is not None
            or args.max_queue is not None):
        slo = SLOSpec(ttft_ticks=args.slo_ttft, tpot_ticks=args.slo_tpot,
                      max_queue=args.max_queue)
    sched = engine.scheduler(num_lanes=args.num_lanes, max_len=max_len,
                             on_pressure=args.on_pressure,
                             oversub=args.oversub, slo=slo)
    if args.arrival is not None:
        spec = workload.WorkloadSpec(
            vocab=arch.vocab_size,
            max_len=max_len - args.shared_prefix,
            prompt_len=(max(1, args.prompt_len // 2), args.prompt_len),
            max_new=(args.max_new, args.max_new),
            widths=(args.width,), eos_id=args.eos_id,
            deadline=args.deadline)
        if args.arrival == "poisson":
            reqs = workload.poisson_trace(0, args.requests, rate=args.rate,
                                          spec=spec)
        else:
            reqs = workload.burst_trace(0, args.requests, rate=args.rate,
                                        on_ticks=args.burst_on,
                                        off_ticks=args.burst_off, spec=spec)
        for r in reqs:
            sched.submit(Request(
                uid=r.uid, prompt=np.concatenate([shared, r.prompt]),
                max_new=r.max_new, width=r.width, eos_id=r.eos_id,
                arrival=r.arrival, deadline=r.deadline))
    else:
        for i in range(args.requests):
            plen = (int(rng.integers(args.prompt_len // 2,
                                     args.prompt_len + 1))
                    if args.stagger else args.prompt_len)
            own = rng.integers(3, arch.vocab_size,
                               size=(plen,)).astype(np.int32)
            sched.submit(Request(
                uid=i, prompt=np.concatenate([shared, own]),
                max_new=args.max_new, width=args.width,
                eos_id=args.eos_id, arrival=i if args.stagger else 0,
                deadline=args.deadline))
    results = sched.run()

    for r in sorted(results, key=lambda r: r.uid):
        print(json.dumps({
            "uid": r.uid, "chains": len(r.lengths),
            "status": r.status, "degraded": r.degraded,
            "preempts": r.preempt_count,
            "generated": r.lengths.tolist(),
            "kv_reads": r.meter.kv_reads,
            "kv_reads_prefill": r.prefill_meter.kv_reads,
            "kv_reads_saved": r.prefill_meter.kv_reads_saved,
            "kv_reads_decode": r.decode_meter.kv_reads,
            "peak_tokens": r.meter.peak_tokens,
            "peak_bytes": r.meter.peak_bytes,
            "ticks": [r.admitted_tick, r.finished_tick],
            "latency_ticks": r.latency_ticks,
            "ttft_ticks": r.ttft_ticks,
            "tpot_ticks": round(r.tpot_ticks, 4),
        }))
    # per-request TTFT/TPOT/status summary table (human-scan view of the
    # JSON rows above)
    print(f"# {'uid':>4} {'status':>9} {'deg':>4} {'ttft':>5} "
          f"{'tpot':>6} {'lat':>5}")
    for r in sorted(results, key=lambda r: r.uid):
        print(f"# {r.uid:>4} {r.status:>9} "
              f"{'y' if r.degraded else '-':>4} {r.ttft_ticks:>5} "
              f"{r.tpot_ticks:>6.2f} {r.latency_ticks:>5}")
    print(json.dumps({
        "policy": args.policy, "cr": args.cr,
        "requests": len(results), "lanes": args.num_lanes,
        "scheduler_ticks": sched.ticks, "scheduler_steps": sched.steps,
    }))
    print(json.dumps({"slo": sched.slo_stats()}))
    pool = sched.pool_stats()
    if pool is not None:
        print(json.dumps({"block_pool": pool}))
    if engine.prefix_cache is not None:
        print(json.dumps({"prefix_cache": sched.prefix_stats()}))


if __name__ == "__main__":
    main()
