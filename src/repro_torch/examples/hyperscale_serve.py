"""Inference-time hyper-scaling demo (paper §5.1): same compute budget,
more reasoning chains via KV compression.

    PYTHONPATH=src python -m repro_torch.examples.hyperscale_serve
        [--device cpu] [--steps 200] [--n-eval 16]

Trains a tiny chain-arithmetic reasoner (:mod:`.reasoner`), retrofits DMS,
then compares accuracy at (roughly) matched KV-read budgets:
    vanilla  L-W-CR = 40-1-1
    DMS      L-W-CR = 40-4-4   (4 chains for the budget of ~1, majority vote)

The W=4 chains share ONE prefill: the engine forks the compressed cache
after prefilling the prompt once (``KVPolicy.fork_cache``), so the
prefill-phase KV reads are 4x lower than re-prefilling per chain, and the
meters report exactly that.  Runs on the card unless ``--device cpu``;
``--steps`` and ``--n-eval`` shorten the run.
"""
from __future__ import annotations

import argparse

from repro_torch.core.config import KVPolicyConfig
from repro_torch.core.hyperscale import ScalingConfig
from repro_torch.data import tasks
from repro_torch.device import resolve_device
from repro_torch.examples.reasoner import trained_reasoner
from repro_torch.serving.engine import Engine, evaluate_hyperscale


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--n-eval", type=int, default=16)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    arch, params, task, alpha, _ = trained_reasoner(steps=args.steps,
                                                    device=device)
    print(f"retrofitted reasoner ready on {device} (alpha={alpha:.2f})")
    prompts, answers = tasks.make_eval_set(task, args.n_eval)

    v_engine = Engine(arch, params, KVPolicyConfig(kind="vanilla"),
                      temperature=0.7, device=device)
    d_engine = Engine(arch, params,
                      KVPolicyConfig(kind="dms", cr=arch.dms.target_cr,
                                     window=arch.dms.window),
                      temperature=0.7, device=device)

    r1 = evaluate_hyperscale(v_engine, prompts, answers,
                             ScalingConfig(task.prompt_len + 8, 1, 1.0))
    r4 = evaluate_hyperscale(d_engine, prompts, answers,
                             ScalingConfig(task.prompt_len + 8, 4,
                                           arch.dms.target_cr))
    print(f"vanilla 1-chain : acc={r1['accuracy']:.2f} "
          f"kv_reads={r1['kv_reads']:.0f}")
    print(f"DMS 4-chain     : acc={r4['accuracy']:.2f} "
          f"kv_reads={r4['kv_reads']:.0f}")

    res = d_engine.hyperscale_generate(prompts[0],
                                       ScalingConfig(task.prompt_len + 8, 4,
                                                     arch.dms.target_cr))
    req = res.requests[0]
    print(f"shared prefill  : {req.prefill_meter.kv_reads:.0f} prefill reads "
          f"for 4 chains (one prefill, forked), "
          f"{req.decode_meter.kv_reads:.0f} decode")
    print("hyper-scaling: the compressed model affords W=4 voting chains at a "
          "comparable read budget — the paper's Figure 3 mechanism.")


if __name__ == "__main__":
    main()
