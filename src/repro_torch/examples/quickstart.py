"""Quickstart: retrofit a small LM with DMS and serve it compressed.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
                                                              [--steps 60]

The paper end to end at the smoke size of qwen-r1-1.5b, on the card unless
``--device cpu``:
  1. pretrain a tiny LM,
  2. DMS-retrofit it (logit distillation, Gumbel-sigmoid relaxed eviction,
     CR schedule 1 → 4),
  3. serve with the slot-compacted cache and print the budget savings.
``--steps`` sets the steps of each of the two training stages.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_smoke
from repro_torch.core.config import DMSConfig, KVPolicyConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.serving.engine import Engine
from repro_torch.train.loop import TrainConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    arch = get_smoke("qwen-r1-1.5b")
    arch = dataclasses.replace(
        arch, dms=DMSConfig(enabled=True, window=8, target_cr=4.0,
                            steps_per_cr_unit=10))
    data = DataConfig(vocab_size=arch.vocab_size, seq_len=64, global_batch=8)
    log_every = max(1, args.steps // 3)

    print(f"== 1. pretrain (vanilla) on {device} ==")
    base = dataclasses.replace(arch, dms=DMSConfig(enabled=False))
    out = train(base, data, TrainConfig(total_steps=args.steps,
                                        log_every=log_every),
                log_fn=lambda m: print(f"  step {m['step']:3d} "
                                       f"ce={m['ce']:.3f}"),
                device=device)

    print("== 2. DMS retrofit (distill from the vanilla teacher) ==")
    out = train(arch, data,
                TrainConfig(total_steps=args.steps, log_every=log_every,
                            retrofit=True),
                params=out["params"],
                log_fn=lambda m: print(f"  step {m['step']:3d} "
                                       f"kd={m['loss_main']:.3f} "
                                       f"alpha={m['alpha_mean']:.2f} "
                                       f"CR(t)={m['cr_schedule']:.1f}"),
                device=device)

    print("== 3. serve compressed vs vanilla ==")
    prompts = np.random.default_rng(0).integers(
        3, arch.vocab_size, size=(2, 32)).astype(np.int32)
    for label, pol in [("vanilla", KVPolicyConfig(kind="vanilla")),
                       ("dms cr4", KVPolicyConfig(kind="dms", cr=4.0,
                                                  window=8))]:
        res = Engine(arch, out["params"], pol, device=device).generate(
            prompts, 24)
        print(f"  {label:9s} kv_reads={res.meter.kv_reads:9.0f} "
              f"peak_tokens={res.meter.peak_tokens:6.0f}")
    print("done — DMS trades a little accuracy for a large KV budget cut;")
    print("hyper-scaling spends that budget on more/longer chains "
          "(benchmarks/pareto.py)")


if __name__ == "__main__":
    main()
