"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the fault-tolerant loop of :mod:`repro_torch.train.loop` on the card
(``--device cpu`` for the CPU).  ``--smoke`` (the default) trains the
reduced same-family config; ``--full`` the full-size one.  ``--retrofit``
distils a DMS student from its own vanilla copy; ``--use-kernel`` routes
attention through the hand-written flash-attention kernels.

    python -m repro_torch.launch.train --arch qwen-r1-1.5b --smoke --retrofit --device cpu
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_arch, get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--retrofit", action="store_true",
                    help="DMS retrofit (logit distillation) instead of pretrain")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    arch = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    data_cfg = DataConfig(vocab_size=arch.vocab_size, seq_len=args.seq_len,
                          global_batch=args.batch, seed=args.seed)
    cfg = TrainConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      retrofit=args.retrofit, use_kernel=args.use_kernel,
                      seed=args.seed)
    out = train(arch, data_cfg, cfg, log_fn=lambda m: print(json.dumps(m)),
                device=args.device)
    print(json.dumps({"final": out["history"][-1] if out["history"] else {},
                      "resumed_from": out["resumed_from"]}))


if __name__ == "__main__":
    main()
