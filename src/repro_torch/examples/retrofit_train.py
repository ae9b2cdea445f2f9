"""End-to-end training example: pretrain a model with checkpointing and
auto-resume, then DMS-retrofit it.

    PYTHONPATH=src python -m repro_torch.examples.retrofit_train
        [--steps 300] [--big] [--device cpu]

``--big`` uses a ~100M-parameter llama-family config; the default is the
smoke llama32-1b, a smaller stand-in on the identical code path.  Runs on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_smoke
from repro_torch.core.config import (ArchConfig, AttentionConfig, DMSConfig,
                                     MLPConfig)
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.train.loop import TrainConfig, train


def build_arch(big: bool) -> ArchConfig:
    if big:   # ~100M params
        return ArchConfig(
            name="demo-100m", num_layers=8, d_model=768, vocab_size=32000,
            attn=AttentionConfig(num_heads=12, num_kv_heads=4, head_dim=64),
            mlp=MLPConfig(d_ff=2048, kind="swiglu"),
            tie_embeddings=True,
            dms=DMSConfig(enabled=True, window=32, target_cr=4.0,
                          steps_per_cr_unit=25))
    arch = get_smoke("llama32-1b")
    return dataclasses.replace(
        arch, dms=DMSConfig(enabled=True, window=8, target_cr=4.0,
                            steps_per_cr_unit=20))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    arch = build_arch(args.big)
    data = DataConfig(vocab_size=arch.vocab_size, seq_len=args.seq_len,
                      global_batch=16)
    with tempfile.TemporaryDirectory() as ckpt:
        print(f"== pretrain {arch.name} for {args.steps} steps on {device} "
              f"(ckpt+resume enabled) ==")
        base = dataclasses.replace(arch, dms=DMSConfig(enabled=False))
        out = train(base, data,
                    TrainConfig(total_steps=args.steps, log_every=25,
                                ckpt_every=100, ckpt_dir=ckpt),
                    log_fn=lambda m: print(f"  {m['step']:4d} "
                                           f"ce={m['ce']:.3f} "
                                           f"gnorm={m['grad_norm']:.2f}"),
                    device=device)
        print("== DMS retrofit ==")
        out2 = train(arch, data,
                     TrainConfig(total_steps=args.steps // 2, log_every=25,
                                 retrofit=True, phase1_steps=10),
                     params=out["params"],
                     log_fn=lambda m: print(
                         f"  {m['step']:4d} kd={m.get('loss_main', 0):.3f} "
                         f"alpha={m.get('alpha_mean', 0):.2f}"),
                     device=device)
        final = out2["history"][-1]
        print(f"final: alpha={final.get('alpha_mean', 0):.2f} "
              f"(target {1 - 1 / arch.dms.target_cr:.2f})")


if __name__ == "__main__":
    main()
