"""The local regions of ``repro_torch.parallel.spmd`` hold their values
across real ranks: four CPU processes on a gloo group, a 2×2 mesh, the
smoke configs in fp32.

On each rank the model runs twice from the same seeded weights: placed on
the mesh per ``repro_torch.parallel.sharding`` (DTensors, real
collectives) and unsharded.  Compared: a DMS prefill's logits and KV
(heads over ``model``: the attention core's ``local_map``; the
vocab-parallel embedding and LM head), decode steps on a slot-split arena
(one kv head on two ``model`` shards: split-KV, the partial softmax
statistics reduced over ``model``; one lane: context parallelism over
``data``), one train step (the vocab-parallel cross entropy, ZeRO-sharded
AdamW state), and the prefill of the MoE (experts over ``model``, and
TP inside each of 3 experts) and SSD smoke configs (their local
regions).  Tolerance: 2e-5 relative to each output's largest
magnitude (fp32 sums in another order; the split softmax normalises
after its sum).
"""
import dataclasses

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
TOL = 2e-5


def _rel(got, want):
    from torch.distributed.tensor import DTensor
    if isinstance(got, DTensor):
        got = got.full_tensor()
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _fp32(name, **attn):
    from repro_torch.configs import get_smoke
    arch = dataclasses.replace(get_smoke(name), dtype="float32")
    if attn:
        arch = dataclasses.replace(arch, attn=dataclasses.replace(arch.attn,
                                                                  **attn))
    return arch


def _cases(mesh):
    """name → max relative error of the placed run against the plain."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding

    def place(params, arch):
        return sharding.distribute(
            params, sharding.param_shardings(params, arch, mesh), mesh)

    gen = torch.Generator().manual_seed(5)
    errs = {}
    with implicit_replication():
        for name in ("qwen-r1-1.5b", "granite-moe-3b-a800m", "granite-ffn",
                     "mamba2-2.7b"):
            if name == "granite-ffn":     # 3 experts on 2: TP inside each
                arch = _fp32("granite-moe-3b-a800m")
                mlp = arch.mlp
                arch = dataclasses.replace(arch, mlp=dataclasses.replace(
                    mlp, moe=dataclasses.replace(mlp.moe, num_experts=3)))
            else:
                arch = _fp32(name)
            params = tfm.init_model(arch, seed=1, device="cpu")
            toks = torch.randint(3, arch.vocab_size, (4, 24), generator=gen,
                                 dtype=torch.int32)
            step = steps.make_prefill_step(arch, dms=arch.attn is not None)
            if name == "mamba2-2.7b":
                step = lambda p, b: (tfm.model_forward(  # noqa: E731
                    p, b["tokens"], arch)[0], {})
            want = step(params, {"tokens": toks})
            got = step(place(params, arch), {"tokens": toks})
            errs[f"prefill {name}"] = max(
                _rel(g, w) for g, w in zip(tree_leaves(got),
                                           tree_leaves(want)))

        for what, kv, lanes in (("split-KV over model", 1, 4),
                                ("context over data", None, 1)):
            arch = _fp32("qwen-r1-1.5b", **({"num_kv_heads": kv} if kv
                                            else {}))
            params = tfm.init_model(arch, seed=2, device="cpu")
            placed = place(params, arch)
            for policy in ("vanilla", "dms"):
                cfg = KVPolicyConfig(kind=policy, cr=2.0, block_p=8)
                plain = tfm.init_decode_state(arch, lanes, 32, cfg,
                                              device="cpu")
                state = tfm.init_decode_state(arch, lanes, 32, cfg,
                                              device="cpu")
                specs = sharding.cache_shardings(state, mesh, lanes, arch)
                state = sharding.distribute(state, specs, mesh)
                err = 0.0
                for t in range(12):
                    tok = torch.randint(3, arch.vocab_size, (lanes, 1),
                                        generator=gen, dtype=torch.int32)
                    pos = torch.full((lanes,), t, dtype=torch.int32)
                    want, plain, _ = tfm.decode_step(params, tok, plain,
                                                     arch, pos)
                    got, state, _ = tfm.decode_step(placed, tok, state, arch,
                                                    pos)
                    err = max(err, _rel(got, want))
                errs[f"decode {policy} {what}"] = err

        arch = _fp32("qwen-r1-1.5b")
        cfg = adamw.AdamWConfig(warmup_steps=0)
        toks = torch.randint(3, arch.vocab_size, (4, 17), generator=gen,
                             dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        train = steps.make_train_step(arch, cfg, attn_impl="chunked")
        params = tfm.init_model(arch, seed=3, device="cpu",
                                dtype=torch.float32)
        want_p, _, want_m = train(params, adamw.init(params), batch, 0)
        params = tfm.init_model(arch, seed=3, device="cpu",
                                dtype=torch.float32)
        placed = place(params, arch)
        opt = adamw.init(placed)
        o_sh = sharding.opt_shardings(params, arch, mesh)
        opt = adamw.AdamWState(opt.step,
                               sharding.distribute(opt.mu, o_sh.mu, mesh),
                               sharding.distribute(opt.nu, o_sh.nu, mesh),
                               None)
        got_p, _, got_m = train(placed, opt, batch, 0)
        errs["train loss"] = _rel(got_m["loss"], want_m["loss"])
        errs["train params"] = max(
            _rel(g, w) for g, w in zip(tree_leaves(got_p),
                                       tree_leaves(want_p)))
    return errs


def _worker(rank, store_path, out_path):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import MeshAxes, make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh(MeshAxes((2, 2), ("data", "model")), device="cpu")
        errs = _cases(mesh)
    finally:
        dist.destroy_process_group()
    torch.save(errs, f"{out_path}.{rank}")


def test_local_regions_match_one_rank_over_four_gloo_ranks(tmp_path):
    out = str(tmp_path / "errs")
    mp.spawn(_worker, args=(str(tmp_path / "store"), out), nprocs=WORLD,
             join=True)
    for rank in range(WORLD):
        errs = torch.load(f"{out}.{rank}")
        print(rank, errs)
        assert len(errs) == 10
        bad = {k: v for k, v in errs.items() if not v <= TOL}
        assert not bad, (rank, bad)
