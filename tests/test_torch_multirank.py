"""The port's checkpoint manager and int8 gradient reduction across real
ranks: four CPU processes on a gloo group, a 2×2 mesh.

Checkpoint: the smoke qwen-r1-1.5b's bf16 params placed on the mesh
(DTensors per ``repro_torch.parallel.sharding``) are saved twice (step 3
without blocking, then step 5 blocking, keep-last 1) and restored onto the
mesh through ``restore(..., shardings=)``.  Every rank takes part in the
gathers, rank 0 alone writes (``np.save`` counted on each rank), one
``step_5`` directory with one manifest is left, and the restored leaves
equal the unsharded weights bit for bit.

Compressed reduction: each rank's own gradient tree and residual go
through ``all_reduce_compressed``; the mean must equal, bit for bit, the
mean in rank order of the reference's ``compress_grads`` results
dequantised (fp32 sums in the same order), and each rank's residual the
reference's for that rank.  The workers import no JAX: the reference's
side runs in the test process.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _grads(rank):
    """Rank ``rank``'s gradient tree (numpy fp32; ``b`` is served to both
    sides in bf16) and its residual."""
    rng = np.random.default_rng(100 + rank)
    scale = rng.uniform(0.01, 100.0)
    tree = {"w": (rng.normal(size=(16, 24)) * scale).astype(np.float32),
            "b": (rng.normal(size=(7,)) * scale).astype(np.float32)}
    res = {k: np.full(v.shape, 1e-3 * (rank + 1), np.float32)
           for k, v in tree.items()}
    return tree, res


def _checkpoint(rank, mesh, directory):
    """Save the placed smoke params twice, restore them onto the mesh;
    returns what this rank saw."""
    from pathlib import Path
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import manager
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding

    arch = get_smoke("qwen-r1-1.5b")
    params = dict(tfm.init_model(arch, seed=0, device="cpu"))
    placed = sharding.distribute(
        params, sharding.param_shardings(params, arch, mesh), mesh)
    writes = []
    real_save = manager.np.save
    manager.np.save = lambda path, arr: (writes.append(str(path)),
                                         real_save(path, arr))
    try:
        mgr = manager.CheckpointManager(directory, keep_last=1)
        mgr.save(3, placed, blocking=False)
        mgr.save(5, placed, extra={"rank": rank})
        mgr.wait()
    finally:
        manager.np.save = real_save
    root = Path(directory)
    listing = sorted(p.name for p in root.iterdir())
    manifests = sorted(str(p.relative_to(root))
                       for p in root.rglob("manifest.json"))
    specs = sharding.map_with_path(
        lambda _, x: (x.device_mesh, tuple(x.placements)), placed)
    restored, step, extra = mgr.restore(placed, shardings=specs)
    unequal = [str(path) for (path, got), (_, want) in zip(
        sharding.leaves_with_path(restored), sharding.leaves_with_path(params))
        if not (isinstance(got, DTensor) and got.dtype == want.dtype
                and torch.equal(got.full_tensor(), want))]
    leaves = len(sharding.leaves_with_path(params))
    return {"writes": len(writes), "listing": listing, "manifests": manifests,
            "step": step, "extra": extra, "unequal": unequal,
            "leaves": leaves}


def _worker(rank, store_path, directory, out_path):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import MeshAxes, make_mesh
    from repro_torch.optim import compress
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh(MeshAxes((2, 2), ("data", "model")), device="cpu")
        out = {"checkpoint": _checkpoint(rank, mesh, directory)}
        tree, res = _grads(rank)
        grads = {"w": torch.tensor(tree["w"]),
                 "b": torch.tensor(tree["b"]).to(torch.bfloat16)}
        mean, new_res = compress.all_reduce_compressed(
            grads, residual={k: torch.tensor(v) for k, v in res.items()})
        out["mean"] = {k: v.numpy() for k, v in mean.items()}
        out["residual"] = {k: v.numpy() for k, v in new_res.items()}
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{out_path}.{rank}")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the four ranks returned (one spawn for both tests)."""
    tmp = tmp_path_factory.mktemp("multirank")
    out = str(tmp / "out")
    mp.spawn(_worker, args=(str(tmp / "store"), str(tmp / "ckpt"), out),
             nprocs=WORLD, join=True)
    return [torch.load(f"{out}.{rank}", weights_only=False)
            for rank in range(WORLD)]


def test_checkpoint_one_writer_over_four_gloo_ranks(ranks):
    for rank, got in enumerate(ranks):
        ck = got["checkpoint"]
        # rank 0 writes each leaf of both steps; the others write nothing
        assert ck["writes"] == (2 * ck["leaves"] if rank == 0 else 0), rank
        assert ck["listing"] == ["step_5"], (rank, ck["listing"])
        assert ck["manifests"] == ["step_5/manifest.json"], rank
        assert ck["step"] == 5 and ck["extra"] == {"rank": 0}, rank
        assert not ck["unequal"], (rank, ck["unequal"])


def test_all_reduce_compressed_is_the_reference_mean_over_four_ranks(ranks):
    import jax.numpy as jnp
    from repro.optim import compress as jcompress
    total, residuals = None, []
    for rank in range(WORLD):
        tree, res = _grads(rank)
        jtree = {"w": jnp.asarray(tree["w"]),
                 "b": jnp.asarray(tree["b"]).astype(jnp.bfloat16)}
        q, s, r = jcompress.compress_grads(
            jtree, {k: jnp.asarray(v) for k, v in res.items()})
        deq = {k: np.asarray(v) for k, v in
               jcompress.decompress_grads(q, s).items()}
        total = deq if total is None else {k: total[k] + deq[k] for k in deq}
        residuals.append({k: np.asarray(v) for k, v in r.items()})
    want = {k: v / np.float32(WORLD) for k, v in total.items()}
    for rank, got in enumerate(ranks):
        for k in want:
            assert got["mean"][k].dtype == np.float32
            np.testing.assert_array_equal(got["mean"][k], want[k],
                                          err_msg=f"rank {rank} mean {k}")
            np.testing.assert_array_equal(got["residual"][k],
                                          residuals[rank][k],
                                          err_msg=f"rank {rank} residual {k}")
