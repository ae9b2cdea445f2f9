"""Multi-pod dry-run of the port: every (architecture × input shape) cell
on the production meshes, with nothing allocated.

For each cell a fake process group (``torch.distributed``'s ``fake``
backend: collectives are no-ops) of world size 256 (16×16) or 512
(2×16×16) stands for the cluster, and the production
:class:`~torch.distributed.device_mesh.DeviceMesh` lies over it.  This
process is rank 0.  Parameters, optimizer state, the batch and the decode
state are placed per :mod:`repro_torch.parallel.sharding` as DTensors whose
local shards are fake tensors (:class:`torch._subclasses.fake_tensor.
FakeTensorMode`): shapes and dtypes, no storage.  The cell's step then runs
eagerly with ``attn_impl="chunked"`` (the CUDA kernels take no fake
tensors), in two passes:

* **flops pass** (no gradient accumulation): the FLOPs of every local op
  this card runs and every collective it issues, (op, output bytes, group
  size), counted by :class:`DeviceCounter`, which reads the counters of
  :mod:`torch.utils.flop_counter` on local shapes (a plain
  ``FlopCounterMode`` sees DTensor ops, whose shapes are global);
  :class:`~torch.distributed.tensor.debug.CommDebugMode`'s counts ride
  along as a check.  They feed :mod:`repro_torch.launch.roofline`;
* **memory pass** (the reference's accumulation choice): the card's peak
  from :class:`torch.distributed._tools.mem_tracker.MemTracker`, the
  counterpart of XLA's ``memory_analysis()``, tested against 80 GB.

Argument bytes are the local shards' bytes.  A cell that fails is printed
and counted as failed, and the exit code is 1; no cell is skipped but by
:func:`cell_is_skipped`.

``--device cuda`` runs rank 0's part of the same program for real on the
card: real local shards (zeros), collectives that are no-ops on the fake
group, values that mean nothing.  The memory pass then also reports
``torch.cuda.max_memory_allocated`` beside the tracker's prediction: an
eager program has no buffer assignment, so its working set is measured by
running it.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen-r1-1.5b \\
        --shape decode_32k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # both meshes

Records go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ASSIGNED_ARCHS, get_arch
from repro_torch.core.config import SHAPES, KVPolicyConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import roofline, steps
from repro_torch.launch.mesh import (MeshAxes, dp_size, make_mesh,
                                     production_axes, tp_size)
from repro_torch.optim import adamw
from repro_torch.parallel import sharding

ARTIFACT_DIR = (Path(__file__).resolve().parents[3] / "artifacts"
                / "dryrun_torch")

_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-permute"}


class SkipCell(Exception):
    pass


def cell_is_skipped(arch, shape) -> Optional[str]:
    """The shape grid's skip rule: long_500k needs a sub-quadratic arch."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return ("long_500k skipped: pure full-attention arch (sub-quadratic "
                "required)")
    return None


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A default process group of ``world_size`` on the fake backend, this
    process as rank 0; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class DeviceCounter(TorchDispatchMode):
    """FLOPs and collectives of the local ops one card runs.

    DTensor ops are deferred to DTensor (``NotImplemented``), which runs
    them as local ops that come back through this mode; ops under a fake
    mode other than the one active on entry (DTensor's sharding
    propagation) are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.collectives: List[roofline.Collective] = []

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._entry_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._entry_mode:
            return out
        pkt = func._overloadpacket
        if pkt in self.registry:
            self.flops += int(self.registry[pkt](*args, **kwargs,
                                                 out_val=out))
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns.startswith("_c10d_functional") and name in _COLLECTIVES:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            group = _resolve_process_group(args[-1]).size()
            t = out if isinstance(out, torch.Tensor) else out[0]
            self.collectives.append((_COLLECTIVES[name],
                                     float(t.numel() * t.element_size()),
                                     group))
        return out


# ---------------------------------------------------------------------------
# placing a cell's inputs
# ---------------------------------------------------------------------------


def _local_shape(shape, placements, mesh):
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            if out[p.dim] % mesh.size(i):
                raise ValueError(f"uneven shard: {tuple(shape)} {placements}")
            out[p.dim] //= mesh.size(i)
    return out


def place(tree: Any, specs: Any, mesh, device: str) -> Any:
    """``tree``'s leaves (fake tensors) as DTensors on ``mesh`` per
    ``specs``: fake local shards on the CPU, zeroed real ones on the card."""
    from torch.distributed.tensor import DTensor

    flat = dict(sharding.leaves_with_path(specs))

    def one(path, leaf):
        pl = sharding.placements(flat[path], mesh)
        shape = _local_shape(leaf.shape, pl, mesh)
        if device == "cpu":
            with steps.fake_mode():
                local = torch.empty(shape, dtype=leaf.dtype)
        else:
            local = torch.zeros(shape, dtype=leaf.dtype, device=device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=leaf.shape,
                                  stride=torch.empty(leaf.shape,
                                                     device="meta").stride())

    return sharding.map_with_path(one, tree)


def _local_bytes(*trees) -> float:
    from torch.distributed.tensor import DTensor
    return float(sum((x.to_local() if isinstance(x, DTensor) else x).numel()
                     * x.element_size()
                     for t in trees for x in tree_leaves(t)))


def _accum_for(arch, shape) -> int:
    if shape.kind == "train" and shape.global_batch >= 8:
        # fine-grained MoE dispatch buffers scale with microbatch tokens
        moe = arch.mlp is not None and arch.mlp.moe is not None
        return 32 if moe else 8
    return 1


def build_cell(arch, shape, mesh, *, device: str,
               policy_kind: str = "vanilla", cr: float = 1.0,
               dms_train: bool = False, remat: bool = True,
               accum_steps: int = 1, tp: Optional[int] = None):
    """(run, args): ``run()`` runs the cell's step (``arch`` ×
    ``shape``, config objects) once on ``args``, the placed inputs."""
    pspec = steps.params_spec(arch, dtype=arch.dtype)
    p_sh = sharding.param_shardings(pspec, arch, mesh, tp=tp)
    params = place(pspec, p_sh, mesh, device)
    params.layer_salt = torch.zeros((arch.num_layers,), dtype=torch.int64,
                                    device=device)
    dp_only = tp == 1

    if shape.kind == "train":
        opt = steps.opt_state_spec(pspec)
        o_sh = sharding.opt_shardings(pspec, arch, mesh, tp=tp)
        opt = adamw.AdamWState(
            torch.zeros((), dtype=torch.int32),
            place(opt.mu, o_sh.mu, mesh, device),
            place(opt.nu, o_sh.nu, mesh, device),
            place(opt.master, o_sh.master, mesh, device))
        batch = steps.train_input_specs(arch, shape, accum_steps=accum_steps)
        batch = place(batch, sharding.batch_shardings(
            mesh, batch, microbatched=accum_steps > 1,
            batch_over_model=dp_only), mesh, device)
        fn = steps.make_train_step(arch, adamw.AdamWConfig(),
                                   dms_train=dms_train, remat=remat,
                                   accum_steps=accum_steps,
                                   attn_impl="chunked")
        return (lambda: fn(params, opt, batch, 0)), (params, opt, batch)
    if shape.kind == "prefill":
        batch = steps.prefill_input_specs(arch, shape)
        batch = place(batch, sharding.batch_shardings(
            mesh, batch, batch_over_model=dp_only), mesh, device)
        fn = steps.make_prefill_step(arch, dms=policy_kind == "dms",
                                     attn_impl="chunked")
        return (lambda: fn(params, batch)), (params, batch)
    policy = KVPolicyConfig(kind=policy_kind, cr=cr)
    batch = steps.decode_input_specs(arch, shape, policy)
    cache = batch.pop("cache")
    cache = place(cache, sharding.cache_shardings(
        cache, mesh, shape.global_batch, arch), mesh, device)
    batch = place(batch, sharding.batch_shardings(mesh, batch), mesh, device)
    fn = steps.make_serve_step(arch)
    return (lambda: fn(params, cache, batch)), (params, cache, batch)


def _run(run):
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        return run()


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
             policy_kind: str = "vanilla", cr: float = 1.0,
             dms_train: bool = False, remat: bool = True,
             accum_steps: Optional[int] = None, save: bool = True,
             verbose: bool = True, variant: str = "",
             memory_pass: bool = True, flops_pass: bool = True,
             tp: Optional[int] = None, device: str = "cpu",
             arch=None, shape=None, axes: Optional[MeshAxes] = None
             ) -> Dict[str, Any]:
    """Both passes of one cell; returns its record (and saves it).
    ``arch``/``shape`` (config objects) and ``axes`` (a mesh in place of
    the production one) let a test run a reduced cell."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode

    arch = arch or get_arch(arch_name)
    shape = shape or SHAPES[shape_name]
    skip = cell_is_skipped(arch, shape)
    if skip and policy_kind == "vanilla":
        raise SkipCell(skip)
    if accum_steps is None:
        accum_steps = _accum_for(arch, shape)
    axes = axes or production_axes(multi_pod=multi_pod)
    kw = dict(device=device, policy_kind=policy_kind, cr=cr,
              dms_train=dms_train, remat=remat, tp=tp)
    rec: Dict[str, Any] = {}
    with fake_process_group(axes.size()):
        mesh = make_mesh(axes, device)
        mesh_desc = "x".join(str(mesh.size(i)) for i in range(mesh.ndim))
        tag = f"[{arch_name} × {shape_name} × {mesh_desc}]"
        modeled = roofline.modeled_bytes_per_device(
            arch, shape, shape.kind, num_devices=mesh.size(),
            tp=(tp or tp_size(mesh)),
            dp=dp_size(mesh) * (tp_size(mesh) if tp == 1 else 1),
            policy=policy_kind, cr=cr, accum=accum_steps, remat=remat)

        def roof(dc, cdm, args, what):
            report = roofline.analyze(
                flops=float(dc.flops), collectives=dc.collectives,
                arch=arch_name, shape=shape_name, mesh_desc=mesh_desc,
                num_devices=mesh.size(), modeled=modeled,
                model_flops=roofline.model_flops_for(arch, shape, shape.kind),
                memory={"argument_bytes": _local_bytes(*args)})
            out = report.as_dict()
            out["comm_debug_counts"] = {
                str(k): v for k, v in cdm.get_comm_counts().items()}
            out["collectives_recorded"] = len(dc.collectives)
            out["roofline_from"] = what
            if verbose:
                print(f"  roofline ({what}): compute={report.compute_s:.4f}s "
                      f"memory={report.memory_model_s:.4f}s "
                      f"collective={report.collective_s:.4f}s -> "
                      f"{report.bottleneck}-bound; useful-FLOPs="
                      f"{report.useful_flops_ratio:.2f} util="
                      f"{report.hw_util:.3f}")
            return out

        if flops_pass:
            t0 = time.time()
            run, args = build_cell(arch, shape, mesh, accum_steps=1, **kw)
            with DeviceCounter() as dc, CommDebugMode() as cdm:
                _run(run)
            secs = time.time() - t0
            if verbose:
                print(f"{tag} flops pass in {secs:.1f}s: "
                      f"flops={dc.flops:.3e}/card, "
                      f"{len(dc.collectives)} collectives, "
                      f"args={_local_bytes(*args) / 1e9:.2f}GB")
            rec = roof(dc, cdm, args, "flops pass")
            rec["flops_pass_seconds"] = secs
            del run, args
        if memory_pass:
            t0 = time.time()
            run, args = build_cell(arch, shape, mesh,
                                   accum_steps=accum_steps, **kw)
            cuda = device != "cpu"
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            mt = MemTracker()
            mt.track_external(*[x for t in args for x in tree_leaves(t)])
            with mt, DeviceCounter() as dc, CommDebugMode() as cdm:
                _run(run)
            if not flops_pass:          # the roofline of this pass's run
                rec = roof(dc, cdm, args, f"memory pass, accum {accum_steps}")
            peak = mt.get_tracker_snapshot("peak")
            dev_key = next(iter(k for k in peak
                                if torch.device(k).type == mesh.device_type))
            fit = {"argument_bytes": _local_bytes(*args),
                   "peak_bytes": float(peak[dev_key]["Total"]),
                   "accum_steps": accum_steps,
                   "seconds": time.time() - t0}
            if cuda:
                torch.cuda.synchronize()
                fit["measured_peak_bytes"] = float(
                    torch.cuda.max_memory_allocated())
            fit["fits_hbm_80g"] = fit["peak_bytes"] < roofline.HBM_BYTES
            rec["memory_fit"] = fit
            del run, args
            if verbose:
                meas = (f" measured={fit['measured_peak_bytes'] / 1e9:.2f}GB"
                        if cuda else "")
                print(f"{tag} memory pass (accum={accum_steps}): "
                      f"peak={fit['peak_bytes'] / 1e9:.2f}GB/card{meas} "
                      f"fits_80GB={fit['fits_hbm_80g']} "
                      f"({fit['seconds']:.1f}s)")
    rec.update(arch=arch_name, shape=shape_name, mesh=mesh_desc,
               policy=policy_kind, cr=cr, variant=variant or policy_kind,
               multi_pod=multi_pod, device=device)
    if save:
        ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
        name = f"{arch_name}__{shape_name}__{mesh_desc}"
        if variant:
            name += f"__{variant}"
        (ARTIFACT_DIR / f"{name}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    from repro_torch.core.policy import available_policies

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every assigned arch × shape on both meshes")
    ap.add_argument("--policy", default="vanilla",
                    choices=list(available_policies()))
    ap.add_argument("--cr", type=float, default=1.0)
    ap.add_argument("--dms-train", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--variant", default="")
    ap.add_argument("--memory-only", action="store_true")
    ap.add_argument("--flops-only", action="store_true")
    ap.add_argument("--accum", type=int, default=0,
                    help="microbatch accumulation steps for the memory pass")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="cpu: fake tensors; cuda: rank 0's shard for real")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])
    t0 = time.time()
    results, failures, skips = [], [], []
    for arch_name in archs:
        for shape_name in shapes:
            for mp in meshes:
                try:
                    results.append(run_cell(
                        arch_name, shape_name, multi_pod=mp,
                        policy_kind=args.policy, cr=args.cr,
                        dms_train=args.dms_train, remat=not args.no_remat,
                        flops_pass=not args.memory_only,
                        memory_pass=not args.flops_only,
                        accum_steps=args.accum or None, variant=args.variant,
                        device=args.device))
                except SkipCell as e:
                    print(f"[{arch_name} × {shape_name} × mp={mp}] SKIP: {e}")
                    skips.append((arch_name, shape_name, mp, str(e)))
                except Exception as e:  # noqa: BLE001 — a cell's failure is its record
                    print(f"[{arch_name} × {shape_name} × mp={mp}] FAIL: {e}")
                    traceback.print_exc()
                    failures.append((arch_name, shape_name, mp, repr(e)))
                sys.stdout.flush()
    print(f"\n=== dry-run summary: {len(results)} ok, {len(skips)} skipped, "
          f"{len(failures)} failed in {time.time() - t0:.1f}s ===")
    for f in failures:
        print("  FAIL:", f[:3])
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
