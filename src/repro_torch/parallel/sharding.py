"""Logical-axis sharding rules: DP / TP / EP / sequence (context)
parallelism, and their DTensor placements.

The reference's ``repro.parallel.sharding`` on the port's trees.  A *spec*
is the reference's ``PartitionSpec`` as a plain tuple, one entry per tensor
dim: ``None`` (replicated), a mesh-dim name, or a tuple of names (the dim
split over several mesh dims, major first), so that a spec compares equal
to ``tuple(P)`` of the reference's.  :func:`placements` turns a spec into
DTensor placements on a :class:`~torch.distributed.device_mesh.DeviceMesh`
and :func:`distribute` places a whole tree.  The rules read only the mesh's
dim names and sizes: a :class:`~repro_torch.launch.mesh.MeshAxes` serves
where no process group exists.

All rules are *adaptive*: a dimension goes on the ``model`` dim only when
it divides evenly (no padded shards; MoE expert counts that do not divide
fall back to TP inside each expert).

Conventions (Megatron-style TP on the fused projection column dims):
  * embed (V, D)             → (model, None)   vocab-parallel
  * attn wq/wk/wv (D, H·Dh)  → (None, model)   column-parallel (fallback: repl.)
  * attn wo (H·Dh, D)        → (model, None)
  * mlp w_gate/up (D, F)     → (None, model);  w_down (F, D) → (model, None)
  * MoE experts (E, D, F)    → (model, None, None)   expert-parallel
  * SSD / RG-LRU channel dims → model (head-parallel recurrence)
  * batch dims               → ("pod", "data") (or ("data",) single-pod)
  * long-context decode (B=1) → KV length on "data" (context parallelism)

Stacked-superblock leading dims are never sharded.  The column rule shards
the fused H·Dh columns whenever they divide, which can cut a head (qwen's
12 heads of 128 on 16 shards: 96 columns each); the attention core then
gathers whole heads first (:mod:`repro_torch.parallel.spmd`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.launch.mesh import axis_size, batch_axes

Spec = Tuple[Any, ...]
Path = Tuple[str, ...]


def _div(n: int, by: int) -> bool:
    return n % by == 0 and n >= by


def _model_if(dim: int, tp: int, allow_uneven: bool = False) -> Optional[str]:
    if _div(dim, tp) or (allow_uneven and dim > 1):
        return "model"
    return None


def _entry(axes: Tuple[str, ...]):
    """A spec entry for ``axes``: one name alone, as ``PartitionSpec``
    normalises a 1-tuple."""
    return axes[0] if len(axes) == 1 else axes


def _size(mesh, axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


# ---------------------------------------------------------------------------
# trees with paths
# ---------------------------------------------------------------------------


def is_spec(x: Any) -> bool:
    """A spec leaf: a plain tuple of None / names / tuples of names."""
    return (type(x) is tuple
            and all(e is None or isinstance(e, str)
                    or (type(e) is tuple and all(isinstance(n, str) for n in e))
                    for e in x))


def _children(node: Any):
    """(key, child) pairs of a container node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)
                if not f.metadata.get("static")]
    return None


def _rebuild(node: Any, values: dict) -> Any:
    if isinstance(node, dict):
        out = type(node)((k, values[str(k)]) for k in node)
        if hasattr(node, "__dict__"):               # Params' layer salts
            out.__dict__.update(node.__dict__)
        return out
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(values[f] for f in node._fields))
    return dataclasses.replace(node, **values)


def map_with_path(fn: Callable[[Path, Any], Any], tree: Any,
                  path: Path = ()) -> Any:
    """``tree`` with every leaf (a tensor or a spec) replaced by ``fn(path,
    leaf)``; ``path`` holds dict keys and field names, as the reference's
    key paths do.  ``None`` stays ``None``."""
    if tree is None:
        return None
    kids = None if is_spec(tree) else _children(tree)
    if kids is None:
        return fn(path, tree)
    return _rebuild(tree, {k: map_with_path(fn, v, path + (k,))
                           for k, v in kids})


def leaves_with_path(tree: Any) -> List[Tuple[Path, Any]]:
    out: List[Tuple[Path, Any]] = []
    map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_spec(path: Path, shape: Tuple[int, ...], arch, tp: int) -> Spec:
    """Spec for one parameter identified by its tree path."""
    name = path[-1]
    inside_blocks = "blocks" in path or "enc_blocks" in path
    lead = (None,) if inside_blocks else ()         # stacked superblock dim

    def spec(*dims):
        return (*lead, *dims)

    if name == "embed":
        return (_model_if(shape[0], tp), None)
    if name == "lm_head":
        return (None, _model_if(shape[1], tp))
    if name in ("scale", "bias", "a_log", "d_skip", "dt_bias", "lam",
                "norm_scale", "b_gate_r", "b_gate_i",
                "conv_x_b", "conv_b_b", "conv_c_b", "conv_b"):
        # small vectors: the channel dim when it divides (ssd/rglru), else repl.
        if name in ("norm_scale", "lam", "b_gate_r", "b_gate_i",
                    "a_log", "d_skip", "dt_bias"):
            return spec(_model_if(shape[-1], tp))
        return spec(*([None] * (len(shape) - len(lead))))
    if name in ("wq", "wk", "wv"):
        return spec(None, _model_if(shape[-1], tp))
    if name == "wo":
        return spec(_model_if(shape[-2], tp), None)
    if name in ("w_gate", "w_up", "w_down", "router"):
        moe = arch.mlp is not None and arch.mlp.moe is not None
        nd = len(shape) - len(lead)
        if moe and nd == 3:                          # (E, D, F) / (E, F, D)
            if shape[len(lead)] % tp == 0:           # expert parallelism
                return spec("model", None, None)
            # E not divisible (40 experts on 16): Megatron TP inside each
            # expert instead — shard the ffn dim
            if name == "w_down":
                return spec(None, _model_if(shape[-2], tp), None)
            return spec(None, None, _model_if(shape[-1], tp))
        if name == "router":
            return spec(None, None)
        if name == "w_down":
            return spec(_model_if(shape[-2], tp), None)
        return spec(None, _model_if(shape[-1], tp))
    if name in ("w_z", "w_x", "w_b", "w_c", "w_dt", "conv_x_w", "conv_b_w",
                "conv_c_w", "conv_w", "w_y", "w_gate_r", "w_gate_i"):
        return spec(None, _model_if(shape[-1], tp))
    if name == "w_out":
        return spec(_model_if(shape[-2], tp), None)
    return spec(*([None] * (len(shape) - len(lead))))   # default: replicate


def param_shardings(params: Any, arch, mesh, tp: Optional[int] = None) -> Any:
    """Spec tree of ``params``.  ``tp`` overrides the tensor-parallel degree:
    tp=1 turns the model dim into extra data parallelism (every parameter
    replicated)."""
    tp = axis_size(mesh, "model") if tp is None else tp
    return map_with_path(
        lambda path, leaf: (param_spec(path, tuple(leaf.shape), arch, tp)
                            if tp > 1 else (None,) * leaf.dim()), params)


# ---------------------------------------------------------------------------
# activations / batches
# ---------------------------------------------------------------------------


def data_spec(mesh, batch: int, extra_dims: int = 1,
              batch_over_model: bool = False) -> Spec:
    """Batch on the data dims when divisible, else replicated."""
    ba = batch_axes(mesh) + (("model",) if batch_over_model else ())
    lead = _entry(ba) if batch % _size(mesh, ba) == 0 else None
    return (lead, *([None] * extra_dims))


def batch_shardings(mesh, batch_tree: Any, microbatched: bool = False,
                    batch_over_model: bool = False) -> Any:
    """Batch dim on the data dims; microbatched inputs (K, B/K, ...) keep
    the accumulation dim K unsharded and B/K carries data parallelism.
    ``batch_over_model`` adds the model dim to the batch dims (tp=1 plan)."""
    def one(_, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        if microbatched and len(shape) >= 2:
            return (None, *data_spec(mesh, shape[1], len(shape) - 2,
                                     batch_over_model))
        return data_spec(mesh, shape[0], len(shape) - 1, batch_over_model)
    return map_with_path(one, batch_tree)


# ---------------------------------------------------------------------------
# KV / decode-state shardings
# ---------------------------------------------------------------------------


def cache_spec_with_rule(path: Path, shape: Tuple[int, ...], mesh,
                         batch: int, arch) -> Tuple[str, Spec]:
    """(rule name, spec) for one decode-state leaf (stacked over
    superblocks: dim 0).

    Layouts: k/v (L,B,H,P,Dh); slot metadata/masks (L,B,H,P); rings
    (L,B,H,w); per-lane lengths (L,B); ssd state (L,B,H,Dh,N); conv buffers
    (L,B,K-1,C); rglru h (L,B,W); paged pool pages (L,NPOOL,bp,Dh) with
    refcounts (L,NPOOL) and scalar counters (L,); page maps (L,B,H,NB).

    Every leaf the decode state can contain must hit a *named* rule here:
    :func:`repro_torch.analysis.contracts.check_sharding_coverage` (the
    audit) flags any leaf answered by the "fallback" rule, so adding cache
    state forces an explicit sharding decision instead of silent
    replication.
    """
    tp = axis_size(mesh, "model")
    ba = batch_axes(mesh)
    bspec = _entry(ba) if batch % _size(mesh, ba) == 0 else None
    name = path[-1] if path else ""
    nd = len(shape)

    # paged block-pool leaves: pages are *shared mutable state* across every
    # lane mapping them (CoW fork, event-masked writes), so they cannot ride
    # the batch dims — replicated until multi-device paged serving lands
    # (pages would shard over a pool dim with owner-aware routing).
    if "pool" in path:
        return "pool-replicated", (None,) * nd
    if nd <= 1:
        return "low-rank", (None,) * nd

    def slot_specs(h, p):
        """(head_spec, slot_spec): TP on heads when divisible; otherwise
        split-KV over 'model'; context parallelism over 'data' (or both) when
        the batch can't shard."""
        hspec = _model_if(h, tp)
        dsz = axis_size(mesh, "data")
        if bspec is None and hspec is None and _div(p, dsz * tp):
            return None, ("data", "model")
        if bspec is None and _div(p, dsz):
            return hspec, "data"
        if hspec is None and _div(p, tp):
            return None, "model"
        return hspec, None

    # block-table leaves: per-(lane, head) NB-sized index state — head-
    # sharded like the arena metadata they describe, entries replicated.
    # Matched by path so BlockTable.pos never falls into the arena-slot
    # "pos" rule below (its NB dim moves in lockstep with tbl/count).
    if "blocks" in path:
        if nd == 4:                        # count / tbl / pos: (L,B,H,NB)
            return "block-table", (None, bspec, _model_if(shape[2], tp), None)
        return "block-table", (None, bspec, _model_if(shape[2], tp))
    # per-cache page map (L,B,H,NB): logical block → pool page — lane-owned
    # like the block table it translates, entries replicated.
    if name == "phys" and nd == 4:
        return "page-map", (None, bspec, _model_if(shape[2], tp), None)
    if name in ("k", "v") and nd == 5:
        hspec, pspec = slot_specs(shape[2], shape[3])
        return "kv-arena", (None, bspec, hspec, pspec, None)
    # per-slot metadata/masks aligned with the arena slot dim (pos/valid
    # rings, H2O mass, DMC weights, masked-DMS retained/alpha, Keyformer
    # scores) — sharded exactly like the slots they annotate.
    if name in ("pos", "valid", "free_ring", "acc", "z", "retained",
                "alpha", "score") and nd == 4:
        hspec, pspec = slot_specs(shape[2], shape[3])
        return "slot-meta", (None, bspec, hspec, pspec)
    if name in ("kmin", "kmax") and nd == 5:
        return "quest-pages", (None, bspec, _model_if(shape[2], tp), None,
                               None)
    if name in ("pending_slot", "pending_alpha") and nd == 4:
        return "pending-ring", (None, bspec, _model_if(shape[2], tp), None)
    if name in ("free_head", "free_count", "overflowed", "count") and nd == 3:
        return "slot-scalars", (None, bspec, _model_if(shape[2], tp))
    # per-lane scalars (L,B): lengths and Keyformer's per-step content salt —
    # lanes advance independently under continuous batching.
    if name in ("length", "salt") and nd == 2:
        return "lane-length", (None, bspec)
    if name == "ssm" and nd == 5:
        return "ssd-state", (None, bspec, _model_if(shape[2], tp), None, None)
    if name in ("conv_x", "conv_b", "conv_c") and nd == 4:
        return "ssd-conv", (None, bspec, None, _model_if(shape[3], tp))
    if name == "h" and nd == 3:                      # rglru state (L,B,W)
        return "rglru-state", (None, bspec, _model_if(shape[2], tp))
    if name == "conv" and nd == 4:
        return "rglru-conv", (None, bspec, None, _model_if(shape[3], tp))
    return "fallback", (None, bspec, *([None] * (nd - 2)))


def cache_spec(path: Path, shape: Tuple[int, ...], mesh, batch: int,
               arch) -> Spec:
    return cache_spec_with_rule(path, shape, mesh, batch, arch)[1]


def cache_shardings(state: Any, mesh, batch: int, arch) -> Any:
    return map_with_path(
        lambda path, leaf: cache_spec(path, tuple(leaf.shape), mesh, batch,
                                      arch), state)


def opt_shardings(params: Any, arch, mesh, tp: Optional[int] = None):
    """ZeRO-1: moments and the fp32 master additionally sharded over the
    data dims on the largest still-unsharded divisible dim (the first such
    dim, as the reference picks it).  With tp=1 (the dp-only plan) the
    model dim joins the ZeRO shard dims.  Returns an ``AdamWState`` of spec
    trees (``step`` replicated)."""
    from repro_torch.optim.adamw import AdamWState

    dp_only = tp == 1
    tp = axis_size(mesh, "model") if not dp_only else 1
    ba = batch_axes(mesh) + (("model",) if dp_only else ())
    dp = _size(mesh, ba)

    def upgrade(path, leaf):
        shape = tuple(leaf.shape)
        spec = (list(param_spec(path, shape, arch, tp)) if tp > 1
                else [None] * len(shape))
        spec += [None] * (len(shape) - len(spec))
        for i, (dim, s) in enumerate(zip(shape, spec)):
            if s is None and dim % dp == 0 and dim >= dp:
                spec[i] = _entry(ba)
                break
        return tuple(spec)

    tree = map_with_path(upgrade, params)
    return AdamWState(step=(), mu=tree, nu=tree, master=tree)


def prefill_out_shardings(out: Any, mesh, arch) -> Any:
    """Prefill returns (last logits (B, V), per-layer KV (L,B,H,T[,Dh])
    (+ retained maps)): batch on the data dims, kv-heads on model."""
    tp = axis_size(mesh, "model")
    ba = batch_axes(mesh)
    dp = _size(mesh, ba)

    def one(_, leaf):
        shp = tuple(leaf.shape)
        if len(shp) == 2:                       # logits (B, V)
            return (_entry(ba) if shp[0] % dp == 0 else None,
                    _model_if(shp[1], tp))
        if len(shp) >= 4:                       # (L, B, H, T[, Dh])
            return (None, _entry(ba) if shp[1] % dp == 0 else None,
                    _model_if(shp[2], tp), *([None] * (len(shp) - 3)))
        return (None,) * len(shp)

    return map_with_path(one, out)


def replicated(ndim: int = 0) -> Spec:
    return (None,) * ndim


def tree_replicated(tree: Any) -> Any:
    return map_with_path(lambda _, leaf: (None,) * leaf.dim(), tree)


# ---------------------------------------------------------------------------
# DTensor placement
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that ``spec`` names at tensor dim ``d``, ``Replicate()`` on the
    rest.  A tensor dim split over several mesh dims takes them in mesh
    order (major first), as the reference's tuple entries do; a tuple out
    of mesh order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else entry
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` with every tensor leaf placed on ``mesh`` as a DTensor per
    the matching spec of ``specs`` (a tree of the same structure, as the
    rules above return it).  A leaf already on the mesh is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    flat = dict(leaves_with_path(specs))

    def one(path, leaf):
        pl = placements(flat[path], mesh)
        if isinstance(leaf, DTensor):
            return leaf.redistribute(mesh, pl)
        return distribute_tensor(leaf, mesh, pl)

    return map_with_path(one, tree)
