"""Local regions of the multi-device program: where the port's model code
leaves DTensor and runs on its rank's own shards.

The model code is written for plain tensors.  Placed on a mesh
(:func:`repro_torch.parallel.sharding.distribute`), its parameters and
decode state are DTensors, and ordinary ops (the projections, norms, MLPs,
the LM head) run as DTensor ops, whose sharding propagation inserts the
collectives.  Two parts of the program do not propagate: the attention
cores (a GQA reshape over a batch-sharded input yields a strided shard that
DTensor has no matmul strategy for, and the CUDA kernels take plain
tensors) and the decode step's cache writes (in-place scatters into a
sharded arena).  Each runs here, in a local region:

* :func:`local_attention` — the full-sequence core, in
  :func:`torch.distributed.tensor.experimental.local_map`: a rank computes
  its own lanes and whole heads.  Where the column rule cut a head (the
  fused H·Dh columns split mid-head), q/k/v are redistributed to whole
  heads (or replicated) first, and that redistribution is the collective
  it is.
* :func:`local_prepare` and :func:`local_decode` — a policy's per-step
  preparation and one layer's decode update and attention, on the local
  shards of the cache: the policy writes its rows in place into the
  shards' storage, never through an arena-sized copy.  Where a rule splits
  the arena's slots over mesh dims (split-KV over ``model``, context over
  ``data``), the slot metadata (small) is gathered whole, the policy's
  bookkeeping runs on it in global slot coordinates, only the rank that
  owns a slot writes its row (:func:`repro_torch.core.kv_cache.
  arena_shard`), each rank attends over its slot shard, and the partial
  maxima, denominators and outputs are combined over the slot dims.

Around the regions, :func:`anchor` pins a gradient to its activation's
placements in the backward pass (:func:`merge_heads`, and the residual
stream), where DTensor's backward strategies would otherwise shard it in a
layout that a view cannot undo.

Outside a region nothing changes: with no DTensor among the arguments each
function calls straight through.  A step over DTensor parameters runs under
:func:`torch.distributed.tensor.experimental.implicit_replication`, so that
the plain tensors it builds (positions, RoPE tables, masks) count as
replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import kv_cache

_BATCH, _HEADS, _SLOTS = "batch", "heads", "slots"


def _dtensor_cls():
    from torch.distributed.tensor import DTensor
    return DTensor


def first_dtensor(*trees) -> Optional[Any]:
    DTensor = _dtensor_cls()
    stack = list(trees)
    while stack:
        x = stack.pop(0)
        if isinstance(x, DTensor):
            return x
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return None


def _placements(roles: Sequence[Optional[str]], dims: Dict[str, int]):
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[r]) if r in dims else Replicate() for r in roles)


def _localize(x: Any, mesh, roles, dims: Dict[str, int]):
    """``x``'s local part under ``roles`` (a plain tensor counts as
    replicated: slicing it to its shard costs no collective)."""
    if not isinstance(x, torch.Tensor):
        return x
    return _replicated(x, mesh).redistribute(
        mesh, _placements(roles, dims)).to_local()


def _replicated(x: torch.Tensor, mesh):
    """``x`` as a DTensor: a plain tensor counts as replicated."""
    DTensor = _dtensor_cls()
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [_replicate()] * mesh.ndim,
                              run_check=False)


def _wrap(x: torch.Tensor, mesh, roles, dims: Dict[str, int]):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, mesh, _placements(roles, dims),
                              run_check=False)


# ---------------------------------------------------------------------------
# activations: pending sums, the vocab-parallel lookup, whole heads
# ---------------------------------------------------------------------------


def anchor(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient in the backward pass is redistributed to
    ``x``'s placements (a no-op forward).  DTensor's backward strategies
    may otherwise shard a replicated activation's gradient over its
    flattened tokens, which a later view cannot split back."""
    DTensor = _dtensor_cls()
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its pending (partial) reductions done: a DTensor's
    ``Partial`` placements become ``Replicate``; a plain tensor as it is."""
    DTensor = _dtensor_cls()
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [_replicate() if p.is_partial()
                                          else p for p in x.placements])


def embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  Over a DTensor table whose rows (the vocab) are
    sharded, vocab-parallel: each rank looks up the ids it owns (zeros
    elsewhere) and the rows are summed over the vocab's mesh dims."""
    DTensor = _dtensor_cls()
    vdims = ([] if not isinstance(table, DTensor) else
             [i for i, p in enumerate(table.placements)
              if p.is_shard() and p.dim == 0])
    if not vdims:
        return torch.nn.functional.embedding(ids, table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    ids = _replicated(ids, mesh)
    idp = tuple(Replicate() if i in vdims else p
                for i, p in enumerate(ids.placements))
    out = [Partial() if i in vdims
           else (Shard(p.dim) if p.is_shard() else Replicate())
           for i, p in enumerate(idp)]
    coord = mesh.get_coordinate()

    def body(tab, idx):
        k = 0
        for i in vdims:
            k = k * mesh.size(i) + coord[i]
        local = idx - k * tab.shape[0]
        own = (local >= 0) & (local < tab.shape[0])
        rows = torch.nn.functional.embedding(
            local.clamp(0, tab.shape[0] - 1), tab)
        return torch.where(own[..., None], rows, 0.0)

    y = local_map(body, out_placements=out,
                  in_placements=(tuple(table.placements), idp),
                  device_mesh=mesh)(table, ids.redistribute(mesh, idp))
    return reduce_partial(y)


def split_heads(y: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(..., heads · head_dim) → (..., heads, head_dim).  A DTensor whose
    fused columns are sharded where whole heads do not divide (the column
    rule cut a head) is gathered over those mesh dims first: DTensor has no
    view for a mid-head shard."""
    DTensor = _dtensor_cls()
    if isinstance(y, DTensor):
        from torch.distributed.tensor import Replicate
        last = y.dim() - 1
        split, pl, cut = 1, list(y.placements), False
        for i, p in enumerate(pl):
            if p.is_shard() and p.dim == last:
                if heads % (split * y.device_mesh.size(i)):
                    pl[i], cut = Replicate(), True
                else:
                    split *= y.device_mesh.size(i)
        if cut:
            y = y.redistribute(y.device_mesh, pl)
    return y.reshape(*y.shape[:-1], heads, head_dim)


def merge_heads(y: torch.Tensor) -> torch.Tensor:
    """(..., heads, head_dim) → (..., heads · head_dim), the inverse of
    :func:`split_heads`.  On a mesh the merged tensor is anchored
    (:func:`anchor`): the output projection's backward shards its gradient
    over the fused columns, which cut heads where whole ones do not divide,
    and the view back to heads would refuse it."""
    return anchor(y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1]))


# ---------------------------------------------------------------------------
# full-sequence attention
# ---------------------------------------------------------------------------


def _core_roles(q, k) -> List[Optional[str]]:
    """Per mesh dim: ``batch`` where q's batch is sharded, ``heads`` where
    q or k is sharded otherwise and whole kv heads divide, else None."""
    from torch.distributed.tensor import Shard
    mesh = q.device_mesh
    hkv = k.shape[2]
    roles: List[Optional[str]] = []
    head_split = 1
    for i in range(mesh.ndim):
        qp, kp = q.placements[i], k.placements[i]
        if isinstance(qp, Shard) and qp.dim == 0:
            roles.append(_BATCH)
        elif ((qp.is_shard() or kp.is_shard())
              and hkv % (head_split * mesh.size(i)) == 0):
            head_split *= mesh.size(i)
            roles.append(_HEADS)
        else:
            roles.append(None)
    return roles


def local_attention(fn: Callable, q, k, v, alpha, **kw):
    """``fn(q, k, v, alpha, **kw)`` (an attention core: q (B, T, Hq, Dh),
    k/v (B, T, Hkv, Dh), alpha (B, Hkv, T) or None) on each rank's lanes
    and whole heads; plain tensors call straight through."""
    DTensor = _dtensor_cls()
    if not isinstance(q, DTensor):
        return fn(q, k, v, alpha, **kw)
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    roles = _core_roles(q, k)
    qkv = {_BATCH: 0, _HEADS: 2}
    pq = _placements(roles, qkv)
    pa = _placements(roles, {_BATCH: 0, _HEADS: 1})
    args = [x.redistribute(mesh, pq) for x in (q, k, v)]
    if alpha is not None:
        alpha = alpha.redistribute(mesh, pa)
    core = local_map(lambda q_, k_, v_, a_: fn(q_, k_, v_, a_, **kw),
                     out_placements=list(pq),
                     in_placements=(pq, pq, pq, None if alpha is None else pa),
                     device_mesh=mesh)
    return core(*args, alpha)


def local_ssd(fn: Callable, x, dt, a, bmat, cmat, q: int, init_state=None):
    """``fn(x, dt, a, bmat, cmat, q, init_state=)`` (the chunked SSD: x
    (B, T, H, P), dt (B, T, H), a (H,), B/C (B, T, G, N), the state (B, H,
    P, N)) on each rank's lanes and heads: the recurrence is independent
    per (lane, head).  A group dim shards with the heads where it divides
    the same way, else B/C are whole; plain tensors call straight
    through."""
    DTensor = _dtensor_cls()
    if not isinstance(x, DTensor):
        return fn(x, dt, a, bmat, cmat, q, init_state=init_state)
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    nh, g = x.shape[2], bmat.shape[2]
    roles: List[Optional[str]] = []
    split = 1
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim == 0:
            roles.append(_BATCH)
        elif (p.is_shard() and nh % (split * mesh.size(i)) == 0
              and (g == 1 or g % (split * mesh.size(i)) == 0)):
            split *= mesh.size(i)
            roles.append(_HEADS)
        else:
            roles.append(None)
    grp = {_BATCH: 0, _HEADS: 2} if g > 1 else {_BATCH: 0}
    dims = [{_BATCH: 0, _HEADS: 2}, {_BATCH: 0, _HEADS: 2}, {_HEADS: 0},
            grp, grp, {_BATCH: 0, _HEADS: 1}]
    args = [x, dt, a, bmat, cmat, init_state]
    pls = [None if t is None else _placements(roles, d)
           for t, d in zip(args, dims)]
    args = [None if t is None else _replicated(t, mesh).redistribute(mesh, pl)
            for t, pl in zip(args, pls)]
    out = (list(pls[0]), list(pls[5] or _placements(roles, dims[5])))
    core = local_map(
        lambda x_, dt_, a_, b_, c_, s_: fn(x_, dt_, a_, b_, c_, q,
                                           init_state=s_),
        out_placements=out, in_placements=tuple(pls), device_mesh=mesh)
    return core(*args)


def local_moe(tokens_fn: Callable, p: dict, x, cfg, dtype,
              capacity_factor: float):
    """A MoE layer (``tokens_fn``: :func:`repro_torch.models.layers.
    _moe_tokens`) on each rank's lanes: every rank routes its tokens (the
    router is replicated) and runs the experts it holds — a slice of the
    experts (expert parallelism) or a slice of every expert's ffn columns
    (TP inside each expert) — so its output is its part of the sum,
    reduced where the residual stream takes it.  The load-balance loss is
    built from token and probability sums over the batch's mesh dims, as
    the whole batch's means.  Returns (y, aux) as ``moe_apply``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    w = p["w_up"]
    mesh = w.device_mesh
    x = _replicated(x, mesh)
    roles: List[Optional[str]] = []
    for i in range(mesh.ndim):
        xp, wp = x.placements[i], w.placements[i]
        if xp.is_shard() and xp.dim == 0:
            roles.append(_BATCH)
        elif wp.is_shard() and wp.dim == 0:
            roles.append("experts")
        elif wp.is_shard() and wp.dim == 2:
            roles.append("ffn")
        else:
            roles.append(None)
    pl = {"x": _placements(roles, {_BATCH: 0}),
          "router": tuple(Replicate() for _ in roles),
          "w_gate": _placements(roles, {"experts": 0, "ffn": 2}),
          "w_up": _placements(roles, {"experts": 0, "ffn": 2}),
          "w_down": _placements(roles, {"experts": 0, "ffn": 1})}
    names = [n for n in ("router", "w_gate", "w_up", "w_down") if n in p]
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    coord = mesh.get_coordinate()

    def body(x_, *ws):
        lp = dict(zip(names, ws))
        experts = None
        if "experts" in roles:
            idx = 0
            for i, r in enumerate(roles):
                if r == "experts":
                    idx = idx * mesh.size(i) + coord[i]
            cnt = lp["w_up"].shape[0]
            experts = (idx * cnt, cnt)
        y, probs, onehot, keep = tokens_fn(lp, x_, cfg, dtype,
                                           capacity_factor, experts=experts)
        n = torch.full((1,), float(x_.shape[0] * x_.shape[1]),
                       device=x_.device)
        stats = torch.cat([onehot.sum(dim=2).reshape(-1, e).float().sum(0),
                           probs.reshape(-1, e).sum(0),
                           keep.float().sum()[None], n])
        return y, stats

    y_pl = [Partial() if r in ("experts", "ffn")
            else (Shard(0) if r == _BATCH else Replicate()) for r in roles]
    st_pl = [Partial() if r == _BATCH else Replicate() for r in roles]
    ys, stats = local_map(
        body, out_placements=(y_pl, st_pl),
        in_placements=(pl["x"],) + tuple(pl[n] for n in names),
        device_mesh=mesh)(x.redistribute(mesh, pl["x"]),
                          *(p[n].redistribute(mesh, pl[n]) for n in names))
    stats = stats.redistribute(mesh, [Replicate()] * mesh.ndim)
    n = stats[2 * e + 1]
    aux = {"moe_aux_loss": cfg.moe.aux_loss_weight * e
           * torch.sum((stats[:e] / n) * (stats[e:2 * e] / n)),
           "moe_drop_frac": 1.0 - stats[2 * e] / (n * k)}
    return ys, aux


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------


def _arena(cache) -> Optional[Any]:
    k = getattr(cache, "k", None)
    return k if isinstance(k, _dtensor_cls()) else None


def _cache_roles(cache) -> List[Optional[str]]:
    """Per mesh dim, what the cache's K arena (..., B, H, P, Dh) is sharded
    over."""
    k = _arena(cache)
    nd = k.dim()
    by_dim = {nd - 4: _BATCH, nd - 3: _HEADS, nd - 2: _SLOTS}
    return [by_dim.get(p.dim) if p.is_shard() else None
            for p in k.placements]


def _slot_shard(mesh, roles) -> Tuple[int, int]:
    """(index of this rank's slot shard, number of slot shards)."""
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i, r in enumerate(roles):
        if r == _SLOTS:
            idx = idx * mesh.size(i) + coord[i]
            n *= mesh.size(i)
    return idx, n


class _LocalCache:
    """The local view of a cache on DTensor leaves: the shards themselves
    (in-place writes land in the DTensors' storage) or, for slot metadata
    of a slot-split cache, whole gathered copies written back by
    :meth:`commit`."""

    def __init__(self, cache, mesh, roles):
        from torch.distributed.tensor import DTensor, Replicate
        self.mesh, self.roles = mesh, roles
        self.split = _SLOTS in roles
        # (local shard, whole gathered copy, slot dim, offset, size)
        self.back: List[Tuple[torch.Tensor, torch.Tensor, int, int,
                              int]] = []
        arenas = {id(getattr(cache, "k", None)), id(getattr(cache, "v", None))}
        idx, n = _slot_shard(mesh, roles)

        def loc(x):
            if not isinstance(x, DTensor):
                return x
            sdims = {p.dim for i, p in enumerate(x.placements)
                     if roles[i] == _SLOTS and p.is_shard()}
            if not self.split or id(x) in arenas or not sdims:
                return x.to_local()
            (d,) = sdims
            pl = [Replicate() if roles[i] == _SLOTS else p
                  for i, p in enumerate(x.placements)]
            full = x.redistribute(self.mesh, pl).to_local()
            size = full.shape[d] // n
            self.back.append((x.to_local(), full, d, idx * size, size))
            return full

        self.local = _map_leaves(loc, cache)
        if self.split:
            k = cache.k.to_local()
            self.offset = idx * k.shape[-2]
            self.total = k.shape[-2] * n

    def commit(self) -> None:
        for shard, full, d, off, size in self.back:
            shard.copy_(full.narrow(d, off, size))


def _map_leaves(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kw = {f.name: (getattr(tree, f.name) if f.metadata.get("static")
                       else _map_leaves(fn, getattr(tree, f.name)))
              for f in dataclasses.fields(tree)}
        return type(tree)(**kw)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return tree


_AUX_DIMS = {"pos_t": {_BATCH: 0}, "active": {_BATCH: 0},
             "alpha_bin": {_BATCH: 0, _HEADS: 1}}


def _local_aux(aux: Dict[str, Any], mesh, roles) -> Dict[str, Any]:
    return {k: (_localize(v, mesh, roles, _AUX_DIMS[k])
                if k in _AUX_DIMS and v is not None else v)
            for k, v in aux.items()}


def local_prepare(prepare: Callable, cache, aux: Dict[str, Any]):
    """A policy's ``prepare_step(stacked cache, aux)`` on the local shards
    (the prepared operands come back as local tensors, which
    :func:`local_decode` hands on as they are)."""
    if _arena(cache) is None:
        return prepare(cache, aux)
    k = _arena(cache)
    mesh, roles = k.device_mesh, _cache_roles(cache)
    lc = _LocalCache(cache, mesh, roles)
    aux = _local_aux(aux, mesh, roles)
    if not lc.split:
        return prepare(lc.local, aux)
    with kv_cache.arena_shard(lc.offset, lc.total):
        return prepare(lc.local, aux)


def local_decode(core: Callable, cache, q, k_new, v_new,
                 aux: Dict[str, Any], attend: Callable, split_attend):
    """One layer's ``core(cache, q, k_new, v_new, aux, attend) -> (cache,
    out, meters, impl)`` on the local shards.  q (B, 1, Hq, Dh), k_new/v_new
    (B, Hkv, 1, Dh); ``attend`` is the single-shard attention,
    ``split_attend(groups, offset)`` makes the slot-split one.  Returns the
    cache (its DTensors, written in place), out and meters as DTensors."""
    if _arena(cache) is None:
        return core(cache, q, k_new, v_new, aux, attend)
    k = _arena(cache)
    mesh, roles = k.device_mesh, _cache_roles(cache)
    lc = _LocalCache(cache, mesh, roles)
    q_dims = {_BATCH: 0, _HEADS: 2}
    kv_dims = {_BATCH: 0, _HEADS: 1}
    ql = _localize(q, mesh, roles, q_dims)
    kl = _localize(k_new, mesh, roles, kv_dims)
    vl = _localize(v_new, mesh, roles, kv_dims)
    la = _local_aux(aux, mesh, roles)
    if lc.split:
        groups = [(mesh, i) for i, r in enumerate(roles) if r == _SLOTS]
        with kv_cache.arena_shard(lc.offset, lc.total,
                                  lambda x: all_reduce(x, "sum", groups)):
            _, out, meters, impl = core(lc.local, ql, kl, vl, la,
                                        split_attend(groups, lc.offset))
        lc.commit()
    else:
        _, out, meters, impl = core(lc.local, ql, kl, vl, la, attend)
    out = _wrap(out, mesh, roles, q_dims)
    meters = {m: _wrap(x, mesh, roles, {_BATCH: 0})
              for m, x in meters.items()}
    return cache, out, meters, impl


def all_reduce(x: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``x`` reduced (``"max"`` or ``"sum"``) over each ``(mesh, dim)`` of
    ``groups`` in turn (functional collectives: traced and counted)."""
    import torch.distributed._functional_collectives as funcol
    for g in groups:
        x = funcol.all_reduce(x, op, g)
    return x


# ---------------------------------------------------------------------------
# vocab-parallel cross entropy
# ---------------------------------------------------------------------------


def logsumexp_and_pick(logits: torch.Tensor, labels: torch.Tensor):
    """(``logsumexp(logits, -1)``, ``logits[..., label]``), fp32, over
    logits (..., V) whose vocab dim may be sharded (the LM head's columns):
    each rank reduces its own columns (a max, then the sum of exponentials
    and the label's logit where it owns the label) and the partial results
    are combined over the vocab's mesh dims, so (..., V) is never gathered.
    A plain tensor (or an unsharded vocab) takes the direct form."""
    DTensor = _dtensor_cls()
    last = logits.dim() - 1
    vdims = ([] if not isinstance(logits, DTensor) else
             [i for i, p in enumerate(logits.placements)
              if p.is_shard() and p.dim == last])
    if not vdims:
        lse = torch.logsumexp(logits, dim=-1)
        return lse, logits.gather(-1, labels.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    lpl = tuple(logits.placements)
    row = tuple(p if p.is_shard() and p.dim < last else Replicate()
                for p in lpl)
    labels = _replicated(labels, mesh).redistribute(mesh, row)

    def per_vocab(op):
        return [Partial(op) if i in vdims else row[i]
                for i in range(mesh.ndim)]

    m = local_map(lambda x: x.detach().amax(dim=-1),
                  out_placements=per_vocab("max"), in_placements=(lpl,),
                  device_mesh=mesh)(logits).redistribute(mesh, row)
    coord = mesh.get_coordinate()

    def body(x, lab, m_):
        idx = 0
        for i in vdims:
            idx = idx * mesh.size(i) + coord[i]
        local = lab.long() - idx * x.shape[-1]
        own = (local >= 0) & (local < x.shape[-1])
        pick = x.gather(-1, local.clamp(0, x.shape[-1] - 1)[..., None])
        return (torch.exp(x - m_[..., None]).sum(dim=-1),
                torch.where(own, pick[..., 0], 0.0))

    sums = per_vocab("sum")
    s, t = local_map(body, out_placements=(sums, sums),
                     in_placements=(lpl, row, row),
                     device_mesh=mesh)(logits, labels, m)
    return (m + torch.log(s.redistribute(mesh, row)),
            t.redistribute(mesh, row))


# ---------------------------------------------------------------------------
# in-place state updates
# ---------------------------------------------------------------------------


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` where ``dst`` may be a DTensor of other
    placements than ``src`` (a decode state written in place)."""
    DTensor = _dtensor_cls()
    if isinstance(dst, DTensor):
        src = _replicated(src, dst.device_mesh).redistribute(
            dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local().to(dst.dtype))
        return
    dst.copy_(src)


def _replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()
