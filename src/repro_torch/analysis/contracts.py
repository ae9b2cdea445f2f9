"""Contract checkers: KVPolicy lifecycle and tree invariance.

The port of the reference's ``repro.analysis.contracts``.  These are not op
lints — they check the *interfaces* the decode path is built on: every
registered policy implements the full lifecycle protocol with state leaf
shapes, dtypes and devices invariant across a decode step.  That is the
contract a captured step relies on: a leaf that changes shape across a
step gives the step a new input signature (a new CUDA graph), and one that
changes structure breaks every caller that carries the state.

The reference evaluates shapes abstractly (``jax.eval_shape``); the port
has no abstract evaluation, so the checkers run the hooks for real, on a
copy of the state: the port's hooks write in place, and the caller's state
must not change.  The reference's third checker, sharding coverage, needs
the multi-device modules and waits for them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch

from repro_torch.analysis.optrace import tensor_leaves
from repro_torch.analysis.passes import Finding
from repro_torch.core.tree import tree_map


def _structure(node: Any) -> str:
    """Tree structure as a string: leaves as ``*``, static dataclass fields
    and other non-tensor values by value."""
    if isinstance(node, torch.Tensor):
        return "*"
    if isinstance(node, dict):
        return "{" + ",".join(f"{k}:{_structure(v)}"
                              for k, v in node.items()) + "}"
    if isinstance(node, (list, tuple)):
        return (type(node).__name__ + "("
                + ",".join(_structure(v) for v in node) + ")")
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return type(node).__name__ + "(" + ",".join(
            f"{f.name}={_structure(getattr(node, f.name))}"
            for f in dataclasses.fields(node)) + ")"
    return repr(node)


def copy_tree(tree: Any) -> Any:
    """A state tree with every leaf cloned."""
    return tree_map(lambda a: a.clone(), tree)


def _leaf_str(t: torch.Tensor) -> str:
    return (f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
            f"@{t.device.type}")


def check_tree_invariance(fn: Callable, tree: Any, *args,
                          path: str = "") -> List[Finding]:
    """Assert ``fn(tree, *args)`` returns a tree with identical structure
    and leaf shapes, dtypes and devices.  ``fn`` runs on a copy of
    ``tree``, which it may update in place.

    This is the stability contract of ``decode_step``: a state leaf that
    changes across a step changes every caller's input signature."""
    try:
        out = fn(copy_tree(tree), *args)
    except Exception as e:  # noqa: BLE001 — the failure IS the finding
        return [Finding("error", "tree-state",
                        f"step function failed to run: {e!r}", path=path)]
    s_in, s_out = _structure(tree), _structure(out)
    if s_in != s_out:
        return [Finding("error", "tree-state",
                        f"tree structure changed across step: "
                        f"{s_in} -> {s_out}", path=path)]
    findings: List[Finding] = []
    for (pi, a), (_, b) in zip(tensor_leaves(tree), tensor_leaves(out)):
        if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
            findings.append(Finding(
                "error", "tree-state",
                f"leaf changed across step: {_leaf_str(a)} -> "
                f"{_leaf_str(b)}", path=f"{path}{pi}"))
    return findings


# ---------------------------------------------------------------------------
# KVPolicy lifecycle
# ---------------------------------------------------------------------------


def check_policy_lifecycle(name: str, arch, cfg, *, batch: int = 2,
                           max_len: int = 16, dtype=None,
                           device=None) -> List[Finding]:
    """Exercise the full KVPolicy lifecycle for one registered policy on a
    tiny cache: init → prepare_step → decode_update (leaves invariant) →
    post_attend → fork/gather/reclaim → export/import prefix roundtrip →
    metrics / peak_bytes.  Any hook that raises, or any step that changes
    the cache's leaves, is a finding."""
    from repro_torch.core import policy as policy_lib
    from repro_torch.device import resolve_device, torch_dtype
    device = resolve_device(device)
    pol = policy_lib.get_policy(name)
    dtype = dtype or torch_dtype(arch.dtype)
    a = arch.attn
    path = f"policy:{name}"
    findings: List[Finding] = []

    def bad(hook: str, e: Exception) -> None:
        findings.append(Finding("error", "policy-protocol",
                                f"{hook} failed: {e!r}", path=path))

    def init():
        return pol.init_cache(arch, batch, max_len, cfg, layer_window=None,
                              dtype=dtype, device=device)

    try:
        cache, fresh = init(), init()
    except Exception as e:  # noqa: BLE001
        bad("init_cache", e)
        return findings

    q = torch.zeros((batch, 1, a.num_heads, a.head_dim), dtype=dtype,
                    device=device)
    kn = torch.zeros((batch, a.num_kv_heads, 1, a.head_dim), dtype=dtype,
                     device=device)
    aux = {"alpha_bin": torch.zeros((batch, a.num_kv_heads), dtype=torch.bool,
                                    device=device),
           "pos_t": torch.zeros((batch,), dtype=torch.int32, device=device),
           "attn_cfg": a, "arch": arch, "dtype": dtype, "active": None,
           "layer_salt": None}
    try:
        prepared = pol.prepare_step(
            tree_map(lambda x: x.unsqueeze(0), cache),
            {"layer_salt": torch.zeros((1,), dtype=torch.int64,
                                       device=device), "active": None})
        if prepared is not None:
            aux.update(prepared[0])
    except Exception as e:  # noqa: BLE001
        bad("prepare_step", e)
    spec = None
    try:
        stepped, spec, _ = pol.decode_update(copy_tree(cache), q, kn, kn,
                                             aux)
        findings += check_tree_invariance(
            lambda c: pol.decode_update(c, q, kn, kn, aux)[0], cache,
            path=f"{path}/decode_update")
    except Exception as e:  # noqa: BLE001
        bad("decode_update", e)
        stepped = cache
    if spec is not None and spec.needs_weights:
        try:
            p = (spec.phys.shape[-1] * spec.block_p if spec.pool is not None
                 else spec.k.shape[2])
            w = torch.zeros((batch, a.num_kv_heads, p), dtype=torch.float32,
                            device=device)
            findings += check_tree_invariance(
                lambda c: pol.post_attend(c, w, aux=aux)[0], stepped,
                path=f"{path}/post_attend")
        except Exception as e:  # noqa: BLE001
            bad("post_attend", e)

    src = torch.arange(batch, dtype=torch.int32, device=device)
    mask = torch.zeros((batch,), dtype=torch.bool, device=device)
    for hook, fn in (
        ("fork_cache", lambda c: pol.gather_cache(
            pol.fork_cache(c, 1, axis=0), src, axis=0)),
        ("gather_cache", lambda c: pol.gather_cache(c, src, axis=0)),
        ("reclaim_cache", lambda c: pol.reclaim_cache(c, mask, fresh,
                                                      axis=0)),
        ("prefix-roundtrip", lambda c: pol.import_prefix(
            c, pol.export_prefix(c, 0, axis=0), 0, axis=0)),
    ):
        try:
            findings += check_tree_invariance(fn, stepped,
                                              path=f"{path}/{hook}")
        except Exception as e:  # noqa: BLE001
            bad(hook, e)

    try:
        m = pol.metrics(stepped)
        for key in ("live_tokens", "reads_tokens", "peak_bytes"):
            if key not in m:
                findings.append(Finding(
                    "error", "policy-protocol",
                    f"metrics() missing required key {key!r}", path=path))
        for key in ("live_tokens", "reads_tokens"):
            if key in m and tuple(m[key].shape) != (batch,):
                findings.append(Finding(
                    "error", "policy-protocol",
                    f"metrics()[{key!r}] must be per-lane (B,), got "
                    f"{tuple(m[key].shape)}", path=path))
    except Exception as e:  # noqa: BLE001
        bad("metrics", e)
    try:
        pb = pol.peak_bytes(stepped)
        if not isinstance(pb, int) or pb <= 0:
            findings.append(Finding(
                "error", "policy-protocol",
                f"peak_bytes() must be a positive static int, got {pb!r}",
                path=path))
    except Exception as e:  # noqa: BLE001
        bad("peak_bytes", e)
    return findings
