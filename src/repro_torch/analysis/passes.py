"""Finding type, pass registry, and the decode-path traffic lints.

The port of the reference's ``repro.analysis.passes``.  A *pass* is a
function ``(trace, ctx) -> iterable[Finding]`` registered under a rule
name; :func:`run_passes` runs every registered pass (or a subset) over the
op trace of one call (:mod:`repro_torch.analysis.optrace`) and applies the
allowlist.  Rule names and severities are the reference's, so findings
compare one to one.

The reference's passes match JAX primitives; the port's match their ATen
forms:

==========================  ==============================================
reference primitive         ATen ops the port matches
==========================  ==============================================
``pad``/``concatenate``     ``cat``, ``stack``, ``constant_pad_nd``,
                            ``pad``, and any fresh copy of the operand
                            (``clone``, ``copy``, ``_to_copy`` to the same
                            dtype): in eager torch a functional-style clone
                            of the arena is this pitfall
``convert_element_type``    ``_to_copy`` with a change of dtype (which is
                            what ``.float()`` and ``.to(dtype)`` dispatch)
``gather``/``dynamic_slice``  ``index``, ``index_select``, ``gather``,
                            ``take_along_dim``, ``take`` over a float
                            operand of rank >= 3 and at least arena size;
                            views (``narrow``, ``slice``, ``select``,
                            ``view``) copy nothing and never count
``dot_general``, >= 2       ``bmm``/``baddbmm`` with an arena-sized float
batch dims                  operand: an einsum lowers to ``bmm`` with its
                            batch dims folded together, so the count of
                            batch dims is lost; parameter products reach
                            ``mm``/``addmm`` and are exempt, as the
                            reference exempts them by their 0 batch dims
``pallas_call``             a ``kernel`` event of the op trace
==========================  ==============================================

In-place and aliasing outputs (``index_put_``, ``copy_``, ``scatter_`` into
the arena return the arena itself) are never a materialised copy: the op
trace marks an output fresh only when its schema declares no alias and its
storage is no input's (:attr:`OpEvent.fresh`).

Severity policy (as in the reference, docs/analysis.md):

* ``error`` — a known-pathological traffic pattern on the decode/fork/
  reclaim path (full-arena copy, arena-sized recast, KV upcast, whole-arena
  gather in table mode).  Always gates the audit.
* ``warn``  — suspicious but occasionally legitimate (a scalar float
  returned from a step).  Gates the audit unless allowlisted.
* ``info``  — an allowlisted finding, kept visible in reports, never gates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.optrace import (OpTrace, is_cast, is_copy,
                                          out_elems, tensor_leaves, trace_ops,
                                          walk_ops)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One audit finding, anchored to a recorded op or a state leaf."""

    severity: str          # "error" | "warn" | "info"
    rule: str              # registered pass / checker name
    message: str
    eqn: str = ""          # offending op + shape summary ("" = tree-level)
    nbytes: int = 0        # bytes the offending op materialises (0 if n/a)
    path: str = ""         # entry point or state path the finding anchors to

    def __str__(self) -> str:
        loc = f" [{self.path}]" if self.path else ""
        op = f" {self.eqn}" if self.eqn else ""
        nb = f" ({self.nbytes} B)" if self.nbytes else ""
        return f"{self.severity}:{self.rule}{loc}{op}{nb} — {self.message}"


@dataclasses.dataclass(frozen=True)
class LintContext:
    """Per-entry-point lint parameters.

    ``arena_elems`` is the element count of the smallest fully-provisioned
    KV arena the entry point touches at once: any op materialising that
    many elements (or more) is touching a whole arena, which the
    block-table contract forbids on the step path.  ``table_mode`` is True
    when auditing the block-table/kernel path, where even a *gather* over
    the provisioned arena indicates the wrapper re-materialising table
    order.  ``vocab``, when given, is the model's padded vocab: a tensor
    ending in it is the lm head's logits, no KV leaf (see ``kv-upcast``)."""

    arena_elems: int
    table_mode: bool = False
    allow: Tuple[str, ...] = ()        # rule names allowlisted for this entry
    vocab: int = 0                     # 0: any tensor may be a KV leaf


_PASSES: Dict[str, Callable] = {}


def register_pass(name: str):
    """Register ``fn(trace, ctx) -> iterable[Finding]`` under ``name``."""
    def deco(fn):
        if name in _PASSES:
            raise ValueError(f"duplicate analysis pass {name!r}")
        _PASSES[name] = fn
        return fn
    return deco


def available_passes() -> Tuple[str, ...]:
    return tuple(sorted(_PASSES))


def _fresh_nbytes(ev) -> int:
    return sum(m.nbytes for m in ev.fresh_outputs)


def run_passes(fn_or_trace, ctx: LintContext, *args,
               passes: Optional[Iterable[str]] = None,
               path: str = "") -> List[Finding]:
    """Run lint passes over one entry point (callable + example args, run
    once under the op recorder, or an already-recorded
    :class:`~repro_torch.analysis.optrace.OpTrace`).  Allowlisted rules are
    downgraded to ``info``."""
    trace = (fn_or_trace if isinstance(fn_or_trace, OpTrace)
             else trace_ops(fn_or_trace, *args))
    names = tuple(passes) if passes is not None else available_passes()
    out: List[Finding] = []
    for name in names:
        for f in _PASSES[name](trace, ctx):
            if f.rule in ctx.allow:
                f = dataclasses.replace(
                    f, severity="info",
                    message=f.message + " (allowlisted)")
            out.append(dataclasses.replace(f, path=f.path or path))
    return out


def gating(findings: Iterable[Finding]) -> List[Finding]:
    """The findings that fail an audit (everything not downgraded to info)."""
    return [f for f in findings if f.severity in ("error", "warn")]


# ---------------------------------------------------------------------------
# traffic lints
# ---------------------------------------------------------------------------


@register_pass("arena-pad")
def _arena_pad(trace, ctx):
    """Full-arena ``cat``/pad/clone on the step path: the seed wrapper
    re-padded the whole provisioned arena every step of every layer — the
    copy the block-table layout exists to remove (docs/kernels.md)."""
    for ev in walk_ops(trace):
        if is_copy(ev) and out_elems(ev) >= ctx.arena_elems:
            yield Finding("error", "arena-pad",
                          "arena-sized copy materialized on a step path",
                          eqn=str(ev), nbytes=_fresh_nbytes(ev))


@register_pass("arena-cast")
def _arena_cast(trace, ctx):
    """Arena-sized cast of integer/bool metadata (the seed's per-step
    ``valid.astype(int32)`` recast of the whole bitmap)."""
    for ev in walk_ops(trace):
        if is_cast(ev) and out_elems(ev) >= ctx.arena_elems \
                and not ev.inputs[0].floating:
            yield Finding("error", "arena-cast",
                          "arena-sized metadata recast on a step path",
                          eqn=str(ev), nbytes=_fresh_nbytes(ev))


@register_pass("kv-upcast")
def _kv_upcast(trace, ctx):
    """Arena-sized dtype *upcast* of a floating KV leaf (e.g. bf16 → f32).

    Accumulating in f32 is correct — but in the product, never by
    converting the cache itself: an arena-sized upcast doubles both the
    HBM read and the materialized footprint per step.  Downcasts (DMC's
    f32 accumulators → model dtype) are by design.

    With ``ctx.vocab`` a cast whose last dim is the vocab is exempt: at
    full width a step's fp32 logits (B, 1, V) can outnumber one layer's
    arena, and they are the lm head's output, no KV leaf.  Any other
    layout of a KV leaf (transposed, heads flattened) still counts."""
    for ev in walk_ops(trace):
        if not is_cast(ev):
            continue
        src, dst = ev.inputs[0].dtype, ev.outputs[0].dtype
        logits = bool(ctx.vocab) and ev.inputs[0].shape[-1:] == (ctx.vocab,)
        if src.is_floating_point and dst.is_floating_point \
                and dst.itemsize > src.itemsize and not logits \
                and out_elems(ev) >= ctx.arena_elems:
            yield Finding("error", "kv-upcast",
                          f"KV arena upcast {src} -> {dst} on a step path",
                          eqn=str(ev), nbytes=_fresh_nbytes(ev))


#: the gather family (``dynamic_slice`` has no copying ATen form: slices
#: are views)
GATHER_OPS = frozenset({"index", "index_select", "gather", "take_along_dim",
                        "take"})


@register_pass("arena-gather")
def _arena_gather(trace, ctx):
    """In table mode, a gather whose *operand* is the whole provisioned
    arena: the kernel consumes the arena in place through the block table,
    so a step-path gather over it means the wrapper is re-materializing
    table order (the dead-block-read pitfall reintroduced one level up).

    Rank-<3 operands are exempt: KV arenas and page pools are always ≥3-D
    ((B,H,S,Dh) / (NPOOL,bp,Dh)), while per-token lookups into big 2-D
    tables (the vocab embedding) are the normal decode front-end.

    The port also asks for an arena-sized gathered output: every layer of
    a step reads a few rows out of the arena operand (the old row at a
    write slot, kept for an inactive lane; a copy-on-write page copy),
    which moves rows, not the arena.  The reference's such reads sit in
    its layer scan's body, where its stacked-arena threshold does not see
    them either."""
    if not ctx.table_mode:
        return
    for ev in walk_ops(trace):
        if ev.kind != "op" or ev.name not in GATHER_OPS or not ev.inputs:
            continue
        op = ev.inputs[0]
        if len(op.shape) >= 3 and op.numel >= ctx.arena_elems \
                and op.floating and out_elems(ev) >= ctx.arena_elems:
            yield Finding("error", "arena-gather",
                          "gather/slice over the whole provisioned arena "
                          "in table mode",
                          eqn=str(ev), nbytes=_fresh_nbytes(ev))


@register_pass("ref-fallback")
def _ref_fallback(trace, ctx):
    """In table (kernel) mode, the decode step must reach the decode
    kernel — a policy that requested ``use_kernel`` but ran the reference
    einsum instead is a *silent* fallback, lying about HBM traffic.  Two
    signals, both gating:

    * no kernel event anywhere in the step — attention fell back
      wholesale;
    * a ``bmm``/``baddbmm`` over an arena-sized float operand — the
      reference ``bhgd,bhpd->bhgp`` score einsum streaming the whole
      provisioned arena (parameter products reach ``mm``/``addmm``;
      Quest's page scoring has small sub-arena operands — neither trips
      this)."""
    if not ctx.table_mode:
        return
    saw_kernel = False
    for ev in walk_ops(trace):
        if ev.kind == "kernel":
            saw_kernel = True
            continue
        if ev.name not in ("bmm", "baddbmm"):
            continue
        if any(m.floating and m.numel >= ctx.arena_elems for m in ev.inputs):
            yield Finding("error", "ref-fallback",
                          "reference attention einsum run where the "
                          "kernel was requested",
                          eqn=str(ev), nbytes=_fresh_nbytes(ev))
    if not saw_kernel:
        yield Finding("error", "ref-fallback",
                      "no kernel launch in the decode program in kernel "
                      "mode — attention silently fell back to the "
                      "reference path")


@register_pass("scalar-output")
def _scalar_output(trace, ctx):
    """Size-1 float *outputs* of the step (e.g. the old
    ``aux["alpha_count"]`` as a device scalar): shape-derived bookkeeping
    is static — returning it as a device scalar allocates a tiny tensor
    per step and invites a ``.item()`` host sync downstream.  Return a
    Python float, or allowlist with a comment (a genuine reduction that
    must live on device).

    The call's returned values only: scalar intermediates (attention
    scales, counters) never leave the step."""
    for _, t in tensor_leaves(trace.result):
        if t.numel() == 1 and t.is_floating_point():
            yield Finding("warn", "scalar-output",
                          "scalar float returned from a step "
                          "(static bookkeeping should be a host value)",
                          eqn=f"output {str(t.dtype).removeprefix('torch.')}"
                              f"{list(t.shape)}")
