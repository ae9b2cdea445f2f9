"""Retrace sentinel: exact signature budgets over a set of named step
callables.

The port of the reference's ``repro.analysis.retrace``.  The reference
counts XLA compiles of its jits; the port compiles nothing, and its
counterpart of a compile is a new **input signature** of a step callable:
the tree structure of its arguments, each tensor leaf's shape, dtype and
device (a numpy array's shape and dtype), and every other argument by
value.  One signature is one program: what a CUDA graph would capture once
and replay.  The serving contract is the reference's: one chunk step per
(num_lanes, chunk), one reset per (lanes, max_len), and admission order,
prompt lengths, fork widths and EOS timing never add a signature.

A step callable is named by where it is looked up — an ``(owner,
attribute)`` pair — because the sentinel wraps it there for the duration
of the region and restores it on exit.  Signatures are counted from the
calls inside the region: every region starts cold.

Usage::

    with RetraceSentinel(scheduler_jits(sched), budget=1) as sentinel:
        ...  # drive a mixed scheduler trace
    assert not sentinel.findings(), sentinel.compiles

``budget`` may be an int (applied to every callable), a dict of per-name
budgets, or an *exact* expectation via ``exact=`` (a signature count that
must match exactly — catching both retraces and silently-dead entry
points).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.passes import Finding

StepRef = Tuple[Any, str]


def _lane_ops() -> Dict[str, StepRef]:
    """The lane-lifecycle programs every scheduler dispatches through the
    transformer module."""
    from repro_torch.models import transformer as tfm
    return {"gather": (tfm, "gather_lanes"),
            "reset": (tfm, "reclaim_lanes"),
            "export": (tfm, "export_lane_state"),
            "import": (tfm, "import_lane_state")}


def engine_jits(engine) -> Dict[str, StepRef]:
    """The signature-budgeted step callables of a
    :class:`repro_torch.serving.engine.Engine`: its chunk step and the lane
    programs.  A scheduler keeps the chunk step it was built with, so this
    covers the schedulers built inside the region; for one built before,
    use :func:`scheduler_jits`."""
    return {"chunk": (engine, "chunk_fn"), **_lane_ops()}


def scheduler_jits(scheduler) -> Dict[str, StepRef]:
    """Same, for a :class:`repro_torch.serving.scheduler.Scheduler`."""
    return {"chunk": (scheduler, "_chunk_fn"), **_lane_ops()}


def signature(node: Any) -> Any:
    """The hashable input signature of an argument tree."""
    if isinstance(node, torch.Tensor):
        return ("tensor", tuple(node.shape), str(node.dtype),
                str(node.device))
    if isinstance(node, np.ndarray):
        return ("ndarray", node.shape, str(node.dtype))
    if isinstance(node, dict):
        return ("dict", tuple((k, signature(v)) for k, v in node.items()))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, tuple(signature(v) for v in node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return (type(node).__qualname__,
                tuple((f.name, signature(getattr(node, f.name)))
                      for f in dataclasses.fields(node)))
    if node is None or isinstance(node, (bool, int, float, str, bytes,
                                         np.generic)):
        return node
    return (type(node).__qualname__,)


class RetraceSentinel:
    """Context manager asserting a signature budget for a region."""

    def __init__(self, jits: Dict[str, StepRef],
                 budget: Union[int, Dict[str, int], None] = None,
                 exact: Optional[Dict[str, int]] = None):
        for name, ref in jits.items():
            if not (isinstance(ref, tuple) and len(ref) == 2
                    and isinstance(ref[1], str)
                    and callable(getattr(ref[0], ref[1], None))):
                raise TypeError(f"{name!r} is not a step callable given as "
                                "(owner, attribute): it cannot be wrapped")
        self._jits = dict(jits)
        self._budget = budget
        self._exact = exact
        self._seen: Dict[str, Set[Any]] = {}
        self._restore: List[Tuple[Any, str, Any, bool]] = []
        #: signatures observed inside the region, per name (set on exit)
        self.compiles: Dict[str, int] = {}

    def _wrap(self, name: str, fn):
        seen = self._seen[name]

        # no __dict__ copy: a stale copy of a counter (``chunk_fn.steps``)
        # would shadow the live one
        @functools.wraps(fn, updated=())
        def wrapped(*args, **kwargs):
            seen.add(signature((args, kwargs)))
            return fn(*args, **kwargs)
        return wrapped

    def __enter__(self) -> "RetraceSentinel":
        for name, (owner, attr) in self._jits.items():
            self._seen[name] = set()
            fn = getattr(owner, attr)
            owned = attr in getattr(owner, "__dict__", {})
            self._restore.append((owner, attr, fn, owned))
            setattr(owner, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc) -> None:
        while self._restore:
            owner, attr, fn, owned = self._restore.pop()
            if owned:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)
        self.compiles = {n: len(s) for n, s in self._seen.items()}
        return None

    def findings(self) -> List[Finding]:
        """Budget violations as gating findings (empty = within budget)."""
        out: List[Finding] = []
        for name, n in self.compiles.items():
            if self._exact is not None and name in self._exact \
                    and n != self._exact[name]:
                out.append(Finding(
                    "error", "retrace",
                    f"expected exactly {self._exact[name]} signature(s), "
                    f"saw {n}", path=name))
                continue
            cap = (self._budget.get(name) if isinstance(self._budget, dict)
                   else self._budget)
            if cap is not None and n > cap:
                out.append(Finding(
                    "error", "retrace",
                    f"signature budget {cap} exceeded: {n} signatures "
                    "(a shape or a non-tensor argument is varying per "
                    "call)", path=name))
        return out
