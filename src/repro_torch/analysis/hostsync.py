"""Host-sync tripwire: flag reads of device values on the host inside a
decode region.

The port of the reference's ``repro.analysis.hostsync``.  A single stray
``.item()``/``.cpu()``/``np.asarray`` inside the decode loop serializes the
host against the device every step — the classic silent 10x serving
regression, and a step that syncs cannot be captured in a CUDA graph.  The
scheduler's design syncs the host exactly once per *chunk* (the
tick-boundary handoff: the chunk's inputs go up, its sampled tokens come
back) and the prefix cache moves snapshots between its tiers lazily;
everything else on the decode path stays on the device.

Two pieces:

* :func:`sanctioned` — a region marker wrapped around the code sites where
  a transfer is *by design* (the scheduler's tick boundary, the prefix
  cache's tier moves, the pool-pressure readback, the preemption snapshot).
  Unarmed, it costs a list push/pop.
* :class:`HostSyncTripwire` — a context manager that, while armed, records
  every read of a tensor's values on the host: ``Tensor.item``,
  ``tolist``, ``__bool__``/``__int__``/``__float__``/``__index__``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")`` (or ``.to`` of a device tensor
  to the host), ``np.asarray``/``np.array`` of tensors; and the ATen ops
  whose output shape depends on values, which sync to size their output
  (``nonzero``, ``masked_select``, a boolean-mask ``index``/``index_put``,
  ``unique*``, ``repeat_interleave`` of a tensor of repeats without
  ``output_size``, ``_local_scalar_dense``).  These are recorded **on every
  device**, so a CPU run predicts the syncs the card would make — the torch
  form of what the reference's patches of ``__array__``, ``item`` and
  ``device_get`` catch.  Each read is attributed to the innermost repo
  frame that caused it.  Reads inside a sanctioned region whose tag is in
  the allowlist are ``info``; everything else is a gating finding.

On a machine with CUDA, arming also sets
``torch.cuda.set_sync_debug_mode("error")``, and a sanctioned region lowers
it to 0 until it exits: the card's own check then raises on any
synchronising call outside a sanctioned region (a blocking host-to-device
copy included), backing up the Python hooks.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.passes import Finding

#: sanctioned tags armed tripwires permit by default: the scheduler's
#: once-per-chunk host handoff, the prefix cache's lazy moves between its
#: tiers, the scheduler's free-page readback when preemption is armed, and
#: the preempt-snapshot (same funnel as prefix demotion).  The fault
#: injector's own readbacks tag as "fault-inject" and are deliberately NOT
#: allowed here: injection is a test-harness act, never a serving path.
DEFAULT_ALLOW = ("tick-boundary", "prefix-demote", "pool-pressure",
                 "preempt-snapshot")

_SANCTIONED: List[str] = []          # active sanctioned-region tag stack
_ACTIVE: List["HostSyncTripwire"] = []   # armed tripwire stack
_PATCHED: List[Tuple] = []           # (owner, name, original, owned)
_IN_EVENT = [False]                  # reentrancy guard (item -> aten op)
_ARMED: List[Any] = []               # [dispatch mode, saved CUDA sync mode]


def _cuda() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def sanctioned(tag: str):
    """Mark a deliberate host transfer site (see DEFAULT_ALLOW)."""
    _SANCTIONED.append(tag)
    lowered = None
    if _ACTIVE and _cuda():
        lowered = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if lowered is not None:
            torch.cuda.set_sync_debug_mode(lowered)
        _SANCTIONED.pop()


def _origin() -> str:
    """Innermost repo frame outside this package and torch/numpy that
    triggered the read."""
    f = sys._getframe(2)
    fallback = ""
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch/analysis" not in fn and "/torch/" not in fn \
                and "numpy" not in fn:
            loc = f"{fn.rsplit('/', 1)[-1]}:{f.f_code.co_name}:{f.f_lineno}"
            if "/repro_torch/" in fn or "/src/" in fn:
                return loc
            if not fallback:
                fallback = loc
        f = f.f_back
    return fallback or "<unknown>"


def _record(kind: str) -> None:
    if not _ACTIVE or _IN_EVENT[0]:
        return
    _IN_EVENT[0] = True
    try:
        tag = _SANCTIONED[-1] if _SANCTIONED else None
        origin = _origin()
        for tw in _ACTIVE:
            tw._observe(kind, tag, origin)
    finally:
        _IN_EVENT[0] = False


def _guarded(kind: str, orig):
    """``orig`` that records ``kind``, and nothing the call does inside."""
    def wrapped(*args, **kwargs):
        if not _ACTIVE or _IN_EVENT[0]:
            return orig(*args, **kwargs)
        _record(kind)
        _IN_EVENT[0] = True
        try:
            return orig(*args, **kwargs)
        finally:
            _IN_EVENT[0] = False
    return wrapped


#: Tensor methods that read values on the host
_TENSOR_READS = {"item": ".item()", "tolist": ".tolist()",
                 "__bool__": "__bool__", "__int__": "__int__",
                 "__float__": "__float__", "__index__": "__index__",
                 "cpu": ".cpu()", "numpy": ".numpy()"}


def _to_host(t: torch.Tensor, args, kwargs) -> bool:
    """Does ``t.to(*args, **kwargs)`` read ``t`` on the host?  Yes when it
    moves a device tensor to the CPU, or names the host as the string
    ``"cpu"``; a ``torch.device`` that is the run's own compute device is
    an upload on the card and a no-op on a CPU run."""
    dev = kwargs.get("device")
    if dev is None and args:
        a = args[0]
        if isinstance(a, torch.Tensor):
            dev = a.device
        elif isinstance(a, (str, torch.device)):
            dev = a
    if dev is None:
        return False
    if torch.device(dev).type != "cpu":
        return False
    return t.device.type != "cpu" or isinstance(dev, str)


def _tensor_to(orig):
    def to(self, *args, **kwargs):
        if not _ACTIVE or _IN_EVENT[0] or not _to_host(self, args, kwargs):
            return orig(self, *args, **kwargs)
        _record('.to("cpu")')
        _IN_EVENT[0] = True
        try:
            return orig(self, *args, **kwargs)
        finally:
            _IN_EVENT[0] = False
    return to


def _np_wrapper(kind: str, orig):
    def wrapped(a=None, *rest, **kw):
        if isinstance(a, torch.Tensor) or (
                isinstance(a, (list, tuple))
                and any(isinstance(x, torch.Tensor) for x in a)):
            return _guarded(kind, orig)(a, *rest, **kw)
        return orig(a, *rest, **kw)
    return wrapped


_VALUE_SHAPED = frozenset({
    "nonzero", "argwhere", "masked_select", "unique", "_unique", "_unique2",
    "unique_dim", "unique_consecutive", "unique_dim_consecutive",
    "_local_scalar_dense"})


def _value_dependent(func, args, kwargs) -> Optional[str]:
    """The kind of a value-dependent op (its output shape, or its result,
    needs the values on the host), else None."""
    name = func._overloadpacket.__name__
    if name in _VALUE_SHAPED:
        return f"aten.{name}"
    if name == "repeat_interleave":
        reps = args[0] if func._overloadname == "Tensor" else (
            args[1] if len(args) > 1 else kwargs.get("repeats"))
        if isinstance(reps, torch.Tensor) and kwargs.get("output_size") is None:
            return "aten.repeat_interleave (no output_size)"
    if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(isinstance(i, torch.Tensor)
               and i.dtype in (torch.bool, torch.uint8) for i in idx or ()):
            return f"aten.{name} (boolean mask)"
    return None


class _ValueOps(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _ACTIVE and not _IN_EVENT[0]:
            kind = _value_dependent(func, args, kwargs)
            if kind is not None:
                _record(kind)
        return func(*args, **kwargs)


def _patch() -> None:
    T = torch.Tensor
    for name, kind in _TENSOR_READS.items():
        orig = getattr(T, name)
        _PATCHED.append((T, name, orig, name in T.__dict__))
        setattr(T, name, _guarded(kind, orig))
    _PATCHED.append((T, "to", T.to, "to" in T.__dict__))
    T.to = _tensor_to(T.to)
    for name in ("asarray", "array"):
        orig = getattr(np, name)
        _PATCHED.append((np, name, orig, True))
        setattr(np, name, _np_wrapper(f"np.{name}", orig))
    mode = _ValueOps()
    mode.__enter__()
    saved = None
    if _cuda():
        saved = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    _ARMED[:] = [mode, saved]


def _unpatch() -> None:
    mode, saved = _ARMED
    _ARMED.clear()
    if saved is not None:
        torch.cuda.set_sync_debug_mode(saved)
    mode.__exit__(None, None, None)
    while _PATCHED:
        owner, name, orig, owned = _PATCHED.pop()
        if owned:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)


class HostSyncTripwire:
    """Arm the host-read hooks for a region that must not sync the host."""

    def __init__(self, allow: Tuple[str, ...] = DEFAULT_ALLOW):
        self.allow = tuple(allow)
        #: every observed read: (kind, sanctioned tag or None, origin)
        self.events: List[Tuple[str, Optional[str], str]] = []

    def _observe(self, kind: str, tag: Optional[str], origin: str) -> None:
        self.events.append((kind, tag, origin))

    def __enter__(self) -> "HostSyncTripwire":
        if not _ACTIVE:
            _patch()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
        if not _ACTIVE:
            _unpatch()
        return None

    def findings(self) -> List[Finding]:
        out: List[Finding] = []
        for kind, tag, origin in self.events:
            if tag in self.allow:
                out.append(Finding("info", "host-sync",
                                   f"sanctioned host read ({tag}) via {kind}",
                                   path=origin))
            else:
                where = f"sanctioned({tag})" if tag else "unsanctioned"
                out.append(Finding("error", "host-sync",
                                   f"{where} host read of device values via "
                                   f"{kind} inside a decode region",
                                   path=origin))
        return out

    def violations(self) -> List[Finding]:
        return [f for f in self.findings() if f.severity == "error"]
