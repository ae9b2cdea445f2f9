"""ATen op traces of one eager call, and the traffic counters over them.

The port of the reference's ``repro.analysis.jaxpr``.  The reference lints
a jaxpr; an eager PyTorch program has none, so the port records the ATen
ops a call dispatches (``torch.utils._python_dispatch.TorchDispatchMode``)
and the lint passes (:mod:`repro_torch.analysis.passes`) walk that list.
Each :class:`OpEvent` keeps the op's name, its tensor inputs' and outputs'
shapes, dtypes and devices, whether it writes an input in place
(``index_put_``, ``copy_``, ``scatter_``: the schema's ``alias_info``) and
which outputs are fresh storage (neither a schema alias nor sharing an
input's storage, so views and in-place results never count as copies).

**Kernel events.**  While a recorder is armed, the kernel entry points
(``repro_torch.kernels.dms_decode.ops.decode_rows`` and
``repro_torch.kernels.dms_attention.ops.flash_fwd``/``flash_dq``/
``flash_dkv``) are patched at their module attributes: each call logs one
``kernel`` event and recording is suspended inside it.  As a
``pallas_call``'s body is opaque in a jaxpr, the plain version that stands
in for the kernel on the CPU (its fp32 casts and gathers) is not linted;
the wrapper's own ops around the kernel (``dms_decode_attention``,
``table_weights_to_arena``) are.

**No dead-code elimination.**  The reference lints a DCE'd jaxpr, so an op
whose result nothing uses is dropped before linting.  Eager mode deletes
nothing: every op recorded is an op the device runs, which makes these
lints stricter than the reference's.

The counters (:func:`count_arena_copies`, :func:`count_big_float_ops`) are
the ones the port's benchmarks import, so the lints and the benchmarks
count the same ops the same way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: (module, attribute) of every kernel entry point a recorder wraps
KERNEL_ENTRY_POINTS = (
    ("repro_torch.kernels.dms_decode.ops", "decode_rows"),
    ("repro_torch.kernels.dms_attention.ops", "flash_fwd"),
    ("repro_torch.kernels.dms_attention.ops", "flash_dq"),
    ("repro_torch.kernels.dms_attention.ops", "flash_dkv"),
)


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: str

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize

    @property
    def floating(self) -> bool:
        return self.dtype.is_floating_point

    def __str__(self) -> str:
        return f"{str(self.dtype).removeprefix('torch.')}{list(self.shape)}"


def _meta(t: torch.Tensor) -> TensorMeta:
    return TensorMeta(tuple(t.shape), t.dtype, t.device.type)


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One dispatched ATen op (``kind == "op"``) or kernel entry-point call
    (``kind == "kernel"``).  ``fresh`` flags, per output, storage of its
    own (not a view, not an in-place result)."""

    name: str                        # "cat", "_to_copy", "decode_rows", ...
    overload: str = ""
    inputs: Tuple[TensorMeta, ...] = ()
    outputs: Tuple[TensorMeta, ...] = ()
    fresh: Tuple[bool, ...] = ()
    inplace: bool = False
    kind: str = "op"

    @property
    def fresh_outputs(self) -> Tuple[TensorMeta, ...]:
        return tuple(m for m, f in zip(self.outputs, self.fresh) if f)

    def __str__(self) -> str:
        outs = ",".join(str(m) for m in self.outputs)
        pre = "kernel:" if self.kind == "kernel" else "aten."
        return f"{pre}{self.name}->{outs}"


@dataclasses.dataclass
class OpTrace:
    """The ops of one call, in dispatch order, and what the call
    returned."""

    events: List[OpEvent]
    result: Any = None

    @property
    def kernel_events(self) -> List[OpEvent]:
        return [e for e in self.events if e.kind == "kernel"]


def tensor_leaves(node: Any, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor leaf of a call's arguments or result:
    dicts, lists, tuples and dataclasses (a decode state) are walked, other
    values hold none."""
    if isinstance(node, torch.Tensor):
        return [(path, node)]
    if isinstance(node, dict):
        return [x for k, v in node.items()
                for x in tensor_leaves(v, f"{path}[{k!r}]")]
    if isinstance(node, (list, tuple)):
        return [x for i, v in enumerate(node)
                for x in tensor_leaves(v, f"{path}[{i}]")]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [x for f in dataclasses.fields(node)
                for x in tensor_leaves(getattr(node, f.name),
                                       f"{path}.{f.name}")]
    return []


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None


class OpRecorder(TorchDispatchMode):
    """Records every ATen op dispatched while active, and one kernel event
    per call of a kernel entry point (recording nothing inside it)."""

    def __init__(self):
        super().__init__()
        self.events: List[OpEvent] = []
        self._inside_kernel = 0
        self._patched: List[Tuple[Any, str, Any]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside_kernel:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        schema = func._schema
        inplace = any(a.alias_info is not None and a.alias_info.is_write
                      for a in schema.arguments)
        aliased = any(r.alias_info is not None for r in schema.returns)
        in_storage = {s for s in map(_storage, ins) if s is not None}
        fresh = tuple(not aliased and _storage(o) not in in_storage
                      for o in outs)
        self.events.append(OpEvent(
            func._overloadpacket.__name__, func._overloadname,
            tuple(map(_meta, ins)), tuple(map(_meta, outs)), fresh, inplace))
        return out

    def _kernel(self, name: str, real: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            if self._inside_kernel:
                return real(*args, **kwargs)
            self._inside_kernel += 1
            try:
                out = real(*args, **kwargs)
            finally:
                self._inside_kernel -= 1
            outs = _tensors(out)
            self.events.append(OpEvent(
                name, "", tuple(map(_meta, _tensors((args, kwargs)))),
                tuple(map(_meta, outs)), (True,) * len(outs), False,
                "kernel"))
            return out
        wrapped.__wrapped__ = real
        return wrapped

    def __enter__(self):
        import importlib
        for mod_name, attr in KERNEL_ENTRY_POINTS:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, attr)
            self._patched.append((mod, attr, real))
            setattr(mod, attr, self._kernel(attr, real))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            while self._patched:
                mod, attr, real = self._patched.pop()
                setattr(mod, attr, real)


def trace_ops(fn: Callable, *args, **kwargs) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpRecorder`; the
    call really runs (on whatever device its tensors live)."""
    with OpRecorder() as rec:
        result = fn(*args, **kwargs)
    return OpTrace(rec.events, result)


def walk_ops(trace: OpTrace) -> Iterator[OpEvent]:
    """Every event of ``trace`` in dispatch order (an eager trace is flat:
    there are no sub-programs to recurse into)."""
    yield from trace.events


def out_elems(ev: OpEvent) -> int:
    """Largest fresh output element count of one event (0 when every output
    is a view or an in-place result)."""
    return max((m.numel for m in ev.fresh_outputs), default=0)


#: ops that materialise a copy of their operand: the torch forms of the
#: reference's ``pad``/``concatenate`` (``_to_copy`` only without a dtype
#: change; with one it is a cast)
COPY_OPS = frozenset({"cat", "stack", "constant_pad_nd", "pad", "clone",
                      "copy", "_to_copy"})


def is_cast(ev: OpEvent) -> bool:
    """A ``_to_copy`` that changes dtype (``.float()``, ``.to(dtype)``)."""
    return (ev.kind == "op" and ev.name == "_to_copy" and ev.inputs
            and ev.outputs and ev.inputs[0].dtype != ev.outputs[0].dtype)


def is_copy(ev: OpEvent) -> bool:
    """An op of :data:`COPY_OPS` that is not a cast and writes fresh
    storage."""
    return (ev.kind == "op" and ev.name in COPY_OPS and not ev.inplace
            and not is_cast(ev))


def count_arena_copies(fn: Callable, *args, arena_elems: int
                       ) -> Dict[str, int]:
    """Count full-arena copy ops in one call of ``fn``: :func:`is_copy`
    ops whose fresh output is arena-sized or larger (the seed wrapper's
    per-step re-pad), and casts of arena-sized *integer/bool* operands (the
    seed's ``valid.astype(int32)`` recast).  The block-table step path must
    show zero of each."""
    pads = casts = 0
    for ev in walk_ops(trace_ops(fn, *args)):
        big = out_elems(ev) >= arena_elems
        if big and is_copy(ev):
            pads += 1
        elif big and is_cast(ev) and not ev.inputs[0].floating:
            casts += 1
    return {"arena_pad_copies": pads, "valid_recasts": casts}


def count_big_float_ops(trace: OpTrace, min_elems: int) -> int:
    """Fresh float outputs of at least ``min_elems`` elements: K/V bytes
    actually moving.  Integer metadata at any size is not counted, and an
    in-place write's output (the arena it wrote a token into) is not
    fresh."""
    return sum(1 for ev in walk_ops(trace) for m in ev.fresh_outputs
               if m.floating and m.numel >= min_elems)
