"""Decode-path auditor of the port (the reference ``repro.analysis``).

The main path's hardest invariants — no arena-sized copy, cast or gather
in a decode step, a kernel really launched in kernel mode, one input
signature per chunk step, no host sync inside the decode loop — as checks
that run on the program itself:

* :mod:`repro_torch.analysis.optrace` — the ATen op trace of one eager
  call (kernel entry points as ``kernel`` events) and the traffic counters
  the benchmarks import.
* :mod:`repro_torch.analysis.passes` — :class:`Finding`, the pass registry
  and the traffic lints (arena pads/casts, KV upcasts, arena gathers,
  reference fallback, device-scalar outputs).
* :mod:`repro_torch.analysis.retrace` — :class:`RetraceSentinel`, an exact
  input-signature budget over named step callables.
* :mod:`repro_torch.analysis.hostsync` — :class:`HostSyncTripwire` and the
  :func:`sanctioned` region marker for deliberate host transfers.
* :mod:`repro_torch.analysis.contracts` — KVPolicy lifecycle and tree
  invariance checkers.
* ``python -m repro_torch.analysis.audit`` — the gate: sweeps every
  registered policy × {ref, kernel} × {fixed, paged} and exits nonzero on
  any gating finding.
"""
from repro_torch.analysis.contracts import (check_policy_lifecycle,
                                            check_tree_invariance)
from repro_torch.analysis.hostsync import (DEFAULT_ALLOW, HostSyncTripwire,
                                           sanctioned)
from repro_torch.analysis.optrace import (count_arena_copies,
                                          count_big_float_ops, trace_ops,
                                          walk_ops)
from repro_torch.analysis.passes import (Finding, LintContext,
                                         available_passes, gating,
                                         register_pass, run_passes)
from repro_torch.analysis.retrace import RetraceSentinel

__all__ = [
    "Finding", "LintContext", "register_pass", "available_passes",
    "run_passes", "gating", "trace_ops", "walk_ops", "count_arena_copies",
    "count_big_float_ops", "RetraceSentinel", "HostSyncTripwire",
    "sanctioned", "DEFAULT_ALLOW", "check_policy_lifecycle",
    "check_tree_invariance",
]
