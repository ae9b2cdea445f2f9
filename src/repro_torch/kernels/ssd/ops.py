"""SSD chunk computation, at the reference's import path
(``repro.kernels.ssd.ops``).

The reference routes ``ssd_chunked`` to its chunked ``jnp`` formulation and
reaches no ``pallas_call``; the port routes it to the same computation in
PyTorch (:func:`repro_torch.models.ssd.ssd_chunked_ref`).  There is no CUDA
source: it is batched matmuls and elementwise ops, which PyTorch dispatches
to the library's kernels.
"""
from __future__ import annotations

from repro_torch.models.ssd import ssd_chunked_ref


def ssd_chunked(x, dt, a, bmat, cmat, *, chunk: int, init_state=None):
    return ssd_chunked_ref(x, dt, a, bmat, cmat, chunk, init_state=init_state)
