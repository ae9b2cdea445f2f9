"""Int8 error-feedback gradient compression for data parallelism over slow
links.

The reference's ``repro.optim.compress`` on torch tensors.  Across nodes
the data-parallel reduction crosses the inter-node links (slow beside
NVLink); quantising gradients to int8 with one fp32 scale per tensor cuts
those bytes about 2× from bf16 (4× from fp32).  Error feedback (the
residual carry) keeps the compression unbiased over steps (the 1-bit Adam
/ EF-SGD lineage).

:func:`all_reduce_compressed` stands in for the reference's
``psum_compressed``: the error-feedback mean over a process group, whose
wire payload is what that docstring promises — the int8 values and one
fp32 scale per tensor (an all-gather of both), dequantised and summed in
fp32 in rank order on every rank.  Use it on the slow group only; fast
in-node reductions stay full precision.

``torch.round`` and ``jnp.round`` both round half to even, so the int8
values and scales equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, 0-d fp32 scale) with ``x ≈ q · scale``."""
    x = x.float()
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def zeros_like_residual(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_grads(grads: Any, residual: Optional[Any]
                   ) -> Tuple[Any, Any, Any]:
    """Returns (int8 tree, fp32 scale tree of 0-d tensors, new fp32
    residual tree): each leaf quantises ``grad + residual`` and keeps what
    the quantisation lost."""
    g_leaves = tree_leaves(grads)
    r_leaves = (tree_leaves(residual) if residual is not None
                else [torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device) for g in g_leaves])
    qs, ss, rs = [], [], []
    for g, r in zip(g_leaves, r_leaves):
        x = g.float() + r
        q, s = quantize_int8(x)
        qs.append(q)
        ss.append(s)
        rs.append(x - dequantize_int8(q, s))
    return (tree_unflatten(grads, qs), tree_unflatten(grads, ss),
            tree_unflatten(grads, rs))


def decompress_grads(q_tree: Any, scale_tree: Any) -> Any:
    return tree_map(dequantize_int8, q_tree, scale_tree)


def payload_bytes(q_tree: Any) -> int:
    """Bytes one rank sends for a compressed tree: int8 values and one fp32
    scale per tensor."""
    return sum(q.numel() + 4 for q in tree_leaves(q_tree))


def all_reduce_compressed(grads: Any, group=None,
                          residual: Optional[Any] = None
                          ) -> Tuple[Any, Any]:
    """Error-feedback int8 mean over ``group`` (None: the default group).

    Each rank quantises ``grad + residual``, all-gathers the int8 values
    and the scales, dequantises every rank's contribution and sums them in
    fp32 in rank order, then divides by the group size: every rank gets
    the same bits.  Returns (mean tree fp32, new residual tree), the
    residual staying on its rank."""
    q_tree, s_tree, new_res = compress_grads(grads, residual)
    n = dist.get_world_size(group)

    def reduce_one(q, s):
        s = s.reshape(1)                 # a collective takes no 0-d tensor
        qs = [torch.empty_like(q) for _ in range(n)]
        ss = [torch.empty_like(s) for _ in range(n)]
        dist.all_gather(qs, q.contiguous(), group=group)
        dist.all_gather(ss, s.contiguous(), group=group)
        total = dequantize_int8(qs[0], ss[0][0])
        for qi, si in zip(qs[1:], ss[1:]):
            total = total + dequantize_int8(qi, si[0])
        return total / n

    return tree_map(reduce_one, q_tree, s_tree), new_res
