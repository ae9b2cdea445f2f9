"""Roofline terms of one (arch × shape × mesh) cell on H100s.

Three terms per cell, in seconds, per card:

    compute    = FLOPs_per_card        / PEAK_FLOPS
    memory     = modeled_bytes_per_card / HBM_BW
    collective = NVLink wire bytes / NVLINK_BW + inter-node wire bytes / INTERNODE_BW

The reference reads FLOPs from XLA's ``cost_analysis()`` and its
collectives from the compiled HLO text.  Here the dry-run
(:mod:`repro_torch.launch.dryrun`) measures them on the program itself: the
FLOPs of the local ops a card runs (the counters of
:mod:`torch.utils.flop_counter`), and each collective as (op, output bytes,
group size), as :class:`torch.distributed.tensor.debug.CommDebugMode` sees
them.  :func:`parse_collectives` applies the reference's ring factors to
that list:

    all-reduce      2(n-1)/n · bytes       all-gather      (n-1)/n · out_bytes
    reduce-scatter  (n-1) · out_bytes      all-to-all      (n-1)/n · bytes
    collective-permute  1 · bytes

Hardware (NVIDIA's H100 SXM data sheet, dense rates): 989 TFLOP/s bf16 on
the tensor cores, 80 GB of HBM3 at 3.35 TB/s, NVLink 450 GB/s each way
between the 8 cards of a node.  A collective whose group spans more than
one node (more than :data:`NODE_CARDS` cards: a mesh lays ranks out row
major, so a group of 16 crosses a node boundary) runs at the inter-node
link's rate, which this module assumes to be one 400 Gb/s InfiniBand NDR
port per card (a DGX H100's ConnectX-7 layout): 50 GB/s each way.  Those
bytes are tallied apart (``internode_bytes``), in place of the reference's
DCI bytes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

# NVIDIA H100 SXM (per card)
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BW = 3.35e12             # B/s
HBM_BYTES = 80e9             # the memory-fit test
NVLINK_BW = 450e9            # B/s each way, within a node
NODE_CARDS = 8
INTERNODE_BW = 50e9          # B/s each way: one 400 Gb/s NDR port per card

#: q rows per block of the port's flash forward kernel (``kFwdRows`` in
#: kernels/dms_attention/csrc/dms_attention.cu:771): the prefill streams K/V
#: once per block
FLASH_Q_ROWS = 64

Collective = Tuple[str, float, int]      # (op, output bytes, group size)


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    internode_bytes: float = 0.0
    op_bytes: Dict[str, float] = field(default_factory=dict)
    op_counts: Dict[str, int] = field(default_factory=dict)

    def add(self, op: str, bytes_: float, internode: bool):
        self.wire_bytes += bytes_
        if internode:
            self.internode_bytes += bytes_
        self.op_bytes[op] = self.op_bytes.get(op, 0.0) + bytes_
        self.op_counts[op] = self.op_counts.get(op, 0) + 1


def wire_bytes(op: str, out_bytes: float, n: int) -> float:
    """Bytes one card puts on the wire for a ring collective over ``n``."""
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * out_bytes
    if op == "all-gather":
        return (n - 1) / n * out_bytes
    if op == "reduce-scatter":
        return (n - 1) * out_bytes
    if op in ("all-to-all", "ragged-all-to-all"):
        return (n - 1) / n * out_bytes
    return float(out_bytes)                          # collective-permute


def parse_collectives(records: Iterable[Collective]) -> CollectiveStats:
    """Ring-factor wire bytes of recorded collectives; groups of one card
    move nothing."""
    stats = CollectiveStats()
    for op, out_bytes, n in records:
        if n <= 1:
            continue
        stats.add(op, wire_bytes(op, out_bytes, n), internode=n > NODE_CARDS)
    return stats


def modeled_bytes_per_device(arch, shape, kind: str, *, num_devices: int,
                             tp: int, dp: int, policy: str = "vanilla",
                             cr: float = 1.0, accum: int = 8,
                             remat: bool = True) -> Dict[str, float]:
    """Analytic per-card HBM traffic for one step (the reference's model:
    bf16 matmul operands, flash attention keeping its tiles on chip, fused
    elementwise chains).  One term is the card's own: the prefill streams
    K/V once per :data:`FLASH_Q_ROWS`-row q block of the port's flash
    kernel, where the reference's TPU kernel streams it once per 2048
    rows."""
    p_total = arch.param_count(active_only=False)
    p_active = arch.param_count(active_only=True)
    p_dev = p_total / tp * 2.0                     # bf16 shard
    d = arch.d_model
    l = arch.num_layers + arch.encoder_layers
    b_loc = max(shape.global_batch / dp, 1.0)
    t = shape.seq_len

    if kind == "train":
        mb_tokens = b_loc * t / accum
        act_coeff = 30.0 if remat else 22.0        # r+w per token-dim, fwd+bwd(+remat)
        act = l * mb_tokens * d * 2.0 * act_coeff * accum
        grads = p_total / tp * 4.0 * 2.0 * accum   # fp32 accumulate r+w
        opt = p_total / (tp * dp) * 4.0 * 3.0 * 2.0  # m, v, master r+w
        logits = mb_tokens * arch.vocab_size / tp * 4.0 * 4.0 * accum
        total = 3.0 * p_dev + grads + opt + act + logits
        return {"params": 3.0 * p_dev, "grads": grads, "opt": opt,
                "activations": act, "logits": logits, "total": total}
    if kind == "prefill":
        a = arch.attn
        act = l * b_loc * t * d * 2.0 * 8.0
        cache_w = (0 if a is None else
                   2.0 * l * b_loc * t * a.num_kv_heads * a.head_dim * 2.0
                   / max(tp // max(a.num_kv_heads, 1), 1) / cr)
        blk = float(FLASH_Q_ROWS)
        attn_stream = (0 if a is None else
                       b_loc * max(a.num_kv_heads / tp, 1.0 / tp) * tp / tp *
                       (t * t / 2.0 / blk) * a.head_dim * 2.0 * 2.0 * l / cr)
        total = p_dev + act + cache_w + attn_stream
        return {"params": p_dev, "activations": act, "cache_write": cache_w,
                "attn_stream": attn_stream, "total": total}
    # decode
    a = arch.attn
    cache = 0.0
    if a is not None:
        kinds = [arch.layer_pattern[i % len(arch.layer_pattern)]
                 for i in range(arch.num_layers)]
        n_attn = sum(1 for k in kinds if k in ("attn", "attn_local"))
        n_local = sum(1 for k in kinds if k == "attn_local")
        h_shard = (max(a.num_kv_heads / tp, 1.0) if shape.global_batch >= dp
                   else a.num_kv_heads)
        seq_fact = 1.0 if shape.global_batch >= dp else 1.0 / dp
        eff_len_g = min(t, a.window or t)
        full_len = t / cr
        cache = 2.0 * 2.0 * h_shard * a.head_dim * b_loc * seq_fact * (
            (n_attn - n_local) * full_len + n_local * min(eff_len_g, full_len))
    ssm_state = 0.0
    if arch.ssm is not None:
        nh = arch.ssm.num_heads(d) / tp
        ssm_state = (arch.num_layers * b_loc * nh * arch.ssm.head_dim
                     * arch.ssm.d_state * 4.0 * 2.0)
    if arch.rglru is not None:
        n_rg = sum(1 for k in arch.layer_pattern if k == "rglru")
        ssm_state += (arch.num_layers * n_rg / len(arch.layer_pattern)
                      * b_loc * (arch.rglru.lru_width or d) / tp * 4.0 * 2.0)
    act = l * b_loc * d * 2.0 * 8.0
    total = 2.0 * p_active / tp + cache + ssm_state + act
    return {"params": 2.0 * p_active / tp, "kv_cache": cache,
            "state": ssm_state, "activations": act, "total": total}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    num_devices: int
    flops_per_device: float
    modeled_bytes_per_dev: float      # the analytic traffic model
    wire_bytes_per_device: float
    internode_bytes_per_device: float
    compute_s: float
    memory_model_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_flops_ratio: float
    step_time_s: float            # max(compute, memory_model, collective)
    hw_util: float                # model_flops / (cards * peak * step_time)
    memory_analysis: Dict[str, float] = field(default_factory=dict)
    memory_breakdown: Dict[str, float] = field(default_factory=dict)
    collective_ops: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(*, flops: float, collectives: Iterable[Collective], arch: str,
            shape: str, mesh_desc: str, num_devices: int, model_flops: float,
            modeled: Dict[str, float],
            memory: Optional[Dict[str, float]] = None) -> RooflineReport:
    """The roofline of a cell from what its dry-run measured: per-card
    ``flops``, the ``collectives`` a card issued and (optionally) its
    ``memory`` figures, beside the analytic traffic ``modeled``."""
    coll = parse_collectives(collectives)
    compute_s = flops / PEAK_FLOPS
    memory_model_s = modeled["total"] / HBM_BW
    collective_s = ((coll.wire_bytes - coll.internode_bytes) / NVLINK_BW
                    + coll.internode_bytes / INTERNODE_BW)
    terms = {"compute": compute_s, "memory": memory_model_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values())
    total_flops = flops * num_devices
    ratio = model_flops / total_flops if total_flops else 0.0
    util = (model_flops / (num_devices * PEAK_FLOPS * step_time)
            if step_time > 0 else 0.0)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_desc, num_devices=num_devices,
        flops_per_device=flops, modeled_bytes_per_dev=float(modeled["total"]),
        wire_bytes_per_device=coll.wire_bytes,
        internode_bytes_per_device=coll.internode_bytes,
        compute_s=compute_s, memory_model_s=memory_model_s,
        collective_s=collective_s, bottleneck=bottleneck,
        model_flops=model_flops, useful_flops_ratio=ratio,
        step_time_s=step_time, hw_util=util,
        memory_analysis=dict(memory or {}),
        memory_breakdown={k: float(v) for k, v in modeled.items()},
        collective_ops=coll.op_bytes, collective_counts=coll.op_counts)


def model_flops_for(arch, shape, kind: str) -> float:
    """MODEL_FLOPS: 6·N·D (train) / 2·N·D (forward only), N = active
    params."""
    n_active = arch.param_count(active_only=True)
    if kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
