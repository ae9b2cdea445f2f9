"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427], as
the reference ``repro.models.rglru`` computes it.

Block = (x-branch: linear -> causal conv1d -> RG-LRU) ⊙ (y-branch: linear ->
GeLU) -> linear out.  RG-LRU recurrence (per channel):

    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(c * softplus(Λ) * (-r_t))     = a^(c·r_t), a = sigmoid(Λ)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The full-sequence forward runs the recurrence as a log-depth associative
scan over T (:func:`associative_scan`, the same odd/even recursion as
``jax.lax.associative_scan``); decode is one step carrying (h, conv
buffer).  The state has a fixed size, so no KV policy applies to these
layers (DMS compresses the hybrid's local-attention layers).

Matmuls run in the compute dtype from weights stored in it; ``lam`` and the
gate biases stay fp32 (:func:`repro_torch.bridge.params_from_numpy`), and
the gates and the recurrence run in fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ArchConfig, RGLRUConfig
from repro_torch.device import torch_dtype

_C = 8.0  # Griffin's fixed gate exponent


@dataclass
class RGLRUState:
    """One layer's recurrent state; leaves lane-leading (batch axis 0)."""

    h: torch.Tensor        # (B, W) fp32
    conv: torch.Tensor     # (B, K-1, W) fp32 storage of compute-dtype values
    length: torch.Tensor   # (B,) int32 per-lane position


def init_rglru(d_model: int, cfg: RGLRUConfig, normal: Callable,
               uniform: Callable) -> dict:
    """The reference's layout and scales.  ``normal(shape, scale)`` draws
    N(0, 1) · scale in the weights' dtype and ``uniform(shape, lo, hi)`` in
    fp32; both may prepend a stacking axis, which every leaf then carries.
    Λ is drawn so that a^c = sigmoid(Λ)^c spreads over (0.9, 0.999) at
    r = 1; Λ and the gate biases are fp32."""
    w = cfg.lru_width or d_model
    a0 = torch.exp(torch.log(uniform((w,), 0.9, 0.999)) / _C)
    lam = torch.log(a0) - torch.log1p(-a0)
    w_x = normal((d_model, w), d_model ** -0.5)
    return {
        "w_x": w_x,
        "w_y": normal((d_model, w), d_model ** -0.5),
        "conv_w": normal((cfg.conv_kernel, w), 0.1),
        "conv_b": torch.zeros_like(lam, dtype=w_x.dtype),
        "w_gate_r": normal((w, w), w ** -0.5),
        "b_gate_r": torch.zeros_like(lam),
        "w_gate_i": normal((w, w), w ** -0.5),
        "b_gate_i": torch.zeros_like(lam),
        "lam": lam,
        "w_out": normal((w, d_model), w ** -0.5),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) with no threshold, as ``jax.nn.softplus``
    (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(p: dict, u: torch.Tensor, dtype) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """u: (..., W) conv output.  Returns (log_a, gated input), fp32."""
    uf = u.to(dtype)
    r = torch.sigmoid((uf @ p["w_gate_r"].to(dtype)).float() + p["b_gate_r"])
    i = torch.sigmoid((uf @ p["w_gate_i"].to(dtype)).float() + p["b_gate_i"])
    # log a_t = c * r_t * log sigmoid(Λ) = -c * r_t * softplus(-Λ)   (<= 0)
    log_a = -_C * softplus(-p["lam"]) * r
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * u.float())
    return log_a, gated


def _combine(c1: Sequence[torch.Tensor], c2: Sequence[torch.Tensor]):
    """(a1, b1) then (a2, b2): h -> a2 (a1 h + b1) + b2."""
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, b1 * a2 + b2


def associative_scan(fn, elems: Sequence[torch.Tensor], dim: int = 1):
    """Inclusive scan of ``fn`` along ``dim``: the odd/even recursion of
    ``jax.lax.associative_scan`` (log₂T levels of ``fn`` over halves), so
    each output is combined in the reference's order."""
    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)

    def sl(a, start, stop=None, step=1):
        idx = [slice(None)] * a.dim()
        idx[dim] = slice(start, stop, step)
        return a[tuple(idx)]

    reduced = fn([sl(e, 0, -1, 2) for e in elems],
                 [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn([sl(e, 0, -1) for e in odd],
                  [sl(e, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):          # interleave: even at 0, 2, ...
        full = ev.new_empty(ev.shape[:dim] + (n,) + ev.shape[dim + 1:])
        sl(full, 0, None, 2).copy_(ev)
        sl(full, 1, None, 2).copy_(od)
        out.append(full)
    return out


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                prev: torch.Tensor, t: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv in x's dtype, op by op (the reference's
    rounding).  x: (B, T, C); w: (K, C); b: (C,); prev: (B, K-1, C)
    history.  Returns (y, the new history)."""
    k = w.shape[0]
    prev = prev.to(x.dtype)
    xp = torch.cat([prev, x], dim=1)
    wd = w.to(x.dtype)
    y = xp[:, 0:t] * wd[0]
    for i in range(1, k):
        y = y + xp[:, i:i + t] * wd[i]
    new_prev = xp[:, t:t + k - 1] if t >= k - 1 else torch.cat(
        [prev[:, t:], x], dim=1)
    return y + b.to(x.dtype), new_prev


def rglru_forward(p: dict, xin: torch.Tensor, arch: ArchConfig,
                  state: Optional[RGLRUState] = None
                  ) -> Tuple[torch.Tensor, RGLRUState]:
    """Full-sequence forward.  xin: (B, T, D).  Returns (out (B, T, D),
    final state); ``state`` carries h and the conv history in."""
    cfg = arch.rglru
    dtype = torch_dtype(arch.dtype)
    bsz, t, _ = xin.shape
    w = cfg.lru_width or arch.d_model
    k = cfg.conv_kernel
    xd = xin.to(dtype)
    x = xd @ p["w_x"].to(dtype)                               # (B,T,W)
    y = F.gelu((xd @ p["w_y"].to(dtype)).float(), approximate="tanh")

    pad = (torch.zeros((bsz, k - 1, w), dtype=x.dtype, device=x.device)
           if state is None else state.conv)
    u, new_conv = causal_conv(x, p["conv_w"], p["conv_b"], pad, t)

    log_a, gated = _gates(p, u, dtype)                        # (B,T,W) fp32
    a_seq = torch.exp(log_a)
    b_seq = gated
    if state is not None:
        b_seq = b_seq.clone()
        b_seq[:, 0] += a_seq[:, 0] * state.h.float()
    _, h_seq = associative_scan(_combine, (a_seq, b_seq), dim=1)

    out = (h_seq * y).to(dtype) @ p["w_out"].to(dtype)
    length = (state.length if state is not None else
              torch.zeros((bsz,), dtype=torch.int32, device=x.device)) + t
    return out.to(xin.dtype), RGLRUState(h_seq[:, -1], new_conv,
                                         length.to(torch.int32))


def rglru_decode_step(p: dict, x_t: torch.Tensor, state: RGLRUState,
                      arch: ArchConfig) -> Tuple[torch.Tensor, RGLRUState]:
    """One token.  x_t: (B, 1, D).  Returns (out (B, 1, D), new state) as
    new tensors (``state`` is not touched)."""
    dtype = torch_dtype(arch.dtype)
    xd = x_t.to(dtype)
    x = xd @ p["w_x"].to(dtype)                               # (B,1,W)
    y = F.gelu((xd @ p["w_y"].to(dtype)).float(), approximate="tanh")
    win = torch.cat([state.conv.to(x.dtype), x], dim=1)      # (B,K,W)
    u = (torch.einsum("bkw,kw->bw", win, p["conv_w"].to(dtype))
         + p["conv_b"].to(dtype))
    log_a, gated = _gates(p, u[:, None], dtype)
    h = torch.exp(log_a[:, 0]) * state.h.float() + gated[:, 0]
    out = ((h[:, None] * y).to(dtype) @ p["w_out"].to(dtype)).to(x_t.dtype)
    return out, RGLRUState(h, win[:, 1:], state.length + 1)


def init_rglru_state(batch: int, d_model: int, cfg: RGLRUConfig,
                     device=None) -> RGLRUState:
    w = cfg.lru_width or d_model
    return RGLRUState(
        torch.zeros((batch, w), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.conv_kernel - 1, w), dtype=torch.float32,
                    device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))
