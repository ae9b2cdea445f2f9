"""Mamba-2 / SSD (state-space duality) block [arXiv:2405.21060], as the
reference ``repro.models.ssd`` computes it.

Chunked SSD: within a chunk the recurrence is a masked matmul (the
"attention" dual form); chunk states are carried by a scan over chunks.
Attention-free: no KV cache.  Decode carries a fixed-size (H, P, N) state
and a (K-1)-deep history for each of the three causal convs.

Projections are separate matrices (``w_z``/``w_x``/``w_b``/``w_c``/
``w_dt``), as in the reference.  ``a_log``, ``dt_bias``, ``d_skip`` and
``norm_scale`` stay fp32 (:func:`repro_torch.bridge.params_from_numpy`);
the chunk computation runs in fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ArchConfig, SSMConfig
from repro_torch.device import torch_dtype
from repro_torch.models.rglru import causal_conv, softplus
from repro_torch.parallel import spmd


@dataclass
class SSDState:
    """One layer's recurrent state; leaves lane-leading (batch axis 0)."""

    ssm: torch.Tensor      # (B, H, P, N) fp32
    conv_x: torch.Tensor   # (B, K-1, d_inner)
    conv_b: torch.Tensor   # (B, K-1, G*N)
    conv_c: torch.Tensor   # (B, K-1, G*N)
    length: torch.Tensor   # (B,) int32 per-lane position


def init_ssd(d_model: int, cfg: SSMConfig, normal: Callable) -> dict:
    """The reference's layout and scales.  ``normal(shape, scale)`` draws
    N(0, 1) · scale in the weights' dtype and may prepend a stacking axis,
    which every leaf then carries; the fp32 leaves are the reference's
    constants."""
    di = cfg.d_inner(d_model)
    nh = cfg.num_heads(d_model)
    gn = cfg.n_groups * cfg.d_state
    k = cfg.conv_kernel
    w_x = normal((d_model, di), d_model ** -0.5)
    lead = w_x.shape[:-2]
    dev = w_x.device

    def const(vec):
        return vec.to(dev).expand(lead + vec.shape).clone()

    def zeros(n):
        return torch.zeros(lead + (n,), dtype=w_x.dtype, device=dev)

    return {
        "w_z": normal((d_model, di), d_model ** -0.5),
        "w_x": w_x,
        "w_b": normal((d_model, gn), d_model ** -0.5),
        "w_c": normal((d_model, gn), d_model ** -0.5),
        "w_dt": normal((d_model, nh), d_model ** -0.5),
        "conv_x_w": normal((k, di), 0.1),
        "conv_x_b": zeros(di),
        "conv_b_w": normal((k, gn), 0.1),
        "conv_b_b": zeros(gn),
        "conv_c_w": normal((k, gn), 0.1),
        "conv_c_b": zeros(gn),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, nh))),
        "d_skip": const(torch.ones((nh,))),
        "dt_bias": const(torch.log(torch.expm1(torch.full((nh,), 0.01)))),
        "norm_scale": const(torch.ones((di,))),
        "w_out": normal((di, d_model), di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor, t: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`~repro_torch.models.rglru.causal_conv` then SiLU."""
    y, new_prev = causal_conv(x, w, b, prev, t)
    return F.silu(y), new_prev


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    yz = y * F.silu(z.float())
    var = torch.mean(yz * yz, dim=-1, keepdim=True)
    return (yz * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _project(p: dict, xd: torch.Tensor, dtype):
    return tuple(xd @ p[name].to(dtype)
                 for name in ("w_z", "w_x", "w_b", "w_c", "w_dt"))


def ssd_forward(p: dict, xin: torch.Tensor, arch: ArchConfig,
                state: Optional[SSDState] = None
                ) -> Tuple[torch.Tensor, SSDState]:
    """Full-sequence SSD.  xin: (B, T, D).  Returns (y, final state).  The
    chunk computation is :func:`ssd_chunked_ref`: the reference's
    ``use_kernel`` route reaches the same function (there is no SSD
    kernel), so the port has no such option."""
    cfg = arch.ssm
    dtype = torch_dtype(arch.dtype)
    bsz, t, d_model = xin.shape
    di = cfg.d_inner(d_model)
    nh = cfg.num_heads(d_model)
    g, n, ph = cfg.n_groups, cfg.d_state, cfg.head_dim
    k = cfg.conv_kernel
    z, x_in, b_in, c_in, dt = _project(p, xin.to(dtype), dtype)

    def hist(name, ch):
        return (torch.zeros((bsz, k - 1, ch), dtype=dtype, device=xin.device)
                if state is None else getattr(state, name))

    x, new_cx = _causal_conv(x_in, p["conv_x_w"], p["conv_x_b"],
                             hist("conv_x", di), t)
    bmat, new_cb = _causal_conv(b_in, p["conv_b_w"], p["conv_b_b"],
                                hist("conv_b", g * n), t)
    cmat, new_cc = _causal_conv(c_in, p["conv_c_w"], p["conv_c_b"],
                                hist("conv_c", g * n), t)

    x = x.reshape(bsz, t, nh, ph)
    bmat = bmat.reshape(bsz, t, g, n)
    cmat = cmat.reshape(bsz, t, g, n)
    dt = softplus(dt.float() + p["dt_bias"])                  # (B,T,H)
    a = -torch.exp(p["a_log"])                                # (H,)

    init = None if state is None else state.ssm
    y, final = spmd.local_ssd(ssd_chunked_ref, x, dt, a, bmat, cmat,
                              cfg.chunk_size, init_state=init)
    y = y + x.float() * p["d_skip"][None, None, :, None]
    y = _gated_norm(y.reshape(bsz, t, di).to(dtype), z, p["norm_scale"])
    out = (y.to(dtype) @ p["w_out"].to(dtype)).to(xin.dtype)
    length = (state.length if state is not None else
              torch.zeros((bsz,), dtype=torch.int32, device=xin.device)) + t
    return out, SSDState(final, new_cx, new_cb, new_cc,
                         length.to(torch.int32))


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bmat: torch.Tensor, cmat: torch.Tensor, q: int,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in fp32.  x: (B,T,H,P); dt: (B,T,H); a: (H,); B/C:
    (B,T,G,N).  T is zero-padded to a multiple of the chunk ``q``.
    Returns (y (B,T,H,P) fp32, final state (B,H,P,N) fp32)."""
    bsz, t, nh, ph = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if t % q:
        padlen = q - t % q
        x = F.pad(x, (0, 0, 0, 0, 0, padlen))
        dt = F.pad(dt, (0, 0, 0, padlen))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, padlen))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, padlen))
    tt = x.shape[1]
    nc = tt // q
    rep = nh // g

    xc = x.reshape(bsz, nc, q, nh, ph).float()
    dtc = dt.reshape(bsz, nc, q, nh).float()
    bh = bmat.reshape(bsz, nc, q, g, n).float().repeat_interleave(rep, dim=3)
    ch = cmat.reshape(bsz, nc, q, g, n).float().repeat_interleave(rep, dim=3)

    da = dtc * a.float()                                      # (B,NC,Q,H)
    cum = torch.cumsum(da, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,NC,Qi,Qj,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    l_mat = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)

    scores = torch.einsum("bcihn,bcjhn->bcijh", ch, bh) * l_mat
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", scores, dtc, xc)

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,NC,Q,H)
    chunk_state = torch.einsum("bcjh,bcjh,bcjhn,bcjhp->bchpn",
                               decay_to_end, dtc, bh, xc)     # (B,NC,H,P,N)
    chunk_decay = torch.exp(torch.sum(da, dim=2))             # (B,NC,H)

    s = (torch.zeros((bsz, nh, ph, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    before = []                                # the state entering each chunk
    for c in range(nc):
        before.append(s)
        s = s * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    states_before = torch.stack(before, dim=1)                # (B,NC,H,P,N)

    y_inter = torch.einsum("bcihn,bchpn->bcihp",
                           ch * torch.exp(cum)[..., None], states_before)
    y = (y_intra + y_inter).reshape(bsz, tt, nh, ph)
    return y[:, :t], s


def ssd_decode_step(p: dict, x_t: torch.Tensor, state: SSDState,
                    arch: ArchConfig) -> Tuple[torch.Tensor, SSDState]:
    """One token.  x_t: (B, 1, D).  Returns (out (B, 1, D), new state) as
    new tensors (``state`` is not touched)."""
    cfg = arch.ssm
    dtype = torch_dtype(arch.dtype)
    bsz, _, d_model = x_t.shape
    di = cfg.d_inner(d_model)
    nh = cfg.num_heads(d_model)
    g, n, ph = cfg.n_groups, cfg.d_state, cfg.head_dim
    z, x_in, b_in, c_in, dt = _project(p, x_t.to(dtype), dtype)

    x, new_cx = _causal_conv(x_in, p["conv_x_w"], p["conv_x_b"],
                             state.conv_x, 1)
    bmat, new_cb = _causal_conv(b_in, p["conv_b_w"], p["conv_b_b"],
                                state.conv_b, 1)
    cmat, new_cc = _causal_conv(c_in, p["conv_c_w"], p["conv_c_b"],
                                state.conv_c, 1)

    x = x.reshape(bsz, nh, ph).float()
    bmat = bmat.reshape(bsz, g, n).repeat_interleave(nh // g, dim=1).float()
    cmat = cmat.reshape(bsz, g, n).repeat_interleave(nh // g, dim=1).float()
    dt = softplus(dt[:, 0].float() + p["dt_bias"])            # (B,H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a[None])
    s = (state.ssm.float() * decay[..., None, None]
         + torch.einsum("bh,bhn,bhp->bhpn", dt, bmat, x))
    y = torch.einsum("bhn,bhpn->bhp", cmat, s)
    y = y + x * p["d_skip"][None, :, None]
    y = _gated_norm(y.reshape(bsz, 1, di).to(dtype), z, p["norm_scale"])
    out = (y.to(dtype) @ p["w_out"].to(dtype)).to(x_t.dtype)
    return out, SSDState(s, new_cx, new_cb, new_cc, state.length + 1)


def init_ssd_state(batch: int, d_model: int, cfg: SSMConfig,
                   device=None) -> SSDState:
    di = cfg.d_inner(d_model)
    nh = cfg.num_heads(d_model)
    gn = cfg.n_groups * cfg.d_state
    k1 = cfg.conv_kernel - 1

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return SSDState(zeros(batch, nh, cfg.head_dim, cfg.d_state),
                    zeros(batch, k1, di), zeros(batch, k1, gn),
                    zeros(batch, k1, gn),
                    torch.zeros((batch,), dtype=torch.int32, device=device))
