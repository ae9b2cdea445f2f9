"""Wrapper of the DMS flash-attention kernels, with their backward.

:func:`dms_flash_attention` takes the relaxed (or binarised) eviction
decisions ``alpha`` and differentiates through the mask as the reference
``repro.kernels.dms_attention.ops`` does: ``log_surv = log1p(-alpha)`` is
computed *outside* the :class:`torch.autograd.Function`, so autograd carries
the α chain rule, while the O(T²) attention body and its gradients are the
hand-written kernels: ``flash_fwd`` forward, ``flash_dq`` and ``flash_dkv``
backward (``csrc/dms_attention.cu``).

CUDA tensors go to the kernels or the call raises; CPU tensors go to the
plain versions (:mod:`.ref`).  Nothing else picks the path.  On the card
the dtype picks the kernel: the bf16 kernels run on the tensor cores and
take a head dim of 64 or 128, so their wrappers zero-pad a smaller one
(:func:`pad_head_dim`) and slice the outputs back; fp32 runs on the CUDA
cores at any head dim up to 128.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dms_attention.ref import (NEG_INF, FlashConfig,
                                                   flash_dkv_plain,
                                                   flash_dq_plain,
                                                   flash_fwd_plain)

DEFAULT_BLOCK_K = 128
MAX_DH = 128
SOURCE = Path(__file__).resolve().parent / "csrc" / "dms_attention.cu"

#: kernel launches since the last reset, per kernel (the CPU path never counts)
launches: Dict[str, int] = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # after the pointers: the dtype flag, the row count, the 12 shape/mask
    # ints of `_ints`, cap, scale and the stream
    tail = [i32] * 14 + [f32, f32, ptr]
    for name, n_ptrs in (("dms_flash_fwd", 7), ("dms_flash_dq", 9),
                         ("dms_flash_dkv", 11)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ptr] * n_ptrs + tail
            fn.restype = i32
    return lib


def build() -> None:
    """Compile and load the kernels now (``chip_smoke.py`` times this)."""
    _library()


def _check(name: str, cfg: FlashConfig, q, k, v, ls, hr, do=None, lse=None,
           delta=None) -> None:
    """Raise on what the kernels do not take."""
    if cfg.window is not None and cfg.window < 1:
        raise ValueError(f"window must be >= 1 or None, got {cfg.window}")
    bhq, tp, dh = q.shape
    if dh != cfg.orig_dh or not 1 <= dh <= MAX_DH:
        raise ValueError(f"{name} kernel takes head_dim <= {MAX_DH} equal to "
                         f"cfg.orig_dh; got {dh}, cfg {cfg.orig_dh}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel: q/k/v must share one dtype of "
                        f"{_DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (bhq // cfg.hq * cfg.hkv, tp, dh) or v.shape != k.shape:
        raise ValueError(f"{name} kernel: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} with Hq={cfg.hq}, Hkv={cfg.hkv}")
    if ls.dtype != torch.float32 or ls.shape != k.shape[:2]:
        raise TypeError(f"{name} kernel: ls must be float32 {tuple(k.shape[:2])}")
    named = dict(q=q, k=k, v=v, ls=ls)
    if cfg.skip_blocks:
        if hr is None or hr.dtype != torch.int32 or \
                hr.shape != (k.shape[0], tp // cfg.block_k):
            raise TypeError(f"{name} kernel: skip_blocks needs hr, int32 "
                            f"{(k.shape[0], tp // cfg.block_k)}")
        named["hr"] = hr
    if do is not None:
        if do.shape != q.shape or do.dtype != q.dtype:
            raise TypeError(f"{name} kernel: do must be {q.dtype} "
                            f"{tuple(q.shape)}, got {do.dtype} {tuple(do.shape)}")
        for arg, t in (("lse", lse), ("delta", delta)):
            if t.dtype != torch.float32 or t.shape != q.shape[:2]:
                raise TypeError(f"{name} kernel: {arg} must be float32 "
                                f"{tuple(q.shape[:2])}, got {t.dtype} "
                                f"{tuple(t.shape)}")
        named.update(do=do, lse=lse, delta=delta)
    for arg, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {arg} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} kernel: {arg} on {t.device}, q on {q.device}")


def _ints(cfg: FlashConfig, tp: int, dh: int) -> list:
    """The shared shape/mask ints of every entry point, after the row count:
    ``dh`` is the operands' head dim, the scale is ``cfg.orig_dh ** -0.5``."""
    return [tp, dh, cfg.hq, cfg.hkv, cfg.t, tp // cfg.block_k,
            cfg.block_k, cfg.window if cfg.window is not None else -1,
            cfg.dms_delay, int(cfg.causal), int(cfg.skip_blocks),
            int(cfg.logit_cap is not None),
            float(cfg.logit_cap if cfg.logit_cap is not None else 0.0),
            float(cfg.orig_dh ** -0.5)]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def tensor_core_dh(dh: int) -> int:
    """The head dim at which the bf16 tensor-core kernels run a ``dh``."""
    return 64 if dh <= 64 else 128


def pad_head_dim(x: torch.Tensor, dh: int) -> torch.Tensor:
    """``x`` (..., Dh) zero-padded to (..., dh).  Zero columns add nothing to
    q.k or to do.v, and give out, dk and dv zero columns, which the
    wrappers slice off; the scale stays ``cfg.orig_dh ** -0.5``."""
    pad = dh - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)).contiguous() if pad else x


def _check_tc(name: str, tp: int, *xs) -> None:
    """What the bf16 tensor-core kernels add to :func:`_check`: TMA reads
    rows of whole 16-byte units from 16-byte aligned bases."""
    if tp % 8:
        raise ValueError(f"{name} kernel (bf16): Tp must be a multiple of 8, "
                         f"got {tp} (see padded_blocks)")
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError(f"{name} kernel (bf16): operands must start on a "
                         "16-byte boundary")


def _call(name: str, fn, q, *args) -> None:
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def flash_fwd(q, k, v, ls, hr, cfg: FlashConfig):
    """q: (BHq, Tp, Dh); k/v: (BHkv, Tp, Dh); ls: (BHkv, Tp) fp32; hr:
    (BHkv, nK) int32 with ``skip_blocks``, else None.  Returns (out
    (BHq, Tp, Dh), lse (BHq, Tp) fp32).  CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, ls, hr, cfg)
    if not q.is_cuda:
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    _check("flash_fwd", cfg, q, k, v, ls, hr)
    bhq, tp, dh = q.shape
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = (pad_head_dim(x, tensor_core_dh(dh)) for x in (q, k, v))
        _check_tc("flash_fwd", tp, q, k, v, ls)
    out = torch.empty_like(q)
    lse = torch.empty((bhq, tp), dtype=torch.float32, device=q.device)
    _call("flash_fwd", _library().dms_flash_fwd, q, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), ls.data_ptr(), _ptr(hr), out.data_ptr(),
          lse.data_ptr(), int(bf16), bhq, *_ints(cfg, tp, q.shape[-1]))
    return (out[..., :dh].contiguous() if out.shape[-1] != dh else out), lse


def flash_dq(q, k, v, ls, do, lse, delta, hr, cfg: FlashConfig):
    """dq (BHq, Tp, Dh) in q's dtype; ``do`` like q, ``lse``/``delta``
    (BHq, Tp) fp32."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, ls, do, lse, delta, hr, cfg)
    if not q.is_cuda:
        raise ValueError(f"flash_dq: unsupported device {q.device}")
    _check("flash_dq", cfg, q, k, v, ls, hr, do, lse, delta)
    bhq, tp, dh = q.shape
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v, do = (pad_head_dim(x, tensor_core_dh(dh))
                       for x in (q, k, v, do))
        _check_tc("flash_dq", tp, q, k, v, ls, do)
    dq = torch.empty_like(q)
    _call("flash_dq", _library().dms_flash_dq, q, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), ls.data_ptr(), do.data_ptr(), lse.data_ptr(),
          delta.data_ptr(), _ptr(hr), dq.data_ptr(), int(bf16), bhq,
          *_ints(cfg, tp, q.shape[-1]))
    return dq[..., :dh].contiguous() if dq.shape[-1] != dh else dq


def flash_dkv(q, k, v, ls, do, lse, delta, hr, cfg: FlashConfig):
    """(dk, dv) (BHkv, Tp, Dh) and dls (BHkv, Tp) fp32, each summed over
    the G query heads of a kv head."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, ls, do, lse, delta, hr, cfg)
    if not q.is_cuda:
        raise ValueError(f"flash_dkv: unsupported device {q.device}")
    _check("flash_dkv", cfg, q, k, v, ls, hr, do, lse, delta)
    bhkv, tp, dh = k.shape
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v, do = (pad_head_dim(x, tensor_core_dh(dh))
                       for x in (q, k, v, do))
        _check_tc("flash_dkv", tp, q, k, v, ls, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dls = torch.empty((bhkv, tp), dtype=torch.float32, device=k.device)
    _call("flash_dkv", _library().dms_flash_dkv, q, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), ls.data_ptr(), do.data_ptr(), lse.data_ptr(),
          delta.data_ptr(), _ptr(hr), dk.data_ptr(), dv.data_ptr(),
          dls.data_ptr(), int(bf16), bhkv, *_ints(cfg, tp, k.shape[-1]))
    if dk.shape[-1] != dh:
        dk, dv = dk[..., :dh].contiguous(), dv[..., :dh].contiguous()
    return dk, dv, dls


# -- autograd Function (log_surv in; the config rides along, not differentiated)


def prep_tables(ls: torch.Tensor, cfg: FlashConfig) -> Optional[torch.Tensor]:
    """The has-retained table ``hr`` (BHkv, Tp / block_k) int32 from
    log-survival when ``skip_blocks``, else None (the kernels read it only
    then).  The reference's ``remap`` table, which kept the TPU's DMA
    pipeline from fetching a dead block, has no use on the card."""
    if not cfg.skip_blocks:
        return None
    bhkv, tp = ls.shape
    nk = tp // cfg.block_k
    retained = (ls > NEG_INF / 2).reshape(bhkv, nk, cfg.block_k)
    ids = torch.arange(tp, device=ls.device).reshape(nk, cfg.block_k)
    retained = retained & (ids < cfg.t)[None]        # key padding is evicted
    return retained.any(dim=-1).to(torch.int32)


class FlashAttention(torch.autograd.Function):
    """``out = flash(q, k, v, ls)`` on folded operands -> (BHq, Tp, Dh),
    differentiable in q, k, v and ls: the forward kernel, and the dq and
    dkv kernels for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, ls, cfg: FlashConfig):
        hr = prep_tables(ls, cfg)
        out, lse = flash_fwd(q, k, v, ls, hr, cfg)
        ctx.save_for_backward(q, k, v, ls, out, lse, hr)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, ls, out, lse, hr = ctx.saved_tensors
        cfg = ctx.cfg
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        dq = flash_dq(q, k, v, ls, dout, lse, delta, hr, cfg)
        dk, dv, dls = flash_dkv(q, k, v, ls, dout, lse, delta, hr, cfg)
        return dq, dk, dv, dls, None


def padded_blocks(t: int, block_k: int = DEFAULT_BLOCK_K):
    """(block_k, Tp) of a length-``t`` sequence: ``hr``'s key blocks of
    ``min(block_k, round_up(t, 8))`` keys, T padded to a whole block.  The
    kernels' own 64-row tiles take any Tp."""
    bk = min(block_k, _round_up(t, 8))
    return bk, _round_up(t, bk)


def fold_heads(x: torch.Tensor, tp: int) -> torch.Tensor:
    """(B, T, H, Dh) -> (B*H, Tp, Dh), zero-padded, contiguous."""
    b, t, h, dh = x.shape
    x = x.transpose(1, 2).reshape(b * h, t, dh)
    return torch.nn.functional.pad(x, (0, 0, 0, tp - t)).contiguous()


def kernel_log_survival(alpha: torch.Tensor, tp: int) -> torch.Tensor:
    """(B, Hkv, T) α -> (B*Hkv, Tp) ``max(log1p(-clip(α, 0, 1)), -1e30)``,
    the reference wrapper's values, padded with -1e30 (padding counts as
    evicted).

    α = 1 exactly (a Gumbel-sigmoid saturates in fp32 once logit/τ exceeds
    ~17) gives -1e30 with gradient 0 here; the reference's
    ``maximum(log1p(-α), -1e30)`` passes 0 · 1/(1 - α) = NaN back there,
    which at full width poisons every gradient within a step or two."""
    b, hkv, t = alpha.shape
    a = torch.clamp(alpha.float(), 0.0, 1.0)
    live = a < 1.0
    ls = torch.where(live, torch.log1p(-torch.where(live, a, 0.0)), NEG_INF)
    return torch.nn.functional.pad(ls.reshape(b * hkv, t), (0, tp - t),
                                   value=NEG_INF)


def dms_flash_attention(
    q: torch.Tensor,                          # (B, T, Hq, Dh)
    k: torch.Tensor,                          # (B, T, Hkv, Dh)
    v: torch.Tensor,                          # (B, T, Hkv, Dh)
    alpha: Optional[torch.Tensor] = None,     # (B, Hkv, T) in [0, 1]; None = vanilla
    *,
    window: Optional[int] = None,
    dms_window: int = 0,
    causal: bool = True,
    logit_cap: Optional[float] = None,
    immediate: bool = False,
    skip_blocks: Optional[bool] = None,       # default False
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Flash attention with the DMS delayed-eviction mask -> (B, T, Hq, Dh).
    Differentiable in q, k, v and alpha."""
    b, t, hq, dh = q.shape
    hkv = k.shape[2]
    bk, tp = padded_blocks(t, block_k)
    if alpha is not None:
        ls = kernel_log_survival(alpha, tp)
        delay = 1 if immediate else dms_window
        skip = bool(skip_blocks)
    else:
        ls = torch.zeros((b * hkv, tp), dtype=torch.float32, device=q.device)
        delay, skip = 0, False
    cfg = FlashConfig(t=t, orig_dh=dh, hq=hq, hkv=hkv, window=window,
                      dms_delay=delay, causal=causal, logit_cap=logit_cap,
                      block_k=bk, skip_blocks=skip)
    out = FlashAttention.apply(fold_heads(q, tp), fold_heads(k, tp),
                               fold_heads(v, tp), ls, cfg)
    return out[:, :t].reshape(b, hq, t, dh).transpose(1, 2)


def dms_flash_attention_prefill(q, k, v, alpha_bin, *, dms_window: int,
                                window=None, causal=True, logit_cap=None,
                                block_k: int = DEFAULT_BLOCK_K):
    """Prefill entry: binarised α enables dead-block skipping."""
    return dms_flash_attention(
        q, k, v, alpha_bin.float(), window=window, dms_window=dms_window,
        causal=causal, logit_cap=logit_cap, skip_blocks=True,
        block_k=block_k)
