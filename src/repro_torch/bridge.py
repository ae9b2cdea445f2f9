"""Bridge from the reference's numpy-converted trees to the port.

The caller (a test) turns a JAX params tree into numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) and a config into a dict
(``dataclasses.asdict``); this module rebuilds both on the port's side.
It imports no JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.config import (ArchConfig, AttentionConfig, DMSConfig,
                                     MLPConfig, MoEConfig, RGLRUConfig,
                                     SSMConfig)
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models.transformer import Params

#: leaves kept in fp32 whatever the compute dtype: norm parameters, and the
#: recurrent layers' vectors the reference applies in fp32 with no cast
#: (RG-LRU's Λ and gate biases; SSD's decay, step bias, skip and norm scale)
_FP32_LEAVES = ("scale", "bias", "lam", "b_gate_r", "b_gate_i", "a_log",
                "dt_bias", "d_skip", "norm_scale")


def arch_from_dict(d: Dict[str, Any]) -> ArchConfig:
    """Rebuild an :class:`ArchConfig` (nested sub-configs included) from
    ``dataclasses.asdict`` of an equal reference config."""
    d = dict(d)
    if d.get("attn") is not None:
        attn = dict(d["attn"])
        attn["mrope_sections"] = tuple(attn.get("mrope_sections", ()))
        d["attn"] = AttentionConfig(**attn)
    if d.get("mlp") is not None:
        mlp = dict(d["mlp"])
        if mlp.get("moe") is not None:
            mlp["moe"] = MoEConfig(**mlp["moe"])
        d["mlp"] = MLPConfig(**mlp)
    if d.get("ssm") is not None:
        d["ssm"] = SSMConfig(**d["ssm"])
    if d.get("rglru") is not None:
        d["rglru"] = RGLRUConfig(**d["rglru"])
    d["dms"] = DMSConfig(**d["dms"])
    d["layer_pattern"] = tuple(d["layer_pattern"])
    return ArchConfig(**d)


def params_from_numpy(tree: Dict[str, Any], arch: ArchConfig,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A reference ``init_model`` tree of numpy arrays -> the port's params.

    The layout is kept (``embed``, ``blocks[str(position)]`` stacked over
    superblocks, MoE experts ``(nsb, E, in, out)``, ``final_norm``,
    ``lm_head`` only when embeddings are untied; an encoder–decoder's
    ``enc_blocks``, ``enc_final_norm`` and each decoder block's ``cross``
    and ``cross_norm``; LayerNorm's ``bias``) and so is the ``x @ W``
    orientation: W stays ``(in, out)``, no transpose.  Matmul weights
    (the router too) are cast once to ``dtype`` (default ``arch.dtype``) —
    the reference keeps fp32 masters and casts at every matmul, which gives
    the same values; the leaves of ``_FP32_LEAVES`` stay fp32, as the
    reference applies them.  Returns
    :class:`~repro_torch.models.transformer.Params`, with each attention
    layer's noise salt taken from the fp32 ``wo`` before the cast (0 for a
    recurrent layer), in the reference's layer order (superblocks, then
    positions): the decoder's self-attention only."""
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(arch.dtype)
    if ("lm_head" in tree) == arch.tie_embeddings:
        raise ValueError(f"{arch.name}: lm_head must be present iff embeddings "
                         "are untied")

    def conv(node, key):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        arr = torch.from_numpy(np.asarray(node, dtype=np.float32).copy())
        want = torch.float32 if key in _FP32_LEAVES else dtype
        return arr.to(device=dev, dtype=want)

    params = Params(conv(tree, ""))
    nsb = arch.num_superblocks
    wo00 = np.stack([np.asarray(blk["attn"]["wo"], dtype=np.float32)[:, 0, 0]
                     if "attn" in blk else np.zeros((nsb,), np.float32)
                     for blk in (tree["blocks"][str(pi)]
                                 for pi in range(arch.pattern_period))],
                    axis=1)
    params.layer_salt = torch.from_numpy(
        wo00.reshape(-1).view(np.uint32).astype(np.int64)).to(dev)
    return params
