"""Parity of the port's layers (``repro_torch.models.layers``) with the JAX
reference (``repro.models.layers``) on the same numpy inputs.

fp32 comparisons hold the algorithm at rtol 1e-4 / atol 1e-5 (the two
frameworks differ only in the order of fp32 sums and in libm ulps); the bf16
case allows 2 bf16 ulps (rtol 1e-2) because the two round intermediate bf16
products at different places.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.config import MLPConfig as JMLPConfig
from repro.models import layers as jlayers
from repro_torch.core.config import MLPConfig
from repro_torch.models import layers as tlayers

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _n(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    r = np.random.default_rng(0)
    x = r.normal(size=(3, 5, 64)).astype(np.float32) * 3.0
    scale = r.normal(size=(64,)).astype(np.float32)
    out_j = jlayers.norm_apply({"scale": jnp.asarray(scale)},
                               jnp.asarray(x, dtype), "rmsnorm", 1e-6)
    out_t = tlayers.norm_apply({"scale": _t(scale)},
                               _t(x, getattr(torch, dtype)), "rmsnorm", 1e-6)
    assert out_t.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_n(out_t), np.asarray(out_j, np.float32),
                               **(F32 if dtype == "float32" else BF16))


def test_softcap_matches_reference():
    x = np.random.default_rng(1).normal(size=(4, 7)).astype(np.float32) * 80
    np.testing.assert_allclose(
        _n(tlayers.softcap(_t(x), 30.0)),
        np.asarray(jlayers.softcap(jnp.asarray(x), 30.0)), **F32)
    np.testing.assert_array_equal(_n(tlayers.softcap(_t(x), None)), x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_interleaved_per_lane_positions(dtype):
    """Full RoPE rotates interleaved pairs (x[2i], x[2i+1]) at per-lane
    positions — not the half-split rotate_half form."""
    r = np.random.default_rng(2)
    b, t, h, dh = 3, 1, 4, 16
    x = r.normal(size=(b, t, h, dh)).astype(np.float32)
    pos = r.integers(0, 300, size=(b, t)).astype(np.int32)
    out_j = jlayers.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos), 1e6)
    out_t = tlayers.apply_rope(_t(x, getattr(torch, dtype)),
                               torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_n(out_t), np.asarray(out_j, np.float32),
                               **(F32 if dtype == "float32" else BF16))
    # the first pair rotates by pos * theta^0 = pos radians
    ang = pos[:, :, None].astype(np.float32)
    want = x[..., 0] * np.cos(ang) - x[..., 1] * np.sin(ang)
    if dtype == "float32":
        np.testing.assert_allclose(_n(out_t)[..., 0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_mlp_matches_reference(dtype):
    r = np.random.default_rng(3)
    d, f = 32, 96
    p = {k: r.normal(size=s).astype(np.float32) * s[0] ** -0.5
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    x = r.normal(size=(2, 3, d)).astype(np.float32)
    y_j, _ = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x, dtype), JMLPConfig(d_ff=f),
                               jnp.dtype(dtype))
    tdt = getattr(torch, dtype)
    y_t, aux = tlayers.mlp_apply({k: _t(v, tdt) for k, v in p.items()},
                                 _t(x, tdt), MLPConfig(d_ff=f), tdt)
    assert aux == {} and y_t.dtype == tdt
    np.testing.assert_allclose(_n(y_t), np.asarray(y_j, np.float32),
                               **(F32 if dtype == "float32" else BF16))


def test_unported_layer_kinds_raise():
    x = torch.zeros((1, 1, 2, 8))
    with pytest.raises(NotImplementedError):
        tlayers.apply_rope(x, torch.zeros((1, 1), dtype=torch.int32), 1e4,
                           kind="half")
    with pytest.raises(NotImplementedError):
        tlayers.norm_apply({"scale": torch.ones(8)}, x, "layernorm", 1e-6)
