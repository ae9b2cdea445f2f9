"""Parity of the port's DMS inference subset (``repro_torch.core.dms``) with
the JAX reference (``repro.core.dms``).  Every function here is a gather, a
shift or a mask, so the fp32 results must be exactly equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import dms as jdms
from repro.core.config import DMSConfig as JDMSConfig
from repro_torch.core import dms as tdms
from repro_torch.core.config import DMSConfig

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)


def _q(seed, shape=(2, 3, 6, 8)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("hkv", [1, 2, 3])
def test_alpha_logits_from_q(hkv):
    q = _q(0)
    out_j = jdms.alpha_logits_from_q(jnp.asarray(q), hkv, -5.0)
    out_t = tdms.alpha_logits_from_q(torch.from_numpy(q), hkv, -5.0)
    assert tuple(out_t.shape) == (2, hkv, 3)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("scale", [0.0, 0.25])
def test_zero_borrowed_neuron(scale):
    q = _q(1)
    out_j = jdms.zero_borrowed_neuron(jnp.asarray(q), 2, scale)
    out_t = tdms.zero_borrowed_neuron(torch.from_numpy(q), 2, scale)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    # only the first dim of the first head of each group changed
    changed = out_t.numpy() != q
    assert not changed[..., 1:].any() and not changed[:, :, [1, 2, 4, 5]].any()


def test_binary_alpha():
    logits = np.concatenate([np.random.default_rng(2).normal(size=64),
                             [0.0, -0.0, 1e-7, -1e-7]]).astype(np.float32)
    np.testing.assert_array_equal(
        tdms.binary_alpha(torch.from_numpy(logits)).numpy(),
        np.asarray(jdms.binary_alpha(jnp.asarray(logits))))


@pytest.mark.parametrize("bias", [-5.0, 0.0, 1.15])
def test_infer_alphas(bias):
    q = _q(3, (2, 5, 4, 16))
    a_j, q_j = jdms.infer_alphas(jnp.asarray(q), 2, JDMSConfig(logit_bias=bias))
    a_t, q_t = tdms.infer_alphas(torch.from_numpy(q), 2, DMSConfig(logit_bias=bias))
    assert a_t.dtype == torch.bool
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
