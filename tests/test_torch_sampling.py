"""Temperature sampling of the port against ``jax.random``: ``split``,
``uniform``, ``gumbel`` and ``categorical`` of ``repro_torch.core.threefry``
— bits equal, floats exact but for the Gumbel logs (within 1 ulp), indices
equal on pinned seeds — and the scheduler's ``sample``.

The end-to-end check (tokens and meters of a seeded ``Engine`` at
temperature 0.7 against the JAX ``Engine``) is in ``test_torch_hyperscale.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import threefry
from repro_torch.serving.scheduler import sample

torch.set_num_threads(1)

TINY = float(np.finfo(np.float32).tiny)


def _key(tk):
    return [int(tk[0]), int(tk[1])]


@pytest.mark.parametrize("seed", [0, 1, 0x5EED0, 2 ** 31 - 1])
@pytest.mark.parametrize("num", [2, 3])
def test_split(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = threefry.split(threefry.prng_key(seed), num)
    assert [_key(k) for k in got] == want.tolist()


def test_split_chain_is_the_reference_stream():
    """The scheduler's pattern ``rng, sub = split(rng)``, repeated: every
    step's subkey equals the reference's."""
    jk, tk = jax.random.PRNGKey(3), threefry.prng_key(3)
    for _ in range(12):
        jk, jsub = jax.random.split(jk)
        tk, tsub = threefry.split(tk)
        assert _key(tsub) == np.asarray(jsub).tolist()
    assert _key(tk) == np.asarray(jk).tolist()


@pytest.mark.parametrize("minval", [0.0, TINY, -2.5])
@pytest.mark.parametrize("shape", [(3, 7), (2, 640)])
def test_uniform_is_exact(minval, shape):
    key = jax.random.PRNGKey(17)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                         minval=minval, maxval=1.0))
    got = threefry.uniform(threefry.prng_key(17), shape, minval=minval)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _within_ulp(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return (np.abs(got - want) <= np.spacing(np.abs(want))).all()


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_gumbel_logs_within_one_ulp(seed):
    """``gumbel`` is ``-log(-log(u))`` of the exact uniform: each log
    within 1 ulp of XLA's on the same input (an ulp of the inner log can
    move the outer one by more where ``-log(u)`` is near 1: that is the
    conditioning of the log, not a second error)."""
    shape = (4, 512)
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, shape, jnp.float32, minval=TINY)
    inner = -jnp.log(u)
    want = np.asarray(jax.random.gumbel(key, shape))
    np.testing.assert_array_equal(np.asarray(-jnp.log(inner)), want)
    tu = threefry.uniform(threefry.prng_key(seed), shape, minval=TINY)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(u))
    assert _within_ulp(-torch.log(tu), inner)
    assert _within_ulp(-torch.log(torch.from_numpy(np.array(inner))), want)
    got = threefry.gumbel(threefry.prng_key(seed), shape)
    assert torch.equal(got, -torch.log(-torch.log(tu)))


def _logits(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("shape", [(4, 512), (3, 1000)])
def test_categorical_indices_equal(seed, shape):
    """Pinned seeds: none of them has a near tie that an ulp of Gumbel
    noise could flip."""
    logits = _logits(shape, seed=seed + 1)
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                             jnp.asarray(logits) / 0.7))
    got = sample(threefry.prng_key(seed), torch.from_numpy(logits), 0.7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_draws_over_the_whole_last_axis():
    """The noise's shape is part of its bits: a draw over a padded row
    whose pad logits are -1e30 equals the reference's over the same row,
    and never picks a pad entry."""
    logits = _logits((4, 512), seed=9)
    logits[:, 500:] = -1e30
    for seed in range(4):
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                                 jnp.asarray(logits)))
        got = threefry.categorical(threefry.prng_key(seed),
                                   torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got < 500).all()


def test_sample_at_temperature_zero_is_argmax():
    logits = torch.from_numpy(_logits((5, 64), seed=2))
    assert torch.equal(sample(None, logits, 0.0), logits.argmax(dim=-1))
