"""The port's Threefry-2x32 (``repro_torch.core.threefry``) against
``jax.random``: keys, ``fold_in`` and ``bits`` bit for bit, and the chain
bits -> uniform -> Gumbel that Keyformer's noise takes, each step exact
or within 1 ulp."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import threefry

torch.set_num_threads(1)

SALTS = [0, 1, 2 ** 31 - 1, 2 ** 31, 0x80000001, 0xDEADBEEF, 2 ** 32 - 1]


def _key(tk):
    return [int(tk[0]), int(tk[1])]


@pytest.mark.parametrize("seed", [0, 1, 0x5EED, 2 ** 31 - 1])
def test_prng_key(seed):
    assert _key(threefry.prng_key(seed)) == \
        np.asarray(jax.random.PRNGKey(seed)).tolist()


@pytest.mark.parametrize("data", SALTS)
def test_fold_in(data):
    want = jax.random.fold_in(jax.random.PRNGKey(0x5EED), data)
    got = threefry.fold_in(threefry.prng_key(0x5EED), torch.tensor(data))
    assert _key(got) == np.asarray(want).tolist()


def test_fold_in_is_batched_over_data():
    """One call folds a (B,) vector of data into one key, as ``jax.vmap``
    of ``fold_in`` does, and the result folds again (the Keyformer chain
    of lane length, then layer salt)."""
    base = jax.random.PRNGKey(0x5EED)
    lens = np.array([0, 7, 12, 2 ** 31 - 1], np.int32)
    salts = np.array(SALTS[3:], np.uint32)
    want = jax.vmap(lambda n, s: jax.random.fold_in(
        jax.random.fold_in(base, n), s))(lens, salts)
    tk = threefry.fold_in(threefry.prng_key(0x5EED), torch.from_numpy(lens))
    tk = threefry.fold_in(tk, torch.from_numpy(salts.astype(np.int64)))
    got = np.stack([t.numpy() for t in tk], axis=-1)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("shape", [(2, 48), (2, 80), (12, 1)])
@pytest.mark.parametrize("salt", [0, 2 ** 31 - 1, 0x80000001])
def test_bits(shape, salt):
    key = jax.random.fold_in(jax.random.PRNGKey(0x5EED), salt)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    tk = threefry.fold_in(threefry.prng_key(0x5EED), torch.tensor(salt))
    got = threefry.random_bits(tk, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_bits_for_a_batch_of_keys():
    """A (B,) batch of keys draws (B, *shape), each row its key's bits."""
    salts = np.array([3, 2 ** 31 + 5, 2 ** 32 - 2], np.uint32)
    base = jax.random.PRNGKey(0x5EED)
    want = np.stack([np.asarray(jax.random.bits(
        jax.random.fold_in(base, s), (2, 80), jnp.uint32)) for s in salts])
    tk = threefry.fold_in(threefry.prng_key(0x5EED),
                          torch.from_numpy(salts.astype(np.int64)))
    got = threefry.random_bits(tk, (2, 80))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _within_ulp(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return (np.abs(got - want) <= np.spacing(np.abs(want))).all()


def test_uniform_and_gumbel_chain():
    """bits -> [0, 1) by mantissa fill and the clip are exact; each of the
    two logs of the Gumbel transform agrees with XLA's to 1 ulp on the same
    input (an ulp of the inner log can move the outer one by more near
    ``-log(u) = 1``: that is the logs' conditioning, not a second error)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0x5EED), 0x80000001)
    jbits = jax.random.bits(key, (12, 80), jnp.uint32)
    ju = jax.lax.bitcast_convert_type(
        (jbits >> 9) | jnp.uint32(0x3F800000), jnp.float32) - 1.0
    jc = jnp.clip(ju, 1e-9, 1.0 - 1e-9)
    jinner = -jnp.log(jc)
    tbits = torch.from_numpy(np.asarray(jbits).astype(np.int64))
    tu = threefry.bits_to_unit(tbits)
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    tc = torch.clamp(tu, 1e-9, 1.0 - 1e-9)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert _within_ulp(-torch.log(tc), jinner)
    inner = torch.from_numpy(np.array(jinner))
    assert _within_ulp(-torch.log(inner), -jnp.log(jinner))
    # the corners: all-zero bits give 0 (the clip lifts it to 1e-9), all-one
    # bits stay below 1
    edge = threefry.bits_to_unit(torch.tensor([0, 2 ** 32 - 1]))
    assert edge[0] == 0.0 and edge[1] == np.float32(1 - 2 ** -23)


@pytest.mark.parametrize("value", [0.0, -0.0, 1.5, -3.25e-3, 7e-39, np.inf])
def test_float_bits(value):
    """The layer salt: the IEEE bits of an fp32 value as uint32."""
    x = np.float32(value)
    want = int(jax.lax.bitcast_convert_type(jnp.float32(x), jnp.uint32))
    assert int(threefry.float_bits(torch.tensor(x))) == want
