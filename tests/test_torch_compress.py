"""The port's int8 gradient compression (``repro_torch.optim.compress``)
against the reference's ``repro.optim.compress``.

``torch.round`` and ``jnp.round`` both round half to even, so the int8
values and the fp32 scales are compared bit for bit on seeded trees
(including values that land exactly on .5 steps).  Error feedback keeps the
compression unbiased (the reference's tolerance: 2% of the largest value
over 20 rounds).  ``all_reduce_compressed`` runs over an in-process gloo
group of world size 1, where the mean is the dequantised tensor itself, bit
for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import compress as jcompress
from repro_torch.core.tree import tree_leaves
from repro_torch.optim import compress

torch.set_num_threads(1)


def _tree(seed):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 100.0)
    return {"w": (rng.normal(size=(16, 24)) * scale).astype(np.float32),
            "b": {"x": (rng.normal(size=(7,)) * scale).astype(np.float32),
                  "steps": (np.arange(-127, 128) * 0.5).astype(np.float32)}}


def _bits(x):
    return np.asarray(x).view(np.uint8 if np.asarray(x).dtype == np.int8
                              else np.uint32)


@pytest.mark.parametrize("seed", range(6))
def test_quantize_matches_reference_bits(seed):
    tree = _tree(seed)
    for leaf in (tree["w"], tree["b"]["x"], tree["b"]["steps"]):
        jq, js = jcompress.quantize_int8(jnp.asarray(leaf))
        tq, ts = compress.quantize_int8(torch.tensor(leaf))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
        np.testing.assert_array_equal(
            compress.dequantize_int8(tq, ts).numpy(),
            np.asarray(jcompress.dequantize_int8(jq, js)))


@pytest.mark.parametrize("seed", range(4))
def test_compress_grads_matches_reference(seed):
    tree = _tree(seed)
    res = _tree(seed + 100)
    jq, js, jr = jcompress.compress_grads(
        {"w": jnp.asarray(tree["w"])}, {"w": jnp.asarray(res["w"]) * 0.01})
    tq, ts, tr = compress.compress_grads(
        {"w": torch.tensor(tree["w"])}, {"w": torch.tensor(res["w"]) * 0.01})
    np.testing.assert_array_equal(tq["w"].numpy(), np.asarray(jq["w"]))
    np.testing.assert_array_equal(_bits(ts["w"].numpy()), _bits(js["w"]))
    np.testing.assert_array_equal(tr["w"].numpy(), np.asarray(jr["w"]))
    out = compress.decompress_grads(tq, ts)
    np.testing.assert_array_equal(
        out["w"].numpy(), np.asarray(jcompress.decompress_grads(jq, js)["w"]))
    assert compress.zeros_like_residual(tq)["w"].dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 3, 17, 250, 999])
def test_int8_compression_error_feedback_unbiased(seed):
    """Residual carry: the mean of 20 dequantised updates converges to the
    true value (as the reference's property test, same tolerance)."""
    rng = np.random.default_rng(seed)
    g = torch.tensor(rng.normal(size=(64,)) * rng.uniform(0.1, 10))
    res, total = None, torch.zeros_like(g, dtype=torch.float32)
    for _ in range(20):
        q, s, res = compress.compress_grads({"g": g}, res)
        total = total + compress.dequantize_int8(q["g"], s["g"])
    np.testing.assert_allclose((total / 20).numpy(), g.float().numpy(),
                               rtol=0.02, atol=float(g.abs().max()) * 0.02)


def test_int8_quantize_bounds():
    x = torch.tensor([-1000.0, 0.0, 1000.0])
    q, s = compress.quantize_int8(x)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    np.testing.assert_allclose(compress.dequantize_int8(q, s).numpy(),
                               x.numpy(), rtol=0.02)


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_all_reduce_compressed_world_of_one(world_of_one):
    """Over one rank the mean is ``dequantize(q, s)`` bit for bit, and
    ``x == dequantize(q) + residual`` exactly; the payload is int8 values
    plus one fp32 scale per tensor."""
    tree = {k: torch.tensor(v) for k, v in _tree(5).items() if k == "w"}
    tree["b"] = torch.tensor(_tree(5)["b"]["x"]).to(torch.bfloat16)
    prev = {k: torch.full(v.shape, 1e-3) for k, v in tree.items()}
    mean, res = compress.all_reduce_compressed(tree, residual=prev)
    q, s, r = compress.compress_grads(tree, prev)
    for name, g in tree.items():
        deq = compress.dequantize_int8(q[name], s[name])
        assert torch.equal(mean[name], deq)
        assert torch.equal(res[name], r[name])
        assert torch.equal(g.float() + prev[name], deq + res[name])
    assert compress.payload_bytes(q) == sum(
        x.numel() for x in tree_leaves(tree)) + 4 * len(tree)
