"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors.  They carry the ``cuda`` marker and skip
where no GPU is present.  This file imports no JAX, so on a machine without
it they run alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.dms_decode import ops
from repro_torch.kernels.dms_decode.ref import dms_decode_plain

BP = 16
BF16 = dict(rtol=2e-2, atol=2e-2)   # each side rounds its output to bf16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("g,dh,p,cap", [(6, 128, 416, None), (2, 16, 64, None),
                                        (16, 256, 64, None), (4, 64, 128, 30.0)])
def test_decode_kernel_matches_plain(cuda_device, g, dh, p, cap):
    """Random fragmented arenas with NaN in every unlisted block: a finite,
    equal output shows those blocks are never read.  Rows 0 and 3 list no
    block and must come out zero."""
    gen = torch.Generator(device=cuda_device).manual_seed(g * dh)
    bh = 8
    q = torch.randn((bh, g, dh), generator=gen, device=cuda_device).bfloat16()
    k = torch.randn((bh, p, dh), generator=gen, device=cuda_device).bfloat16()
    v = torch.randn((bh, p, dh), generator=gen, device=cuda_device).bfloat16()
    valid = torch.rand((bh, p), generator=gen, device=cuda_device) < 0.5
    live = valid.reshape(bh, p // BP, BP).any(-1)
    live[:, 1::3] = False                              # unlisted, poisoned
    live[[0, 3]] = False
    tbl = torch.argsort((~live).to(torch.int8), dim=-1, stable=True).int()
    n = live.sum(-1).int()
    dead = ~live.repeat_interleave(BP, dim=1)
    k[dead] = float("nan")
    v[dead] = float("nan")
    before = ops.launches
    out = ops.decode_rows(q, k, v, valid, tbl, n, BP, cap)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    ref = dms_decode_plain(q, k, v, valid, tbl, n, BP, cap)
    assert torch.isfinite(out.float()).all()
    assert not out[[0, 3]].float().abs().any()
    torch.testing.assert_close(out.float(), ref.float(), **BF16)


@pytest.mark.cuda
def test_decode_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    q = torch.zeros((1, 1, 2, 12), dtype=torch.bfloat16, device=cuda_device)
    k = torch.zeros((1, 1, 16, 12), dtype=torch.bfloat16, device=cuda_device)
    valid = torch.ones((1, 1, 16), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.dms_decode_attention(q, k, k, valid, block_p=16)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.dms_decode_attention(q.float()[..., :8], k.float()[..., :8],
                                 k.float()[..., :8], valid, block_p=16)
