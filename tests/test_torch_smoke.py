"""A CPU rehearsal of ``chip_smoke.py``: its serving phase on the smoke
config (the decode kernel's plain version in place of the CUDA kernel) and
its NaN-poisoned kernel cases, so the script's own logic is exercised by
the CPU suite before it meets the card."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.kernels.dms_decode.ref import dms_decode_plain  # noqa: E402

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("case", [dict(density=0.85), dict(density=0.03),
                                  dict(density=0.5, table="partial"),
                                  dict(density=0.5, empty_rows=(0, 3))])
def test_smoke_cases_poison_only_unlisted_blocks(case):
    gen = torch.Generator().manual_seed(0)
    q, k, v, valid, tbl, n = chip_smoke.make_case(
        torch, gen, bh=8, g=6, dh=128, p=416, bp=16, device="cpu", **case)
    # unlisted blocks, and only those, hold NaN
    assert bool(torch.isnan(k.float()).any()) == bool((n < 416 // 16).any())
    out = dms_decode_plain(q, k, v, valid, tbl, n, 16)
    assert torch.isfinite(out.float()).all()
    for r in case.get("empty_rows", ()):
        assert int(n[r]) == 0 and not out[r].float().abs().any()


def _cpu_setup():
    return chip_smoke.serving_setup(torch, device="cpu", lens=(48, 36, 24, 12),
                                    news=(6, 4, 3, 6), hs=(32, 8, 4))


def test_smoke_serving_phase_on_the_cpu(capsys):
    setup = _cpu_setup()
    out = chip_smoke.phase_serve(torch, setup, short=6)
    assert out["launches"] == 0 and out["steps"] > 0
    assert out["arena"][:3] == (2, 4, 2)
    printed = capsys.readouterr().out
    assert "all ok" in printed and "profile:" in printed


def test_smoke_paged_phase_on_the_cpu(capsys):
    """Phase 5 on the smoke config with block_p 4 (the smoke arenas hold
    only two 16-slot blocks): token equality with phase 4, the CoW fork,
    and the oversubscribed pair preempted and resumed."""
    setup = dict(_cpu_setup(), block_p=4)
    fixed = chip_smoke.phase_serve(torch, setup, short=2)
    out = chip_smoke.phase_paged_serve(torch, setup, fixed)
    assert out["launches"] == 0 and out["steps"] > 0
    printed = capsys.readouterr().out
    assert "tokens equal to the fixed arenas'" in printed
    assert "all ok, tokens equal to (a)'s" in printed


@pytest.mark.parametrize("name", sorted(chip_smoke.POOL_CASES))
def test_smoke_pool_cases_shared_equals_fixed(name):
    """The shared-pool cases of phase 3 on the CPU: the plain versions of
    both modes agree bitwise on the same logical contents, and the output
    is finite with NaN in unlisted pages."""
    from repro_torch.kernels.dms_decode.ref import (dms_decode_plain,
                                                    dms_decode_plain_shared)
    gen = torch.Generator().manual_seed(1)
    kw = dict(chip_smoke.POOL_CASES[name])
    case = chip_smoke.make_pool_case(torch, gen, bh=8, g=6, dh=128,
                                     nb=kw.pop("nb", 26), bp=16, device="cpu",
                                     **kw)
    out = dms_decode_plain_shared(*case["shared"], 16)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, dms_decode_plain(*case["fixed"], 16))
    assert case["npool"] >= 2 * case["n_blocks"]


def test_smoke_weights_phase_on_the_cpu(capsys):
    """Phase 5b on the smoke config (block_p 4): TOVA on fixed arenas and
    on the pool with equal tokens, H2O and Keyformer, the teacher-forced
    checks against the reference path and the plain version, and the
    profile of each policy beside dms."""
    setup = dict(_cpu_setup(), block_p=4)
    fixed = chip_smoke.phase_serve(torch, setup, short=2)
    out = chip_smoke.phase_weights_serve(torch, setup, fixed, short=10,
                                         short_len=32)
    assert out["fixed"] == out["shared"] == 0       # plain versions launch none
    assert out["arena"] == 8 and set(out["ms_step"]) == {
        "tova", "tova paged", "h2o", "keyformer"}
    printed = capsys.readouterr().out
    assert printed.count("all ok") >= 5
    for kind in ("tova", "h2o", "keyformer"):
        assert f"weights: {kind} kernel vs reference path" in printed
        assert f"profile: {kind} / dms wall per step" in printed


@pytest.mark.parametrize("name", sorted(chip_smoke.WEIGHTS_CASES))
def test_smoke_weights_cases_on_the_cpu(name):
    """Phase 3's weights-out cases on the CPU: the checks the card runs on
    the kernel hold for the plain version in both layouts."""
    shape = (8, 6, 128, 80, 16)
    cases = chip_smoke.WEIGHTS_CASES
    try:
        chip_smoke.WEIGHTS_CASES = {name: cases[name]}
        err = chip_smoke.phase_weights_kernels(torch, shape, device="cpu")
        # the main case's error is returned (plain against itself: 0)
        assert err == (0.0 if name == "main-path shape" else None)
    finally:
        chip_smoke.WEIGHTS_CASES = cases


def test_cut_depth_serves_the_first_layers():
    """Phases 4 and 5 serve the model cut to its first layers: views of the
    same weights and salts, and the decode state follows the cut."""
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.models import transformer as tfm
    setup = _cpu_setup()
    cut = chip_smoke.cut_depth(setup, 1)
    assert cut["arch"].num_layers == 1 and setup["arch"].num_layers == 2
    wq = setup["params"]["blocks"]["0"]["attn"]["wq"]
    assert cut["params"]["blocks"]["0"]["attn"]["wq"].data_ptr() == wq.data_ptr()
    assert torch.equal(tfm.layer_salts(cut["params"]),
                       tfm.layer_salts(setup["params"])[:1])
    state = tfm.init_decode_state(cut["arch"], 2, 16,
                                  KVPolicyConfig(kind="dms", cr=2.0),
                                  device="cpu")
    logits, _, _ = tfm.decode_step(cut["params"], torch.tensor([[5], [9]]),
                                   state, cut["arch"], 0)
    assert torch.isfinite(logits).all()
