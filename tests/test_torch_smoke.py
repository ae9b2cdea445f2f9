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
    case = [c for c in chip_smoke.weights_cases(shape) if c[0] == name]
    errs = chip_smoke.phase_weights_kernels(torch, case, device="cpu")
    # each case's error is returned (plain against itself: 0)
    assert errs == {name: 0.0}


@pytest.mark.parametrize("key", [(8, 6, 128, 80, 16),
                                 (8, 6, 128, 640, 16, 5, "shared")],
                         ids=["fixed", "shared"])
def test_smoke_weights_launch_keys_on_the_cpu(key):
    """Phase 5j's weights-out check at a recorded launch shape runs phase
    3's checks there: a shared-pool key at its table width and pool."""
    (name, shape, kw), = chip_smoke.weights_key_cases({key}, "phase 5j")
    assert shape == key[:5] and kw["nan"]
    assert (kw.get("nb"), kw.get("pages")) == (
        (5, 40) if len(key) == 7 else (None, None))
    assert chip_smoke.phase_weights_kernels(
        torch, [(name, shape, kw)], device="cpu") == {name: 0.0}


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


def test_smoke_paper_phase_on_the_cpu(capsys):
    """Phase 5l on the smoke configs of llama32-1b, qwen-r1-7b and
    qwen-r1-32b (plain kernel versions, a short trace): every request ok,
    the pool's tokens equal the fixed arenas' for llama and the 7B (the
    32B fixed only), live tokens below vanilla's, the kernel-vs-reference
    trace, the profiles of the 7B and the 32B, the memory line, and every
    launch at a shape ``paper_layouts`` predicts."""
    trace = {name: ((24, 18, 12, 8), (6, 4, 3, 6))
             for name in chip_smoke.PAPER_SERVED}
    out = chip_smoke.phase_paper(torch, device="cpu", trace=trace, tf=4,
                                 memory=("qwen-r1-32b", 4, 256))
    printed = capsys.readouterr().out
    for name in chip_smoke.PAPER_SERVED:
        assert f"5l (a) {name}: requests [0, 1, 2, 3]" in printed
        assert f"5l (e) {name}: peak live tokens" in printed
        assert f"5l (c): {name} (2 layers) kernel vs reference" in printed
    assert printed.count("tokens equal to the fixed arenas'") == 2
    assert sorted(out["profiles"]) == ["qwen-r1-32b", "qwen-r1-7b"]
    assert 0 < out["memory"]["dms_bytes"] < out["memory"]["vanilla_bytes"]
    assert "phase 5l's decode launch shapes" in printed
    # the plain versions launch nothing; the wrapper was called on the path
    assert sum(out["launches"].values()) > 0


def test_paper_launch_keys_keep_each_models_head_grouping():
    """The shapes phase 3 checks for 5l at full width: llama32-1b's G 4 at
    Dh 64, qwen-r1-7b's G 7 and qwen-r1-32b's G 5 at Dh 128, over B·Hkv
    of 4 lanes (and 2 for the teacher-forced trace); shared-pool shapes for
    llama and the 7B only."""
    keys = chip_smoke.paper_decode_keys()
    groups = {(k[1], k[2]) for k in keys}
    assert groups == {(4, 64), (7, 128), (5, 128)}
    assert {k[:3] for k in keys if len(k) == 7} == {(32, 4, 64), (16, 7, 128)}
    assert (32, 5, 128, 48, 16) in keys and (16, 5, 128, 48, 16) in keys


def test_smoke_catalog_phase_on_the_cpu(capsys):
    """Phase 5n on the smoke configs of phi3-mini-3.8b, minitron-4b and
    granite-moe-1b-a400m (plain kernel versions, its own 32-step trace, a
    short prefill export): every request ok, granite's pool tokens equal
    its fixed arenas', live tokens below vanilla's, the kernel-vs-reference
    trace, phi3's and minitron's profiles, phi3's memory line and prefill
    export, and every decode and flash launch at a shape ``paper_layouts``
    and ``catalog_flash_cases`` predict."""
    out = chip_smoke.phase_catalog(torch, device="cpu", tf=4,
                                   memory=("phi3-mini-3.8b", 8, 256),
                                   export=(48, 4))
    printed = capsys.readouterr().out
    for name in chip_smoke.CATALOG_SERVED:
        assert f"5n (a) {name}: requests [0, 1, 2, 3]" in printed
        assert f"5n (d) {name}: peak live tokens" in printed
        assert f"5n (c): {name} (2 layers) kernel vs reference" in printed
    assert printed.count("32 decode steps") == 4     # granite paged too
    assert printed.count("tokens equal to the fixed arenas'") == 1
    assert "5n (g) phi3-mini-3.8b prefill export, dms" in printed
    assert "alpha flips between the paths" in printed
    assert sorted(out["profiles"]) == ["minitron-4b", "phi3-mini-3.8b"]
    assert 0 < out["memory"]["dms_bytes"] < out["memory"]["vanilla_bytes"]
    assert "phase 5n's decode launch shapes" in printed
    assert "and flash launch shapes [(True, 4, 48, 2, 2, 16" in printed
    # the plain versions launch nothing; the wrapper was called on the path
    assert sum(out["launches"].values()) > 0


def test_catalog_launch_keys_keep_each_models_head_grouping():
    """The shapes phase 3 checks for 5n at full width: phi3-mini's G 1 at
    Dh 96 over B·Hkv 128 (4 lanes of 32 kv heads), minitron-4b's G 3 at Dh
    128 and granite-1b's G 2 at Dh 64 over 32, each in both modes at its
    served arena of 48 slots; phi3's prefill export arenas; the flash
    kernels at phi3's Dh 96, its retrofit shape and (g)'s export with the
    served delay window of 16."""
    keys = chip_smoke.catalog_decode_keys()
    assert {(k[1], k[2]) for k in keys} == {(1, 96), (3, 128), (2, 64)}
    assert {k[:3] for k in keys if len(k) == 7} == {
        (128, 1, 96), (32, 3, 128), (32, 2, 64)}
    assert {(128, 1, 96, 48, 16), (32, 3, 128, 48, 16),
            (32, 2, 64, 48, 16), (128, 1, 96, 112, 16)} <= keys
    flash = chip_smoke.encdec_flash_keys(
        torch, chip_smoke.catalog_flash_cases(), device="cpu")
    assert flash == {(True, 2, 1024, 32, 32, 96, "bfloat16", 256),
                     (True, 4, 512, 32, 32, 96, "bfloat16", 16)}


def test_route_forcer_hands_each_call_the_recorded_experts():
    """The reference path of a full-depth MoE trace routes as the kernel
    path did: each call gets the recorded expert ids in order, the router's
    probabilities at them renormalised, and a flag says where its own
    choice of experts differed."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(5)
    p = {"router": torch.randn((8, 6), generator=gen)}
    xt = torch.randn((2, 1, 8), generator=gen)
    probs, _, own = layers.moe_route(p, xt, 2)
    other = (own + 1) % 6
    rerouted = []
    forcing, real = chip_smoke.route_forcer(torch, layers, [own, other],
                                            rerouted)
    assert real is layers.moe_route
    for want in (own, other):
        got_probs, got_p, got_e = forcing(p, xt, 2)
        assert torch.equal(got_e, want) and torch.equal(got_probs, probs)
        weights = probs.gather(-1, want)
        torch.testing.assert_close(got_p, weights / weights.sum(-1,
                                                                 keepdim=True))
    assert rerouted == [False, True]


def test_alpha_forcer_records_then_hands_the_recorded_alphas():
    """The held reference path of 5n (g)'s prefill export takes the kernel
    path's α^bin in every layer: recorded in order, handed back in order,
    with the count of the reference's own decisions that differ."""
    from repro_torch.core import dms as dms_lib
    from repro_torch.core.config import DMSConfig
    gen = torch.Generator().manual_seed(6)
    cfg = DMSConfig(logit_bias=0.0)
    qs = [torch.randn((2, 5, 4, 8), generator=gen) for _ in range(2)]
    alphas = []
    recording, real = chip_smoke.alpha_forcer(dms_lib, alphas)
    own = [recording(q, 2, cfg)[0] for q in qs]
    assert all(torch.equal(a, b) for a, b in zip(alphas, own))
    alphas[1] = ~alphas[1]                         # every decision flipped
    flips = []
    forcing = chip_smoke.alpha_forcer(dms_lib, alphas, flips)[0]
    for q, want in zip(qs, alphas):
        got, q_out = forcing(q, 2, cfg)
        assert torch.equal(got, want)
        assert torch.equal(q_out, real(q, 2, cfg)[1])
    assert flips == [0, alphas[1].numel()]


def test_smoke_reasoner_phase_on_the_cpu(capsys):
    """Phase 5m at the demo's own width on the CPU (the kernels' plain
    versions), its steps, problems and traces cut: the training's flash
    wrapper calls as the formula counts them, the held losses, every
    request ok, dms's peak below vanilla's, the forked prefill, the
    eviction count, the child process's CPU evaluations, and every launch
    at a shape ``reasoner_layouts`` and ``reasoner_flash_cases``
    predict."""
    out = chip_smoke.phase_reasoner(torch, device="cpu", steps=8, n_eval=2,
                                    held=2, tf=4)
    printed = capsys.readouterr().out
    assert "5m (b) trained_reasoner(8) on cpu" in printed
    for name in ("vanilla at 40-1-1", "dms at 40-4-4"):
        assert f"5m (c) {name}, 2 problems, temperature 0.7: all ok" in printed
    assert "(one prefill, forked)" in printed
    assert "5m (d) the card's evaluations beside the CPU plain path's" in printed
    assert "phase 5m's decode launch shapes" in printed
    assert len(out["rate"]) == 2 and all(0.0 <= r <= 1.0 for r in out["rate"])
    # the plain versions launch nothing; the wrapper was called on the path
    assert sum(out["launches"].values()) > 0


def test_reasoner_launch_keys_are_the_demos_arenas():
    """The decode shapes phase 3 checks for 5m: G 2 at Dh 16 on the
    evaluations' arenas (vanilla's one lane of 48 slots, dms's four chains
    and one chain of 32), the trace's two lanes; the flash cases at B 32,
    T 32, Dh 16, vanilla and the DMS window 4."""
    keys = chip_smoke.reasoner_decode_keys()
    assert {k[1:3] for k in keys} == {(2, 16)}
    assert {(2, 2, 16, 48, 16), (8, 2, 16, 32, 16),
            (2, 2, 16, 32, 16)} <= keys
    cases = chip_smoke.reasoner_flash_cases()
    assert sorted((kw["b"], kw["t"], kw["dh"], kw.get("delay", 0))
                  for kw in cases.values()) == [(32, 32, 16, 0),
                                                (32, 32, 16, 4)]


def test_mesh_shard_cells_cut_as_the_sharding_rule_cuts():
    """Phase 5k (c)'s layouts come from the dry-run's decode state and the
    sharding rule: qwen-r1-1.5b's ``decode_32k`` at 8 lanes a rank and
    ``long_500k`` at 1, each arena cut 16 ways; only Quest's shards are
    whole blocks."""
    got = {c["name"]: c for c in chip_smoke.mesh_shard_cells()}
    want = {"decode_32k h2o": (8, 4112), "decode_32k dms": (8, 4368),
            "decode_32k quest": (8, 32768), "long_500k h2o": (1, 65552),
            "long_500k dms": (1, 65808)}
    assert {n: (c["lanes"], c["p"]) for n, c in got.items()} == want
    for name, c in got.items():
        assert (c["hkv"], c["g"], c["dh"], c["bp"], c["shards"]) == \
            (2, 6, 128, 16, 16)
        assert ((c["p"] // c["shards"]) % c["bp"] == 0) == c["quest"], name
    assert got["decode_32k quest"]["top"] == 256


def test_smoke_mesh_shards_phase_on_the_cpu(capsys):
    """Phase 5k (c) on small arenas with the plain versions: each shard's
    m, l and output against its plain shard version, every shard's
    partial, combined, within ``KERNEL_TOL`` and ``FLASH_REL_TOL`` of the
    whole arena, weights within ``WEIGHTS_TOL``; no kernel launch counted,
    no row timed."""
    cells = [dict(name="h2o", lanes=2, hkv=2, g=3, dh=16, p=80, shards=4,
                  bp=16, weights=True, quest=False, top=0),
             dict(name="dms", lanes=1, hkv=2, g=6, dh=32, p=96, shards=8,
                  bp=16, weights=False, quest=False, top=0),
             dict(name="quest", lanes=2, hkv=2, g=2, dh=16, p=128, shards=4,
                  bp=8, weights=False, quest=True, top=4)]
    assert chip_smoke.phase_mesh_shards(torch, device="cpu",
                                        cells=cells) == []
    printed = capsys.readouterr().out
    assert printed.count("the shards' kernel partials combined") == 3
    assert printed.count("each shard's kernel m and l against its plain") == 3
    assert "0 slot-shard launches over 3 arenas" in printed
