"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's ``repro.launch.roofline``.

The arithmetic is the reference's: ``modeled_bytes_per_device`` and
``model_flops_for`` equal its values for every arch × shape × production
mesh, except the prefill's ``attn_stream`` term, which streams K/V once per
64-row block of the port's flash kernel instead of once per 2048 rows
(2048 / 64 = 32 times the reference's term; the total moves by the same
difference).  The ring factors of ``parse_collectives`` applied to
recorded (op, bytes, group) triples give the wire bytes the reference's
parser reads from the same collectives written as HLO.  Values are
compared exactly (``==`` on floats from the same formulas; the attn_stream
ratio to 1e-12 relative).
"""
import pytest

from repro.configs import ASSIGNED_ARCHS, PAPER_ARCHS
from repro.configs import get_arch as jget_arch
from repro.core.config import SHAPES as JSHAPES
from repro.launch import roofline as jroof
from repro_torch.configs import get_arch
from repro_torch.core.config import SHAPES
from repro_torch.launch import roofline

MESHES = {"16x16": (256, 16, 16), "2x16x16": (512, 16, 32)}   # n, tp, dp


@pytest.mark.parametrize("name", ASSIGNED_ARCHS + PAPER_ARCHS)
def test_modeled_bytes_and_model_flops_match_reference(name):
    ja, ta = jget_arch(name), get_arch(name)
    for shape in SHAPES:
        kind = SHAPES[shape].kind
        assert roofline.model_flops_for(ta, SHAPES[shape], kind) == \
            jroof.model_flops_for(ja, JSHAPES[shape], kind)
        for n, tp, dp in MESHES.values():
            for cr, accum in ((1.0, 8), (4.0, 32)):
                kw = dict(num_devices=n, tp=tp, dp=dp, cr=cr, accum=accum)
                want = jroof.modeled_bytes_per_device(ja, JSHAPES[shape],
                                                      kind, **kw)
                got = roofline.modeled_bytes_per_device(ta, SHAPES[shape],
                                                        kind, **kw)
                assert set(got) == set(want)
                if kind == "prefill":
                    ratio = 2048.0 / roofline.FLASH_Q_ROWS
                    assert got["attn_stream"] == pytest.approx(
                        want["attn_stream"] * ratio, rel=1e-12)
                    assert got["total"] == pytest.approx(
                        want["total"] - want["attn_stream"]
                        + got["attn_stream"], rel=1e-12)
                    got = {k: v for k, v in got.items()
                           if k not in ("attn_stream", "total")}
                    want = {k: v for k, v in want.items()
                            if k not in ("attn_stream", "total")}
                assert got == want, (shape, n, cr)


def _hlo(op, shape, groups):
    dt, dims = shape
    ids = ",".join(str(i) for i in range(groups))
    return (f"  %{op}.1 = {dt}[{dims}]{{0}} {op}({dt}[{dims}]{{0}} %x), "
            f"replica_groups={{{{{ids}}}}}")


CASES = [("all-reduce", ("f32", "1024,16"), 4, 1024 * 16 * 4),
         ("all-gather", ("bf16", "64,128"), 16, 64 * 128 * 2),
         ("reduce-scatter", ("f32", "256"), 16, 256 * 4),
         ("all-to-all", ("f32", "8,8"), 2, 8 * 8 * 4),
         ("collective-permute", ("bf16", "32"), 2, 32 * 2),
         ("all-reduce", ("f32", "10"), 1, 40)]


def test_ring_factors_match_reference_parser():
    text = "\n".join(_hlo(op, shp, n) for op, shp, n, _ in CASES)
    want = jroof.parse_collectives(text, num_devices=4)
    got = roofline.parse_collectives([(op, b, n) for op, _, n, b in CASES])
    assert got.wire_bytes == pytest.approx(want.wire_bytes, rel=1e-12)
    assert got.op_counts == want.op_counts
    assert got.op_bytes == pytest.approx(want.op_bytes, rel=1e-12)
    # groups beyond one node of 8 cards cross the inter-node links
    assert got.internode_bytes == pytest.approx(
        roofline.wire_bytes("all-gather", 64 * 128 * 2, 16)
        + roofline.wire_bytes("reduce-scatter", 256 * 4, 16), rel=1e-12)


def test_analyze_terms_and_bottleneck():
    arch, shape = get_arch("qwen-r1-1.5b"), SHAPES["decode_32k"]
    modeled = roofline.modeled_bytes_per_device(
        arch, shape, "decode", num_devices=256, tp=16, dp=16)
    coll = [("all-reduce", 1e6, 16), ("all-gather", 2e6, 4)]
    rep = roofline.analyze(
        flops=2e12, collectives=coll, arch="qwen-r1-1.5b", shape="decode_32k",
        mesh_desc="16x16", num_devices=256, modeled=modeled,
        model_flops=roofline.model_flops_for(arch, shape, "decode"),
        memory={"argument_bytes": 1.0})
    inter = roofline.wire_bytes("all-reduce", 1e6, 16)
    intra = roofline.wire_bytes("all-gather", 2e6, 4)
    assert rep.compute_s == pytest.approx(2e12 / roofline.PEAK_FLOPS)
    assert rep.memory_model_s == pytest.approx(
        modeled["total"] / roofline.HBM_BW)
    assert rep.collective_s == pytest.approx(
        intra / roofline.NVLINK_BW + inter / roofline.INTERNODE_BW)
    assert rep.internode_bytes_per_device == pytest.approx(inter)
    terms = {"compute": rep.compute_s, "memory": rep.memory_model_s,
             "collective": rep.collective_s}
    assert rep.bottleneck == max(terms, key=terms.get)
    assert rep.step_time_s == max(terms.values())
    assert rep.memory_analysis == {"argument_bytes": 1.0}
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.HBM_BYTES) == \
        (989e12, 3.35e12, 80e9)
