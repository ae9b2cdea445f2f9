"""The port's workload generators against the reference's: for each seed,
every generator gives the same request list (uids, arrivals, prompts,
output budgets, widths, EOS and deadlines), ``trace_summary`` the same
offered load, and ``WorkloadSpec`` refuses the same specs.  Both draw from
``np.random.default_rng``, so the lists must be equal, not close."""
import numpy as np
import pytest

from repro.serving import workload as jw
from repro_torch.serving import workload as tw

KW = dict(vocab=64, max_len=24, prompt_len=(4, 10), max_new=(2, 6),
          widths=(1, 2), eos_id=5, deadline=12)
WEIGHTED = dict(KW, widths=(1, 2, 4), width_weights=(0.5, 0.3, 0.2),
                max_len=40)


def _fields(reqs):
    return [(r.uid, r.arrival, r.max_new, r.width, r.eos_id, r.deadline,
             r.prompt.dtype.str, tuple(r.prompt.tolist())) for r in reqs]


def _both(make, spec_kw):
    return (make(tw, tw.WorkloadSpec(**spec_kw)),
            make(jw, jw.WorkloadSpec(**spec_kw)))


GENERATORS = {
    "poisson": lambda m, s, seed: m.poisson_trace(seed, 12, rate=0.7, spec=s),
    "burst": lambda m, s, seed: m.burst_trace(seed, 12, rate=1.5, on_ticks=4,
                                              off_ticks=6, spec=s),
    "multi_turn": lambda m, s, seed: m.multi_turn_trace(
        seed, sessions=3, turns=3, spec=s, session_rate=0.3, think_ticks=3),
    "from_arrivals": lambda m, s, seed: m.requests_from_arrivals(
        seed, [5, 1, 3, 3, 9], s, uid_base=10),
}


@pytest.mark.parametrize("spec", ["plain", "weighted"])
@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_trace_equals_reference(gen, seed, spec):
    t, j = _both(lambda m, s: GENERATORS[gen](m, s, seed),
                 KW if spec == "plain" else WEIGHTED)
    assert len(t) > 0
    assert _fields(t) == _fields(j)
    assert tw.trace_summary(t) == jw.trace_summary(j)


@pytest.mark.parametrize("seed", [0, 5])
def test_arrival_processes_equal_reference(seed):
    np.testing.assert_array_equal(tw.poisson_arrivals(seed, 20, 0.4),
                                  jw.poisson_arrivals(seed, 20, 0.4))
    np.testing.assert_array_equal(
        tw.burst_arrivals(seed, 20, rate=2.0, on_ticks=3, off_ticks=5),
        jw.burst_arrivals(seed, 20, rate=2.0, on_ticks=3, off_ticks=5))


@pytest.mark.parametrize("bad", [
    (dict(vocab=64, max_len=24, prompt_len=(5, 4)), "prompt_len"),
    (dict(vocab=64, max_len=24, max_new=(0, 3)), "max_new"),
    (dict(vocab=64, max_len=10, prompt_len=(4, 10), max_new=(2, 6)),
     "max_len"),
    (dict(vocab=64, max_len=24, widths=(1, 2), width_weights=(1.0,)),
     "width_weights"),
], ids=["prompt_len", "max_new", "max_len", "width_weights"])
def test_spec_validation_matches_reference(bad):
    kw, match = bad
    for mod in (tw, jw):
        with pytest.raises(ValueError, match=match):
            mod.WorkloadSpec(**kw)


def test_generator_argument_checks():
    for mod in (tw, jw):
        with pytest.raises(ValueError, match="rate"):
            mod.poisson_arrivals(0, 4, 0.0)
        with pytest.raises(ValueError, match="on_ticks"):
            mod.burst_arrivals(0, 4, rate=1.0, on_ticks=0, off_ticks=1)
        with pytest.raises(ValueError, match="sessions"):
            mod.multi_turn_trace(0, sessions=0, turns=1,
                                 spec=mod.WorkloadSpec(**KW))
    assert tw.trace_summary([]) == jw.trace_summary([])
