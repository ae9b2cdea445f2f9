"""The port's decode-path auditor (``repro_torch.analysis``) against the
reference's (``repro.analysis``): every case of ``tests/test_analysis.py``
on the port — each lint pass red on its seeded pathology and green on the
healthy twin, the contract checkers catching broken implementations, the
retrace sentinel and the host-sync tripwire over a randomized mixed
scheduler trace — then parity with the reference's sweep, the ref path's
allowlisted KV upcast and the tripwire's every kind.  The card's side
(the sync debug mode behind the tripwire, a kernel combo's launch
counters) is in ``tests/test_torch_cuda.py``, which imports no JAX.

The reference's two ``check_sharding_coverage`` cases wait for the
multi-device modules.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import analysis, bridge
from repro_torch.analysis import audit, contracts
from repro_torch.analysis.hostsync import HostSyncTripwire, sanctioned
from repro_torch.analysis.optrace import count_big_float_ops, trace_ops
from repro_torch.analysis.passes import LintContext, gating, run_passes
from repro_torch.analysis.retrace import RetraceSentinel, scheduler_jits
from repro_torch.core import policy as policy_lib
from repro_torch.core.config import KVPolicyConfig
from repro_torch.core.policy import _REGISTRY, available_policies, get_policy
from repro_torch.core.tree import tree_map
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

ARENA = (2, 2, 16, 4)                       # (B, Hkv, S, Dh) toy arena
ELEMS = int(np.prod(ARENA))


def _findings(fn, *args, table_mode=False, passes=None):
    ctx = LintContext(arena_elems=ELEMS, table_mode=table_mode)
    return run_passes(fn, ctx, *args, passes=passes, path="test")


def _rules(findings):
    return sorted({f.rule for f in gating(findings)})


@pytest.fixture(scope="module")
def port(tiny_arch, tiny_params):
    import jax
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")
    return tarch, params


# -- traffic lints: red on the seeded pathology, green on the healthy twin --


class TestArenaPad:
    def test_red_per_step_repad(self):
        def step(arena, kn):
            # the seed wrapper: re-pad the whole arena every step
            return torch.cat([arena[:, :, 1:], kn], dim=2)

        arena = torch.zeros(ARENA)
        kn = torch.zeros((2, 2, 1, 4))
        assert _rules(_findings(step, arena, kn)) == ["arena-pad"]

    def test_green_in_place_write(self):
        def step(arena, kn, pos):
            # copy_ into the arena returns the arena itself: no copy
            arena.narrow(2, pos, 1).copy_(kn)
            return arena

        arena = torch.zeros(ARENA)
        assert not _findings(step, arena, torch.zeros((2, 2, 1, 4)), 3)

    def test_red_functional_clone(self):
        # eager torch's form of the pitfall: a functional update clones
        def step(arena, kn):
            return arena.clone().index_put_(
                (torch.tensor([0]),), kn[0, :, 0][None, :, None].expand(
                    1, 2, 16, 4))

        arena = torch.zeros(ARENA)
        assert _rules(_findings(step, arena, torch.zeros((2, 2, 1, 4)))) \
            == ["arena-pad"]

    def test_green_index_put_in_place(self):
        def step(arena, rows, idx):
            arena.index_put_((idx,), rows)       # aliasing output
            return arena

        arena = torch.zeros(ARENA)
        assert not _findings(step, arena, torch.zeros((1, 2, 16, 4)),
                             torch.tensor([1]))


class TestArenaCast:
    def test_red_valid_bitmap_recast(self):
        def step(valid):
            # seed-era: astype(int32) of the whole validity bitmap per step
            return valid.to(torch.int32).sum(dim=-1)

        valid = torch.zeros(ARENA, dtype=torch.bool)
        assert _rules(_findings(step, valid)) == ["arena-cast"]

    def test_green_small_cast(self):
        def step(length):
            return length.to(torch.int32)

        assert not _findings(step, torch.zeros((2,), dtype=torch.int8))


class TestKVUpcast:
    def test_red_bf16_arena_to_f32(self):
        def step(arena):
            return arena.float() * 2.0

        assert _rules(_findings(step, torch.zeros(ARENA,
                                                  dtype=torch.bfloat16))) \
            == ["kv-upcast"]

    def test_green_downcast_is_by_design(self):
        def step(acc):
            # DMC writes its f32 accumulators back at model dtype
            return acc.to(torch.bfloat16)

        assert not _findings(step, torch.zeros(ARENA, dtype=torch.float32))

    def test_green_logits_are_no_kv_leaf(self):
        # at full width a step's fp32 logits (B, 1, V) can outnumber one
        # layer's arena; with the vocab named they are not KV
        logits = torch.zeros((2, 1, ELEMS), dtype=torch.bfloat16)
        ctx = LintContext(arena_elems=ELEMS, vocab=ELEMS)
        assert not run_passes(lambda x: x.float(), ctx, logits)
        assert _rules(run_passes(lambda x: x.float(), ctx,
                                 torch.zeros(ARENA, dtype=torch.bfloat16))) \
            == ["kv-upcast"]
        assert _rules(_findings(lambda x: x.float(), logits)) == ["kv-upcast"]

    @pytest.mark.parametrize("layout", ["transposed", "flattened"])
    def test_red_kv_upcast_in_any_layout(self, layout):
        # the vocab exemption is by identity: a KV leaf upcast through a
        # transposed or flattened view is still the pathology
        def step(arena):
            if layout == "transposed":
                return arena.transpose(-1, -2).float()
            return arena.flatten(2).float()           # (B, Hkv, S * Dh)

        ctx = LintContext(arena_elems=ELEMS, vocab=ELEMS)
        assert _rules(run_passes(step, ctx, torch.zeros(
            ARENA, dtype=torch.bfloat16))) == ["kv-upcast"]


class TestArenaGather:
    @staticmethod
    def _dense_rematerialize(arena, idx):
        # the wrapper re-materializing table order around the kernel
        return torch.index_select(arena, 2, idx)

    def test_red_table_mode(self):
        # pass-scoped: a kernel-free toy program also (correctly) trips the
        # ref-fallback lint in table mode, exercised by its own tests below
        arena = torch.zeros(ARENA)
        idx = torch.arange(ARENA[2])
        got = _findings(self._dense_rematerialize, arena, idx,
                        table_mode=True, passes=["arena-gather"])
        assert _rules(got) == ["arena-gather"]

    def test_green_ref_mode_gathers_allowed(self):
        arena = torch.zeros(ARENA)
        idx = torch.arange(ARENA[2])
        assert not _findings(self._dense_rematerialize, arena, idx)

    def test_green_embedding_lookup_exempt(self):
        # per-token lookups into big 2-D tables are the decode front-end,
        # not arena traffic (rank-<3 exemption)
        embed = torch.zeros((ELEMS * 2, 8))
        tok = torch.zeros((2, 1), dtype=torch.int64)
        assert not _findings(lambda e, t: e[t], embed, tok,
                             table_mode=True, passes=["arena-gather"])

    def test_green_row_read_exempt(self):
        # a step reads single rows out of the arena (the old row at a write
        # slot): the operand is the arena, the bytes moved are a row
        arena = torch.zeros(ARENA)
        bi = torch.arange(2)[:, None]
        hi = torch.arange(2)[None, :]
        si = torch.zeros((2, 2), dtype=torch.int64)
        assert not _findings(lambda a: a[bi, hi, si], arena, table_mode=True,
                             passes=["arena-gather"])


class TestRefFallback:
    @staticmethod
    def _ref_attention(q, arena):
        # the reference bhgd,bhpd->bhgp score einsum over the whole arena
        return torch.einsum("bhgd,bhpd->bhgp", q, arena)

    def test_red_reference_einsum_in_kernel_mode(self):
        q = torch.zeros((2, 2, 2, 4))
        got = _findings(self._ref_attention, q, torch.zeros(ARENA),
                        table_mode=True, passes=["ref-fallback"])
        assert _rules(got) == ["ref-fallback"]
        # both signals fire: the arena-sized score einsum itself, and the
        # absence of any kernel launch in the program
        assert len(gating(got)) == 2

    def test_green_ref_mode_is_silent(self):
        q = torch.zeros((2, 2, 2, 4))
        assert not _findings(self._ref_attention, q, torch.zeros(ARENA),
                             passes=["ref-fallback"])

    def test_param_matmul_not_flagged_as_einsum_fallback(self):
        # parameter products (the MLP/projection path) reach mm, never the
        # einsum signal, however large — only the missing-kernel signal
        # remains for this (kernel-free) toy program
        w = torch.zeros((ELEMS, 8))
        x = torch.zeros((2, ELEMS))
        got = _findings(lambda x, w: x @ w, x, w, table_mode=True,
                        passes=["ref-fallback"])
        msgs = [f.message for f in gating(got)]
        assert msgs and all("no kernel launch" in m for m in msgs)

    def test_red_real_reference_decode_in_table_mode(self, port,
                                                     paged_state):
        # the actual pathology: a decode step that ran the reference einsum
        # where the kernel was requested is caught
        tarch, params = port
        _, state = paged_state
        tok = torch.zeros((2, 1), dtype=torch.int32)
        pos = torch.zeros((2,), dtype=torch.int32)
        trace = trace_ops(lambda s: tfm.decode_step(
            params, tok, s, tarch, pos, use_kernel=False), state)
        ctx = LintContext(arena_elems=audit.arena_elems(state, True),
                          table_mode=True)
        got = run_passes(trace, ctx, passes=("ref-fallback",))
        assert _rules(got) == ["ref-fallback"]


class TestScalarOutput:
    def test_red_device_scalar_bookkeeping(self):
        def step(arena):
            # the old aux["alpha_count"]: static size returned as f32[]
            return arena * 2.0, (torch.tensor(float(arena.numel()))
                                 + arena.sum() * 0)

        got = _findings(step, torch.zeros(ARENA))
        assert _rules(got) == ["scalar-output"]

    def test_green_vector_metrics(self):
        def step(arena):
            return arena * 2.0, arena.sum(dim=(1, 2, 3))  # per-lane (B,)

        assert not _findings(step, torch.zeros(ARENA))


def test_allowlist_downgrades_to_info():
    def step(arena):
        return torch.cat([arena, arena], dim=2)

    ctx = LintContext(arena_elems=ELEMS, allow=("arena-pad",))
    got = run_passes(step, ctx, torch.zeros(ARENA))
    assert got and not gating(got)
    assert all(f.severity == "info" for f in got)


# -- green on the real entry points (the audit sweep is not vacuous) --------


@pytest.fixture(scope="module")
def paged_state(port):
    tarch, _ = port
    cfg = KVPolicyConfig(kind="dms", cr=2.0, window=4, block_p=8, paged=True)
    return cfg, tfm.init_decode_state(tarch, 2, 32, cfg, device="cpu")


def _copy(state):
    return tree_map(lambda a: a.clone(), state)


def test_decode_step_lints_clean(port, paged_state):
    """Both paths lint clean, the ref path with the audit's one allowance
    (its KV upcast: see ``test_ref_path_kv_upcast_is_seen_and_allowlisted``)."""
    tarch, params = port
    _, state = paged_state
    tok = torch.zeros((2, 1), dtype=torch.int32)
    pos = torch.zeros((2,), dtype=torch.int32)
    for use_kernel in (False, True):
        trace = trace_ops(lambda s: tfm.decode_step(
            params, tok, s, tarch, pos, use_kernel=use_kernel),
            _copy(state))
        path = "kernel" if use_kernel else "ref"
        ctx = LintContext(arena_elems=audit.arena_elems(state, True),
                          table_mode=use_kernel,
                          allow=audit.PATH_ALLOW.get(("decode", path), ()))
        assert not gating(run_passes(trace, ctx)), use_kernel


def test_ref_path_kv_upcast_is_seen_and_allowlisted(port, paged_state):
    """The ref path casts the bf16 K/V arena to fp32 in every layer
    (``models/attention.py``'s ``k.float()``/``v.float()``): the auditor
    reports it, and the audit allowlists it for the ref path alone, with
    its reason; the kernel path has no upcast and no allowance."""
    tarch, params = port
    _, state = paged_state
    tok = torch.zeros((2, 1), dtype=torch.int32)
    pos = torch.zeros((2,), dtype=torch.int32)
    ctx = LintContext(arena_elems=audit.arena_elems(state, True))
    ref = run_passes(trace_ops(lambda s: tfm.decode_step(
        params, tok, s, tarch, pos, use_kernel=False), _copy(state)), ctx)
    ups = [f for f in ref if f.rule == "kv-upcast"]
    # k and v, in each attention layer
    assert len(ups) == 2 * tarch.num_layers and _rules(ref) == ["kv-upcast"]
    assert "bfloat16 -> torch.float32" in ups[0].message
    assert audit.PATH_ALLOW[("decode", "ref")] == ("kv-upcast",)
    assert ("decode", "kernel") not in audit.PATH_ALLOW
    rep = audit.audit_combo(tarch, params, "dms", True, False,
                            device="cpu")
    info = [f for f in rep.findings if f.rule == "kv-upcast"]
    assert len(info) == len(ups) and all(f.severity == "info" for f in info)
    kern = run_passes(trace_ops(lambda s: tfm.decode_step(
        params, tok, s, tarch, pos, use_kernel=True), _copy(state)),
        dataclasses.replace(ctx, table_mode=True))
    assert not kern


def test_fork_reclaim_lint_clean(port, paged_state):
    tarch, _ = port
    cfg, state = paged_state
    ctx = LintContext(arena_elems=audit.arena_elems(state))
    src = torch.zeros((2,), dtype=torch.int32)
    assert not gating(run_passes(tfm.gather_lanes, ctx, _copy(state), src))
    fresh = tfm.init_decode_state(tarch, 2, 32, cfg, device="cpu")
    assert not gating(run_passes(tfm.reclaim_lanes, ctx, _copy(state),
                                 torch.zeros((2,), dtype=torch.bool), fresh))


def test_shared_counters_match_benchmark_semantics():
    # eager mode runs (and records) each of the loop's ops: three pads,
    # where the reference's scan body holds one eqn
    def looped_pad(arena):
        for _ in range(3):
            arena = torch.cat([arena[:, :, 1:], torch.ones((2, 2, 1, 4))],
                              dim=2)
        return arena

    arena = torch.zeros(ARENA)
    got = analysis.count_arena_copies(looped_pad, arena, arena_elems=ELEMS)
    assert got == {"arena_pad_copies": 3, "valid_recasts": 0}
    assert count_big_float_ops(trace_ops(looped_pad, arena), ELEMS) == 3


# -- contract checkers ------------------------------------------------------


def test_tree_invariance_red_and_green():
    tree = {"k": torch.zeros((2, 4), dtype=torch.bfloat16),
            "n": torch.zeros((), dtype=torch.int32)}
    assert not contracts.check_tree_invariance(lambda t: t, tree)
    got = contracts.check_tree_invariance(
        lambda t: {"k": t["k"].float(), "n": t["n"]}, tree)
    assert _rules(got) == ["tree-state"]
    # structure drift is also a finding, not a crash
    got = contracts.check_tree_invariance(lambda t: {"k": t["k"]}, tree)
    assert _rules(got) == ["tree-state"]


def test_tree_invariance_leaves_the_caller_state_alone():
    tree = {"k": torch.zeros((2, 4))}

    def step(t):
        t["k"].add_(1.0)                     # the port's steps write in place
        return t

    assert not contracts.check_tree_invariance(step, tree)
    assert not tree["k"].any()


def test_policy_lifecycle_green_all_registered(port):
    tarch, _ = port
    for name in available_policies():
        cfg = KVPolicyConfig(kind=name, cr=2.0, window=4, block_p=8,
                             quest_page_size=8, quest_top_pages=2)
        got = contracts.check_policy_lifecycle(name, tarch, cfg,
                                               batch=2, max_len=32,
                                               device="cpu")
        assert not got, (name, [str(f) for f in got])


def test_policy_lifecycle_red_aval_drift(port):
    tarch, _ = port

    class Broken(type(get_policy("vanilla"))):
        def decode_update(self, cache, q, k_new, v_new, aux):
            cache, spec, meters = super().decode_update(cache, q, k_new,
                                                        v_new, aux)
            return tree_map(lambda x: x.to(torch.float16), cache), spec, \
                meters

        def metrics(self, cache):
            return {"live_tokens": torch.zeros(())}   # wrong shape + missing

    pol = Broken()
    pol.name = "broken-test"
    _REGISTRY["broken-test"] = pol
    try:
        cfg = KVPolicyConfig(kind="vanilla", cr=2.0, window=4)
        got = contracts.check_policy_lifecycle("broken-test", tarch, cfg,
                                               batch=2, max_len=16,
                                               device="cpu")
    finally:
        del _REGISTRY["broken-test"]
    rules = _rules(got)
    assert rules == ["policy-protocol", "tree-state"]
    msgs = " ".join(f.message for f in got)
    assert "live_tokens" in msgs and "reads_tokens" in msgs


# -- retrace sentinel -------------------------------------------------------


def test_retrace_sentinel_red_shape_retrace():
    holder = types.SimpleNamespace(f=lambda x: x * 2)
    holder.f(torch.zeros((2,)))                  # outside the region
    with RetraceSentinel({"f": (holder, "f")}, exact={"f": 1}) as s:
        holder.f(torch.zeros((3,)))
        holder.f(torch.zeros((4,)))              # second signature = retrace
    assert s.compiles == {"f": 2}
    assert _rules(s.findings()) == ["retrace"]


def test_retrace_sentinel_green_stable_shapes():
    holder = types.SimpleNamespace(f=lambda x: x + 1)
    with RetraceSentinel({"f": (holder, "f")}, budget=1) as s:
        for _ in range(4):
            holder.f(torch.zeros((5,)))
    assert s.compiles == {"f": 1} and not s.findings()


def test_retrace_sentinel_rejects_non_step():
    # a bare callable has nowhere to be wrapped for the duration
    with pytest.raises(TypeError):
        RetraceSentinel({"f": lambda x: x})


@pytest.mark.parametrize("arg,other", [
    (torch.zeros((2,), dtype=torch.int32), torch.zeros((2,), dtype=torch.int64)),
    (0, 1),                                       # a non-tensor, by value
    ({"a": torch.zeros(2)}, {"b": torch.zeros(2)}),   # tree structure
], ids=["dtype", "python-value", "structure"])
def test_retrace_sentinel_signature_parts(arg, other):
    holder = types.SimpleNamespace(f=lambda x: x)
    with RetraceSentinel({"f": (holder, "f")}, exact={"f": 1}) as s:
        holder.f(arg)
        holder.f(arg)
    assert not s.findings()
    with RetraceSentinel({"f": (holder, "f")}, exact={"f": 1}) as s:
        holder.f(arg)
        holder.f(other)
    assert _rules(s.findings()) == ["retrace"]
    assert holder.f(3) == 3 and "f" in vars(holder)   # restored


# -- host-sync tripwire -----------------------------------------------------


def test_hostsync_red_each_kind():
    x = torch.arange(4)
    with HostSyncTripwire() as tw:
        np.asarray(x)                            # np.asarray
        x[0].item()                              # .item()
        x.cpu()                                  # .cpu()
    kinds = [e[0] for e in tw.events]
    assert kinds == ["np.asarray", ".item()", ".cpu()"]
    assert len(tw.violations()) == 3
    assert all(f.rule == "host-sync" for f in tw.violations())


READS = {
    ".tolist()": lambda x: x.tolist(),
    "__bool__": lambda x: bool(x[0]),
    "__int__": lambda x: int(x[0]),
    "__float__": lambda x: float(x[0]),
    "__index__": lambda x: [0, 1, 2, 3, 4][x[1]],
    ".numpy()": lambda x: x.numpy(),
    '.to("cpu")': lambda x: x.to("cpu"),
    "np.array": lambda x: np.array(x),
    "aten.nonzero": lambda x: torch.nonzero(x),
    "aten.masked_select": lambda x: torch.masked_select(x, x > 1),
    "aten.index (boolean mask)": lambda x: x[x > 1],
    "aten._unique2": lambda x: torch.unique(x),
    "aten.repeat_interleave (no output_size)":
        lambda x: torch.repeat_interleave(x, x),
}


@pytest.mark.parametrize("kind", sorted(READS))
def test_hostsync_every_kind_red_and_sanctioned(kind):
    """Every host read the tripwire knows, recorded on the CPU as it would
    sync on the card: a violation unsanctioned, info under an allowed
    tag."""
    x = torch.arange(4)
    with HostSyncTripwire() as tw:
        READS[kind](x)
        with sanctioned("tick-boundary"):
            READS[kind](x)
    assert [e[:2] for e in tw.events] == [(kind, None),
                                          (kind, "tick-boundary")]
    assert [f.severity for f in tw.findings()] == ["error", "info"]
    assert tw.events[0][2].startswith("test_torch_analysis.py:")


def test_hostsync_green_shape_free_ops():
    """The forms that need no values on the host are not recorded: a
    repeat count given with its output size, an int repeat, a
    ``torch.device`` move of a CPU tensor (an upload on the card), a
    masked fill."""
    x = torch.arange(4)
    with HostSyncTripwire() as tw:
        torch.repeat_interleave(x, x, output_size=6)
        x.repeat_interleave(2)
        x.to(torch.device("cpu"))
        x.masked_fill(x > 1, 0)
        x.to(torch.float32)
    assert tw.events == []


def test_hostsync_sanctioned_tags():
    x = torch.arange(4)
    with HostSyncTripwire() as tw:
        with sanctioned("tick-boundary"):
            np.asarray(x)                        # allowed: info, not gating
        with sanctioned("rogue-tag"):
            np.asarray(x)                        # unknown tag still gates
    assert not gating(tw.findings()[:1])
    assert len(tw.violations()) == 1
    assert "rogue-tag" in tw.violations()[0].message


def test_hostsync_unarmed_is_free():
    x = torch.arange(4)
    with sanctioned("tick-boundary"):
        assert int(np.asarray(x)[0]) == 0        # no tripwire: plain numpy
    tw = HostSyncTripwire()
    assert tw.events == [] and not tw.findings()
    assert "__bool__" not in torch.Tensor.__dict__   # nothing left patched


def test_hostsync_boolean_mask_in_a_step_is_caught(port):
    """A boolean-mask index inside a chunk step syncs on the card to size
    its output: caught on the CPU, where it syncs nothing."""
    tarch, params = port
    eng = Engine(tarch, params, audit.policy_cfg("dms", False), chunk=4,
                 use_kernel=False, device="cpu")
    sched = eng.scheduler(num_lanes=2, max_len=24)
    real = sched._chunk_fn

    def chunk_fn(*args):
        out = real(*args)
        out[6][out[6] > 0].sum()                # last_logits[mask]
        return out
    sched._chunk_fn = chunk_fn
    sched.submit(Request(uid=0, prompt=np.arange(3, 9, dtype=np.int32),
                         max_new=3))
    with HostSyncTripwire() as tw:
        sched.run()
    bad = tw.violations()
    assert bad and {f.message.split(" via ")[1].split(" inside")[0]
                    for f in bad} == {"aten.index (boolean mask)"}
    # attributed to the innermost frame of the package: the chunk's call
    assert all(f.path.startswith("scheduler.py:_tick:") for f in bad)


@pytest.mark.parametrize("arch_name", ["gemma2-2b", "recurrentgemma-2b"])
def test_embedding_multiplier_reads_no_tensor(arch_name):
    """The families with an embedding multiplier round it to the compute
    dtype in host arithmetic, as ``torch.tensor(m, dtype=dtype)`` rounds
    it: a step's embedding reads no tensor's value."""
    from repro_torch.configs import get_smoke
    arch = get_smoke(arch_name)
    m = arch.embedding_multiplier
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for v in [m, 1.0 / m] + list(rng.uniform(-300.0, 300.0, 2000)):
            assert tfm.round_to_dtype(float(v), dtype) == torch.tensor(
                float(v), dtype=dtype).item()
    params = {"embed": torch.randn((arch.padded_vocab, arch.d_model))}
    tokens = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    with HostSyncTripwire() as tw:
        x = tfm.embed_tokens(params, tokens, arch)
    assert tw.events == []
    dtype = x.dtype
    want = params["embed"][tokens.long()].to(dtype) * torch.tensor(
        m, dtype=dtype).item()
    assert torch.equal(x, want)


# -- the serving contract, end to end ---------------------------------------


def _seed11_trace(sched_submit, request_cls):
    rng = np.random.default_rng(11)
    for uid in range(6):
        w = int(rng.choice([1, 1, 2]))
        sched_submit(request_cls(
            uid=uid,
            prompt=rng.integers(1, 97, size=int(rng.integers(2, 11)))
                      .astype(np.int32),
            max_new=int(rng.integers(2, 6)),
            width=w,
            eos_id=(3 if uid % 2 else None),     # EOS may or may not fire
            arrival=int(rng.integers(0, 4))))


def test_scheduler_trace_compile_budget_and_no_host_sync(tiny_arch,
                                                         tiny_params, port):
    """Randomized mixed trace (the reference test's seed-11 trace):
    prompt lengths, widths, arrivals and EOS vary per request — none of
    it adds a chunk signature or syncs the host outside the tick
    boundary; tokens equal the JAX ``Engine``'s, and the tags the port's
    tripwire saw are the reference tripwire's."""
    from repro.analysis.hostsync import HostSyncTripwire as JTripwire
    from repro.analysis.retrace import RetraceSentinel as JSentinel
    from repro.analysis.retrace import engine_jits
    from repro.core.config import KVPolicyConfig as JKV
    from repro.serving.engine import Engine as JEngine
    from repro.serving.scheduler import Request as JRequest

    kw = dict(kind="dms", cr=2.0, window=4, block_p=8, paged=True)
    jeng = JEngine(tiny_arch, tiny_params, JKV(**kw), chunk=4)
    jsched = jeng.scheduler(num_lanes=4, max_len=48)
    _seed11_trace(jsched.submit, JRequest)
    with JSentinel(engine_jits(jeng), exact={"chunk": 1}), \
            JTripwire() as jtw:
        want = {r.uid: r for r in jsched.run()}

    tarch, params = port
    eng = Engine(tarch, params, KVPolicyConfig(**kw), chunk=4,
                 use_kernel=False, device="cpu")
    sched = eng.scheduler(num_lanes=4, max_len=48)
    _seed11_trace(sched.submit, Request)
    with RetraceSentinel(scheduler_jits(sched),
                         exact={"chunk": 1},
                         budget={"gather": 1, "reset": 1, "export": 0,
                                 "import": 0}) as sentinel, \
            HostSyncTripwire() as tripwire:
        results = sched.run()
    assert len(results) == 6
    for r in results:
        np.testing.assert_array_equal(r.tokens, want[r.uid].tokens)
        np.testing.assert_array_equal(r.lengths, want[r.uid].lengths)
    assert sentinel.compiles["chunk"] == 1, sentinel.compiles
    assert not sentinel.findings(), sentinel.compiles
    assert not tripwire.violations(), \
        [f.path for f in tripwire.violations()]
    # the sanctioned tick-boundary sync did happen (the trace is not dead)
    tags = {tag for _, tag, _ in tripwire.events}
    assert "tick-boundary" in tags
    assert tags == {tag for _, tag, _ in jtw.events}


# -- parity with the reference's sweep --------------------------------------


COMBOS = [(p, paged, k) for p in sorted(policy_lib.available_policies())
          for paged in (False, True) for k in (False, True)]


def _combo_id(c):
    return f"{c[0]}-{'paged' if c[1] else 'fixed'}-{'kernel' if c[2] else 'ref'}"


@pytest.mark.parametrize("combo", COMBOS, ids=_combo_id)
def test_audit_combo_clean(port, combo):
    """Each of the reference sweep's 36 combos, at the ``tiny_arch``
    config: no gating finding (the reference's ``audit_combo`` gives none
    anywhere); in kernel mode one kernel event per attention layer."""
    tarch, params = port
    policy, paged, use_kernel = combo
    rep = audit.audit_combo(tarch, params, policy, paged, use_kernel,
                            device="cpu")
    assert not gating(rep.findings), [str(f) for f in gating(rep.findings)]
    assert rep.ops_per_step > 0
    if use_kernel:
        assert rep.kernel_events == rep.attn_layers == tarch.num_layers
    else:
        assert {f.rule for f in rep.findings} == {"kv-upcast"}


@pytest.mark.parametrize("combo", [("dms", True, True), ("quest", False, True),
                                   ("dmc", True, False)], ids=_combo_id)
def test_audit_combo_matches_reference(tiny_arch, tiny_params, port, combo):
    """A few combos side by side with the reference's ``audit_combo``:
    both free of gating findings."""
    from repro.analysis import audit as jaudit
    from repro.analysis.passes import gating as jgating
    policy, paged, use_kernel = combo
    want = jgating(jaudit.audit_combo(tiny_arch, tiny_params, policy, paged,
                                      use_kernel))
    tarch, params = port
    got = gating(audit.audit_combo(tarch, params, policy, paged,
                                   use_kernel, device="cpu").findings)
    assert want == [] and got == []


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("name", [n for n, _ in audit.TRACES])
def test_audit_traces_clean(port, name, paged):
    """The scheduler, preempt and SLO traces under the sentinel and the
    tripwire, fixed and paged, on the kernel path (its plain version)."""
    tarch, params = port
    fn = dict(audit.TRACES)[name]
    assert not fn(tarch, params, paged, device="cpu")


def test_audit_main_exits_zero_on_cpu(capsys):
    assert audit.main(["--device", "cpu", "--policies", "dms,vanilla",
                       "--skip-scheduler"]) == 0
    out = capsys.readouterr().out
    assert "audit: 0 gating finding(s)" in out
    assert "2 policies x {ref,kernel} x {fixed,paged}" in out


def test_audit_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        audit.main(["--policies", "dms", "--skip-scheduler"])


@pytest.mark.parametrize("name", ["audit_combo", "audit_contracts",
                                  "audit_scheduler", "audit_preempt",
                                  "audit_slo", "sweep",
                                  "check_policy_lifecycle"])
def test_audit_functions_default_to_the_card(port, name):
    """Every public entry point of the auditor runs on the card unless the
    caller asks for the CPU: with no card, leaving ``device`` out raises
    instead of auditing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    tarch, params = port
    calls = {
        "audit_combo": lambda: audit.audit_combo(tarch, params, "dms",
                                                 False, True),
        "audit_contracts": lambda: audit.audit_contracts(tarch, "dms",
                                                         False),
        "audit_scheduler": lambda: audit.audit_scheduler(tarch, params,
                                                         False),
        "audit_preempt": lambda: audit.audit_preempt(tarch, params, False),
        "audit_slo": lambda: audit.audit_slo(tarch, params, False),
        "sweep": lambda: audit.sweep(tarch, params, policies=("dms",)),
        "check_policy_lifecycle": lambda: contracts.check_policy_lifecycle(
            "dms", tarch, audit.policy_cfg("dms", False)),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[name]()


def test_planted_ref_path_in_kernel_mode_is_caught(port):
    """A step that forces the reference path where the kernel was asked
    for fails the kernel combo: the ref-fallback lint and the launch
    check."""
    tarch, params = port

    def forced(*args, use_kernel=False, **kw):
        return tfm.decode_step(*args, use_kernel=False, **kw)

    rep = audit.audit_combo(tarch, params, "dms", False, True, step=forced,
                            device="cpu")
    assert _rules(rep.findings) == ["kernel-launch", "kv-upcast",
                                    "ref-fallback"]
