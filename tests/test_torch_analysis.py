"""The port's static analysis (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU.

Both packages run the same programs and the same seeded mutant passes;
the port keeps its blocks on ``device="cpu"``, the reference runs its
NumPy interpreter.  Where the two compare, they must agree exactly: the
same rule names, severities and blamed passes for every mutant, the
same count of verified flushes for every paper app, the same messages
for a rendezvous schedule.  Results are held to the reference (or to
host NumPy) bit for bit for elementwise programs, and at rtol 1e-12 for
programs with reductions, transcendentals or matmul (torch sums and
evaluates those in another order than NumPy: tests/test_torch_runtime.py).
"""
import threading
import types

import numpy as np
import pytest

import repro_torch
from repro_torch import apps
from repro_torch.analysis import (
    AnalysisReport,
    Diagnostic,
    VerificationError,
    available_rules,
    check,
    register_rule,
)
from repro_torch.api.config import ExecutionPolicy, RuntimeConfig
from repro_torch.api.registry import PASSES, RULES, register_pass
from repro_torch.core.engine import FlushTicket, Runtime
from repro_torch.core.graph import (
    COMPUTE,
    AccessNode,
    OperationNode,
    cone_region_footprint,
    region_footprints_conflict,
)

pytest.importorskip("jax")

import repro  # noqa: E402
import repro.analysis  # noqa: E402
import repro.api.registry  # noqa: E402
import repro.core.engine  # noqa: E402
import repro.core.graph  # noqa: E402
from benchmarks.paper_apps import APPS as REF_APPS  # noqa: E402

FULL = dict(flush="async", channel="async", sync="demand", verify="full")

# tests/test_torch_runtime.py's sizes and blocks
SMALL = dict(
    fractal=dict(n=128, iters=4),
    black_scholes=dict(n=50_000, iters=3),
    nbody=dict(n=192, steps=2),
    knn=dict(n=512, d=16),
    lbm2d=dict(h=128, w=128, steps=2),
    lbm3d=dict(d=16, h=16, w=16, steps=2),
    jacobi=dict(n=256, nrhs=256, iters=3),
    jacobi_stencil=dict(n=256, iters=3),
)
SMALL_BLOCKS = dict(
    fractal=32, black_scholes=8192, nbody=64, knn=128,
    lbm2d=32, lbm3d=8, jacobi=64, jacobi_stencil=64,
)
EXACT = {"fractal", "lbm2d", "lbm3d", "jacobi_stencil"}


def _packages():
    """The two packages behind one surface: the port with its blocks on
    the CPU, the reference on its NumPy interpreter."""
    ref = types.SimpleNamespace(
        name="repro", mod=repro, kw={}, backend="numpy",
        VerificationError=repro.analysis.VerificationError,
        register_pass=repro.api.registry.register_pass,
        PASSES=repro.api.registry.PASSES,
        check=repro.analysis.check,
        OperationNode=repro.core.graph.OperationNode,
        AccessNode=repro.core.graph.AccessNode,
        COMPUTE=repro.core.graph.COMPUTE,
    )
    port = types.SimpleNamespace(
        name="repro_torch", mod=repro_torch, kw={"device": "cpu"}, backend="torch",
        VerificationError=VerificationError, register_pass=register_pass,
        PASSES=PASSES, check=check, OperationNode=OperationNode,
        AccessNode=AccessNode, COMPUTE=COMPUTE,
    )
    return ref, port


def _policy(P, **kw):
    return P.mod.ExecutionPolicy(**{**FULL, "backend": P.backend, **kw})


def _mk(P, key, region, write, label):
    op = P.OperationNode(P.COMPUTE, None, procs=(0,), label=label)
    op.add_access(P.AccessNode(key, region, write=write))
    return op


def _findings(report) -> list:
    return sorted((d.rule, d.severity, d.pass_name) for d in report.errors)


@pytest.fixture
def mutant():
    """Register a throwaway mutant pass in a package; unregister on
    teardown."""
    added = []

    def add(P, name, fn):
        P.register_pass(name, fn)
        added.append((P, name))
        return name

    yield add
    for P, name in added:
        P.PASSES.unregister(name)


# ---------------------------------------------------------------------------
# configuration surface
# ---------------------------------------------------------------------------


def test_registry_lists_the_reference_rules():
    assert set(available_rules()) == set(repro.analysis.available_rules())
    assert {"plan", "races", "deadlock"} <= set(available_rules())


def test_register_rule_registry():
    seen = []

    @register_rule("test-custom")
    def custom(ctx):
        seen.append(True)
        ctx.emit("test-custom", "info", "ran")

    try:
        rep = check(rules=("test-custom",))
        assert seen and len(rep.diagnostics) == 1
        assert rep.rules_run == ("test-custom",)
    finally:
        RULES.unregister("test-custom")


def test_runtime_verify_kwarg_and_env(monkeypatch):
    with pytest.raises(ValueError, match="off|plan|full"):
        ExecutionPolicy(verify="bogus")
    rt = Runtime(nprocs=2, verify="plan", device="cpu")
    assert rt.verify_mode == "plan" and rt.verify_stats is not None
    rt = Runtime(nprocs=2, device="cpu")
    assert rt.verify_mode == "off" and rt.verify_stats is None
    monkeypatch.setenv("REPRO_VERIFY", "full")
    assert Runtime(nprocs=2, device="cpu").verify_mode == "full"
    # an explicit kwarg beats the environment
    assert Runtime(nprocs=2, verify="plan", device="cpu").verify_mode == "plan"
    monkeypatch.setenv("REPRO_VERIFY", "bogus")
    with pytest.raises(ValueError, match="verify"):
        Runtime(nprocs=2, device="cpu")


# ---------------------------------------------------------------------------
# clean programs: the built-in pipeline verifies clean on every paper app
# ---------------------------------------------------------------------------


def _verified_app(P, app_fn, app, fusion):
    config = P.mod.RuntimeConfig(nprocs=4, block_size=SMALL_BLOCKS[app], fusion=fusion,
                                 **P.kw)
    with P.mod.core.engine.Runtime.from_config(config, _policy(P)) as rt:
        out = np.asarray(app_fn(**SMALL[app]))
        return out, rt.verify_stats


@pytest.mark.parametrize("app", list(SMALL))
def test_apps_verify_clean_as_the_reference(app):
    """verify="full" over each paper app: no diagnostic on either
    package, the same number of verified flushes, the same result."""
    ref, port = _packages()
    fusion = app == "jacobi_stencil"
    want, ref_vs = _verified_app(ref, REF_APPS[app][0], app, fusion)
    got, vs = _verified_app(port, apps.APPS[app][0], app, fusion)
    assert ref_vs.n_diagnostics == 0 and vs.n_diagnostics == 0, (ref_vs, vs)
    assert vs.n_flushes_verified == ref_vs.n_flushes_verified >= 1
    assert vs.n_race_checks == ref_vs.n_race_checks
    if app in EXACT:
        assert np.array_equal(got, want, equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_builtin_pipeline_verifies_clean():
    with repro_torch.runtime(nprocs=4, block_size=16, policy=ExecutionPolicy(**FULL),
                             device="cpu") as rt:
        a = repro_torch.array(np.arange(64.0))
        b = a * 2.0 + 1.0
        t = b * b
        s = t.sum()  # dead temp -> map+reduce fusion
        del t
        a[0:8] = 7.0
        np.testing.assert_array_equal(np.asarray(b), np.arange(64.0) * 2 + 1)
        np.testing.assert_allclose(
            np.asarray(s), ((np.arange(64.0) * 2 + 1) ** 2).sum(), rtol=1e-12
        )
        vs = rt.verify_stats
        assert vs.n_flushes_verified >= 1 and vs.n_diagnostics == 0
        assert rt.last_verify_report is not None and rt.last_verify_report.ok
        assert vs.verify_seconds > 0


def test_verify_cached_plans_reverifies_every_entry():
    """A verified cone's plan enters the plan-shape cache; each resident
    entry re-proves clean on demand, and a repeated shape hits."""
    with repro_torch.runtime(nprocs=4, block_size=16, plan_cache=True, device="cpu",
                             policy=ExecutionPolicy(**FULL)) as rt:
        outs = []
        for k in range(2):
            a = repro_torch.array(np.arange(64.0) + k)
            outs.append(np.asarray(np.roll(a, 1, axis=0) * 2.0 + a))
        reports = rt.verify_cached_plans()
        assert reports and all(r.ok for r in reports)
        assert rt._plan_cache.hits >= 1
        assert rt.verify_stats.n_diagnostics == 0
    for k, out in enumerate(outs):
        h = np.arange(64.0) + k
        np.testing.assert_array_equal(out, np.roll(h, 1, axis=0) * 2.0 + h)


# ---------------------------------------------------------------------------
# plan-rule mutants, each caught by both packages alike
# ---------------------------------------------------------------------------


def _inversion(P, mutant):
    def reverse(ctx):
        ctx.ops = list(reversed(ctx.ops))
        ctx.dirty = True

    name = mutant(P, "evil-reverse", reverse)
    with pytest.raises(P.VerificationError) as ei:
        with P.mod.runtime(nprocs=2, block_size=16,
                           policy=_policy(P, passes=(name,)), **P.kw):
            a = P.mod.ones((32,))
            a += 1.0
            a *= 3.0  # conflicting write pair -> inverted by the mutant
            np.asarray(a)
    report = ei.value.report
    assert any(d.rule == "plan" and "inverted" in d.message for d in report.errors)
    return report


def _dropped_live_store(P, mutant):
    def drop_first_store(ctx):
        for i, op in enumerate(ctx.ops):
            if any(a.write and a.key[0] != "s" for a in op.accesses):
                ctx.note_drop(op)
                ctx.ops = ctx.ops[:i] + ctx.ops[i + 1:]
                ctx.dirty = True
                return

    name = mutant(P, "evil-drop", drop_first_store)
    with pytest.raises(P.VerificationError) as ei:
        with P.mod.runtime(nprocs=2, block_size=16,
                           policy=_policy(P, passes=(name,)), **P.kw):
            a = P.mod.ones((32,))
            a += 1.0
            np.asarray(a)
    report = ei.value.report
    err = next(d for d in report.errors if d.rule == "plan")
    assert "live base" in err.message and err.pass_name == "evil-drop"
    return report


def _unrestricted_dse(P, mutant):
    """Dead-store elimination keyed on the runtime-wide dead set drops a
    producer whose consumer stays in the flush remainder; the real
    pipeline on the same program verifies clean and stays correct."""
    host = np.arange(32.0)

    def scenario(policy, holder):
        with P.mod.runtime(nprocs=2, block_size=16, policy=policy, **P.kw) as rt:
            holder.append(rt)
            a = P.mod.array(host.copy())
            np.asarray(a)  # drain creation: the cone below is P+W only
            x = a * 2.0  # producer, reads a
            y = x + 1.0  # consumer: stays in the remainder
            a[0:16] = 7.0  # the write to a pulls the producer in
            del x  # x's base is dead runtime-wide, but y still reads it
            sub = np.asarray(a[0:16])
            return sub, np.asarray(y)

    holder = []
    sub, y = scenario(_policy(P, passes=("coalesce", "fuse", "batch")), holder)
    np.testing.assert_array_equal(sub, np.full(16, 7.0))
    np.testing.assert_array_equal(y, host * 2.0 + 1.0)
    assert holder[0].verify_stats.n_diagnostics == 0
    holder2 = []

    def unrestricted(ctx):
        rt = holder2[0]
        drop = [i for i, op in enumerate(ctx.ops)
                if getattr(op.payload, "out_base", None) in rt._dead_bases]
        if drop:
            for i in drop:
                ctx.note_drop(ctx.ops[i])
            ctx.ops = [op for i, op in enumerate(ctx.ops) if i not in set(drop)]
            ctx.dirty = True

    name = mutant(P, "evil-unrestricted-dse", unrestricted)
    with pytest.raises(P.VerificationError) as ei:
        scenario(_policy(P, passes=(name,)), holder2)
    report = ei.value.report
    err = next(d for d in report.errors if d.rule == "plan")
    assert "live base" in err.message and err.pass_name == name
    return report


def _merge_hoisting(P, mutant):
    """Merging two reads across an intervening write hoists the later
    read above the write."""
    k = (7, (0,))
    A = _mk(P, k, None, False, "readA")
    B = _mk(P, k, None, True, "writeB")
    C = _mk(P, k, None, False, "readC")
    M = P.OperationNode(P.COMPUTE, None, procs=(0,), label="mergedAC")
    M.add_access(P.AccessNode(k, None, write=False))
    rep = P.check(pre=[A, B, C], post=[M, B],
                  provenance={M.uid: ("evil-merge", (A.uid, C.uid))}, rules=("plan",))
    err = next(d for d in rep.errors if d.rule == "plan")
    assert "inverted" in err.message and set(err.ops) == {B.uid, C.uid}
    return rep


@pytest.mark.parametrize("scenario", [_inversion, _dropped_live_store,
                                      _unrestricted_dse, _merge_hoisting],
                         ids=["inversion", "dropped-live-store", "unrestricted-dse",
                              "merge-hoisting"])
def test_mutant_caught_by_both_packages_alike(scenario, mutant):
    ref, port = _packages()
    want = _findings(scenario(ref, mutant))
    got = _findings(scenario(port, mutant))
    assert got and got == want


def test_legit_merge_shares_position_no_false_positive():
    k = (7, (0,))
    port = _packages()[1]
    A = _mk(port, k, None, True, "w1")
    B = _mk(port, k, None, True, "w2")
    M = _mk(port, k, None, True, "merged")
    rep = check(pre=[A, B], post=[M],
                provenance={M.uid: ("coalesce", (A.uid, B.uid))}, rules=("plan",))
    assert rep.ok


def test_check_identity_plan_is_clean():
    port = _packages()[1]
    ops = [_mk(port, (1, (0,)), ((0, 8),), True, "w"),
           _mk(port, (1, (0,)), ((0, 8),), False, "r")]
    rep = check(pre=ops, post=ops, rules=("plan", "deadlock"))
    assert rep.ok and not rep.diagnostics


# ---------------------------------------------------------------------------
# the race rule (the cones_conflict soundness oracle)
# ---------------------------------------------------------------------------


class _FakeFut:
    """An in-flight drain future: never done, resolves to None when
    joined (so _join_conflicting does not block)."""

    def done(self):
        return False

    def result(self, timeout=None):
        return None

    def add_done_callback(self, fn):
        pass


def test_race_rule_flags_broken_cones_conflict(monkeypatch):
    port = _packages()[1]
    c1 = [_mk(port, (1, (0,)), ((0, 16),), True, "w0")]
    c2 = [_mk(port, (1, (0,)), ((8, 24),), False, "r0")]
    rep = check(cones=[("A", c1), ("B", c2)], rules=("races",))
    assert rep.ok and rep.n_key_conflicts == 1  # sound oracle: no error

    from repro_torch.core import graph as G

    monkeypatch.setattr(G, "cones_conflict", lambda a, b: False)
    rep = check(cones=[("A", c1), ("B", c2)], rules=("races",))
    err = next(d for d in rep.errors if d.rule == "races")
    assert "race" in err.message and err.key == (1, (0,))


def test_race_rule_precision_report_as_the_reference():
    ref, port = _packages()
    reps = []
    for P in (ref, port):
        c1 = [_mk(P, (1, (0,)), ((0, 8),), True, "w")]
        c2 = [_mk(P, (1, (0,)), ((8, 16),), False, "r")]
        reps.append(P.check(cones=[c1, c2], rules=("races",)))
    for rep in reps:
        assert rep.ok and rep.n_key_conflicts == 1 and rep.n_region_false_positives == 1
    assert ([(d.rule, d.severity) for d in reps[0].diagnostics]
            == [(d.rule, d.severity) for d in reps[1].diagnostics])


def test_engine_race_oracle_catches_broken_cones_conflict(monkeypatch):
    """verify="full" end to end: a fabricated in-flight drain whose
    region footprint overlaps the new cone, with an always-False
    cones_conflict, aborts the flush before anything is extracted."""
    from repro_torch.core import graph as G

    with repro_torch.runtime(nprocs=2, block_size=8, policy=ExecutionPolicy(**FULL),
                             device="cpu") as rt:
        a = repro_torch.array(np.ones(16))
        np.asarray(a)  # drain creation ops
        a += 1.0
        key = (a._base.id, (0,))
        fake = FlushTicket(rt, fut=_FakeFut(), tag=999, keys=(set(), {key}),
                           regions={key: ([], [None])})
        rt._tickets.append(fake)
        try:
            monkeypatch.setattr(G, "cones_conflict", lambda x, y: False)
            n_pending = rt.deps.n_pending
            with pytest.raises(VerificationError) as ei:
                np.asarray(a)
            assert rt.deps.n_pending == n_pending  # nothing extracted
            assert rt.verify_stats.n_race_checks >= 1
            err = next(iter(ei.value.report.errors))
            assert err.rule == "races" and err.key == key
        finally:
            rt._tickets.remove(fake)
        np.testing.assert_array_equal(np.asarray(a), np.full(16, 2.0))  # still usable


def test_engine_precision_counters():
    """A key-level conflict with disjoint regions serialises the drains
    and counts as a region-level false positive, not an error."""
    with repro_torch.runtime(nprocs=2, block_size=8, policy=ExecutionPolicy(**FULL),
                             device="cpu") as rt:
        a = repro_torch.array(np.ones(16))
        np.asarray(a)
        a[0:4] += 1.0  # sub-region write in block 0
        key = (a._base.id, (0,))
        fake = FlushTicket(rt, fut=_FakeFut(), tag=998, keys=(set(), {key}),
                           regions={key: ([], [((4, 8),)])})
        rt._tickets.append(fake)
        np.asarray(a)  # joins the fake (key conflict), counts the fp
        vs = rt.verify_stats
        assert vs.n_key_conflicts >= 1 and vs.n_region_false_positives >= 1
        assert vs.precision is not None and vs.precision < 1.0
        assert vs.n_diagnostics == 0


def test_region_footprint_geometry():
    port = _packages()[1]
    ops = [_mk(port, (1, (0,)), ((0, 8),), True, "w"),
           _mk(port, (1, (0,)), ((4, 12),), False, "r"),
           _mk(port, (2, (0,)), None, True, "whole")]
    fp = cone_region_footprint(ops)
    assert fp[(1, (0,))] == ([((4, 12),)], [((0, 8),)])
    assert fp[(2, (0,))] == ([], [None])
    other = cone_region_footprint([_mk(port, (1, (0,)), ((12, 16),), True, "w2")])
    assert region_footprints_conflict(fp, other) is None  # disjoint regions
    other2 = cone_region_footprint([_mk(port, (1, (0,)), ((6, 16),), True, "w3")])
    assert region_footprints_conflict(fp, other2) == (1, (0,))


# ---------------------------------------------------------------------------
# the deadlock rule: fig. 6 statically, dangling scratch
# ---------------------------------------------------------------------------

FIG6 = [[{"kind": "recv", "tag": "x", "peer": 1}, {"kind": "send", "tag": "y", "peer": 1}],
        [{"kind": "recv", "tag": "y", "peer": 0}, {"kind": "send", "tag": "x", "peer": 0}]]
WELL_ORDERED = [[{"kind": "send", "tag": "y", "peer": 1}, {"kind": "compute"},
                 {"kind": "recv", "tag": "x", "peer": 1}],
                [{"kind": "recv", "tag": "y", "peer": 0},
                 {"kind": "send", "tag": "x", "peer": 0}]]
UNMATCHED = [[{"kind": "send", "tag": "z", "peer": 1}], [{"kind": "compute"}]]


@pytest.mark.parametrize("schedule", [FIG6, UNMATCHED], ids=["fig6", "unmatched"])
def test_schedule_rejected_as_the_reference(schedule):
    """The same stuck operation-nodes, in the same messages, from both."""
    got = check(schedule=schedule, rules=("deadlock",))
    want = repro.analysis.check(schedule=schedule, rules=("deadlock",))
    assert not got.ok
    assert ([(d.rule, d.severity, d.message) for d in got.errors]
            == [(d.rule, d.severity, d.message) for d in want.errors])
    if schedule is FIG6:
        err = got.errors[0]
        assert "cycle" in err.message and "stuck operation-nodes" in err.message
        assert "p0@step0" in err.message and "p1@step0" in err.message


def test_well_ordered_schedule_is_clean():
    assert check(schedule=WELL_ORDERED, rules=("deadlock",)).ok


def test_rendezvous_runner_rejects_fig6_before_any_thread():
    """run_rendezvous_bsp_async refuses statically, starting no thread;
    the dynamic detector still exists behind static_check=False."""
    from repro_torch.exec.backend import DeadlockError, run_rendezvous_bsp_async

    before = threading.active_count()
    with pytest.raises(DeadlockError, match="statically at plan time"):
        run_rendezvous_bsp_async(FIG6)
    assert threading.active_count() == before
    with pytest.raises(DeadlockError, match="every live rank is parked"):
        run_rendezvous_bsp_async(FIG6, static_check=False)
    assert run_rendezvous_bsp_async(WELL_ORDERED) == 5


def test_dangling_scratch_read_flagged_as_the_reference():
    ref, port = _packages()
    found = []
    for P in (ref, port):
        reader = _mk(P, ("s", 123), None, False, "scratch-reader")
        writer = _mk(P, ("s", 123), None, True, "scratch-writer")
        rep = P.check(post=[reader], rules=("deadlock",))
        err = next(d for d in rep.errors if d.rule == "deadlock")
        assert "stall" in err.message
        assert P.check(post=[reader], scratch_available=[123], rules=("deadlock",)).ok
        assert P.check(post=[writer, reader], rules=("deadlock",)).ok
        blamed = P.check(pre=[writer, reader], post=[reader],
                         dropped={writer.uid: "evil"}, rules=("deadlock",))
        found.append((_findings(rep), _findings(blamed)))
    assert found[0] == found[1]
    assert found[1][1] == [("deadlock", "error", "evil")]


def test_report_and_error_formatting():
    d = Diagnostic("plan", "error", "boom", ops=(1, 2), key=(1, (0,)), pass_name="fuse")
    assert "plan/error" in str(d) and "fuse" in str(d)
    with pytest.raises(ValueError):
        Diagnostic("plan", "fatal", "bad severity")
    rep = AnalysisReport(diagnostics=[d])
    assert not rep.ok and rep.errors == [d]
    with pytest.raises(VerificationError) as ei:
        rep.raise_if_errors()
    assert ei.value.report is rep
    assert "static verification failed with 1 error" in str(ei.value)


# ---------------------------------------------------------------------------
# the plan-property strategy of tests/test_plan_properties.py on the port
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402
from test_plan_properties import N_ARRAYS, SHAPE, _step  # noqa: E402

# at least one recorded step: a program of self-iadds records nothing
# (the reference's interpreter skips them), which is the known fault of
# test_plan_cache_hits_bit_identical_to_cold_plans (ROADMAP queue 3)
recorded_programs = st.lists(_step, min_size=1, max_size=10).filter(
    lambda prog: any(step[0] != "iadd" for step in prog))


def _interpret(prog, xp, array, maximum):
    """tests/test_plan_properties.py's program interpreter over an array
    namespace: the runtime's (``array`` = its constructor) or NumPy's.
    Returns every array and output, in creation order."""
    arrs = [array(np.arange(48.0).reshape(SHAPE) * (i + 1) - 20.0)
            for i in range(N_ARRAYS)]
    outs = []
    for step in prog:
        kind = step[0]
        if kind == "fill":
            _, d, r0, c0, v = step
            arrs[d % len(arrs)][r0 % SHAPE[0]:, c0 % SHAPE[1]:] = float(v)
        elif kind == "binop":
            _, a, b, opname = step
            x, y = arrs[a % len(arrs)], arrs[b % len(arrs)]
            arrs.append(maximum(x, y) if opname == "max"
                        else x + y if opname == "add" else x * y)
        elif kind == "setslice":
            _, d, s, r0 = step
            lo = r0 % SHAPE[0]
            arrs[d % len(arrs)][lo:, :] = arrs[s % len(arrs)][lo:, :]
        elif kind == "iadd":
            _, d, s = step
            if d % len(arrs) != s % len(arrs):
                arrs[d % len(arrs)] += arrs[s % len(arrs)]
        elif kind == "sumexpr":
            _, a, b, ax = step
            outs.append((arrs[a % len(arrs)] * arrs[b % len(arrs)]).sum(axis=ax))
        elif kind == "reduce":
            _, a, ax = step
            outs.append(arrs[a % len(arrs)].sum(axis=ax))
    return arrs, outs


@settings(max_examples=20, deadline=None)
@given(prog=recorded_programs)
def test_plan_property_programs_verify_clean_on_the_port(prog):
    """Random programs under verify="plan", with each built-in pipeline,
    on the simulator with barrier readbacks and on the async executor
    with demand-driven cones: no diagnostic, at least one verified
    flush, and every array bit-identical to host NumPy (elementwise ops
    only); every reduction at rtol 1e-12 (the runtime sums by block)."""
    from repro_torch.core import darray as dnp

    want_arrs, want_outs = _interpret(prog, np, lambda h: h.copy(), np.maximum)
    for pipeline in (("coalesce",), ("coalesce", "fuse")):
        for flush, sync in (("sim", "barrier"), ("async", "demand")):
            with repro_torch.runtime(nprocs=4, block_size=3, passes=pipeline, flush=flush,
                                     sync=sync, verify="plan", device="cpu") as rt:
                arrs, outs = _interpret(prog, dnp, dnp.array, dnp.maximum)
                got_arrs = [np.asarray(a).copy() for a in arrs]
                got_outs = [np.asarray(o).copy() for o in outs]
                vs = rt.verify_stats
            assert vs.n_diagnostics == 0 and vs.n_flushes_verified >= 1, (pipeline, sync, vs)
            for got, want in zip(got_arrs, want_arrs):
                np.testing.assert_array_equal(got, want, err_msg=f"{pipeline} {sync}")
            for got, want in zip(got_outs, want_outs):
                np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9,
                                           err_msg=f"{pipeline} {sync}")


def test_graph_lint_entry_point_runs_clean(tmp_path):
    """python -m repro_torch.analysis, in-process, on the CPU: the
    stencil, the overlap probe and the other apps verify clean."""
    import json

    from repro_torch.analysis.__main__ import main

    out = tmp_path / "lint.json"
    assert main(["--device", "cpu", "--n", "128", "--iters", "2", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu"
    assert len(doc["results"]) == 9 and all(r["ok"] for r in doc["results"])
    assert all(r["n_flushes_verified"] >= 1 for r in doc["results"])
