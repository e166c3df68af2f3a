"""The port's plan-vs-actual report (``repro_torch.obs.report``) against
the JAX package's: the interval algebra, and on the JAX tests' simulated
timelines (a Temporal switch, a Pipelined straggler, a 2x slow measured
run) the same report, drift feedback, text and JSON from both."""
import json

import pytest

import repro.core.profiler as jprof
import repro.core.scheduler as jsched
import repro.core.simulator as jsim
import repro.obs.report as jrep
import repro.obs.trace as jtrace
import repro_torch.core.profiler as tprof
import repro_torch.core.scheduler as tsched
import repro_torch.core.simulator as tsim
import repro_torch.obs.report as trep
import repro_torch.obs.trace as ttrace

PKGS = {"jax": (jprof, jsched, jsim, jrep, jtrace),
        "port": (tprof, tsched, tsim, trep, ttrace)}


class _FakePlan:
    def __init__(self, schedule, placement):
        self.schedule = schedule
        self.placement = placement
        self.members = {}


def _profiles(prof):
    return {
        "gen": prof.CostModel("gen", base_time=0.5, slope_time=0.02,
                              onload_time=0.2, offload_time=0.1),
        "train": prof.CostModel("train", base_time=0.3, slope_time=0.01),
    }


def _temporal(pkg):
    prof, sched, sim, rep, _ = PKGS[pkg]
    profiles = _profiles(prof)
    s = sched.Temporal(sched.Leaf("gen", 4, 64), sched.Leaf("train", 4, 64),
                       switch_cost=0.3)
    placement = {"gen": [0, 1, 2, 3], "train": [0, 1, 2, 3]}
    result = sim.Simulator(profiles).run(s, 64)
    tracer = rep.replay_sim(result, placement=placement)
    return rep.plan_vs_actual(_FakePlan(s, placement), profiles, tracer, 64)


def _pipelined(pkg):
    prof, sched, sim, rep, _ = PKGS[pkg]
    profiles = _profiles(prof)
    s = sched.Pipelined(sched.Leaf("gen", 2, 16), sched.Leaf("train", 2, 16),
                        granularity=16, n_s=2, n_t=2)
    placement = {"gen": [0, 1], "train": [2, 3]}
    result = sim.Simulator(profiles).run(s, 64)
    tracer = rep.replay_sim(result, placement=placement)
    return rep.plan_vs_actual(_FakePlan(s, placement), profiles, tracer, 64)


def _slow(pkg):
    """A measured timeline 2x slower than the prediction; returns the
    report, the drift applied and the re-simulated makespan ratio."""
    prof, sched, sim, rep, trace = PKGS[pkg]
    profiles = _profiles(prof)
    s = sched.Leaf("gen", 4, 64)
    placement = {"gen": [0, 1, 2, 3]}
    result = sim.Simulator(profiles).run(s, 64)
    tracer = trace.Tracer(clock=lambda: 0.0)
    tracer.epoch = 0.0
    for sp in result.spans:
        tracer.add(sp.worker, "task", sp.start,
                   sp.start + 2 * (sp.end - sp.start), lane=sp.worker,
                   worker=sp.worker, devices=placement[sp.worker])
    tracer.add("iteration", "iteration", 0.0, 2 * result.makespan,
               lane="run")
    report = rep.plan_vs_actual(_FakePlan(s, placement), profiles, tracer, 64)
    applied = rep.apply_drift(profiles, report, blend=1.0)
    again = sim.Simulator(profiles).run(s, 64)
    return report, applied, again.makespan / result.makespan, profiles


def _same_report(a, b):
    assert a.to_json() == b.to_json()
    assert a.format() == b.format()
    assert a.gap_totals() == b.gap_totals()
    assert a.bubble_fraction() == b.bubble_fraction()


def test_interval_algebra_matches_jax():
    cases = [[(0, 1), (0.5, 2), (3, 4)], [(0, 2), (3, 4)], [(1, 3.5)],
             [(0, 4)], [(1, 2), (3, 5)]]
    for a in cases:
        assert trep.merge_intervals(a) == jrep.merge_intervals(a)
        for b in cases:
            assert trep.intersect(a, b) == jrep.intersect(a, b)
            assert trep.subtract(a, b) == jrep.subtract(a, b)
        assert trep.complement(a, 0, 6) == jrep.complement(a, 0, 6)
    assert trep.subtract([(0, 4)], [(1, 2), (3, 5)]) == [(0, 1), (2, 3)]


def test_plan_vs_actual_matches_jax_on_replayed_sim():
    got, want = _temporal("port"), _temporal("jax")
    _same_report(got, want)
    # a replayed simulation IS the prediction: ratio lands at 1 exactly
    assert got.wall_ratio == pytest.approx(1.0, abs=1e-9)
    assert all(r.ratio == pytest.approx(1.0, abs=1e-9) for r in got.drift)
    assert got.gap_totals()["switch"] == pytest.approx(0.3 * 4, rel=1e-6)
    assert got.bubble_fraction() > 0


def test_pipelined_straggler_attribution_matches_jax():
    got, want = _pipelined("port"), _pipelined("jax")
    _same_report(got, want)
    train_dev = next(d for d in got.devices if d.device == 2)
    assert train_dev.gaps["straggler"] > 0


def test_drift_feedback_matches_jax():
    got, g_applied, g_ratio, g_prof = _slow("port")
    want, w_applied, w_ratio, w_prof = _slow("jax")
    _same_report(got, want)
    assert g_applied == w_applied
    assert got.wall_ratio == pytest.approx(2.0, rel=1e-6)
    assert g_applied["gen"] == pytest.approx(2.0, rel=1e-6)
    assert g_ratio == pytest.approx(2.0, rel=1e-6) and g_ratio == w_ratio
    assert (g_prof["gen"].base_time, g_prof["gen"].slope_time) == (
        w_prof["gen"].base_time, w_prof["gen"].slope_time)


def test_replay_export_and_json_file_match_jax(tmp_path):
    def build(pkg):
        prof, sched, sim, rep, _ = PKGS[pkg]
        s = sched.Temporal(sched.Leaf("gen", 2, 32),
                           sched.Leaf("train", 2, 32), switch_cost=0.1)
        result = sim.Simulator(_profiles(prof)).run(s, 32)
        tracer = rep.replay_sim(result, placement={"gen": [0], "train": [0]})
        return json.dumps(tracer.to_chrome(), sort_keys=True)

    assert build("port") == build("port") == build("jax")
    trep.report_to_json_file(_temporal("port"), str(tmp_path / "t.json"))
    jrep.report_to_json_file(_temporal("jax"), str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (
        tmp_path / "j.json").read_text()


def test_obs_package_exposes_the_report_lazily():
    import repro_torch.obs as obs

    assert obs.plan_vs_actual is trep.plan_vs_actual
    assert obs.FlowReport is trep.FlowReport
    with pytest.raises(AttributeError):
        obs.not_a_name
