"""Port planner, profiler and flat serving engine vs `repro`, plus CPU serves.

The planner, the analytic profiler and the engine are copies of pure-Python
layers, so they must agree with the originals bit for bit on the same rows.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import Planner as JPlanner, dag as jdag  # noqa: E402
from repro.profiling import analytic as janalytic  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.workloads import synth_profiles  # noqa: E402
from repro.workloads.apps import CAPTION, FACE, TRAFFIC, make_workload  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import Config, ModuleProfile, Planner, Workload, dag  # noqa: E402
from repro_torch.kernels import KERNELS, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.profiling import H100_SXM, analytic  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

JPROFILES = synth_profiles()
PROFILES = {
    m: ModuleProfile(p.name, tuple(Config(c.batch, c.duration, c.hardware, c.unit_price) for c in p.configs))
    for m, p in JPROFILES.items()
}


def port_sp(sp):
    """A `repro.core.dag` series-parallel tree rebuilt from the port's classes."""
    if isinstance(sp, jdag.Leaf):
        return dag.Leaf(sp.name)
    cls = dag.Series if isinstance(sp, jdag.Series) else dag.Par
    return cls(tuple(port_sp(p) for p in sp.parts))


def port_workload(jwl):
    return Workload(dag.AppDAG(jwl.app.name, port_sp(jwl.app.sp)), dict(jwl.rates), jwl.slo, jwl.tag)


def plain_allocs(plan):
    return {
        m: [(a.config.batch, a.config.duration, a.config.hardware, a.machines, a.rate, a.dummy)
            for a in s.allocs]
        for m, s in plan.schedules.items()
    }


WORKLOADS = [
    (FACE, 150.0, 2.5),
    (TRAFFIC, 100.0, 2.0),
    (CAPTION, 90.0, 2.5),
]
SINGLE = [("face_detect", 120.0, 1.0), ("openpose", 60.0, 3.0)]


def single_workload(module, rate, slo):
    jwl = jdag.Workload(jdag.AppDAG(module, jdag.series(jdag.Leaf(module))), {module: rate}, slo)
    return jwl, port_workload(jwl)


@pytest.mark.parametrize("case", [f"{a.name}@{r}" for a, r, _ in WORKLOADS] + [m for m, _, _ in SINGLE])
def test_planner_copy_is_bit_equal(case):
    if "@" in case:
        app, rate, slo = next(w for w in WORKLOADS if f"{w[0].name}@{w[1]}" == case)
        jwl = make_workload(app, rate=rate, slo=slo)
        wl = port_workload(jwl)
    else:
        jwl, wl = single_workload(*next(s for s in SINGLE if s[0] == case))
    jplan = JPlanner().plan(jwl, JPROFILES)
    plan = Planner().plan(wl, PROFILES)
    assert plan.feasible == jplan.feasible
    assert plan.cost == jplan.cost
    assert plain_allocs(plan) == plain_allocs(jplan)


@pytest.mark.parametrize("arrivals", ["uniform", "poisson"])
@pytest.mark.parametrize("timeout", [None, "budget"])
def test_flat_engine_copy_is_bit_equal(arrivals, timeout):
    for app, rate, slo in WORKLOADS:
        jwl = make_workload(app, rate=rate, slo=slo)
        jres = JEngine(JPlanner().plan(jwl, JPROFILES)).run(600, rate, arrivals=arrivals, timeout=timeout, seed=3)
        res = ServingEngine(Planner().plan(port_workload(jwl), PROFILES)).run(
            600, rate, arrivals=arrivals, timeout=timeout, seed=3)
        assert res.e2e_latencies == jres.e2e_latencies
        assert res.dropped == jres.dropped
        assert {m: (s.batches, s.latencies) for m, s in res.module_stats.items()} == {
            m: (s.batches, s.latencies) for m, s in jres.module_stats.items()}


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-1b", "qwen1.5-4b"])
def test_analytic_profiler_copy_matches_on_the_h100_spec(arch):
    """The same GPUSpec object through both copies of module_duration."""
    for b in (1, 8, 32):
        assert analytic.module_duration(ARCHS[arch], b, 128, H100_SXM) == janalytic.module_duration(
            JARCHS[arch], b, 128, H100_SXM)
    prof = analytic.arch_profile(ARCHS[arch])
    assert {c.hardware for c in prof.configs} == {"h100-sxm"}


def test_cpu_serve_with_smoke_executors_answers_every_request():
    reset_launch_counts()
    profile, executor = serve.profile_model("smollm-360m", batches=(1, 2, 4), seq=8, smoke=True,
                                            device="cpu", reps=1)
    assert sorted(c.batch for c in profile.configs) == [1, 2, 4] and {c.hardware for c in profile.configs} == {"cpu"}
    big = max(profile.configs, key=lambda c: c.batch)
    rate = 0.5 * big.batch / big.duration
    wl = Workload(dag.AppDAG("m", dag.series(dag.Leaf("smollm-360m"))), {"smollm-360m": rate},
                  4.0 * (big.batch / rate + big.duration))
    plan = Planner().plan(wl, {"smollm-360m": profile})
    assert plan.feasible
    res = ServingEngine(plan, executors={"smollm-360m": executor}).run(12, rate)
    assert len(res.e2e_latencies) == 12 and res.dropped == 0
    assert res.module_stats["smollm-360m"].batches >= 3
    assert all(k.launches == 0 for k in KERNELS)  # CPU tensors take the plain versions


def test_serve_main_runs_on_cpu(capsys):
    serve.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--real",
                "--requests", "8", "--seq", "8", "--rate", "50", "--slo", "1.0"])
    out = capsys.readouterr().out
    assert "served 8 requests" in out and "feasible=True" in out


def test_serve_main_defaults_to_cuda():
    assert serve.build_parser().parse_args(["--arch", "smollm-360m"]).device == "cuda"
