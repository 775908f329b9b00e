"""The port's copy of the host layer against the JAX package's.

The state that crosses between the two packages is the reference's own
serialised form: the Configuration Dictionary through ``to_json`` /
``from_json`` and the job trace through ``save_trace`` / ``load_trace``.
Each package computes its own characterization and scenarios; these tests
hold them equal entry for entry and job for job, and hold the numpy-path
``Simulator`` runs equal result for result.  The tolerance is exact."""

import dataclasses
import math

import pytest

import repro.core.configdict as jx_configdict
import repro.core.scheduler as jx_scheduler
import repro.core.simulator as jx_simulator
import repro.core.workers as jx_workers
import repro.core.workload as jx_workload
from repro_torch.core import offline, scheduler, simulator, workers, workload
from repro_torch.core.configdict import ConfigDict


@pytest.fixture(scope="module")
def torch_cd():
    return offline.characterize()


def canon(results):
    """Every JobResult field but ``decision_s`` (host wall clock), as
    plain data with NaN made comparable."""
    def clean(x):
        if isinstance(x, float) and math.isnan(x):
            return "nan"
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(clean(v) for v in x)
        return x
    out = []
    for r in results:
        d = dataclasses.asdict(r)
        d.pop("decision_s")
        out.append(clean(d))
    return out


def test_characterize_matches_through_json(configdict, torch_cd, tmp_path):
    ref_path = tmp_path / "jax.json"
    port_path = tmp_path / "torch.json"
    configdict.to_json(str(ref_path))
    torch_cd.to_json(str(port_path))
    assert port_path.read_bytes() == ref_path.read_bytes()
    loaded = ConfigDict.from_json(str(ref_path))
    assert loaded.table == torch_cd.table
    assert loaded.best == torch_cd.best
    assert loaded.default == torch_cd.default
    assert len(torch_cd.table) == len(configdict.table) > 0
    # and the other way round: the reference reads the port's file
    back = jx_configdict.ConfigDict.from_json(str(port_path))
    assert [dataclasses.astuple(e) for e in back.table] \
        == [dataclasses.astuple(e) for e in torch_cd.table]


@pytest.mark.parametrize("kind,kw", [
    ("poisson", {}),
    ("mmpp", {}),
    ("diurnal", {}),
    ("flash", {}),
    ("multi-tenant", {}),
    ("drift", {}),
    ("mmpp", {"serving": "batched", "streaming": (2.0, 2.5)}),
    ("poisson", {"serving": "batched", "patience": 3.0}),
])
def test_scenario_matches_through_trace(configdict, torch_cd, tmp_path,
                                        kind, kw):
    ref = jx_workload.scenario(configdict, kind, n_jobs=150,
                               fleet=jx_workers.synth_fleet(2, 3, 3),
                               seed=4, **kw)
    port = workload.scenario(torch_cd, kind, n_jobs=150,
                             fleet=workers.synth_fleet(2, 3, 3), seed=4,
                             **kw)
    path = tmp_path / "trace.jsonl"
    assert jx_workload.save_trace(str(path), ref) == len(port) == 150
    assert workload.load_trace(str(path)) == port
    # the port's trace file is the reference's, byte for byte
    port_path = tmp_path / "port.jsonl"
    workload.save_trace(str(port_path), port)
    assert port_path.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("serving,extra", [
    ("job", {}),
    ("batched", {"streaming": (2.0, 2.5)}),
])
def test_numpy_path_simulator_matches(configdict, torch_cd, serving, extra):
    """The default numpy SynergAI on both packages' simulators, with
    worker failures and disaggregated pools in the batched case."""
    disagg = serving == "batched"
    def run(pkg_workers, pkg_workload, pkg_sim, pkg_sched, cd):
        fleet = pkg_workers.synth_fleet(2, 3, 3, disaggregate=disagg)
        jobs = pkg_workload.scenario(cd, "mmpp", n_jobs=160, fleet=fleet,
                                     seed=7, utilization=0.95,
                                     serving=serving, **extra)
        span = jobs[-1].arrival
        fails = pkg_workload.synth_failures(fleet, span, mtbf_s=span,
                                            mttr_s=60.0, seed=7)
        sim = pkg_sim.Simulator(cd, pkg_sched.SynergAI(), fleet=fleet,
                                failures=fails, seed=7, serving=serving)
        return canon(sim.run(jobs)), len(fails)

    ref, n_ref = run(jx_workers, jx_workload, jx_simulator, jx_scheduler,
                     configdict)
    port, n_port = run(workers, workload, simulator, scheduler, torch_cd)
    assert n_ref == n_port > 0
    assert port == ref
    assert len(port) == 160


def test_paper_experiment_matches(configdict, torch_cd):
    from repro.core.job import make_experiment as jx_make_experiment
    from repro_torch.core.job import make_experiment
    ref = jx_simulator.Simulator(configdict, jx_scheduler.SynergAI(),
                                 seed=11).run(
        jx_make_experiment(configdict, "DH", "FH", seed=11))
    port = simulator.Simulator(torch_cd, scheduler.SynergAI(),
                               seed=11).run(
        make_experiment(torch_cd, "DH", "FH", seed=11))
    assert canon(port) == canon(ref)
