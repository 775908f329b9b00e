"""The port's comparison policies, energy accounting and seed-loop oracle
against the JAX package's.

``repro_torch.core.{slo_mael, baselines, energy, simulator_legacy}`` are
copies of their ``repro.core`` counterparts.  Each package builds its own
characterization and jobs from the same seeds; the tolerance is exact: every
``JobResult`` field but the host wall-clock ``decision_s``, every
``summarize`` figure but those that add it, every joule."""

import math
import types

import pytest

import repro.core.baselines as jx_baselines
import repro.core.energy as jx_energy
import repro.core.job as jx_job
import repro.core.metrics as jx_metrics
import repro.core.pallas_scoring as jx_scoring
import repro.core.scheduler as jx_scheduler
import repro.core.simulator as jx_simulator
import repro.core.simulator_legacy as jx_legacy
import repro.core.slo_mael as jx_slo_mael
import repro.core.workers as jx_workers
import repro.core.workload as jx_workload
from repro_torch.core import (baselines, energy, job, metrics, scheduler,
                              scoring, simulator, simulator_legacy, slo_mael,
                              workers, workload)
from repro_torch.core.offline import characterize
from test_torch_host import canon
from test_torch_recharacterize import one_torch_thread  # noqa: F401

PORT = types.SimpleNamespace(
    bl=baselines, slo=slo_mael, job=job, met=metrics, sched=scheduler,
    sim=simulator, legacy=simulator_legacy, wk=workers, wl=workload,
    en=energy,
    resident=lambda: scoring.make_torch_score_fn(device_cache=True,
                                                 device="cpu"))
JAX = types.SimpleNamespace(
    bl=jx_baselines, slo=jx_slo_mael, job=jx_job, met=jx_metrics,
    sched=jx_scheduler, sim=jx_simulator, legacy=jx_legacy, wk=jx_workers,
    wl=jx_workload, en=jx_energy,
    resident=lambda: jx_scoring.make_pallas_score_fn(device_cache=True))
HOST = {"RR": lambda pk: pk.bl.RoundRobin(),
        "SRR": lambda pk: pk.bl.StrictRoundRobin(),
        "LRU": lambda pk: pk.bl.LeastRecentlyUsed(),
        "MRU": lambda pk: pk.bl.MostRecentlyUsed(),
        "BE": lambda pk: pk.bl.BestEffort(),
        "SLO-MAEL": lambda pk: pk.slo.SloMael()}
EXPERIMENTS = {"DL-FL": ("DL", "FL"), "DL-FH": ("DL", "FH"),
               "DH-FH": ("DH", "FH")}


@pytest.fixture(scope="module")
def torch_cd():
    return characterize()


def _cds(configdict, torch_cd):
    return {"port": (PORT, torch_cd), "jax": (JAX, configdict)}


def plain(summary):
    """``summarize``'s figures with NaN made comparable, but the
    ``overhead_*`` ones: they add the host wall-clock ``decision_s``."""
    return {k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
            for k, v in summary.items() if not k.startswith("overhead_")}


# ----------------------------------------------------------------------------
# SLO-MAEL and the five baselines

@pytest.mark.parametrize("experiment", list(EXPERIMENTS) + ["mmpp-streaming"])
@pytest.mark.parametrize("policy", list(HOST))
def test_host_policy_matches_reference(configdict, torch_cd, policy,
                                       experiment):
    out = {}
    for name, (pk, cd) in _cds(configdict, torch_cd).items():
        runs = []
        if experiment == "mmpp-streaming":
            fleet = pk.wk.synth_fleet(2, 3, 3)
            jobs = pk.wl.scenario(cd, "mmpp", n_jobs=300, fleet=fleet,
                                  seed=4, utilization=1.0, serving="batched",
                                  streaming=(2.0, 2.5))
            runs.append(pk.sim.Simulator(cd, HOST[policy](pk), fleet=fleet,
                                         seed=4, serving="batched")
                        .run(jobs))
        else:
            for seed in (1, 2):
                jobs = pk.job.make_experiment(cd, *EXPERIMENTS[experiment],
                                              seed=seed)
                runs.append(pk.sim.Simulator(cd, HOST[policy](pk),
                                             seed=seed).run(jobs))
        out[name] = [(canon(r), plain(pk.met.summarize(r))) for r in runs]
    assert out["port"] == out["jax"]
    assert all(len(r) for r, _ in out["port"])
    if experiment == "mmpp-streaming":
        assert any(r["ttft"] != "nan" for r in out["port"][0][0])


@pytest.mark.parametrize("policy", list(HOST) + ["SynergAI"])
def test_default_and_optimal_configurations(configdict, torch_cd, policy):
    """The baselines and SLO-MAEL run each device's default configuration,
    SynergAI its optimal one (``tests/test_scheduler.py:190``), in the port
    as in the reference."""
    out = {}
    for name, (pk, cd) in _cds(configdict, torch_cd).items():
        jobs = pk.job.make_experiment(cd, "DL", "FL", seed=1)
        pol = (pk.sched.SynergAI() if policy == "SynergAI"
               else HOST[policy](pk))
        res = pk.sim.Simulator(cd, pol, seed=1).run(jobs)
        for r in res:
            ent = (cd.optimal(r.job.engine, r.worker) if not
                   pol.use_default_config else
                   cd.default_entry(r.job.engine, r.worker))
            assert r.config == f"{ent.mode}/r{ent.chips_per_replica}"
        out[name] = (pol.use_default_config, canon(res))
    assert out["port"] == out["jax"]
    assert out["port"][0] == (policy != "SynergAI")


# ----------------------------------------------------------------------------
# LegacySimulator, the seed loop the event-heap engine is held to

@pytest.mark.parametrize("experiment", ["DL-FL", "DH-FH"])
@pytest.mark.parametrize("policy", ["RR", "SLO-MAEL", "SynergAI"])
def test_legacy_simulator_matches_engine_and_reference(configdict, torch_cd,
                                                       policy, experiment):
    out = {}
    for name, (pk, cd) in _cds(configdict, torch_cd).items():
        jobs = pk.job.make_experiment(cd, *EXPERIMENTS[experiment], seed=3)

        def make():
            return (pk.sched.SynergAI() if policy == "SynergAI"
                    else HOST[policy](pk))

        out[name] = canon(pk.legacy.LegacySimulator(cd, make(), seed=3)
                          .run(jobs))
        if name == "port":
            assert canon(pk.sim.Simulator(cd, make(), seed=3)
                         .run(jobs)) == out[name]
    assert out["port"] == out["jax"] and len(out["port"]) == 24


def test_legacy_simulator_with_failures_on_a_synth_fleet(configdict,
                                                         torch_cd):
    out = {}
    for name, (pk, cd) in _cds(configdict, torch_cd).items():
        fleet = pk.wk.synth_fleet(2, 3, 3)
        jobs = pk.wl.scenario(cd, "mmpp", n_jobs=300, fleet=fleet, seed=5)
        fails = pk.wl.synth_failures(fleet, jobs[-1].arrival, mtbf_s=600.0,
                                     mttr_s=60.0, seed=5)
        out[name] = [canon(pk.legacy.LegacySimulator(
            cd, P(), fleet=fleet, failures=fails, seed=5).run(jobs))
            for P in (pk.sched.SynergAI, pk.bl.RoundRobin)]
        if name == "port":
            new = [canon(pk.sim.Simulator(cd, P(), fleet=fleet,
                                          failures=fails, seed=5).run(jobs))
                   for P in (pk.sched.SynergAI, pk.bl.RoundRobin)]
            assert new == out[name]
    assert out["port"] == out["jax"]


def test_legacy_simulator_refuses_batched_serving(torch_cd):
    with pytest.raises(NotImplementedError, match="serving bridge"):
        simulator_legacy.LegacySimulator(
            torch_cd, scheduler.SynergAI(), serving="batched").run([])


# ----------------------------------------------------------------------------
# energy accounting

def _energy_runs(pk, cd):
    """An energy-blind and an ``energy_weight=0.5`` resident run of one
    batched trace; returns {label: (results, cluster)}."""
    fleet = pk.wk.synth_fleet(1, 2, 2)
    jobs = pk.wl.scenario(cd, "mmpp", n_jobs=160, fleet=fleet, seed=3,
                          utilization=1.2, serving="batched")
    out = {}
    for label, weight in (("blind", 0.0), ("aware", 0.5)):
        sim = pk.sim.Simulator(cd, pk.sched.SynergAI(
            score_fn=pk.resident(), energy_weight=weight), fleet=fleet,
            seed=3, serving="batched")
        out[label] = (sim.run(jobs), sim.cluster)
    return out


def test_energy_accounting_matches_reference(configdict, torch_cd):
    out = {}
    for name, (pk, cd) in _cds(configdict, torch_cd).items():
        runs = _energy_runs(pk, cd)
        res, cluster = runs["aware"]
        out[name] = (
            pk.en.edge_energy(cluster), pk.en.idle_energy(cluster),
            pk.en.normalized_edge_energy({k: c for k, (_, c)
                                          in runs.items()}),
            pk.en.offload_fraction(res, cluster),
            pk.en.offload_fraction(res),
            canon(res))
    assert out["port"] == out["jax"]
    edge, idle, norm, offload = out["port"][:4]
    assert edge and any(v > 0 for v in edge.values())
    assert any(v > 0 for v in idle.values())
    assert set(norm) == {"blind", "aware"}
    assert max(max(v.values()) for v in norm.values()) == 1.0
    assert 0.0 <= offload <= 1.0


def test_energy_normalization_of_disjoint_fleets(configdict, torch_cd):
    """A pool missing from one policy's fleet is omitted from its row, and a
    pool that burned nothing normalizes to 0.0, in both packages."""
    out = {}
    for name, (pk, cd) in _cds(configdict, torch_cd).items():
        clusters = {}
        for label, fleet in (("small", pk.wk.synth_fleet(1, 1, 0)),
                             ("large", pk.wk.synth_fleet(1, 2, 2))):
            jobs = pk.job.make_experiment(cd, "DL", "FL", seed=2)
            sim = pk.sim.Simulator(cd, pk.bl.RoundRobin(), fleet=fleet,
                                   seed=2)
            sim.run(jobs)
            clusters[label] = sim.cluster
        idle = pk.sim.Cluster(cd, pk.wk.synth_fleet(0, 1, 1))
        clusters["idle"] = idle
        out[name] = pk.en.normalized_edge_energy(clusters)
    assert out["port"] == out["jax"]
    assert set(out["port"]["small"]) < set(out["port"]["large"])
