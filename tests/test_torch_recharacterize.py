"""The port's online re-characterization against the JAX package's.

``repro_torch.core.recharacterize`` is a copy of ``repro.core.
recharacterize``; these tests hold the closed loop run for run against the
live reference, never against a pinned digest.  The drift cell is the
reference's own (``tests/test_recharacterize.py::_drift_setup``) cut to a
few hundred jobs: ``scenario(cd, "drift", ...)`` on ``synth_fleet(2, 5, 5,
regions=3)`` with a third of the edge pools slowed five-fold from a third of
the way in, sized so that the loop refreshes at least once.  Each package
builds its own characterization, jobs, degradations and a fresh
``OnlineRecharacterizer`` (a process-unique profile id) for every run.

Backends: the numpy default, the device-resident path on the CPU plain
versions (``make_torch_score_fn(device_cache=True, device="cpu")``) against
the JAX resident path in interpret mode; the fused v2 backend has a file of
its own, ``test_torch_recharacterize_v2.py``.  The tolerance is
exact: every ``JobResult`` field but the host wall-clock ``decision_s``, the
refresh count, reason and times, the overlay's scales, and the device
caches' counters, ``profile_reclaims`` among them."""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.hierarchy as jx_hierarchy
import repro.core.pallas_scoring as jx_scoring
import repro.core.recharacterize as jx_recharacterize
import repro.core.scheduler as jx_scheduler
import repro.core.simulator as jx_simulator
import repro.core.slo_mael as jx_slo_mael
import repro.core.workers as jx_workers
import repro.core.workload as jx_workload
from repro.core import estimator as jx_estimator
from repro.core.engines import engine_catalogue
from repro_torch.core import (estimator, hierarchy, recharacterize,
                              scheduler, scoring, simulator, slo_mael,
                              workers, workload)
from repro_torch.core.devicecache import DeviceScoreCache
from repro_torch.core.offline import characterize
from test_torch_host import canon

PORT = types.SimpleNamespace(
    sched=scheduler, sim=simulator, wk=workers, wl=workload, hi=hierarchy,
    rc=recharacterize, est=estimator, slo=slo_mael,
    resident=lambda: scoring.make_torch_score_fn(device_cache=True,
                                                 device="cpu"))
JAX = types.SimpleNamespace(
    sched=jx_scheduler, sim=jx_simulator, wk=jx_workers, wl=jx_workload,
    hi=jx_hierarchy, rc=jx_recharacterize, est=jx_estimator, slo=jx_slo_mael,
    resident=lambda: jx_scoring.make_pallas_score_fn(device_cache=True))
_COUNTERS = ("ticks", "rows_uploaded", "bytes_to_device", "fail_masks",
             "flushes", "col_extends", "profile_reclaims")


@pytest.fixture(scope="module")
def torch_cd():
    return characterize()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These runs are thousands of small tensor ops; torch's intra-op
    threads only spin on them and starve the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cds(configdict, torch_cd):
    return {"port": (PORT, torch_cd), "jax": (JAX, configdict)}


def caches(policy):
    subs = getattr(policy, "_subs", None)
    pols = list(subs.values()) if subs is not None else [policy]
    return [p.cache for p in pols if getattr(p, "cache", None) is not None]


def counters(policy):
    return {k: sum(getattr(c, k) for c in caches(policy))
            for k in _COUNTERS}


def drift(pk, cd, n_jobs, serving="job"):
    fleet = pk.wk.synth_fleet(2, 5, 5, regions=3)
    jobs = pk.wl.scenario(cd, "drift", n_jobs=n_jobs, fleet=fleet, seed=0,
                          serving=serving)
    degs = pk.wl.synth_degradations(fleet, jobs[-1].arrival, factor=5.0,
                                    fraction=0.35, prefix="edge", seed=0)
    return fleet, jobs, degs


def loop_state(pk, cd, rc):
    """What a refresh leaves behind: its count, reason and times, and the
    overlay's scales."""
    if rc is None:
        return None
    return (rc.refreshes, rc.last_reason, list(rc.triggered_at),
            pk.est.profile_overlay(cd, rc.profile).scale)


def run_drift(pk, cd, make_policy, n_jobs, rc_kw=None, serving="job",
              oracle=False):
    """One drift run of ``make_policy(pk, rc)`` with a fresh re-characterizer
    (``rc_kw`` None: none).  Returns (policy, canon results, loop state,
    violations)."""
    fleet, jobs, degs = drift(pk, cd, n_jobs, serving)
    rc = None
    if oracle:
        rc = pk.rc.OnlineRecharacterizer(detect=False)
        rc.seed(pk.sim.Cluster(cd, list(fleet)),
                worker_factors={d.worker: d.factor for d in degs})
    elif rc_kw is not None:
        rc = pk.rc.OnlineRecharacterizer(**rc_kw)
    pol = make_policy(pk, rc)
    res = pk.sim.Simulator(cd, pol, fleet=list(fleet), degradations=degs,
                           seed=0, serving=serving).run(list(jobs))
    return pol, canon(res), loop_state(pk, cd, rc), sum(r.violated
                                                         for r in res)


# ----------------------------------------------------------------------------
# the quiet detector: enabled on traffic without drift it never refreshes and
# leaves the schedule bit for bit as it is without one

@pytest.mark.parametrize("kind,serving,policy,backend", [
    ("mmpp", "job", "synergai", "numpy"),
    ("mmpp", "batched", "synergai", "resident"),
    ("flash", "job", "hier", "numpy"),
    ("multi-tenant", "batched", "hier", "resident"),
    ("poisson", "job", "slomael", "numpy"),
    ("diurnal", "batched", "slomael", "numpy"),
])
def test_quiet_detector_is_inert_like_the_reference(configdict, torch_cd,
                                                    kind, serving, policy,
                                                    backend):
    regions = 2 if policy == "hier" else None

    def make(pk, rc, fn):
        if policy == "slomael":
            return pk.slo.SloMael(recharacterizer=rc)
        cls = pk.sched.SynergAI if policy == "synergai" else \
            pk.hi.HierarchicalSynergAI
        return cls(score_fn=fn, recharacterizer=rc)

    out = {}
    for name, (pk, cd) in _cds(configdict, torch_cd).items():
        fleet = pk.wk.synth_fleet(1, 2, 2, regions=regions)
        jobs = pk.wl.scenario(cd, kind, n_jobs=260, fleet=fleet, seed=3,
                              utilization=1.2, serving=serving)
        kw = dict(fleet=fleet, seed=3, serving=serving)
        fn = (PORT.resident() if name == "port" and backend == "resident"
              else None)
        rc = pk.rc.OnlineRecharacterizer()
        withrc = canon(pk.sim.Simulator(cd, make(pk, rc, fn), **kw)
                       .run(jobs))
        assert rc.refreshes == 0, rc.last_reason
        if name == "port":
            base_fn = PORT.resident() if backend == "resident" else None
            base = canon(pk.sim.Simulator(cd, make(pk, None, base_fn), **kw)
                         .run(jobs))
            assert withrc == base
        out[name] = withrc
    assert out["port"] == out["jax"] and len(out["port"]) == 260


def test_detect_false_is_inert(configdict, torch_cd):
    def make(pk, rc):
        return pk.sched.SynergAI(
            recharacterizer=rc or pk.rc.OnlineRecharacterizer(detect=False))

    runs = {name: run_drift(pk, cd, make, 300)
            for name, (pk, cd) in _cds(configdict, torch_cd).items()}
    stale = run_drift(PORT, torch_cd,
                      lambda pk, rc: pk.sched.SynergAI(), 300)
    assert runs["port"][1] == runs["jax"][1] == stale[1]


# ----------------------------------------------------------------------------
# the closed loop on the numpy default, flat, hierarchical and SLO-MAEL

@pytest.mark.parametrize("policy,n_jobs,serving", [
    ("synergai", 400, "job"), ("hier", 400, "job"),
    ("synergai", 400, "batched"), ("slomael", 400, "job")])
def test_numpy_loop_matches_reference(configdict, torch_cd, policy, n_jobs,
                                      serving):
    def make(pk, rc):
        if policy == "slomael":
            return pk.slo.SloMael(recharacterizer=rc)
        cls = pk.sched.SynergAI if policy == "synergai" else \
            pk.hi.HierarchicalSynergAI
        return cls(recharacterizer=rc)

    runs = {name: run_drift(pk, cd, make, n_jobs, {}, serving)
            for name, (pk, cd) in _cds(configdict, torch_cd).items()}
    port, jax = runs["port"], runs["jax"]
    assert port[1] == jax[1] and len(port[1]) == n_jobs
    assert port[2] == jax[2]
    assert port[2][0] >= 1               # the loop refreshed
    assert port[2][3]                    # and installed scales


def test_online_beats_stale_and_oracle_matches_reference(configdict,
                                                         torch_cd):
    """The loop's whole purpose, in the port as in the reference: online
    below stale, and the oracle's t = 0 install equal in both packages."""
    def make(pk, rc):
        return pk.sched.SynergAI(recharacterizer=rc)

    viol = {}
    for name, (pk, cd) in _cds(configdict, torch_cd).items():
        stale = run_drift(pk, cd, make, 400)
        online = run_drift(pk, cd, make, 400, {})
        oracle = run_drift(pk, cd, make, 400, oracle=True)
        viol[name] = (stale[3], online[3], oracle[3], online[2][0],
                      oracle[1], oracle[2])
    assert viol["port"] == viol["jax"]
    stale, online, oracle = viol["port"][:3]
    assert online < stale and oracle <= online


# ----------------------------------------------------------------------------
# the closed loop through the device-resident tick

@pytest.mark.parametrize("policy,oracle", [("synergai", False),
                                           ("hier", False),
                                           ("synergai", True)])
def test_resident_loop_matches_jax_resident_and_numpy(configdict, torch_cd,
                                                      policy, oracle):
    """The refresh path of the resident cache: ``profile_gen`` moves, the
    refreshed engines' rows are reclaimed (``_reclaim_profile``) and
    re-uploaded.  The port's counters are held to the JAX
    ``DeviceScoreCache``'s, never to the host ``ScoreCache``'s (they count
    ``profile_reclaims`` differently when a refresh and a failure share a
    tick)."""
    def make(fn):
        def build(pk, rc):
            cls = pk.sched.SynergAI if policy == "synergai" else \
                pk.hi.HierarchicalSynergAI
            return cls(score_fn=fn, recharacterizer=rc)
        return build

    port = run_drift(PORT, torch_cd, make(PORT.resident()), 300, {},
                     oracle=oracle)
    jax = run_drift(JAX, configdict, make(JAX.resident()), 300, {},
                    oracle=oracle)
    numpy_run = run_drift(PORT, torch_cd, make(None), 300, {},
                          oracle=oracle)
    assert all(isinstance(c, DeviceScoreCache) for c in caches(port[0]))
    assert port[1] == jax[1] == numpy_run[1] and len(port[1]) == 300
    assert port[2] == jax[2] == numpy_run[2]
    assert counters(port[0]) == counters(jax[0])
    c = counters(port[0])
    assert port[2][0] >= 1 and c["ticks"] > 0
    if not oracle:
        assert c["profile_reclaims"] > 0 and c["rows_uploaded"] > 0


def test_resident_loop_refills_freed_slots_with_energy_rows(configdict,
                                                            torch_cd):
    """Rows a refresh reclaimed are refilled by later arrivals, and the new
    scales reach the energy pool too (``energy_weight > 0``)."""
    def make(fn):
        return lambda pk, rc: pk.sched.SynergAI(score_fn=fn,
                                                recharacterizer=rc,
                                                energy_weight=0.5)

    port = run_drift(PORT, torch_cd, make(PORT.resident()), 300, {},
                     serving="batched")
    jax = run_drift(JAX, configdict, make(JAX.resident()), 300, {},
                    serving="batched")
    assert port[1] == jax[1] and port[2] == jax[2]
    assert counters(port[0]) == counters(jax[0])
    assert port[2][0] >= 1 and counters(port[0])["profile_reclaims"] > 0


# ----------------------------------------------------------------------------
# the oracle and the detector's windows

def test_seed_oracle_installs_the_reference_scales(configdict, torch_cd):
    ovs = {}
    for name, (pk, cd) in _cds(configdict, torch_cd).items():
        fleet = pk.wk.synth_fleet(2, 5, 5, regions=3)
        rc = pk.rc.OnlineRecharacterizer(detect=False)
        rc.seed(pk.sim.Cluster(cd, fleet),
                worker_factors={fleet[0].name: 4.0, fleet[5].name: 2.5},
                engine_factors={"gemma-2b/bf16": 2.0})
        ov = pk.est.profile_overlay(cd, rc.profile)
        ovs[name] = (rc.refreshes, rc.last_reason, rc.triggered_at,
                     ov.gen, ov.scale, dict(ov.touched))
    assert ovs["port"] == ovs["jax"]
    assert ovs["port"][:2] == (1, "seed")
    assert ovs["port"][4]["gemma-2b/bf16"]


def _window_streams(seed):
    rng = np.random.default_rng(seed)
    engines = sorted(engine_catalogue())
    # a steady mix, then a mix confined to other engines
    mix = ([engines[i] for i in rng.integers(0, 3, 200)]
           + [engines[i] for i in rng.integers(3, len(engines), 200)])
    # stationary noise over six workers, then one worker 3x slower
    names = [f"w{i}" for i in range(6)]
    resid = []
    for i in range(640):
        w = names[int(rng.integers(0, 6))]
        shift = np.log(3.0) if i >= 384 and w == "w1" else 0.0
        resid.append((engines[int(rng.integers(0, 4))], w,
                      float(rng.normal(-0.02 + shift, 0.2))))
    return mix, resid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windows_fire_on_the_same_samples(seed):
    mix, resid = _window_streams(seed)
    trace = {}
    for name, pk in (("port", PORT), ("jax", JAX)):
        mw = pk.rc._MixWindow(32, 0.3, 2)
        rw = pk.rc._ResidWindow(window=64, threshold=0.35)
        mixed = [(mw.add(e), mw.last_tv, mw.streak) for e in mix]
        fired = []
        for i, (e, w, lr) in enumerate(resid):
            if rw.add(e, w, lr):
                fired.append((i, rw.last_dev, rw.worker_evidence()))
                rw.epoch_reset()
        trace[name] = (mixed, fired, rw.anchor)
    assert trace["port"] == trace["jax"]
    assert any(f for f, _, _ in trace["port"][0])
    assert trace["port"][1]


# ----------------------------------------------------------------------------
# the card's gate on the loop (chip_smoke.hold_loop), exercised on the CPU

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_loop_gate_catches_a_diverging_refresh(torch_cd):
    smoke = _chip_smoke()
    fleet = workers.synth_fleet(1, 2, 2)
    cluster = simulator.Cluster(torch_cd, fleet)

    def seeded(factor):
        rc = recharacterize.OnlineRecharacterizer(detect=False)
        rc.seed(cluster, worker_factors={fleet[1].name: factor})
        return rc

    cache = types.SimpleNamespace(profile_reclaims=3)
    rcs = {"numpy": seeded(4.0), "card": seeded(4.0), "cpu": seeded(4.0)}

    def report(rc):   # the CPU run's, as its forked child sends it back
        return {"refreshes": rc.refreshes, "scales": smoke.scales(torch_cd,
                                                                  rc)}

    line = smoke.hold_loop("t", torch_cd, rcs, [cache], online=True,
                           cpu=report(rcs["cpu"]))
    assert line["refreshes"] == {"card": 1, "cpu": 1, "numpy": 1}
    with pytest.raises(SystemExit, match="overlay scales differ"):
        smoke.hold_loop("t", torch_cd, rcs, [cache], online=True,
                        cpu=report(seeded(4.0000001)))
    with pytest.raises(SystemExit, match="refreshes"):
        smoke.hold_loop("t", torch_cd, rcs, [cache], online=True,
                        cpu=report(recharacterize.OnlineRecharacterizer()))
    with pytest.raises(SystemExit, match="did not run"):
        smoke.hold_loop("t", torch_cd, rcs,
                        [types.SimpleNamespace(profile_reclaims=0)],
                        online=True, cpu=report(rcs["cpu"]))
    with pytest.raises(SystemExit, match="share"):
        smoke.hold_loop("t", torch_cd, dict(rcs, cpu=rcs["card"]), [cache],
                        online=True, cpu=report(rcs["card"]))
    assert smoke.hold_loop("t", torch_cd, dict.fromkeys(rcs), [cache],
                           online=False, cpu=None) == {}
