"""The port's device-resident path as a whole, flat: the port's
``Simulator`` + ``SynergAI(score_fn=make_torch_score_fn(device_cache=True,
device="cpu"))`` against the port's numpy ``SynergAI()`` and against the JAX
package's ``SynergAI(score_fn=make_pallas_score_fn(device_cache=True))``
(``scheduler_tick`` in interpret mode), on the scenarios of
``tests/test_devicecache.py``.  Each package builds its own characterization
and jobs from the same seeds.  The tolerance is exact: every ``JobResult``
field but the host wall-clock ``decision_s``; the two device caches' transfer
counters equal too.  The hierarchical runs and the goldens are in
``test_torch_resident_hier.py``."""

import types

import pytest

import repro.core.hierarchy as jx_hierarchy
import repro.core.overload as jx_overload
import repro.core.pallas_scoring as jx_scoring
import repro.core.scheduler as jx_scheduler
import repro.core.simulator as jx_simulator
import repro.core.workers as jx_workers
import repro.core.workload as jx_workload
from repro_torch.core import hierarchy, overload, scheduler, scoring
from repro_torch.core import simulator, workers, workload
from repro_torch.core.devicecache import DeviceScoreCache
from repro_torch.core.offline import characterize
from test_torch_host import canon

_COUNTERS = ("ticks", "rows_uploaded", "bytes_to_device", "fail_masks",
             "flushes", "col_extends")

PORT = types.SimpleNamespace(
    sched=scheduler, sim=simulator, wk=workers, wl=workload, ov=overload,
    hi=hierarchy,
    resident=lambda: scoring.make_torch_score_fn(device_cache=True,
                                                 device="cpu"))
JAX = types.SimpleNamespace(
    sched=jx_scheduler, sim=jx_simulator, wk=jx_workers, wl=jx_workload,
    ov=jx_overload, hi=jx_hierarchy,
    resident=lambda: jx_scoring.make_pallas_score_fn(device_cache=True))


@pytest.fixture(scope="module")
def torch_cd():
    return characterize()


def caches(policy):
    subs = getattr(policy, "_subs", None)
    return ([s.cache for s in subs.values()] if subs is not None
            else [policy.cache])


def counters(policy):
    return {k: sum(getattr(c, k) for c in caches(policy))
            for k in _COUNTERS}


def run_three(configdict, torch_cd, setup, policy, numpy_too=True):
    """``setup(pk, cd)`` -> (fleet, jobs, Simulator kwargs) and
    ``policy(pk, score_fn)`` -> a policy, per package.  Runs the port's
    resident path, the JAX resident path and (``numpy_too``) the port's
    numpy default; asserts they agree and returns the port's policy and
    results."""
    out = {}
    for name, pk, cd, fn in (("port", PORT, torch_cd, PORT.resident()),
                             ("jax", JAX, configdict, JAX.resident()),
                             ("numpy", PORT, torch_cd, None)):
        if name == "numpy" and not numpy_too:
            continue
        fleet, jobs, kw = setup(pk, cd)
        pol = policy(pk, fn)
        res = pk.sim.Simulator(cd, pol, fleet=fleet, **kw).run(jobs)
        out[name] = (pol, canon(res), res)
    port_pol, port, port_res = out["port"]
    assert all(isinstance(c, DeviceScoreCache) for c in caches(port_pol))
    assert counters(port_pol) == counters(out["jax"][0])
    assert counters(port_pol)["ticks"] > 0
    assert port == out["jax"][1] and len(port) > 0
    if numpy_too:
        assert port == out["numpy"][1]
    return port_pol, port_res


def _flat(**sched_kw):
    return lambda pk, fn: pk.sched.SynergAI(score_fn=fn, **sched_kw)


@pytest.mark.parametrize("serving,streaming,disaggregate",
                         [("job", None, False),
                          ("batched", None, False),
                          ("batched", (2.0, 2.5), False),
                          ("batched", (2.0, 2.5), True)])
def test_resident_matches_numpy_and_jax(configdict, torch_cd, serving,
                                        streaming, disaggregate):
    def setup(pk, cd):
        fleet = pk.wk.synth_fleet(1, 2, 2, disaggregate=disaggregate)
        jobs = pk.wl.scenario(cd, "mmpp", n_jobs=60, fleet=fleet, seed=7,
                              utilization=1.2, serving=serving,
                              streaming=streaming)
        return fleet, jobs, dict(seed=7, serving=serving)

    _, res = run_three(configdict, torch_cd, setup, _flat())
    if streaming:
        assert any(r.ttft == r.ttft for r in res)
    if disaggregate:
        assert any(r.prefill_worker for r in res)


@pytest.mark.parametrize("serving", ["job", "batched"])
def test_resident_under_failures_elastic_energy(configdict, torch_cd,
                                                serving):
    def setup(pk, cd):
        fleet = pk.wk.synth_fleet(1, 2, 2)
        jobs = pk.wl.scenario(cd, "mmpp", n_jobs=120, fleet=fleet, seed=3,
                              utilization=1.2, serving=serving)
        span = jobs[-1].arrival
        return fleet, jobs, dict(
            seed=3, serving=serving,
            failures=pk.wl.synth_failures(fleet, span, mtbf_s=span / 2,
                                          mttr_s=span / 6, seed=5),
            elastic_max=3, elastic_threshold=4)

    pol, res = run_three(configdict, torch_cd, setup,
                         _flat(energy_weight=0.5))
    c = counters(pol)
    assert c["fail_masks"] > 0 and c["col_extends"] > 0
    assert any("__clone" in r.worker for r in res)


def test_resident_with_an_overload_controller_that_sheds(configdict,
                                                         torch_cd):
    """The resident path filters the kernel's placements through the
    controller after the tick, so a shed job's worker idles one tick: the
    schedule is held to the JAX resident run, not to numpy's."""
    def setup(pk, cd):
        fleet = pk.wk.synth_fleet(1, 2, 2)
        jobs = pk.wl.scenario(cd, "flash", n_jobs=120, fleet=fleet,
                              utilization=2.5, seed=3)
        return fleet, jobs, dict(seed=1)

    pol, res = run_three(
        configdict, torch_cd, setup,
        lambda pk, fn: pk.sched.SynergAI(
            score_fn=fn, overload=pk.ov.OverloadController(queue_cap=10)),
        numpy_too=False)
    assert pol.overload.shed_doom_total + \
        pol.overload.shed_backpressure_total > 0
    assert any(r.outcome == "shed" for r in res)
