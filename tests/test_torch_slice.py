"""The port's main path as a whole against the JAX package's: the port's
``Simulator`` + ``SynergAI(score_fn=make_torch_score_fn(device="cpu"))``
against the reference ``SynergAI(score_fn=make_pallas_score_fn())`` on the
scenarios of ``tests/test_pallas_parity.py``.  Each package builds its own
characterization and jobs from the same seeds (``test_torch_host.py`` holds
those equal).  The tolerance is exact: every ``JobResult`` field but the
host wall-clock ``decision_s``."""

import pytest
import torch

from repro.core.job import make_experiment as jx_make_experiment
from repro.core.pallas_scoring import make_pallas_score_fn
from repro.core.scheduler import SynergAI as JxSynergAI
from repro.core.simulator import Simulator as JxSimulator
from repro.core.workers import synth_fleet as jx_synth_fleet
from repro.core.workload import scenario as jx_scenario
from repro_torch.core.devicecache import DeviceScoreCache
from repro_torch.core.job import make_experiment
from repro_torch.core.offline import characterize
from repro_torch.core.scheduler import SynergAI
from repro_torch.core.scoring import make_torch_score_fn
from repro_torch.core.simulator import Simulator
from repro_torch.core.workers import synth_fleet
from repro_torch.core.workload import scenario
from repro_torch.kernels.scheduler_score import (scheduler_score,
                                                 scheduler_score_v2)
from test_torch_host import canon


@pytest.fixture(scope="module")
def torch_cd():
    return characterize()


def _run_both(configdict, torch_cd, v2, build_jobs, fleet_args,
              **sim_kw):
    """The same run on the JAX package through the Pallas backend
    (interpret mode) and on the port through its CPU plain versions;
    ``fleet_args`` = ((n_cloud, n_el, n_es), kwargs) or None for the
    paper fleet."""
    ref_fleet = port_fleet = None
    if fleet_args:
        ref_fleet = jx_synth_fleet(*fleet_args[0], **fleet_args[1])
        port_fleet = synth_fleet(*fleet_args[0], **fleet_args[1])
    ref = JxSimulator(configdict,
                      JxSynergAI(score_fn=make_pallas_score_fn(v2=v2)),
                      fleet=ref_fleet, **sim_kw).run(
        build_jobs(configdict, ref_fleet, jx=True))
    fn = make_torch_score_fn(v2=v2, device="cpu")
    port = Simulator(torch_cd, SynergAI(score_fn=fn), fleet=port_fleet,
                     **sim_kw).run(build_jobs(torch_cd, port_fleet, jx=False))
    assert fn.calls > 0                 # the backend really scored
    return canon(ref), canon(port)


def _paper(cd, fleet, jx):
    return (jx_make_experiment if jx else make_experiment)(
        cd, "DH", "FH", seed=11)


def _mmpp_job(cd, fleet, jx):
    return (jx_scenario if jx else scenario)(
        cd, "mmpp", n_jobs=120, fleet=fleet, utilization=0.9, seed=5)


@pytest.mark.parametrize("case", ["paper", "fleet"])
def test_v1_slice_matches_pallas_path(configdict, torch_cd, case):
    if case == "paper":
        ref, port = _run_both(configdict, torch_cd, False, _paper, None,
                              seed=11)
    else:
        ref, port = _run_both(configdict, torch_cd, False, _mmpp_job,
                              ((2, 3, 3), {}), seed=5)
    assert port == ref and len(port) > 0


@pytest.mark.parametrize("variant", ["numpy", "uncached", "torch",
                                     "torch-v2", "torch-resident"])
def test_zero_job_tick_all_variants(torch_cd, variant):
    pol = {
        "numpy": lambda: SynergAI(),
        "uncached": lambda: SynergAI(incremental=False),
        "torch": lambda: SynergAI(
            score_fn=make_torch_score_fn(device="cpu")),
        "torch-v2": lambda: SynergAI(
            score_fn=make_torch_score_fn(v2=True, device="cpu")),
        "torch-resident": lambda: SynergAI(
            score_fn=make_torch_score_fn(device_cache=True, device="cpu")),
    }[variant]()
    fleet = synth_fleet(1, 2, 2)
    cluster = Simulator(torch_cd, pol, fleet=fleet).cluster
    assert pol.schedule(0.0, [], cluster) == []
    jobs = scenario(torch_cd, "poisson", n_jobs=4, fleet=fleet, seed=2)
    assert pol.schedule(0.0, list(jobs), cluster)
    assert pol.schedule(1.0, [], cluster) == []


def test_zero_job_score_fn_returns_the_shared_empty(torch_cd):
    workers = [w.name for w in synth_fleet(1, 2, 2)]
    got = make_torch_score_fn(device="cpu")(torch_cd, [], workers, now=0.0)
    assert got.workers == workers
    assert got.t_estimated.shape == (0, len(workers))
    assert got.best_worker.shape == (0,)


def test_device_marker_builds_the_ports_cache_on_its_device():
    marker = make_torch_score_fn(device_cache=True, device="cpu")
    assert marker.device_cache and marker.takes_profile
    with pytest.raises(TypeError, match="marker"):
        marker()
    pol = SynergAI(score_fn=marker)
    assert isinstance(pol.cache, DeviceScoreCache)
    assert pol.cache.device == torch.device("cpu") and pol.cache.bj == 128
    assert pol._device and not pol._fused


def test_cpu_slice_launches_no_kernel(torch_cd):
    before = (scheduler_score.launches, scheduler_score_v2.launches)
    fleet = synth_fleet(1, 2, 2)
    jobs = scenario(torch_cd, "mmpp", n_jobs=40, fleet=fleet, seed=1)
    for v2 in (False, True):
        fn = make_torch_score_fn(v2=v2, device="cpu")
        Simulator(torch_cd, SynergAI(score_fn=fn), fleet=fleet,
                  seed=1).run(jobs)
        assert fn.calls > 0
        assert set(fn.seconds) == {"build", "h2d", "kernel", "d2h"}
    assert (scheduler_score.launches, scheduler_score_v2.launches) == before
