"""The port's device-resident path under ``HierarchicalSynergAI``, on the
pinned goldens and on a replayed trace.

* Regions 1, 2 and 3: the port's hierarchy over resident region cores
  against the port's numpy hierarchy and the JAX hierarchy over its
  resident cores, every ``JobResult`` field equal (``run_three``).
* ``PR2_GOLDEN`` and ``STREAM_GOLDEN`` (``tests/test_streaming_qos.py``)
  reproduced by the port's resident path at the goldens' own tolerance.
* A trace saved by the JAX package and replayed by both packages: the
  port's resident runs, flat and at one region, equal a live run of the
  reference's resident path on the same trace.  (The pinned
  ``REPLAY_GOLDEN_DIGEST`` no longer matches the reference itself, so it is
  not the yardstick.)"""

import pytest

from repro.core.hierarchy import HierarchicalSynergAI as JxHierarchical
from repro.core.pallas_scoring import make_pallas_score_fn
from repro.core.scheduler import SynergAI as JxSynergAI
from repro.core.simulator import Simulator as JxSimulator
from repro.core.workers import synth_fleet as jx_synth_fleet
from repro.core.workload import replay as jx_replay
from repro.core.workload import save_trace
from repro.core.workload import scenario as jx_scenario
from repro_torch.core.hierarchy import HierarchicalSynergAI
from repro_torch.core.offline import characterize
from repro_torch.core.scheduler import SynergAI
from repro_torch.core.scoring import make_torch_score_fn
from repro_torch.core.simulator import Simulator
from repro_torch.core.workers import synth_fleet
from repro_torch.core.workload import replay, scenario
from test_streaming_qos import PR2_GOLDEN, STREAM_GOLDEN
from test_torch_host import canon
from test_torch_resident import caches, run_three

_APPROX = 1e-9


@pytest.fixture(scope="module")
def torch_cd():
    return characterize()


def _resident():
    return make_torch_score_fn(device_cache=True, device="cpu")


def _hier(pk, fn):
    return pk.hi.HierarchicalSynergAI(score_fn=fn)


@pytest.mark.parametrize("regions", [1, 2, 3])
def test_hierarchical_resident_matches_numpy_and_jax(configdict, torch_cd,
                                                     regions):
    def setup(pk, cd):
        fleet = pk.wk.synth_fleet(1, 2, 2, regions=regions)
        jobs = pk.wl.regional_scenario(cd, "mmpp", n_jobs=80, fleet=fleet,
                                       seed=5, utilization=1.1,
                                       serving="batched")
        return fleet, jobs, dict(seed=5, serving="batched")

    pol, _ = run_three(configdict, torch_cd, setup, _hier)
    if regions > 1:
        assert len(pol._subs) >= 2
        assert all(c.rows_uploaded > 0 for c in caches(pol))


def test_pr2_golden_reproduced_resident(torch_cd):
    fleet = synth_fleet(1, 2, 2)
    jobs = scenario(torch_cd, "mmpp", n_jobs=40, fleet=fleet, seed=7,
                    utilization=1.2, serving="batched")
    res = {r.job.id: r for r in
           Simulator(torch_cd, SynergAI(score_fn=_resident()), fleet=fleet,
                     seed=7, serving="batched").run(jobs)}
    for jid, worker, start, end, exec_s, violated in PR2_GOLDEN:
        r = res[jid]
        assert r.worker == worker
        assert r.start == pytest.approx(start, rel=_APPROX)
        assert r.end == pytest.approx(end, rel=_APPROX)
        assert r.exec_s == pytest.approx(exec_s, rel=_APPROX)
        assert r.violated == violated


def test_stream_golden_reproduced_resident(torch_cd):
    fleet = synth_fleet(1, 1, 1)
    jobs = scenario(torch_cd, "poisson", n_jobs=12, fleet=fleet, seed=11,
                    utilization=1.0, serving="batched")
    res = {r.job.id: r for r in
           Simulator(torch_cd, SynergAI(score_fn=_resident()), fleet=fleet,
                     seed=11, serving="batched").run(jobs)}
    for jid, ttft, tpot in STREAM_GOLDEN:
        assert res[jid].ttft == pytest.approx(ttft, rel=_APPROX), jid
        assert res[jid].tpot == pytest.approx(tpot, rel=_APPROX), jid


def test_replayed_trace_matches_a_live_reference_run(configdict, torch_cd,
                                                     tmp_path):
    jobs = jx_scenario(configdict, "mmpp", n_jobs=40,
                       fleet=jx_synth_fleet(1, 2, 2), seed=7,
                       utilization=1.2)
    path = str(tmp_path / "trace.jsonl")
    save_trace(path, jobs)
    ref = canon(JxSimulator(
        configdict, JxSynergAI(score_fn=make_pallas_score_fn(
            device_cache=True)),
        fleet=jx_synth_fleet(1, 2, 2), seed=7).run(jx_replay(path)))
    ref_hier = canon(JxSimulator(
        configdict, JxHierarchical(score_fn=make_pallas_score_fn(
            device_cache=True)),
        fleet=jx_synth_fleet(1, 2, 2, regions=1), seed=7).run(
            jx_replay(path)))
    flat = canon(Simulator(torch_cd, SynergAI(score_fn=_resident()),
                           fleet=synth_fleet(1, 2, 2), seed=7).run(
                               replay(path)))
    hier = canon(Simulator(torch_cd,
                           HierarchicalSynergAI(score_fn=_resident()),
                           fleet=synth_fleet(1, 2, 2, regions=1), seed=7)
                 .run(replay(path)))
    assert flat == ref and len(flat) == 40
    assert hier == ref_hier
