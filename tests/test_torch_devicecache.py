"""The port's ``DeviceScoreCache`` (pools as torch tensors, here on the CPU)
against the port's host ``ScoreCache`` and against the JAX package's
``DeviceScoreCache``, through the same op sequences.

* The differential harness of ``tests/test_devicecache.py::_drive``:
  arrivals, placements, failures, elastic clones and profile refreshes on a
  live cluster, with every device row checked against its host row after
  each step.  The one sanctioned divergence from the host cache is the mask
  rule: a pure ``fail_gen`` bump masks instead of flushing, so the device
  cache may flush less often and may reclaim more slots on a later profile
  refresh than the host cache; the harness allows for both.
* The same op sequence through the JAX cache: the pools equal as float32
  after every step (padding included), and ``rows_uploaded``,
  ``bytes_to_device``, ``fail_masks``, ``flushes`` and ``col_extends``
  equal.
* The column-extension, profile re-ship, fail-mask and O(churn * W)
  steady-tick tests of ``tests/test_devicecache.py``, on the port.

The tolerance is exact."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.devicecache as jx_devicecache
import repro.core.estimator as jx_estimator
import repro.core.scheduler as jx_scheduler
import repro.core.simulator as jx_simulator
import repro.core.workers as jx_workers
import repro.core.workload as jx_workload
from repro_torch.core import devicecache, estimator, scheduler, simulator
from repro_torch.core import workers, workload
from repro_torch.core.devicecache import DeviceScoreCache
from repro_torch.core.estimator import new_profile_id, profile_overlay
from repro_torch.core.offline import characterize
from repro_torch.core.scheduler import SynergAI
from repro_torch.core.scorecache import ScoreCache
from repro_torch.core.scoring import make_torch_score_fn
from repro_torch.core.simulator import Simulator
from repro_torch.core.workers import synth_fleet
from repro_torch.core.workload import scenario

_OPS = ("arrive", "place", "fail", "clone", "profile")
_COUNTERS = ("rows_uploaded", "bytes_to_device", "fail_masks", "flushes",
             "col_extends")


@pytest.fixture(scope="module")
def torch_cd():
    return characterize()


def _port():
    return dict(cache=lambda pid: DeviceScoreCache(profile=pid,
                                                   device="cpu"),
                est=estimator, sched=scheduler, sim=simulator, wk=workers,
                wl=workload, pool=lambda p: p.numpy().copy())


def _jax():
    return dict(cache=lambda pid: jx_devicecache.DeviceScoreCache(
                    profile=pid),
                est=jx_estimator, sched=jx_scheduler, sim=jx_simulator,
                wk=jx_workers, wl=jx_workload,
                pool=lambda p: np.array(p, copy=True))


def _snapshot(pk, dc, cd, queue, cluster):
    slots = dc.sync(cd, queue, cluster)
    pools = tuple(None if p is None else pk["pool"](p)
                  for p in (dc._dt, dc._dpre, dc._ddec, dc._dene))
    return slots, pools, {k: getattr(dc, k) for k in _COUNTERS}


def _drive(pk, cd, ops, seed=13, host=False):
    """Apply ``ops`` to one live cluster of package ``pk`` while its
    DeviceScoreCache (and, with ``host``, a plain ScoreCache) tracks the
    queue; returns the cache's snapshot after every step."""
    fleet = pk["wk"].synth_fleet(1, 2, 2)
    cluster = pk["sim"].Simulator(cd, pk["sched"].SynergAI(),
                                  fleet=fleet).cluster
    pid = pk["est"].new_profile_id()
    dc = pk["cache"](pid)
    hc = ScoreCache(profile=pid) if host else None
    pool = list(pk["wl"].scenario(cd, "poisson", n_jobs=160, fleet=fleet,
                                  seed=seed))
    queue = [pool.pop(0) for _ in range(12)]
    engines = sorted({j.engine for j in pool})
    names = list(cluster.arrays.names)
    now, clones = 0.0, 0
    snaps = []

    def check():
        snaps.append(_snapshot(pk, dc, cd, queue, cluster))
        if hc is not None:
            _assert_mirrors_host(hc, dc, cd, queue, cluster)

    check()
    for step, op in enumerate(ops):
        now += 1.0
        if op == "arrive":
            queue.extend(pool.pop(0) for _ in range(min(3, len(pool))))
        elif op == "place":
            if queue:
                queue.pop(step % len(queue))
        elif op == "fail":
            cluster.workers[names[step % len(names)]].failed_until = \
                now + 5.0
        elif op == "clone":
            clones += 1
            base = cluster.workers["cloud-pod"].pool
            clone = dataclasses.replace(
                base, name=f"cloud-pod__clone{clones}")
            cluster.workers[clone.name] = cluster._make_worker(clone)
            names = list(cluster.arrays.names)
        elif op == "profile":
            pk["est"].profile_overlay(cd, pid).apply(
                {engines[step % len(engines)]:
                 {names[0]: 0.5 + 0.1 * (step % 4)}})
        check()
    if hc is not None:
        # the mask rule: a pure fail_gen bump never flushes the device
        # cache, so it flushes at most as often as the host cache
        assert dc.flushes <= hc.flushes
        assert dc.col_extends == hc.col_extends
    return snaps


def _assert_mirrors_host(hc, dc, cd, queue, cluster):
    """Every view of the two caches agrees exactly, and every device row is
    the f32 cast of its host row, padded columns inf."""
    hs = hc.sync(cd, queue, cluster)
    ds = dc.sync(cd, queue, cluster)
    np.testing.assert_array_equal(hc.t_matrix(hs), dc.t_matrix(ds))
    np.testing.assert_array_equal(hc.min_estimate(hs), dc.min_estimate(ds))
    np.testing.assert_array_equal(hc.t_remaining(hs, 0.0),
                                  dc.t_remaining(ds, 0.0))
    if len(queue):
        W = dc._W
        pool = dc._dt.numpy()
        np.testing.assert_array_equal(pool[ds, :W],
                                      dc._t[ds].astype(np.float32))
        if dc._have_phase:
            pre, dec = dc.phase_matrices(ds)
            np.testing.assert_array_equal(dc._dpre.numpy()[ds, :W],
                                          pre.astype(np.float32))
            np.testing.assert_array_equal(dc._ddec.numpy()[ds, :W],
                                          dec.astype(np.float32))
        assert np.isinf(pool[ds, W:]).all()


def _ops(seed, n=24):
    rng = np.random.default_rng(seed)
    return [_OPS[i] for i in rng.integers(0, len(_OPS), size=n)]


# the seeded sequences, and the counterexample that
# tests/test_devicecache.py::test_differential_interleavings_property
# reports (arrive x8, place, arrive x6, fail, profile)
SEQUENCES = [_ops(s) for s in range(4)] + [
    ["arrive"] * 8 + ["place"] + ["arrive"] * 6 + ["fail", "profile"],
    ["arrive", "clone", "fail", "arrive", "clone", "profile", "place",
     "fail", "arrive"]]


@pytest.mark.parametrize("k", range(len(SEQUENCES)))
def test_differential_harness_against_the_host_cache(torch_cd, k):
    _drive(_port(), torch_cd, SEQUENCES[k], seed=13 + k, host=True)


@pytest.mark.parametrize("k", range(len(SEQUENCES)))
def test_same_ops_as_the_jax_device_cache(configdict, torch_cd, k):
    got = _drive(_port(), torch_cd, SEQUENCES[k], seed=13 + k)
    want = _drive(_jax(), configdict, SEQUENCES[k], seed=13 + k)
    assert len(got) == len(want) == len(SEQUENCES[k]) + 1
    for (gs, gp, gc), (ws, wp, wc) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        assert gc == wc
        for a, b in zip(gp, wp):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)


def test_fail_gen_masks_instead_of_flushing(torch_cd):
    cd = torch_cd
    fleet = synth_fleet(1, 2, 2)
    cluster = Simulator(cd, SynergAI(), fleet=fleet).cluster
    jobs = list(scenario(cd, "poisson", n_jobs=40, fleet=fleet, seed=5))
    dc = DeviceScoreCache(device="cpu")
    dc.sync(cd, jobs, cluster)
    rows0, up0 = dict(dc._slot), dc.rows_uploaded
    cluster.workers["edge-large"].failed_until = 50.0
    hc = ScoreCache()
    hc.sync(cd, jobs, cluster)      # a fresh host cache, post-failure rows
    _assert_mirrors_host(hc, dc, cd, jobs, cluster)
    assert dc.fail_masks == 1
    assert dc.flushes == 0
    assert dc._slot == rows0
    assert dc.rows_uploaded == up0


def test_elastic_clone_extends_device_columns(torch_cd):
    cd = torch_cd
    fleet = synth_fleet(1, 2, 2)
    cluster = Simulator(cd, SynergAI(), fleet=fleet).cluster
    jobs = list(scenario(cd, "poisson", n_jobs=30, fleet=fleet, seed=9))
    dc = DeviceScoreCache(device="cpu")
    slots = dc.sync(cd, jobs, cluster)
    bytes0 = dc.bytes_to_device
    base = cluster.workers["cloud-pod"].pool
    clone = dataclasses.replace(base, name="cloud-pod__clone1")
    cluster.workers[clone.name] = cluster._make_worker(clone)
    slots = dc.sync(cd, jobs, cluster)
    assert dc.col_extends == 1 and dc.flushes == 0
    W = dc._W
    np.testing.assert_array_equal(dc._dt.numpy()[slots, :W],
                                  dc._t[slots].astype(np.float32))
    # one new column for the live rows, not a row re-upload
    assert dc.bytes_to_device - bytes0 < len(jobs) * 16 * 4
    # retiring the clone is a non-append membership change: a full flush,
    # and the device pools drop and rebuild on the next sync
    del cluster.workers[clone.name]
    slots = dc.sync(cd, jobs, cluster)
    assert dc.flushes == 1
    np.testing.assert_array_equal(dc._dt.numpy()[slots, :dc._W],
                                  dc._t[slots].astype(np.float32))


def test_elastic_clone_past_the_column_block_regrows(torch_cd):
    """Clones that cross the 128-column block widen the pools: the old
    block is kept, the new columns hold the clones' rows."""
    cd = torch_cd
    fleet = synth_fleet(20, 50, 57)            # 127 pools
    cluster = Simulator(cd, SynergAI(), fleet=fleet).cluster
    jobs = list(scenario(cd, "poisson", n_jobs=20, fleet=fleet, seed=4))
    dc = DeviceScoreCache(device="cpu")
    slots = dc.sync(cd, jobs, cluster)
    dc.ensure_phase_rows(cd, jobs, slots, cluster)
    assert dc._d_Wp == 128
    base = cluster.workers["cloud-pod"].pool
    for i in range(3):
        clone = dataclasses.replace(base, name=f"cloud-pod__clone{i}")
        cluster.workers[clone.name] = cluster._make_worker(clone)
    slots = dc.sync(cd, jobs, cluster)
    assert dc.col_extends == 1 and dc._d_Wp == 256 and dc._W == 130
    pre, dec = dc.phase_matrices(slots)
    for pool, host in ((dc._dt, dc._t[slots]), (dc._dpre, pre),
                       (dc._ddec, dec)):
        np.testing.assert_array_equal(pool.numpy()[slots, :130],
                                      host.astype(np.float32))
        assert np.isinf(pool.numpy()[:, 130:]).all()


def test_profile_refresh_reships_only_touched_rows(torch_cd):
    cd = torch_cd
    fleet = synth_fleet(1, 2, 2)
    cluster = Simulator(cd, SynergAI(), fleet=fleet).cluster
    jobs = list(scenario(cd, "poisson", n_jobs=60, fleet=fleet, seed=6))
    pid = new_profile_id()
    dc = DeviceScoreCache(profile=pid, device="cpu")
    dc.sync(cd, jobs, cluster)
    up0 = dc.rows_uploaded
    target = sorted({j.engine for j in jobs})[0]
    profile_overlay(cd, pid).apply({target: {fleet[0].name: 0.5}})
    slots = dc.sync(cd, jobs, cluster)
    touched = sum(j.engine == target for j in jobs)
    assert dc.profile_reclaims == touched
    assert dc.rows_uploaded - up0 == touched
    np.testing.assert_array_equal(dc._dt.numpy()[slots, :dc._W],
                                  dc._t[slots].astype(np.float32))


def test_steady_tick_transfer_is_o_churn_w(torch_cd):
    cd = torch_cd
    fleet = synth_fleet(2, 4, 4)
    cluster = Simulator(cd, SynergAI(), fleet=fleet).cluster
    jobs = list(scenario(cd, "poisson", n_jobs=512, fleet=fleet, seed=21))
    pol = SynergAI(score_fn=make_torch_score_fn(device_cache=True,
                                                device="cpu"))
    queue = list(jobs[:480])
    spare = list(jobs[480:])
    pol.schedule(0.0, queue, cluster)    # cold tick: every row uploads
    dc = pol.cache
    assert dc.rows_uploaded == len(queue)
    full_matrix = len(queue) * dc._d_Wp * 4    # one [J, W] f32 re-upload
    # steady ticks: no arrivals, so no matrix row travels, only the
    # O(J + W) per-tick vectors
    b0, u0 = dc.bytes_to_device, dc.rows_uploaded
    for i in range(5):
        pol.schedule(1.0 + i, queue, cluster)
    assert dc.rows_uploaded == u0
    per_tick = (dc.bytes_to_device - b0) / 5
    assert per_tick < 0.25 * full_matrix
    # a churn tick: exactly the arrivals' rows ship
    churn = 16
    queue.extend(spare[:churn])
    b1, u1 = dc.bytes_to_device, dc.rows_uploaded
    pol.schedule(10.0, queue, cluster)
    assert dc.rows_uploaded - u1 == churn
    assert dc.bytes_to_device - b1 < per_tick + 4 * churn * dc._d_Wp * 8
    assert dc.flushes == 0


def test_device_counters_over_full_run(torch_cd):
    cd = torch_cd
    fleet = synth_fleet(1, 2, 2)
    jobs = scenario(cd, "mmpp", n_jobs=120, fleet=fleet, seed=3,
                    utilization=1.2)
    pol = SynergAI(score_fn=make_torch_score_fn(device_cache=True,
                                                device="cpu"))
    Simulator(cd, pol, fleet=fleet, seed=3).run(jobs)
    dc = pol.cache
    assert dc.flushes == 0
    assert dc.rows_uploaded == 120
    assert dc.ticks >= 100
    full_matrix_per_tick = 120 * dc._d_Wp * 4
    assert dc.bytes_to_device / dc.ticks < 0.5 * full_matrix_per_tick


def test_ship_packs_one_buffer_and_keeps_every_array():
    rng = np.random.default_rng(0)
    arrays = [rng.integers(-5, 5, 7).astype(np.int32),
              rng.random((3, 5)).astype(np.float32),
              rng.random(9) < 0.5,
              np.array([-0.0, np.nan, np.inf], np.float32)]
    got = devicecache._ship(arrays, torch.device("cpu"))
    base = got[0].untyped_storage().data_ptr()
    for a, g in zip(arrays, got):
        assert g.untyped_storage().data_ptr() == base   # one buffer
        assert g.shape == a.shape and g.numpy().dtype == a.dtype
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      a.view(np.uint8))
