"""The port's scoring kernels' plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode) and its numpy oracle
``repro.kernels.ref.scheduler_score_ref``, on the same numpy inputs.

The tolerance is exact: both sides compute in float32 with IEEE-rounded
division and multiplication and the same operation order, so every output
element is compared bit for bit (NaN matched by position).  The CUDA
kernels themselves are held against these plain versions on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.estimator import score_matrices
from repro.core.workers import synth_fleet
from repro.kernels.ref import scheduler_score_ref
from repro.kernels.scheduler_score import scheduler_score as pallas_v1
from repro.kernels.scheduler_score import scheduler_score_v2 as pallas_v2
from repro_torch.core.scoring import make_torch_score_fn
from repro_torch.kernels.scheduler_score import (scheduler_score,
                                                 scheduler_score_v2)
from test_pallas_parity import _fleet_queue, _tie_inputs, _v2_inputs

# the messy input sets that chip_smoke.py holds the kernels to on the card
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def assert_exact(got, want):
    """Bit-for-bit equality of two arrays (NaN matched by position)."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    if got.dtype.kind == "f":
        assert (np.isnan(got) == np.isnan(want)).all()
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(got[ok], want[ok])
    else:
        np.testing.assert_array_equal(got, want)


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


def _v1_torch(qps, pre, q, rem):
    out = scheduler_score(_t(qps), _t(pre), _t(q), _t(rem))
    return [x.numpy() for x in out]


V2_DTYPES = (np.float32,) * 5 + (np.int32,) * 3 + (np.float32,) * 3


def _v2_torch(*inputs):
    out = scheduler_score_v2(*(_t(a, dt) for a, dt in zip(inputs,
                                                          V2_DTYPES)))
    return [x.numpy() for x in out]


def _v2_pallas(*inputs):
    args = [np.asarray(a, dt) for a, dt in zip(inputs, V2_DTYPES)]
    return [np.asarray(x) for x in pallas_v2(*args, bj=128, interpret=True)]


def _fleet_v1_inputs(configdict, J):
    fleet = synth_fleet(86, 85, 85)
    workers = [w.name for w in fleet]
    jobs = _fleet_queue(configdict, J)[:J]
    now = float(np.median([j.arrival for j in jobs]))  # t_rem straddles 0
    qps, pre = score_matrices(configdict, jobs, workers)
    q = np.array([float(j.queries) for j in jobs])
    rem = np.array([j.t_qos - (now - j.arrival) for j in jobs])
    return tuple(np.asarray(a, np.float32) for a in (qps, pre, q, rem))


# ---------------------------------------------------------------------------
# v1


@pytest.mark.parametrize("J", [2048, 2043])
def test_v1_plain_matches_numpy_ref_at_fleet_scale(configdict, J):
    inputs = _fleet_v1_inputs(configdict, J)
    got = _v1_torch(*inputs)
    want = scheduler_score_ref(*inputs)
    for g, w in zip(got, want):
        assert_exact(g, w)
    est, best, urg, acc = got
    assert (best == -1).any()                      # all-infeasible rows
    assert acc.any(1).any() and not acc.any(1).all()   # doomed rows too


@pytest.mark.parametrize("seed", [0, 1])
def test_v1_plain_matches_pallas_interpret(seed):
    inputs = chip_smoke.messy_v1_inputs(301, 64, seed)
    got = _v1_torch(*inputs)
    want = pallas_v1(*inputs, bj=128, interpret=True)
    for g, w in zip(got, want):
        assert_exact(g, np.asarray(w))
    est, best, urg, acc = got
    # the inputs really hit the edges: -1 rows with rem - BIG urgency,
    # doomed rows, f32 boundary ties accepted at equality, argmin ties
    none = best == -1
    assert none.any()
    np.testing.assert_array_equal(urg[none],
                                  inputs[3][none] - np.float32(3e38))
    assert acc.any(1).any() and not acc.any(1).all()
    tie = inputs[3] == np.float32(chip_smoke.TIE_EST)
    assert tie.any() and (est[tie, 0] == inputs[3][tie]).all()
    assert acc[tie, 0].all()
    row_min = np.where(acc.astype(bool), est, np.inf).min(1, keepdims=True)
    assert ((np.where(acc.astype(bool), est, np.inf) == row_min).sum(1)
            > 1).any()                             # argmin ties


# ---------------------------------------------------------------------------
# v2


@pytest.mark.parametrize("seed", [0, 1])
def test_v2_plain_matches_pallas_interpret(seed):
    inputs = chip_smoke.messy_v2_inputs(299, 64, seed)
    got = _v2_torch(*inputs)
    want = _v2_pallas(*inputs)
    for g, w in zip(got, want):
        assert_exact(g, w)
    t0, _, dec_m, _, _, phase, _, has_tpot, _, _, dtok = inputs
    # inf / inf cells where the TPOT gate is live
    nan_cells = np.isinf(dec_m) & np.isinf(dtok)[:, None]
    assert (nan_cells & (has_tpot & (phase != 1))[:, None]).any()
    doom = got[3].astype(bool)
    assert doom.any() and not doom.all()
    assert np.isinf(t0).all(1).any()               # all-infeasible rows
    tie = inputs[3] == np.float32(chip_smoke.TIE_EST)
    assert tie.any() and got[1][tie, 0].all()      # accepted at equality


def test_v2_plain_matches_pallas_on_fleet_inputs(configdict):
    """The messy fleet-scale set of the Pallas parity tests (profiled
    matrices, depth penalties, phases, streaming deadlines)."""
    inputs = _v2_inputs(configdict, 509, seed=17)
    got = _v2_torch(*inputs)
    want = _v2_pallas(*inputs)
    for g, w in zip(got, want):
        assert_exact(g, w)
    assert (inputs[4] != 1.0).any()


# ---------------------------------------------------------------------------
# the float32 boundary-tie contract (mirrors test_pallas_parity.py)


def test_f32_boundary_tie_contract_v1():
    qps, pre, q, t, t_rem = _tie_inputs()
    acc64 = t_rem[:, None] >= t
    assert not acc64[0].any() and acc64[1].all()
    est, best, urg, acc = _v1_torch(qps, pre, q, t_rem)
    acc = acc.astype(bool)
    diff = acc != acc64
    assert diff.sum() == 1 and diff[0, 0]          # only the tie cell flips
    np.testing.assert_array_equal(est.astype(np.float64), t)
    # and the port agrees with the Pallas kernel on the tie itself
    want = pallas_v1(*(np.asarray(a, np.float32) for a in
                       (qps, pre, q, t_rem)), bj=8, interpret=True)
    for g, w in zip((est, best, urg, acc.astype(np.int8)), want):
        assert_exact(g, np.asarray(w))


def test_f32_boundary_tie_contract_v2():
    qps, pre, q, t, t_rem = _tie_inputs()
    acc64 = t_rem[:, None] >= t
    J, W = t.shape
    fn = make_torch_score_fn(v2=True, device="cpu")
    t2, acc, urg, doom = fn(
        t, t, t, t_rem, np.ones(W), np.zeros(J, np.int8),
        np.zeros(J, bool), np.zeros(J, bool), np.full(J, np.inf),
        np.full(J, np.inf), np.ones(J))
    diff = acc != acc64
    assert diff.sum() == 1 and diff[0, 0]
    assert doom[0] != (~acc64[0].any())            # the flip un-dooms job 0
    assert not doom[1] and (acc[1] == acc64[1]).all()
    np.testing.assert_array_equal(t2, t)


def test_f32_off_boundary_exact_parity():
    qps, pre, q, t, _ = _tie_inputs()
    for rem0 in (np.float64(np.nextafter(np.float32(50.25),
                                         np.float32(0.0))),
                 np.float64(np.nextafter(np.float32(50.25),
                                         np.float32(100.0)))):
        t_rem = np.array([rem0, 60.0])
        acc64 = t_rem[:, None] >= t
        acc = _v1_torch(qps, pre, q, t_rem)[3]
        np.testing.assert_array_equal(acc.astype(bool), acc64)


# ---------------------------------------------------------------------------
# the wrappers' contract on the CPU


def test_wrappers_reject_what_the_kernels_do_not_take():
    qps, pre, q, rem = chip_smoke.messy_v1_inputs(16, 8, 0)
    with pytest.raises(TypeError):
        scheduler_score(_t(qps, np.float64), _t(pre), _t(q), _t(rem))
    with pytest.raises(ValueError):
        scheduler_score(_t(qps), _t(pre)[:, :4], _t(q), _t(rem))
    with pytest.raises(ValueError):
        scheduler_score(_t(qps).t(), _t(pre).t(), _t(q)[:8], _t(rem)[:8])
    # a tensor that lies neither on the CPU nor on a CUDA card never
    # reaches the plain version
    meta = [torch.empty(a.shape, dtype=torch.float32, device="meta")
            for a in (qps, pre, q, rem)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        scheduler_score(*meta)


def test_cpu_runs_leave_the_launch_counters_at_zero():
    v1_before = scheduler_score.launches
    v2_before = scheduler_score_v2.launches
    _v1_torch(*chip_smoke.messy_v1_inputs(64, 16, 3))
    _v2_torch(*chip_smoke.messy_v2_inputs(64, 16, 3))
    assert scheduler_score.launches == v1_before
    assert scheduler_score_v2.launches == v2_before


def test_zero_job_calls_return_empty_outputs():
    W = 8
    z2 = torch.zeros((0, W))
    z1 = torch.zeros(0)
    est, best, urg, acc = scheduler_score(z2, z2, z1, z1)
    assert est.shape == (0, W) and best.shape == (0,) and acc.dtype == \
        torch.int8
    zi = torch.zeros(0, dtype=torch.int32)
    out = scheduler_score_v2(z2, z2, z2, z1, torch.ones(W), zi, zi, zi,
                             z1, z1, z1)
    assert [tuple(x.shape) for x in out] == [(0, W), (0, W), (0,), (0,)]
