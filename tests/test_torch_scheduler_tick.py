"""The port's device-resident tick (plain PyTorch versions) against the JAX
package's ``scheduler_tick`` (Pallas in interpret mode) and against a numpy
transcription of ``SynergAI._place`` (``tests/test_kernels.py:325``), on the
same seeded numpy inputs.

The inputs are ``chip_smoke.messy_tick_inputs``, the sets the CUDA kernels
are held to on the card: slot -1 padding, inf cells, rows and columns, f32
ties, NaN / +-inf / -0.0 urgencies, K > 1 admission masks, energy off and
on.  The tolerance is exact: ``assign`` and ``order`` equal element for
element, and the scoring outputs equal bit for bit (NaN by position)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.scheduler_score import scheduler_tick as jx_tick
from repro_torch.kernels import scheduler_score as ss
from test_torch_scheduler_score import assert_exact

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CASES = [(40, 64, 16, 0), (43, 96, 20, 1), (120, 256, 100, 2),
         (200, 512, 64, 3), (130, 300, 128, 3)]


def _torch(inputs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in inputs]


def _jax_tick(inputs, use_energy, bj):
    pools = inputs[:4] if use_energy else (
        *inputs[:3], np.zeros((1, inputs[0].shape[1]), np.float32))
    assign, order = jx_tick(*(jnp.asarray(a) for a in pools),
                            *(jnp.asarray(a) for a in inputs[4:]),
                            use_energy=use_energy, bj=bj, interpret=True)
    return np.asarray(assign), np.asarray(order)


def _numpy_tick(inputs, use_energy):
    """The reference's tick written out in numpy float32: gather, the v2
    recipe, the placement-cost prep, masks, lexsort and the greedy walk."""
    (pool_t, pool_pre, pool_dec, pool_ene, slots, t_rem, ttft_rem, tpot_qos,
     dtok, has_ttft, has_tpot, phase, ekey, emask, pen, bw, escale,
     open0) = inputs
    idx = np.clip(slots, 0, pool_t.shape[0] - 1)
    t, pre, dec = pool_t[idx], pool_pre[idx], pool_dec[idx]
    ph = phase[:, None]
    hft, hpt = (has_ttft != 0)[:, None], (has_tpot != 0)[:, None]
    with np.errstate(invalid="ignore"):
        t_eff = np.where(ph == 1, pre, np.where(ph == 2, dec, t)) * pen
        acc = t_rem[:, None] >= t_eff
        ttft_est = pre * pen
        tpot_est = dec * pen / dtok[:, None]
        acc &= ~hft | (ph == 2) | (ttft_est <= ttft_rem[:, None])
        acc &= ~hpt | (ph == 1) | (tpot_est <= tpot_qos[:, None])
        urg = t_rem - t.min(axis=1)
        tight = (has_ttft != 0) & (phase != 2)
        urg = np.where(tight, np.minimum(urg, ttft_rem - ttft_est.min(1)),
                       urg)
        doom = ~acc.any(axis=1)
        feas = np.isfinite(t_eff)
        costd = t_eff + bw
        best = np.where(feas, costd, np.inf).min(axis=1, keepdims=True)
        eligd = feas & (t_eff <= np.float32(1.5) * best)
        cost = np.where(doom[:, None], costd, t_eff)
        elig = np.where(doom[:, None], eligd, acc)
        if use_energy:
            cost = cost + pool_ene[idx] * escale
    jvalid = slots >= 0
    elig = elig & emask[ekey] & jvalid[:, None]
    ranked = np.where(elig, cost, np.float32(np.inf))
    order = np.lexsort((np.where(jvalid, urg, np.inf),
                        np.where(jvalid, doom.astype(np.int32), 2)))
    assign = np.full(len(slots), -1, np.int32)
    open_slots = open0.copy()
    for ji in order:
        if not open_slots.any():
            break
        cand = np.where(open_slots, ranked[ji], np.inf)
        wi = int(cand.argmin())
        if np.isfinite(cand[wi]):
            assign[ji] = wi
            open_slots[wi] = False
    return assign, order.astype(np.int32), ranked, urg, doom.astype(np.int8)


@pytest.mark.parametrize("use_energy", [False, True])
@pytest.mark.parametrize("J,cap,W,seed", CASES)
def test_tick_plain_matches_pallas_tick(J, cap, W, seed, use_energy):
    inputs = chip_smoke.messy_tick_inputs(J, cap, W, seed, deep=use_energy)
    assign, order = ss.scheduler_tick(*_torch(inputs),
                                      use_energy=use_energy)
    want_assign, want_order = _jax_tick(inputs, use_energy, bj=128)
    assert_exact(order.numpy(), want_order)
    assert_exact(assign.numpy(), want_assign)
    assert (want_assign >= 0).any()


@pytest.mark.parametrize("use_energy", [False, True])
@pytest.mark.parametrize("J,cap,W,seed", CASES)
def test_tick_plain_matches_numpy_transcription(J, cap, W, seed,
                                               use_energy):
    inputs = chip_smoke.messy_tick_inputs(J, cap, W, seed, deep=use_energy)
    dev = _torch(inputs)
    ranked, urg, doom = ss.tick_score(*dev[:17], use_energy=use_energy)
    order = ss.tick_order(urg, doom, dev[4])
    assign = ss.greedy_place(ranked, order, dev[4], dev[17])
    want = _numpy_tick(inputs, use_energy)
    for got, exp in zip((assign, order, ranked, urg, doom), want):
        assert_exact(got.numpy(), exp)


def test_messy_inputs_cover_the_hazards():
    """The input sets hold every hazard of the tick's contract: padding rows,
    NaN, +-inf and -0.0 urgencies, NaN costs, inf rows, f32 ties in
    ranked rows, doomed rows, and walks that stop on both conditions."""
    steps = {}
    for deep in (False, True):
        inputs = chip_smoke.messy_tick_inputs(2043, 4096, 256, 7, deep=deep)
        dev = _torch(inputs)
        ranked, urg, doom = ss.tick_score(*dev[:17], use_energy=deep)
        u = urg[:2043]
        assert torch.isnan(u).any() and (u == torch.inf).any()
        assert (u == -torch.inf).any()
        assert ((u == 0) & torch.signbit(u)).any()
        assert doom[:2043].any() and not doom[:2043].all()
        assert (dev[4] < 0).any() and len(torch.unique(dev[13], dim=0)) > 2
        if deep:
            assert torch.isnan(ranked).any()
        low = ranked.amin(dim=1, keepdim=True)
        tied = ((ranked == low) & torch.isfinite(ranked)).sum(dim=1) > 1
        assert tied.any()
        order = ss.tick_order(urg, doom, dev[4])
        assign = ss.greedy_place(ranked, order, dev[4], dev[17])
        steps[deep] = chip_smoke.walk_steps(assign.numpy(), order.numpy(),
                                            inputs[4], inputs[17])
    small = chip_smoke.messy_tick_inputs(200, 512, 64, 3)
    dev = _torch(small)
    r, u, d = ss.tick_score(*dev[:17])
    o = ss.tick_order(u, d, dev[4])
    a = ss.greedy_place(r, o, dev[4], dev[17])
    assert chip_smoke.walk_steps(a.numpy(), o.numpy(), small[4],
                                 small[17]) < 200    # stopped: none open
    assert steps[True] == 2043                       # deep: every row


def test_order_pins_the_lexsort_rules():
    """-0.0 sorts equal to 0.0, every NaN sorts last and equal (queue
    order kept), doomed after undoomed, padding after everything."""
    nan = float("nan")
    urg = torch.tensor([0.0, -0.0, nan, 1.0, -nan, torch.inf, -torch.inf,
                        0.0, nan, -1.0, 5.0, -0.0], dtype=torch.float32)
    doom = torch.tensor([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0],
                        dtype=torch.int8)
    slots = torch.tensor([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, -1, 13],
                         dtype=torch.int32)
    got = ss.tick_order(urg, doom, slots).numpy()
    want = np.asarray(jnp.lexsort((
        jnp.where(jnp.asarray(slots.numpy()) >= 0, urg.numpy(), jnp.inf),
        jnp.where(jnp.asarray(slots.numpy()) >= 0,
                  doom.numpy().astype(np.int32), 2))))
    assert_exact(got, want.astype(np.int32))
    assert list(got) == [6, 0, 1, 7, 11, 3, 5, 2, 4, 9, 8, 10]


def test_greedy_walk_takes_nothing_from_a_nan_or_inf_row():
    ranked = torch.tensor([[torch.inf, torch.inf, torch.inf],
                           [2.0, float("nan"), 1.0],
                           [3.0, 3.0, 1.0],
                           [torch.inf, 0.5, torch.inf]])
    order = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    slots = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    open0 = torch.tensor([True, True, True])
    assign = ss.greedy_place(ranked, order, slots, open0)
    # the all-inf row and the NaN row place nothing; ties go to the lowest
    # index among open workers
    assert assign.tolist() == [-1, -1, 2, 1]


def test_wrappers_check_their_inputs():
    inputs = _torch(chip_smoke.messy_tick_inputs(8, 16, 4, 0))
    bad = list(inputs)
    bad[4] = bad[4].long()
    with pytest.raises(TypeError, match="slots"):
        ss.scheduler_tick(*bad)
    bad = list(inputs)
    bad[14] = bad[14][:3]
    with pytest.raises(ValueError, match="pen"):
        ss.scheduler_tick(*bad)
    with pytest.raises(ValueError, match="pool_ene"):
        ss.scheduler_tick(*inputs[:3], inputs[3][:2], *inputs[4:],
                          use_energy=True)
    # energy off: pool_ene is not read
    assign, order = ss.scheduler_tick(*inputs[:3], None, *inputs[4:])
    assert assign.shape == order.shape == (128,)
