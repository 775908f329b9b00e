"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The tolerance is exact (NaN matched by position): kernel and plain version
do the same IEEE float32 operations in the same order.  ``chip_smoke.py``
holds the same kernels at the main path's full shapes."""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import scheduler_score as ss

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a kernels)")
    return torch.device("cuda")


@pytest.mark.parametrize("J,W", [(1, 1), (7, 33), (301, 64), (2043, 256)])
@pytest.mark.parametrize("kernel", ["v1", "v2"])
def test_kernel_matches_plain_version(card, kernel, J, W):
    if kernel == "v1":
        wrapper, plain = ss.scheduler_score, ss.scheduler_score_plain
        inputs = chip_smoke.to_card(chip_smoke.messy_v1_inputs(J, W, J))
    else:
        wrapper, plain = ss.scheduler_score_v2, ss.scheduler_score_v2_plain
        inputs = chip_smoke.to_card(chip_smoke.messy_v2_inputs(J, W, J))
    before = wrapper.launches
    out = wrapper(*inputs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = plain(*inputs)
    for a, b in zip(out, ref):
        assert chip_smoke.exact(a, b)


def test_wrapper_refuses_cpu_and_card_tensors_mixed(card):
    inputs = chip_smoke.to_card(chip_smoke.messy_v1_inputs(8, 8, 0))
    inputs[2] = inputs[2].cpu()
    with pytest.raises(ValueError, match="expected cuda"):
        ss.scheduler_score(*inputs)


@pytest.mark.parametrize("J,cap,W", [(1, 8, 1), (7, 64, 33), (301, 512, 64),
                                     (2043, 4096, 256)])
@pytest.mark.parametrize("use_energy", [False, True])
def test_tick_kernels_match_plain_versions(card, J, cap, W, use_energy):
    inputs = chip_smoke.to_card(chip_smoke.messy_tick_inputs(
        J, cap, W, seed=J, deep=use_energy))
    score_in, slots, open0 = inputs[:17], inputs[4], inputs[17]
    before = (ss.tick_score.launches, ss.greedy_place.launches)
    ranked, urg, doom = ss.tick_score(*score_in, use_energy=use_energy)
    want = ss.tick_score_plain(*score_in, use_energy=use_energy)
    for a, b in zip((ranked, urg, doom), want):
        assert chip_smoke.exact(a, b)
    order = ss.tick_order(urg, doom, slots)
    assign = ss.greedy_place(ranked, order, slots, open0)
    torch.cuda.synchronize()
    assert chip_smoke.exact(assign, ss.greedy_place_plain(ranked, order,
                                                          slots, open0))
    assert (ss.tick_score.launches, ss.greedy_place.launches) == (
        before[0] + 1, before[1] + 1)
    whole = ss.scheduler_tick(*inputs, use_energy=use_energy)
    plain = ss.scheduler_tick_plain(*inputs, use_energy=use_energy)
    for a, b in zip(whole, plain):
        assert chip_smoke.exact(a, b)


def test_resident_cache_runs_on_the_card(card):
    from repro_torch.core.offline import characterize
    from repro_torch.core.scheduler import SynergAI
    from repro_torch.core.scoring import make_torch_score_fn
    from repro_torch.core.simulator import Simulator
    from repro_torch.core.workers import synth_fleet
    from repro_torch.core.workload import scenario
    cd = characterize()
    fleet = synth_fleet(1, 2, 2)
    jobs = scenario(cd, "mmpp", n_jobs=60, fleet=fleet, seed=7,
                    utilization=1.2, serving="batched")
    runs = []
    for device in (None, "cpu"):
        pol = SynergAI(score_fn=make_torch_score_fn(device_cache=True,
                                                    device=device))
        res = Simulator(cd, pol, fleet=fleet, seed=7,
                        serving="batched").run(jobs)
        runs.append([(r.job.id, r.worker, r.start, r.end) for r in res])
        assert pol.cache._dt.device.type == (device or "cuda")
    assert runs[0] == runs[1]
