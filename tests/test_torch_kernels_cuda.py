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
