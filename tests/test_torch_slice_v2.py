"""The fused v2 backend of the port's main path against the JAX package's:
the port's ``Simulator`` + ``SynergAI(score_fn=make_torch_score_fn(v2=True,
device="cpu"))`` against ``SynergAI(score_fn=make_pallas_score_fn(v2=True))``
on the batched + streaming + disaggregated and the job-mode scenarios of
``tests/test_pallas_parity.py``.  Exact, as in ``test_torch_slice.py``; a
file of its own because the Pallas side runs in interpret mode for minutes."""

import pytest

from repro.core.workload import scenario as jx_scenario
from repro_torch.core.offline import characterize
from repro_torch.core.workload import scenario
from test_torch_slice import _mmpp_job, _run_both


@pytest.fixture(scope="module")
def torch_cd():
    return characterize()


def _mmpp_streaming(cd, fleet, jx):
    return (jx_scenario if jx else scenario)(
        cd, "mmpp", n_jobs=120, fleet=fleet, seed=3, utilization=1.0,
        serving="batched", streaming=(2.0, 2.5))


@pytest.mark.parametrize("case", ["batched-streaming-disagg", "job"])
def test_v2_slice_matches_pallas_path(configdict, torch_cd, case):
    if case == "job":
        ref, port = _run_both(configdict, torch_cd, True, _mmpp_job,
                              ((2, 3, 3), {}), seed=5)
    else:
        ref, port = _run_both(configdict, torch_cd, True, _mmpp_streaming,
                              ((2, 3, 3), {"disaggregate": True}), seed=3,
                              serving="batched")
        assert any(r["ttft"] != "nan" for r in port)
        assert any(r["prefill_worker"] for r in port)
    assert port == ref and len(port) == 120
