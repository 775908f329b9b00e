"""The port's online re-characterization through the fused v2 backend: the
port's ``SynergAI(score_fn=make_torch_score_fn(v2=True, device="cpu"),
recharacterizer=...)`` against the JAX package's
``SynergAI(score_fn=make_pallas_score_fn(v2=True), recharacterizer=...)`` on
the drift cell of ``test_torch_recharacterize.py``.  Exact, as there; a file
of its own because the JAX v2 kernel runs in interpret mode at ~0.3 s a
tick."""

import pytest

import repro.core.pallas_scoring as jx_scoring
from repro_torch.core import scoring
from repro_torch.core.offline import characterize
from test_torch_recharacterize import JAX, PORT, run_drift
from test_torch_recharacterize import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def torch_cd():
    return characterize()


def _v2(pk):
    if pk is PORT:
        return scoring.make_torch_score_fn(v2=True, device="cpu")
    return jx_scoring.make_pallas_score_fn(v2=True)


def test_v2_loop_matches_jax_v2(configdict, torch_cd):
    """The fused v2 backend reads the overlay through the host cache.  This
    case takes 150 jobs and a 32-completion window, which still refreshes
    mid-run and reclaims rows."""
    def make(pk, rc):
        return pk.sched.SynergAI(score_fn=_v2(pk), recharacterizer=rc)

    port = run_drift(PORT, torch_cd, make, 150, {"window": 32})
    jax = run_drift(JAX, configdict, make, 150, {"window": 32})
    assert port[1] == jax[1] and len(port[1]) == 150
    assert port[2] == jax[2] and port[2][0] >= 1
    assert port[0].cache.profile_reclaims == jax[0].cache.profile_reclaims > 0
