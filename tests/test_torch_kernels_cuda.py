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


# ---------------------------------------------------------------------------
# attention kernels: f32 within 2e-5 (the same f32 math summed in another
# order); bf16 within one bf16 ulp (2**-7 relative: kernel and plain version
# round their f32 results to bf16 independently)

ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
            torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}


def _attn_inputs(q_shape, kv_shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).cuda()
            for s in (q_shape, kv_shape, kv_shape)]


@pytest.fixture
def no_tf32(card):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield card
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (2, 128, 4, 4, 16, True, None), (2, 200, 8, 2, 32, True, None),
    (1, 333, 4, 1, 64, True, 100), (2, 257, 8, 2, 80, True, 64),
    (2, 300, 32, 8, 128, True, None), (1, 190, 8, 1, 256, True, None),
    (1, 70, 4, 2, 64, False, None), (1, 1, 4, 2, 128, True, None),
    (1, 65, 64, 1, 16, True, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(no_tf32, B, S, H, K, hd, causal,
                                            window, dtype):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs((B, S, H, hd), (B, S, K, hd), dtype, S + hd)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("B,S,H,K,hd,k_valid", [
    (2, 64, 4, 4, 16, 64), (2, 1000, 8, 2, 32, 999), (1, 333, 4, 1, 64, 1),
    (4, 1000, 32, 8, 80, 777), (4, 1064, 32, 8, 128, 1025),
    (1, 500, 8, 1, 256, 500), (2, 100, 4, 2, 128, 130),
    (1, 40, 4, 2, 64, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_version(no_tf32, B, S, H, K, hd,
                                             k_valid, dtype):
    from repro_torch.kernels import decode_attention as da
    q, k, v = _attn_inputs((B, 1, H, hd), (B, S, K, hd), dtype, S + hd)
    before = da.decode_attention.launches
    out = da.decode_attention(q, k, v, k_valid)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_plain(q, k, v, k_valid)
    torch.testing.assert_close(out.float(), want.float(), **ATTN_TOL[dtype])


def test_attention_wrappers_refuse_mixed_devices(card):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs((1, 8, 4, 64), (1, 8, 2, 64), torch.float32, 0)
    with pytest.raises(ValueError, match="share dtype and device"):
        fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="share dtype and device"):
        da.decode_attention(q[:, :1], k, v.cpu(), 4)


def test_dense_model_on_the_card_matches_the_cpu(no_tf32):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import InferenceEngine
    cfg = reduced(get_config("h2o-danube-1.8b"), head_dim=80, d_model=320)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = build_model(cfg)
    gparams = _to(params, gpu.device)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    out = InferenceEngine(gpu, gparams, max_len=60).generate(
        {"tokens": toks.cuda()}, 6)
    assert (fa.flash_attention.launches, da.decode_attention.launches) == (
        before[0] + 2, before[1] + 2 * 5)
    want = InferenceEngine(cpu, params, max_len=60).generate(
        {"tokens": toks}, 6)
    assert torch.equal(out.cpu(), want)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# the WKV scan: kernel and plain version do the same f32 roundings in the
# same order (the sum over the key index as one fixed pairwise tree), so y
# and the end state are equal bit for bit, which also meets the smoke's
# tolerance (1e-5 of max |plain|, bf16 y one ulp more)


@pytest.mark.parametrize("B,S,H,hd,with_state", [
    (4, 1024, 32, 64, False), (4, 1, 32, 64, True), (2, 1000, 8, 64, True),
    (2, 333, 8, 16, True), (1, 77, 4, 32, False), (3, 5, 2, 16, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_kernel_matches_plain_version(card, B, S, H, hd, with_state,
                                           dtype):
    from repro_torch.kernels import rwkv_scan as rs
    ins, state = chip_smoke.rwkv_inputs(B, S, H, hd, dtype, S + hd,
                                        with_state)
    before = rs.rwkv_scan.launches
    y, s = rs.rwkv_scan(*ins, state)
    torch.cuda.synchronize()
    assert rs.rwkv_scan.launches == before + 1
    assert y.dtype == dtype and y.shape == (B, S, H, hd)
    assert s.dtype == torch.float32 and s.shape == (B, H, hd, hd)
    y_plain, s_plain = rs.rwkv_scan_plain(*ins, state)
    err, ok = chip_smoke.rwkv_held(y, s, y_plain, s_plain)
    assert ok, err
    assert torch.equal(y, y_plain) and torch.equal(s, s_plain), err
    # in place: the state buffer updated by the kernel itself
    inplace = (state.clone() if with_state
               else torch.zeros((B, H, hd, hd), device="cuda"))
    y2, s2 = rs.rwkv_scan(*ins, inplace, state_out=inplace)
    torch.cuda.synchronize()
    assert s2 is inplace and torch.equal(inplace, s) and torch.equal(y2, y)


def test_rwkv_kernel_takes_zero_steps_without_a_launch(card):
    from repro_torch.kernels import rwkv_scan as rs
    ins, state = chip_smoke.rwkv_inputs(2, 0, 4, 64, torch.float32, 0, True)
    before = rs.rwkv_scan.launches
    y, s = rs.rwkv_scan(*ins, state)
    out = torch.empty_like(state)
    _, s2 = rs.rwkv_scan(*ins, state, state_out=out)
    assert rs.rwkv_scan.launches == before
    assert y.shape == (2, 0, 4, 64) and torch.equal(s, state)
    assert s2 is out and torch.equal(out, state)


def test_rwkv_model_on_the_card_matches_the_cpu(no_tf32):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import InferenceEngine
    cfg = reduced(get_config("rwkv6-1.6b"))
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = build_model(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    before = (rs.rwkv_scan.launches, fa.flash_attention.launches,
              da.decode_attention.launches)
    out = InferenceEngine(gpu, _to(params, gpu.device), max_len=60).generate(
        {"tokens": toks.cuda()}, 6)
    assert (rs.rwkv_scan.launches, fa.flash_attention.launches,
            da.decode_attention.launches) == (
        before[0] + cfg.n_layers * 6, before[1], before[2])
    want = InferenceEngine(cpu, params, max_len=60).generate(
        {"tokens": toks}, 6)
    assert torch.equal(out.cpu(), want)


# ---------------------------------------------------------------------------
# the MoE router: kernel and plain version do the same f32 roundings in the
# same order (lane sums in increasing d, a fixed lane tree, the softmax and
# gate sums in expert-index order, expf as torch.exp), so gates and mask
# are equal bit for bit


@pytest.mark.parametrize("T,D,E,k,case", [
    (1, 64, 16, 2, "random"), (37, 100, 8, 3, "random"),
    (300, 4096, 16, 2, "random"), (129, 513, 160, 6, "random"),
    (64, 256, 16, 2, "underflow"), (64, 256, 16, 2, "tie"),
    (16, 33, 5, 5, "random"), (17, 31, 1, 1, "random")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routing_kernel_matches_plain_version(card, T, D, E, k, case, dtype):
    from repro_torch.kernels import moe_routing as mr
    x, w = chip_smoke.routing_inputs(T, D, E, dtype, T + D + E, case)
    before = mr.moe_routing.launches
    gates, mask = mr.moe_routing(x, w, k)
    torch.cuda.synchronize()
    assert mr.moe_routing.launches == before + 1
    assert gates.shape == mask.shape == (T, E)
    gates_plain, mask_plain = mr.moe_routing_plain(x, w, k)
    assert chip_smoke.routing_held(gates, mask, gates_plain, mask_plain, k,
                                   case)


def test_routing_kernel_takes_no_token_without_a_launch(card):
    from repro_torch.kernels import moe_routing as mr
    x, w = chip_smoke.routing_inputs(0, 64, 16, torch.bfloat16, 0)
    before = mr.moe_routing.launches
    gates, mask = mr.moe_routing(x, w, 2)
    assert mr.moe_routing.launches == before
    assert gates.shape == mask.shape == (0, 16) and gates.is_cuda
    with pytest.raises(ValueError, match="router_w on"):
        mr.moe_routing(x, w.cpu(), 2)


def test_moe_model_on_the_card_matches_the_cpu(no_tf32):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_routing as mr
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import InferenceEngine
    cfg = reduced(get_config("phi3.5-moe-42b-a6.6b"))
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = build_model(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    before = (mr.moe_routing.launches, fa.flash_attention.launches,
              da.decode_attention.launches)
    out = InferenceEngine(gpu, _to(params, gpu.device), max_len=60).generate(
        {"tokens": toks.cuda()}, 6)
    L = cfg.n_layers
    assert (mr.moe_routing.launches, fa.flash_attention.launches,
            da.decode_attention.launches) == (
        before[0] + L * 6, before[1] + L, before[2] + L * 5)
    want = InferenceEngine(cpu, params, max_len=60).generate(
        {"tokens": toks}, 6)
    assert torch.equal(out.cpu(), want)
