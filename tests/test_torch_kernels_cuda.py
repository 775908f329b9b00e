"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The scheduling, scan and routing kernels are held exactly (NaN matched by
position): kernel and plain version do the same IEEE float32 operations in
the same order.  The attention kernels are held within ``ATTN_TOL``: they
sum in another order (the bf16 flash kernel on the tensor cores).
``chip_smoke.py`` holds the same kernels at the main path's full shapes."""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import moe_routing as mr
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


# (22, 506, 64): the resident main path's mean tick (rows in registers);
# (64, 128, 4100): 8,192 padded workers, rows staged in shared memory;
# (8, 16, 16000): 16,384, rows too wide for it, read from global memory
@pytest.mark.parametrize("J,cap,W", [(1, 8, 1), (7, 64, 33), (301, 512, 64),
                                     (2043, 4096, 256), (22, 506, 64),
                                     (1, 8, 64), (64, 128, 4100),
                                     (8, 16, 16000)])
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


def _walk_inputs(J, W, case, seed):
    """(ranked, order, slots, open0) for the greedy walk: small integer
    costs (ties), +inf scattered, one NaN in some rows and one -inf in
    others (each places nothing); "runs_out" opens fewer workers than there
    are finite rows, so n_open reaches 0 mid-walk; "early_pad" puts a
    padded row third in the order."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ranked = rng.integers(0, 6, (J, W)).astype(np.float32)
    ranked[rng.random((J, W)) < 0.15] = np.inf
    for bad in (np.nan, -np.inf):
        rows = np.nonzero(rng.random(J) < 0.05)[0]
        ranked[rows, rng.integers(0, W, len(rows))] = bad
    slots = np.arange(J, dtype=np.int32)
    open0 = rng.random(W) < 0.8
    if case == "runs_out":
        ranked = np.nan_to_num(ranked, nan=1.0, posinf=2.0, neginf=0.0)
        open0[:] = False
        open0[rng.choice(W, size=max(1, min(W, J) // 2), replace=False)] = True
    order = rng.permutation(J).astype(np.int32)
    if case == "early_pad" and J > 3:
        slots[order[2]] = -1
    return [torch.from_numpy(a).cuda() for a in (ranked, order, slots, open0)]


@pytest.mark.parametrize("W", [1, 31, 33, 64, 1000, 1024, 1025, 2048, 3000,
                               8192, 24576, 40000, 65537])
@pytest.mark.parametrize("J,case", [(1, "messy"), (300, "messy"),
                                    (300, "runs_out"), (40, "early_pad")])
def test_greedy_walk_matches_plain_version(card, J, W, case):
    inputs = _walk_inputs(J, W, case, seed=J * 7 + W)
    before = ss.greedy_place.launches
    assign = ss.greedy_place(*inputs)
    torch.cuda.synchronize()
    assert ss.greedy_place.launches == before + 1
    want = ss.greedy_place_plain(*inputs)
    assert chip_smoke.exact(assign, want)
    if case == "runs_out":
        assert int((want >= 0).sum()) == int(inputs[3].sum())


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
    (1, 65, 64, 1, 16, True, 7),
    # G = 5 (Hymba's grouping); a window narrower than a key tile;
    # non-causal with a window; rows not a multiple of the CTA's
    (2, 150, 25, 5, 64, True, None), (1, 97, 25, 5, 128, True, 40),
    (1, 300, 8, 2, 128, True, 16), (2, 100, 10, 5, 80, False, 24),
    (1, 77, 8, 2, 16, True, None), (1, 45, 8, 2, 256, True, 20)])
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


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (5, 1, True, None), (40, 1, False, None), (100, 37, True, None),
    (37, 100, True, None), (130, 70, True, 16), (64, 200, False, 50)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_other_key_lengths(no_tf32, Sq, Sk, causal, window,
                                              dtype):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(Sq * 1000 + Sk)
    q, k, v = [torch.randn(s, generator=g).to(dtype).cuda()
               for s in ((2, Sq, 8, 128), (2, Sk, 2, 128), (2, Sk, 2, 128))]
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
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


# the decode design below mr.SWITCH_T tokens, the prefill design from it
ROUTER_CASES = [
    (1, 64, 16, 2, "random"), (37, 100, 8, 3, "random"),
    (300, 4096, 16, 2, "random"), (129, 513, 160, 6, "random"),
    (64, 256, 16, 2, "underflow"), (64, 256, 16, 2, "tie"),
    (16, 33, 5, 5, "random"), (17, 31, 1, 1, "random"),
    (1, 4096, 16, 2, "random"), (4, 4096, 16, 2, "random"),
    (8, 4096, 16, 2, "random"), (mr.SWITCH_T - 1, 4096, 16, 2, "random"),
    (mr.SWITCH_T, 4096, 16, 2, "random"), (4, 5120, 160, 6, "random"),
    (4, 4000, 256, 8, "random"), (3, 33, 16, 2, "random")]


@pytest.mark.parametrize("T,D,E,k,case", ROUTER_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routing_kernel_matches_plain_version(card, T, D, E, k, case, dtype):
    x, w = chip_smoke.routing_inputs(T, D, E, dtype, T + D + E, case)
    before = mr.moe_routing.launches
    gates, mask = mr.moe_routing(x, w, k)
    torch.cuda.synchronize()
    assert mr.moe_routing.launches == before + 1
    assert gates.shape == mask.shape == (T, E)
    gates_plain, mask_plain = mr.moe_routing_plain(x, w, k)
    assert chip_smoke.routing_held(gates, mask, gates_plain, mask_plain, k,
                                   case)


@pytest.mark.parametrize("T,D,E,k,case", [
    (1, 64, 16, 2, "random"), (4, 4096, 16, 2, "random"),
    (37, 100, 8, 3, "random"), (4, 5120, 160, 6, "random"),
    (16, 33, 5, 5, "random"), (64, 256, 16, 2, "underflow"),
    (64, 256, 16, 2, "tie"), (600, 4096, 16, 2, "random")])
@pytest.mark.parametrize("design", ["decode", "prefill"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_both_router_designs_match_plain_version(card, T, D, E, k, case,
                                                 design, dtype):
    x, w = chip_smoke.routing_inputs(T, D, E, dtype, T + D + E, case)
    before = mr.moe_routing.launches
    gates, mask = mr.moe_routing(x, w, k, design=design)
    torch.cuda.synchronize()
    assert mr.moe_routing.launches == before + 1
    gates_plain, mask_plain = mr.moe_routing_plain(x, w, k)
    assert chip_smoke.routing_held(gates, mask, gates_plain, mask_plain, k,
                                   case)


def test_router_switch_over_is_the_wrappers(card):
    from repro_torch.kernels import _build
    lib = _build.load("moe_routing")
    assert lib.synergai_moe_routing_switch() == mr.SWITCH_T


def test_routing_kernel_takes_no_token_without_a_launch(card):
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
