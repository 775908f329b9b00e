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
    (1, 77, 8, 2, 16, True, None), (1, 45, 8, 2, 256, True, 20),
    # seamless-m4t's encoder and cross prefill: G = 1, hd 64, non-causal
    (1, 1024, 16, 16, 64, False, None)])
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


# the one-launch design: the split plan's corners (G = 5 and G = 1, G = 64
# in 8 row blocks, a long cache in many splits, one split, a k_valid on a
# split boundary and past S, hd-256 MQA); three calls in a row must agree
# bit for bit (the merge runs in split order whichever CTA ends last) and
# leave the ticket counters at zero
@pytest.mark.parametrize("B,S,H,K,hd,k_valid", [
    (2, 1000, 25, 5, 64, 999), (2, 300, 4, 4, 128, 300),
    (1, 8192, 8, 2, 128, 8192), (1, 8192, 64, 1, 64, 5000),
    (4, 1064, 32, 8, 128, 1), (4, 1064, 32, 8, 128, 1024),
    (2, 100, 4, 2, 256, 500), (2, 2056, 8, 1, 256, 2050)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_is_one_deterministic_launch(no_tf32, B, S, H, K, hd,
                                                   k_valid, dtype):
    from repro_torch.kernels import decode_attention as da
    q, k, v = _attn_inputs((B, 1, H, hd), (B, S, K, hd), dtype, S + H)
    kv_end = min(k_valid, S)
    n_split = da.plan_splits(B, K, H // K, kv_end, hd)
    if k_valid == 1024:
        assert da.split_keys(n_split, kv_end)[-1][1] == k_valid
        assert k_valid % da.TILE == 0
    before = da.decode_attention.launches
    outs = [da.decode_attention(q, k, v, k_valid) for _ in range(3)]
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 3
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert da.tickets_at_zero(q.device)
    want = da.decode_attention_plain(q, k, v, k_valid)
    torch.testing.assert_close(outs[0].float(), want.float(),
                               **ATTN_TOL[dtype])


# the log-sum-exp instances: one split and many, a k_valid on a split
# boundary, every key masked (k_valid <= 0); the output is the unrounded
# f32 of the instance without lse, bit for bit, and the lse is the plain
# version's logsumexp within 1e-5
@pytest.mark.parametrize("B,S,H,K,hd,k_valid", [
    (2, 64, 4, 4, 16, 64), (1, 40, 4, 2, 64, 0), (4, 1064, 32, 8, 128, 1024),
    (1, 8192, 64, 1, 64, 5000), (2, 1000, 25, 5, 80, -3),
    (1, 2056, 8, 1, 256, 2050), (4, 1000, 40, 8, 128, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_lse_output(no_tf32, B, S, H, K, hd, k_valid, dtype):
    from repro_torch.kernels import decode_attention as da
    q, k, v = _attn_inputs((B, 1, H, hd), (B, S, K, hd), dtype, S + 3 * hd)
    before = da.decode_attention.launches
    out, lse = da.decode_attention(q, k, v, k_valid, return_lse=True)
    plain = da.decode_attention(q, k, v, k_valid)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 2
    assert out.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.equal(out.to(dtype), plain)
    want_out, want_lse = da.decode_attention_plain(q, k, v, k_valid,
                                                   return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, want_out, **ATTN_TOL[dtype])
    assert da.tickets_at_zero(q.device)


def test_decode_kernel_runs_on_two_streams_at_once(no_tf32):
    """Two streams of one device run ``decode_attention`` at once on
    different inputs, 8 calls each, queued behind a ~10 ms spin on each
    stream so that their kernels meet: every output is bit-equal to the
    same call run alone, and the tickets end at 0 (each stream has its
    own)."""
    from repro_torch.kernels import decode_attention as da
    shapes = [(4, 1064, 32, 8, 128, 1024), (2, 2056, 8, 1, 256, 2050)]
    inputs = [_attn_inputs((B, 1, H, hd), (B, S, K, hd), torch.bfloat16, i)
              + [kv] for i, (B, S, H, K, hd, kv) in enumerate(shapes)]
    alone = [da.decode_attention(*x) for x in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    outs = [[], []]
    for st in streams:
        with torch.cuda.stream(st):
            torch.cuda._sleep(20_000_000)
    for _ in range(8):
        for i, (x, st) in enumerate(zip(inputs, streams)):
            with torch.cuda.stream(st):
                outs[i].append(da.decode_attention(*x))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, alone[i]) for o in outs[i]), i
    assert da.tickets_at_zero(inputs[0][0].device)


def test_decode_tile_is_the_wrappers(card):
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    assert _build.load("decode_attention").synergai_decode_tile() == da.TILE


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


# every column-split class (CTAs per (b, h)) at hd 16, 32 and 64, bit-equal
@pytest.mark.parametrize("B,S,H,hd,split", [
    (8, 50, 16, 16, 1), (2, 40, 64, 32, 1), (2, 77, 4, 16, 1),
    (1, 60, 64, 32, 2), (1, 100, 64, 64, 2), (1, 33, 8, 32, 2),
    (1, 90, 32, 64, 4), (1, 129, 2, 64, 4), (3, 17, 5, 64, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_kernel_is_bit_equal_at_every_column_split(card, B, S, H, hd,
                                                        split, dtype):
    from repro_torch.kernels import rwkv_scan as rs
    assert rs.column_split(B, H, hd) == split
    ins, state = chip_smoke.rwkv_inputs(B, S, H, hd, dtype, S + H, True)
    y, s = rs.rwkv_scan(*ins, state)
    y_plain, s_plain = rs.rwkv_scan_plain(*ins, state)
    inplace = state.clone()
    y2, _ = rs.rwkv_scan(*ins, inplace, state_out=inplace)
    torch.cuda.synchronize()
    assert torch.equal(y, y_plain) and torch.equal(s, s_plain)
    assert torch.equal(y2, y) and torch.equal(inplace, s)


def test_rwkv_lanes_are_the_wrappers(card):
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv_scan as rs
    lib = _build.load("rwkv_scan")
    assert (lib.synergai_rwkv_lanes(), lib.synergai_rwkv_cols(),
            lib.synergai_rwkv_chunk()) == (rs.LANES, rs.COLS, rs.CHUNK)
    bwd = _build.load("rwkv_scan_bwd")
    assert bwd.synergai_rwkv_bwd_chunk() == rs.CHUNK
    assert bwd.synergai_rwkv_bwd_steps() == rs.BWD_STEPS
    for hd in rs.HEAD_DIMS:
        assert (bwd.synergai_rwkv_bwd_lanes(hd),
                bwd.synergai_rwkv_bwd_cols(hd)) == rs.BWD_LAYOUT[hd]
        splits = rs.bwd_splits(hd)
        assert (bwd.synergai_rwkv_bwd_min_split(hd),
                bwd.synergai_rwkv_bwd_max_split(hd)) == (splits[0],
                                                         splits[-1])


@pytest.mark.parametrize("B,S,H,hd", [(2, 1000, 8, 64), (1, 64, 2, 32),
                                      (3, 129, 5, 16), (2, 1, 4, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_kernel_writes_the_plain_chunk_states(card, B, S, H, hd, dtype):
    """With ``ckpt`` the kernel writes the states before steps 0, 64, ...
    bit-equal to the plain version's, and y and the end state are the bits
    it gives without them."""
    from repro_torch.kernels import rwkv_scan as rs
    ins, state = chip_smoke.rwkv_inputs(B, S, H, hd, dtype, S + 3, True)
    ck, ck_plain = (torch.full((B, H, rs.n_chunks(S), hd, hd), float("nan"),
                               device="cuda") for _ in range(2))
    y, s = rs._scan(*ins, state, None, ck)
    rs.rwkv_scan_plain(*ins, state, ckpt=ck_plain)
    y0, s0 = rs.rwkv_scan(*ins, state)
    torch.cuda.synchronize()
    assert torch.equal(ck, ck_plain)
    assert torch.equal(y, y0) and torch.equal(s, s0)


# the WKV backward: kernel and plain version do the same f32 roundings in
# the same order (sums over j as the adjacent pairwise tree, over i as the
# forward's tree), so all five outputs are equal bit for bit
@pytest.mark.parametrize("B,S,H,hd,with_state", chip_smoke.RWKV_BWD_HOLDS
                         + ((3, 130, 5, 16, True), (1, 77, 4, 32, False)))
def test_rwkv_backward_kernel_matches_plain_version(card, B, S, H, hd,
                                                    with_state):
    r = chip_smoke.hold_rwkv_bwd(B, S, H, hd, with_state, 3.35e12)
    assert r["exact"] and r["repeat_bit_identical"]


def test_rwkv_backward_takes_zero_steps_without_a_launch(card):
    from repro_torch.kernels import rwkv_scan as rs
    (r, k, v, w, _), state = chip_smoke.rwkv_inputs(2, 0, 4, 64,
                                                    torch.float32, 0, True)
    ckpt = torch.empty((2, 4, 0, 64, 64), device="cuda")
    before = rs.rwkv_scan_bwd.launches
    dr, dk, dv, dw, ds0 = rs.rwkv_scan_bwd(r, k, v, w, ckpt, r, state)
    assert rs.rwkv_scan_bwd.launches == before
    assert dr.shape == (2, 0, 4, 64) and torch.equal(ds0, state)
    with pytest.raises(TypeError, match="takes float32"):
        b = r.to(torch.bfloat16)
        rs.rwkv_scan_bwd(b, b, b, b, ckpt, b)
    with pytest.raises(ValueError, match="ds_end must be"):
        rs.rwkv_scan_bwd(r, k, v, w, ckpt, r, state.cpu())


def test_rwkv_gradient_launches_both_kernels(card):
    """Under grad, ``rwkv_scan`` on card tensors goes through
    ``RwkvScanFn``: one forward launch with the bits of a launch without a
    gradient, one backward launch; the grads are those of the same
    Function on the plain versions (patched in where it launches)."""
    from repro_torch.kernels import rwkv_scan as rs
    ins, state = chip_smoke.rwkv_inputs(2, 300, 4, 64, torch.float32, 5,
                                        True)
    g = torch.Generator().manual_seed(6)
    dy = torch.randn((2, 300, 4, 64), generator=g).cuda()
    ds = torch.randn((2, 4, 64, 64), generator=g).cuda()
    runs = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in ins + [state]]
        before = (rs.rwkv_scan.launches, rs.rwkv_scan_bwd.launches)
        with chip_smoke.patched(chip_smoke.attention_plain_grad()
                                if plain else {}):
            y, end = rs.rwkv_scan(*leaves)
            grads = torch.autograd.grad((y, end), leaves, (dy, ds))
        torch.cuda.synchronize()
        moved = (rs.rwkv_scan.launches - before[0],
                 rs.rwkv_scan_bwd.launches - before[1])
        assert moved == ((0, 0) if plain else (1, 1))
        runs.append((y.detach(), end.detach(), grads))
    y0, end0 = rs.rwkv_scan(*ins, state)
    assert torch.equal(runs[0][0], y0) and torch.equal(runs[0][1], end0)
    for a, b in zip(runs[0], runs[1]):
        for x, z in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, z)


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


# ---------------------------------------------------------------------------
# the router backward: its kernels and moe_routing_bwd_plain do the same f32
# roundings in the same order, so dx and dW are held bit for bit; it uses
# no atomics, so two calls are bit-identical.  T past mr.DW_CHUNK takes the
# merge of the chunks' partials


ROUTER_BWD_CASES = [
    (1, 64, 16, 2, "random"), (37, 100, 8, 3, "random"),
    (300, 4096, 16, 2, "random"), (129, 513, 160, 6, "random"),
    (64, 256, 16, 2, "underflow"), (64, 256, 16, 2, "tie"),
    (16, 33, 5, 5, "random"), (17, 31, 1, 1, "random"),
    (4, 4000, 256, 8, "random"), (mr.DW_CHUNK, 96, 16, 2, "random"),
    (mr.DW_CHUNK + 1, 96, 16, 2, "random"), (1000, 4000, 16, 2, "random"),
    (2 * mr.DW_CHUNK + 77, 130, 24, 3, "random"),
    (2048, 5120, 160, 6, "random")]


@pytest.mark.parametrize("T,D,E,k,case", ROUTER_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_router_backward_kernel_matches_plain_version(card, T, D, E, k, case,
                                                      dtype):
    x, w, dg = chip_smoke.routing_bwd_inputs(T, D, E, dtype, T + D + E, case)
    before = mr.moe_routing_bwd.launches
    dx, dw = mr.moe_routing_bwd(x, w, k, dg)
    again = mr.moe_routing_bwd(x, w, k, dg)
    torch.cuda.synchronize()
    assert mr.moe_routing_bwd.launches == before + 2
    assert dx.dtype == dtype and dx.shape == (T, D) and dw.shape == (D, E)
    want = mr.moe_routing_bwd_plain(x, w, k, dg)
    for a, b, c in zip((dx, dw), again, want):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        assert chip_smoke.exact(a, c) and bool(torch.isfinite(a).all())


def test_router_backward_takes_no_token_without_a_launch(card):
    from repro_torch.kernels import _build
    lib = _build.load("moe_routing_bwd")
    assert lib.synergai_moe_routing_bwd_chunk() == mr.DW_CHUNK
    x, w, dg = chip_smoke.routing_bwd_inputs(0, 64, 16, torch.bfloat16, 0)
    before = mr.moe_routing_bwd.launches
    dx, dw = mr.moe_routing_bwd(x, w, 2, dg)
    assert mr.moe_routing_bwd.launches == before
    assert dx.shape == (0, 64) and dw.is_cuda and not dw.any()
    with pytest.raises(ValueError, match="dgates"):
        mr.moe_routing_bwd(x, w, 2, dg.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routing_gradient_launches_both_kernels(card, dtype):
    """Under grad, ``moe_routing`` on card tensors goes through
    ``MoeRoutingFn``: one forward launch with the gates' bits, one backward
    launch whose dx and dW are the plain backward's."""
    x, w, dg = chip_smoke.routing_bwd_inputs(300, 512, 16, dtype, 3)
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    before = (mr.moe_routing.launches, mr.moe_routing_bwd.launches)
    gates, mask = mr.moe_routing(*leaves, 2)
    got = torch.autograd.grad((gates * dg).sum(), leaves)
    torch.cuda.synchronize()
    assert (mr.moe_routing.launches, mr.moe_routing_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert not mask.requires_grad
    assert chip_smoke.exact(gates.detach(), mr.moe_routing_plain(x, w, 2)[0])
    for a, b in zip(got, mr.moe_routing_bwd_plain(x, w, 2, dg)):
        assert chip_smoke.exact(a, b)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"])
def test_moe_models_train_on_the_card_like_the_cpu(no_tf32, arch):
    """The reduced MoE models (remat on) on the card: 2 router forwards
    and 1 backward a layer, flash 2 and 1 on phi3.5-moe's attention and
    none on MLA's; the loss within 1e-5 and every grad within 1e-4 of its
    max |CPU| of the CPU run's (the attention sums in other orders)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import build_model
    from repro_torch.training.train_step import loss_and_grads
    cfg = reduced(get_config(arch), remat=True)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = build_model(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    wrappers = (mr.moe_routing, mr.moe_routing_bwd, fa.flash_attention,
                fa.flash_attention_bwd)
    before = [f.launches for f in wrappers]
    loss, grads = loss_and_grads(gpu, _to(params, gpu.device),
                                 _to(batch, gpu.device))
    L = cfg.n_layers
    flash = 0 if cfg.mla else L
    assert [f.launches - b for f, b in zip(wrappers, before)] == [
        2 * L, L, 2 * flash, flash]
    want_loss, want = loss_and_grads(cpu, params, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for a, c in zip(tree_leaves(grads), tree_leaves(want)):
        assert float((a.cpu() - c).abs().max()) <= 1e-4 * float(
            c.abs().max())


# ---------------------------------------------------------------------------
# the flash backward: its kernels sum in another order than the plain
# formula, so dq, dk, dv are held within chip_smoke.BWD_REL of each tensor's
# max |plain|; it uses no atomics, so two calls are bit-identical.  bf16
# runs the tensor-core kernels (``_mma``), f32 the FMA ones, by dtype


BWD_CASES = [
    (2, 128, 128, 4, 4, 16, True, None), (2, 200, 200, 8, 2, 32, True, None),
    (1, 333, 333, 4, 1, 64, True, 100), (2, 257, 257, 8, 2, 80, True, 64),
    (1, 190, 190, 8, 1, 256, True, None), (1, 70, 70, 4, 2, 64, False, None),
    (2, 150, 150, 25, 5, 64, True, None), (1, 97, 97, 25, 5, 128, True, 40),
    (2, 100, 100, 10, 5, 80, False, 24), (1, 1, 1, 4, 2, 128, True, None),
    (1, 100, 37, 8, 2, 128, True, None), (1, 37, 100, 8, 2, 128, True, None),
    (1, 64, 200, 8, 2, 16, False, 50), (1, 300, 300, 32, 8, 128, True, None)]
# the tile edges of the mma kernels (64 keys a dK/dV CTA, 16 a warp; query
# tiles of 32 or 64; 64 query rows a dQ CTA): Sq, Sk around one and two
# tiles, causal (Sq != Sk among them) and windowed
EDGE_LENGTHS = (63, 64, 65, 127, 128, 129)


def _bwd_inputs(B, Sq, Sk, H, K, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).cuda()
            for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd),
                      (B, Sq, H, hd))]


def _hold_bwd(B, Sq, Sk, H, K, hd, causal, window, dtype):
    """The backward kernels against their plain version at one shape: dq,
    dk, dv within BWD_REL of max |plain|, two calls bit-identical."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, dout = _bwd_inputs(B, Sq, Sk, H, K, hd, dtype, Sq * 31 + hd)
    out, lse = fa._launch_forward(q, k, v, causal, window, True)
    out_p, lse_p = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, return_lse=True)
    torch.testing.assert_close(lse, lse_p, rtol=2e-5, atol=2e-5)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                 window=window)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 2
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                        causal=causal, window=window)
    dtype_name = str(dtype).split(".")[-1]
    bound = chip_smoke.BWD_REL[dtype_name]
    # with one key P = 1, so dq and dk are 0 up to the rounding of dP - D,
    # two f32 sums of hd products |dout| |v|: held to that, not to max |c|
    cancel = (torch.finfo(torch.float32).eps * hd
              * float(dout.float().abs().max() * v.float().abs().max()))
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype and a.shape == c.shape
        assert torch.equal(a, b)
        tol = (cancel if Sk == 1 and name != "dv"
               else bound * float(c.float().abs().max()))
        assert float((a.float() - c.float()).abs().max()) <= tol, name


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal,window", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_matches_plain_version(no_tf32, B, Sq, Sk, H,
                                                     K, hd, causal, window,
                                                     dtype):
    _hold_bwd(B, Sq, Sk, H, K, hd, causal, window, dtype)


@pytest.mark.parametrize("Sq", EDGE_LENGTHS)
@pytest.mark.parametrize("Sk", EDGE_LENGTHS)
@pytest.mark.parametrize("window", [None, 70])
def test_flash_backward_kernel_at_tile_edges(no_tf32, Sq, Sk, window):
    _hold_bwd(1, Sq, Sk, 8, 2, 128, True, window, torch.bfloat16)


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_runs_the_dtypes_kernels(no_tf32, hd, dtype):
    """At every head dim the kernels take, one call is three launches: in
    bf16 the D pre-pass and the tensor-core (``_mma``) dK/dV and dQ
    kernels, in f32 the FMA ones (the profiler's names)."""
    from repro_torch.kernels import flash_attention as fa
    assert hd in fa.HEAD_DIMS
    q, k, v, dout = _bwd_inputs(1, 100, 100, 4, 2, hd, dtype, hd)
    out, lse = fa._launch_forward(q, k, v, True, None, True)
    device, api = chip_smoke.kernels_per_call(
        lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout), reps=3,
        tries=5)
    assert api == 3
    assert chip_smoke.bwd_kernels_fault(
        device, str(dtype).split(".")[-1]) is None


# G = 5 and hd 256 at ragged lengths, windowed and not, causal and not
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal,window", [
    (1, 129, 65, 10, 2, 80, True, 70), (2, 65, 129, 25, 5, 64, True, None),
    (1, 127, 127, 10, 2, 256, True, 33), (1, 65, 129, 4, 2, 256, False, 40),
    (1, 129, 64, 4, 1, 256, True, None), (1, 200, 200, 5, 1, 32, False, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_other_groupings(no_tf32, B, Sq, Sk, H, K, hd,
                                               causal, window, dtype):
    _hold_bwd(B, Sq, Sk, H, K, hd, causal, window, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradient_on_the_card_runs_the_backward_kernel(no_tf32, dtype):
    from repro_torch.kernels import flash_attention as fa
    q, k, v, dout = _bwd_inputs(2, 96, 96, 8, 2, 64, dtype, 5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    out = fa.flash_attention(*leaves, causal=True, window=40)
    got = torch.autograd.grad(out, leaves, dout)
    assert (fa.flash_attention.launches,
            fa.flash_attention_bwd.launches) == (before[0] + 1,
                                                 before[1] + 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    with chip_smoke.patched(chip_smoke.attention_plain_grad()):
        want = torch.autograd.grad(
            fa.flash_attention(*plain, causal=True, window=40), plain, dout)
    assert (fa.flash_attention.launches,
            fa.flash_attention_bwd.launches) == (before[0] + 1,
                                                 before[1] + 1)
    bound = chip_smoke.BWD_REL[str(dtype).split(".")[-1]]
    for a, c in zip(got, want):
        assert float((a.float() - c.float()).abs().max()) <= 2 * bound * (
            float(c.float().abs().max()))


def test_kernels_without_a_backward_refuse_gradients(card):
    from repro_torch.kernels import decode_attention as da
    q, k, v = _attn_inputs((1, 1, 4, 64), (1, 8, 2, 64), torch.float32, 1)
    leaf = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="training slice"):
        da.decode_attention(leaf, k, v, 8)
    with torch.no_grad():
        da.decode_attention(leaf, k, v, 8)   # no gradient asked for: runs
    da.decode_attention(q, k, v, 8)          # no input requires grad


def test_dense_model_trains_on_the_card_like_the_cpu(no_tf32):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import build_model
    from repro_torch.training.train_step import loss_and_grads
    cfg = reduced(get_config("qwen3-4b"), remat=True)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = build_model(cfg)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    loss, grads = loss_and_grads(gpu, _to(params, gpu.device),
                                 _to(batch, gpu.device))
    L = cfg.n_layers
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (before[0] + 2 * L, before[1] + L)
    want_loss, want = loss_and_grads(cpu, params, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    from repro_torch._tree import tree_leaves
    for a, c in zip(tree_leaves(grads), tree_leaves(want)):
        assert float((a.cpu() - c).abs().max()) <= 1e-4 * float(
            c.abs().max())


@pytest.mark.parametrize("arch", ["hymba-1.5b", "llama-3.2-vision-11b"])
def test_hybrid_and_vlm_models_train_on_the_card_like_the_cpu(no_tf32, arch):
    """The reduced hymba (its 32-wide window binding and the Mamba scan
    chunked at S = 128) and the reduced VLM (cross gates at 0.5), remat on,
    one f32 step on the card: flash 2 and its backward 1 a layer with self
    attention (none on the VLM's cross layers); the loss within 1e-5 and
    every grad and m within 1e-4 and v within 2e-4 (quadratic in the
    grad) of its max |CPU| of the CPU run's, which runs the plain
    versions."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.decoder import build_layout
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_update
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import loss_and_grads
    cfg = reduced(get_config(arch), remat=True)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    if cfg.vision:
        assert chip_smoke.set_gates(params, cfg, 0.5) > 0
    gpu = build_model(cfg)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 129), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.vision:
        batch["vision_embeds"] = 0.02 * torch.randn(
            (2, cfg.vision.n_vision_tokens, cfg.d_model), generator=g)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    runs = []
    for model, p, b in ((gpu, _to(params, gpu.device), _to(batch, gpu.device)),
                        (cpu, params, batch)):
        loss, grads = loss_and_grads(model, p, b)
        _, opt, _ = adamw_update(opt_cfg, p, grads, init_opt_state(p))
        runs.append((float(loss), {
            key: [t.cpu() for t in tree_leaves(tree)] for key, tree in
            (("grad", grads), ("m", opt["m"]), ("v", opt["v"]))}))
    flash = sum(g.n for g in build_layout(cfg) if g.spec.kind != "cross")
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (before[0] + 2 * flash, before[1] + flash)
    (loss, got), (want_loss, want) = runs
    assert abs(loss - want_loss) <= 1e-5 * want_loss
    for key, bound in (("grad", 1e-4), ("m", 1e-4), ("v", 2e-4)):
        for a, c in zip(got[key], want[key]):
            assert float((a - c).abs().max()) <= bound * float(
                c.abs().max()), key


def test_rwkv_model_trains_on_the_card_like_the_cpu(no_tf32):
    """The reduced rwkv6 (head dim 16), remat on, at S = 128 (two chunk
    states), one f32 step on the card: the WKV forward 2 and its backward 1
    a layer, no other kernel; the loss within 1e-5 and every grad and m
    within 1e-4 and v within 2e-4 (quadratic in the grad) of its max |CPU|
    of the CPU run's, which runs the plain versions."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_update
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import loss_and_grads
    cfg = reduced(get_config("rwkv6-1.6b"), remat=True)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = build_model(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 129),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    before = (rs.rwkv_scan.launches, rs.rwkv_scan_bwd.launches,
              fa.flash_attention.launches)
    runs = []
    for model, p, b in ((gpu, _to(params, gpu.device), _to(batch, gpu.device)),
                        (cpu, params, batch)):
        loss, grads = loss_and_grads(model, p, b)
        _, opt, _ = adamw_update(opt_cfg, p, grads, init_opt_state(p))
        runs.append((float(loss), {
            key: [t.cpu() for t in tree_leaves(tree)] for key, tree in
            (("grad", grads), ("m", opt["m"]), ("v", opt["v"]))}))
    L = cfg.n_layers
    assert (rs.rwkv_scan.launches, rs.rwkv_scan_bwd.launches,
            fa.flash_attention.launches) == (before[0] + 2 * L,
                                             before[1] + L, before[2])
    (loss, got), (want_loss, want) = runs
    assert abs(loss - want_loss) <= 1e-5 * want_loss
    for key, bound in (("grad", 1e-4), ("m", 1e-4), ("v", 2e-4)):
        for a, c in zip(got[key], want[key]):
            assert float((a - c).abs().max()) <= bound * float(
                c.abs().max()), key
