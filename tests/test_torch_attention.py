"""The port's attention kernels' plain versions, and the model's routing
to them, against the JAX package.

The same numpy inputs (from a seed) go through the Pallas kernels in
interpret mode, the ``kernels/ref.py`` oracles and the port's wrappers on
CPU tensors (which run the plain versions and launch nothing).  Tolerances
are those of ``tests/test_kernels.py``: rtol = atol = 2e-5 in f32 and 2e-3
in bf16 (both sides accumulate in f32; bf16 rounds the output once).  Ragged
shapes, which the Pallas wrappers reject, are held against the oracles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import common as jcommon
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import common
from repro_torch.models.convert import to_torch

TOL32 = dict(rtol=2e-5, atol=2e-5)
TOL16 = dict(rtol=2e-3, atol=2e-3)
DTYPES = {"float32": (jnp.float32, TOL32), "bfloat16": (jnp.bfloat16, TOL16)}


def inputs(seed, q_shape, kv_shape, dtype):
    """q, k, v as (jax arrays, cpu tensors) with identical bits."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(dtype)
          for s in (q_shape, kv_shape, kv_shape)]
    return jx, [to_torch(np.asarray(a)) for a in jx]


def close(out, want, tol):
    got = out.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("B,S,H,K,hd", [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 256, 4, 1, 128),    # MQA, wide head
    (2, 128, 2, 2, 32),     # small head_dim
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_matches_pallas_and_ref(B, S, H, K, hd, dtype):
    jdt, tol = DTYPES[dtype]
    (q, k, v), (tq, tk, tv) = inputs(0, (B, S, H, hd), (B, S, K, hd), jdt)
    before = fa.flash_attention.launches
    out = fa.flash_attention(tq, tk, tv, causal=True)
    assert fa.flash_attention.launches == before
    assert out.dtype == tq.dtype and out.shape == tq.shape
    close(out, pallas_flash(q, k, v, causal=True, bq=128, bk=128,
                            interpret=True), tol)
    close(out, ref.flash_attention_ref(q, k, v, causal=True), tol)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_plain_sliding_window_matches_pallas(window):
    B, S, H, K, hd = 1, 256, 4, 2, 64
    (q, k, v), (tq, tk, tv) = inputs(1, (B, S, H, hd), (B, S, K, hd),
                                     jnp.float32)
    out = fa.flash_attention(tq, tk, tv, causal=True, window=window)
    close(out, pallas_flash(q, k, v, causal=True, window=window, bq=64,
                            bk=64, interpret=True), TOL32)
    close(out, ref.flash_attention_ref(q, k, v, causal=True, window=window),
          TOL32)


@pytest.mark.parametrize("B,S,H,K,hd,k_valid", [
    (2, 512, 8, 2, 64, 512),
    (1, 1024, 4, 1, 128, 700),   # partially filled cache
    (4, 512, 4, 4, 64, 33),      # barely-warm cache
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_plain_matches_pallas_and_ref(B, S, H, K, hd, k_valid,
                                             dtype):
    jdt, tol = DTYPES[dtype]
    (q, k, v), (tq, tk, tv) = inputs(2, (B, 1, H, hd), (B, S, K, hd), jdt)
    before = da.decode_attention.launches
    out = da.decode_attention(tq, tk, tv, k_valid)
    assert da.decode_attention.launches == before
    assert out.dtype == tq.dtype and out.shape == tq.shape
    close(out, pallas_decode(q, k, v, k_valid, bk=256, interpret=True), tol)
    close(out, ref.decode_attention_ref(q, k, v, k_valid), tol)


@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (2, 100, 8, 2, 80, True, None),     # danube head_dim, ragged length
    (1, 77, 8, 1, 256, True, None),     # gemma MQA
    (3, 130, 4, 2, 16, True, 17),       # window, ragged
    (1, 45, 4, 4, 32, False, None),     # bidirectional
    (1, 1, 4, 2, 64, True, None),       # one token
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_ragged_matches_ref(B, S, H, K, hd, causal, window,
                                       dtype):
    jdt, tol = DTYPES[dtype]
    (q, k, v), (tq, tk, tv) = inputs(3, (B, S, H, hd), (B, S, K, hd), jdt)
    out = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    close(out, ref.flash_attention_ref(q, k, v, causal=causal, window=window),
          tol)


@pytest.mark.parametrize("B,S,H,K,hd,k_valid", [
    (4, 1064, 32, 8, 128, 1025),   # the serving buffer, prompt + 1
    (2, 1000, 8, 2, 80, 777),      # ragged buffer
    (1, 300, 8, 1, 256, 1),        # one valid position
    (2, 50, 4, 2, 16, 50),
    (2, 50, 4, 2, 32, 80),         # k_valid past the buffer
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_plain_ragged_matches_ref(B, S, H, K, hd, k_valid, dtype):
    jdt, tol = DTYPES[dtype]
    (q, k, v), (tq, tk, tv) = inputs(4, (B, 1, H, hd), (B, S, K, hd), jdt)
    out = da.decode_attention(tq, tk, tv, k_valid)
    close(out, ref.decode_attention_ref(q, k, v, k_valid), tol)


@pytest.mark.parametrize("B,K,G,kv_end,hd", [
    (4, 8, 4, 1040, 128),     # the serving path's mean step
    (4, 8, 4, 1, 128), (4, 8, 4, 1024, 128), (4, 8, 4, 1064, 128),
    (2, 1, 8, 2050, 256),     # MQA: the staged partials cap the split
    (2, 5, 5, 999, 64), (1, 2, 4, 8192, 128), (1, 1, 64, 5000, 64),
    (4, 8, 4, 777, 80), (1, 1, 1, 31, 16), (64, 8, 4, 4000, 128)])
def test_plan_splits_cover_the_cache_in_whole_tiles(B, K, G, kv_end, hd):
    n = da.plan_splits(B, K, G, kv_end, hd)
    keys = da.split_keys(n, kv_end)
    assert len(keys) == n and keys[0][0] == 0 and keys[-1][1] == kv_end
    assert all(a < b for a, b in keys)                   # no empty split
    assert all(keys[i][1] == keys[i + 1][0] for i in range(n - 1))
    assert all(a % da.TILE == 0 for a, _ in keys)        # whole tiles
    # two CTAs an SM, less than a row of splits short, where the keys (and
    # the staged partials) allow; never more, unless one split is more
    rows = B * K * da.row_blocks(G)
    staged = da.MERGE_BYTES // (4 * da.rows_per_cta(G) * (hd + 4))
    assert (2 * 132 - rows < n * rows <= 2 * 132
            or n == min(-(-kv_end // da.TILE), staged) or n == 1)
    assert n * rows <= 2 * 132 or n == 1
    assert n * da.rows_per_cta(G) * (hd + 4) * 4 <= da.MERGE_BYTES


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 4, 48)
    with pytest.raises(ValueError, match="head_dim 48"):
        fa.flash_attention(q, torch.zeros(1, 4, 2, 48), torch.zeros(1, 4, 2, 48))
    q = torch.zeros(1, 4, 4, 64)
    kv = torch.zeros(1, 4, 3, 64)
    with pytest.raises(ValueError, match="4 query heads over 3"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(TypeError, match="float16"):
        h = q.half()
        fa.flash_attention(h, h, h)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 64, 4, 4).transpose(1, 3)
        fa.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="window 0"):
        fa.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="2 query tokens"):
        da.decode_attention(torch.zeros(1, 2, 4, 64), q, q, 3)


# ---------------------------------------------------------------------------
# the model's attention routes by shape: a v head dim other than q's and k's
# (MLA: qk 192 / v 128 at full width, 24 / 16 in the reduced deepseek-v2)
# never reaches the kernel wrappers and equals the JAX package's attention


@pytest.mark.parametrize("Sq,Sk,causal,k_valid", [
    (8, 8, True, None),        # prefill, naive
    (1, 16, False, 9),         # one decode token against a cache, naive
    (96, 96, True, None),      # prefill past flash_threshold, chunked flash
    (1, 96, False, 70),        # decode past flash_threshold, chunked flash
])
def test_attention_takes_mla_shapes_off_the_kernels(monkeypatch, Sq, Sk,
                                                    causal, k_valid):
    jcfg = reduced(get_config("deepseek-v2-236b"))
    tcfg = t_reduced(t_get_config("deepseek-v2-236b"))
    qk_hd = jcfg.mla.qk_nope_head_dim + jcfg.mla.qk_rope_head_dim
    v_hd = jcfg.mla.v_head_dim
    assert (qk_hd, v_hd) == (24, 16)
    B, H = 1, 4
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = (rng.standard_normal(s, dtype=np.float32) for s in (
        (B, Sq, H, qk_hd), (B, Sk, H, qk_hd), (B, Sk, H, v_hd)))

    def refuse(*a, **kw):
        raise AssertionError("routed to a kernel wrapper")

    monkeypatch.setattr(common, "flash_attention", refuse)
    monkeypatch.setattr(common, "decode_attention", refuse)
    kw = dict(causal=causal, k_valid=k_valid)
    out = common.attention(tcfg, *map(torch.from_numpy, (q, k, v)), **kw)
    want = jcommon.attention(jcfg, *map(jnp.asarray, (q, k, v)), **kw)
    assert out.shape == (B, Sq, H, v_hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the wrappers still refuse these shapes when called directly
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="do not fit together"):
        (fa.flash_attention(tq, tk, tv) if k_valid is None
         else da.decode_attention(tq, tk, tv, k_valid))


def test_fits_kernels_is_the_wrappers_shape_rule():
    ok = torch.zeros(2, 8, 4, 64), torch.zeros(2, 8, 2, 64)
    assert fa.fits_kernels(ok[0], ok[1], ok[1])
    for q, k, v in [
            (ok[0], ok[1], torch.zeros(2, 8, 2, 32)),          # v head dim
            (torch.zeros(2, 8, 4, 48), torch.zeros(2, 8, 2, 48),
             torch.zeros(2, 8, 2, 48)),                        # head_dim 48
            (ok[0], torch.zeros(2, 8, 3, 64),
             torch.zeros(2, 8, 3, 64)),                        # 4 over 3
            (ok[0], torch.zeros(1, 8, 2, 64),
             torch.zeros(1, 8, 2, 64)),                        # batch
            (ok[0], torch.zeros(2, 0, 2, 64),
             torch.zeros(2, 0, 2, 64))]:                       # no keys
        assert not fa.fits_kernels(q, k, v)
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, v)
