"""The precision design of the bf16 flash backward, rehearsed on the CPU.

``flash_attention_bwd_{dkdv,dq}_kernel_mma``
(``kernels/csrc/flash_attention_bwd.cu``) run every product on the tensor
cores, whose operands are bf16.  S = Q K^T and dP = dO V^T are products of
bf16 inputs summed in f32, exact but for the order of the sums; P (for
dV = P^T dO) and dS (for dK = dS^T Q and dQ = dS K) are f32 and must be
rounded to bf16 first.  ``emulate_bwd_kernel`` below repeats the kernels'
arithmetic in plain f32 PyTorch: bf16 products summed in f32; P recomputed
as exp2 in the log2 domain from the forward's natural-log lse
(``scale * log2(e)`` and ``lse * log2(e)`` rounded once each to f32); P and
dS each split into ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` for two
products (or one bf16 operand, to show why not); the dK/dV kernel's order
(the G heads, then query tiles of 64 rows, 32 at hd >= 128) and the dQ
kernel's (key tiles of 64, 32 at hd 128, 16 at hd 256); dK and dQ times
the scale; the final bf16 rounding.

The card holds the kernels to ``flash_attention_bwd_plain`` within
``BWD_REL["bfloat16"]`` = 2^-7 of each output's max |plain| (one bf16 ulp of
the largest element), both sides rounded to bf16.  Rounding alone moves an
element by at most one ulp, which the bound admits; what the arithmetic
adds on top must stay well below it.  The rule: take one bf16 operand only
where the rehearsal's worst value, over every rehearsed shape, is at most
half of 2^-7.  Over the long shapes below, one bf16 P, one bf16 dS or
both (errors of up to 2^-9 of each element, 1.0e-3-2.8e-3 of max |plain|
before the rounding) reach 5.1e-3-5.3e-3 after it, two thirds of the
bound; with both split the arithmetic's own error is ~3e-6 of max |plain|,
far below an ulp, and the worst after the rounding 2.1e-3.  So the kernels
split both.  The emulation is held within the bound at the card tests'
shapes and at S = 1,024-2,048, and to ``jax.vjp`` of the JAX package's
attention at one shape."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models import common as jcommon
from repro_torch.kernels import flash_attention as fa

BWD_REL = 2.0 ** -7               # chip_smoke.BWD_REL["bfloat16"]
HALF = BWD_REL / 2
LOG2E = 1.4426950408889634


def tiles(hd):
    """(query rows of a dK/dV tile, keys of a dQ tile) in the kernels."""
    return (32 if hd >= 128 else 64,
            16 if hd == 256 else 32 if hd >= 128 else 64)


def operands(x, split):
    """x as the tensor cores take it: [bf16(x)], or [hi, lo] with
    hi = bf16(x), lo = bf16(x - hi), each a product of its own."""
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()] if split else [hi]


def emulate_bwd_kernel(q, k, v, out, lse, dout, *, causal=True, window=None,
                       split_p=True, split_ds=True, round_output=True):
    """The bf16 kernels' arithmetic on CPU tensors q, out, dout
    [B, Sq, H, hd], k, v [B, Sk, K, hd] (bf16) and lse [B, H, Sq] (f32):
    (dq, dk, dv) in bf16, or in f32 before the final rounding."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    QT, KT = tiles(hd)
    f32 = torch.float32
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=f32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=f32)
    lse2 = lse.reshape(B, K, G, Sq) * torch.tensor(LOG2E, dtype=f32)
    D = (dout.float() * out.float()).sum(-1)             # the pre-pass

    def heads(x):                                        # [B, K, G, Sq, hd]
        return x.float().reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4)

    Q, dO = heads(q), heads(dout)
    D = D.reshape(B, Sq, K, G).permute(0, 2, 3, 1)
    Kf, Vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))
    visible = fa._visible(Sq, Sk, causal, window, q.device)

    # dK/dV: per key, over the G heads, then query tiles, ascending
    dK = torch.zeros((B, K, Sk, hd))
    dV = torch.zeros((B, K, Sk, hd))
    for g in range(G):
        for q0 in range(0, Sq, QT):
            qs = slice(q0, q0 + QT)
            sT = Kf @ Q[:, :, g, qs].transpose(-1, -2)   # [B, K, Sk, QT]
            pT = torch.exp2(sT * scale_log2 - lse2[:, :, g, None, qs])
            pT = pT.masked_fill(~visible[qs].T, 0.0)
            dpT = Vf @ dO[:, :, g, qs].transpose(-1, -2)
            dsT = pT * (dpT - D[:, :, g, None, qs])
            for part in operands(pT, split_p):
                dV += part @ dO[:, :, g, qs]
            for part in operands(dsT, split_ds):
                dK += part @ Q[:, :, g, qs]

    # dQ: per query row, over key tiles, ascending
    dQ = torch.zeros((B, K, G, Sq, hd))
    for k0 in range(0, Sk, KT):
        ks = slice(k0, k0 + KT)
        kt, vt = Kf[:, :, None, ks], Vf[:, :, None, ks]
        p = torch.exp2(Q @ kt.transpose(-1, -2) * scale_log2
                       - lse2[..., None])
        p = p.masked_fill(~visible[:, ks], 0.0)
        ds = p * (dO @ vt.transpose(-1, -2) - D[..., None])
        for part in operands(ds, split_ds):
            dQ += part @ kt

    dq = (dQ * scale).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    dk = (dK * scale).permute(0, 2, 1, 3)
    dv = dV.permute(0, 2, 1, 3)
    if round_output:
        return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()
    return dq, dk, dv


def bwd_inputs(seed, B, Sq, Sk, H, K, hd, causal, window):
    """q, k, v, dout (bf16, standard normal from a numpy seed) and the
    forward's out and lse (the plain forward)."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                     .bfloat16() for s in ((B, Sq, H, hd), (B, Sk, K, hd),
                                           (B, Sk, K, hd), (B, Sq, H, hd))]
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, return_lse=True)
    return q, k, v, out, lse, dout


def rel_errors(got, want):
    return [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max()) for a, b in zip(got, want)]


# the bf16 BWD_CASES of tests/test_torch_kernels_cuda.py
BWD_CASES = [
    (2, 128, 128, 4, 4, 16, True, None), (2, 200, 200, 8, 2, 32, True, None),
    (1, 333, 333, 4, 1, 64, True, 100), (2, 257, 257, 8, 2, 80, True, 64),
    (1, 190, 190, 8, 1, 256, True, None), (1, 70, 70, 4, 2, 64, False, None),
    (2, 150, 150, 25, 5, 64, True, None), (1, 97, 97, 25, 5, 128, True, 40),
    (2, 100, 100, 10, 5, 80, False, 24), (1, 1, 1, 4, 2, 128, True, None),
    (1, 100, 37, 8, 2, 128, True, None), (1, 37, 100, 8, 2, 128, True, None),
    (1, 64, 200, 8, 2, 16, False, 50), (1, 300, 300, 32, 8, 128, True, None)]
# long rows, where one bf16 operand's errors add up: qwen3-like GQA, MQA at
# hd 256, hymba-like G = 5 windowed, seamless-like non-causal G = 1
LONG_CASES = [
    (1, 1024, 1024, 8, 2, 128, True, None),
    (1, 2048, 2048, 2, 1, 256, True, None),
    (1, 1024, 1024, 10, 2, 64, True, 1024),
    (1, 1024, 1024, 16, 16, 64, False, None)]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal,window",
                         BWD_CASES + LONG_CASES[:3])
def test_emulated_kernels_hold_bwd_rel(B, Sq, Sk, H, K, hd, causal, window):
    q, k, v, out, lse, dout = bwd_inputs(Sq * 31 + hd, B, Sq, Sk, H, K, hd,
                                         causal, window)
    got = emulate_bwd_kernel(q, k, v, out, lse, dout, causal=causal,
                             window=window)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                        causal=causal, window=window)
    # with one key P = 1, so dq and dk are 0 up to the rounding of dP - D,
    # two f32 sums of hd products |dout| |v|: held to that, as on the card
    cancel = (torch.finfo(torch.float32).eps * hd
              * float(dout.float().abs().max() * v.float().abs().max()))
    for name, a, c in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == c.shape
        tol = (cancel if Sk == 1 and name != "dv"
               else BWD_REL * float(c.float().abs().max()))
        assert float((a.float() - c.float()).abs().max()) <= tol, name


def variant_errors(case):
    """Per variant (P, dS split or not): the worst of dq, dk, dv after the
    final bf16 rounding against the plain version, and before it against
    the plain formula in f32 on the same bf16 values."""
    B, Sq, Sk, H, K, hd, causal, window = case
    q, k, v, out, lse, dout = bwd_inputs(Sq + hd, *case)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                        causal=causal, window=window)
    want32 = fa.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
        causal=causal, window=window)
    errors = {}
    for split_p in (False, True):
        for split_ds in (False, True):
            got = emulate_bwd_kernel(q, k, v, out, lse, dout, causal=causal,
                                     window=window, split_p=split_p,
                                     split_ds=split_ds, round_output=False)
            errors[split_p, split_ds] = (
                max(rel_errors([x.bfloat16() for x in got], want)),
                max(rel_errors(got, want32)))
    return errors


def test_only_both_splits_hold_the_half_bound():
    """The rule that chose the split: over the long shapes, one bf16 P, one
    bf16 dS or both exceed half of the bound after the rounding; P and dS
    both split stay within it, their arithmetic ~2^-16 of max |plain|."""
    worst = {}
    for case in LONG_CASES:
        for variant, (after, before) in variant_errors(case).items():
            a, b = worst.get(variant, (0.0, 0.0))
            worst[variant] = (max(a, after), max(b, before))
    for variant in ((False, False), (False, True), (True, False)):
        assert worst[variant][0] > HALF, (variant, worst[variant])
        assert worst[variant][1] > 100 * worst[True, True][1]
    assert worst[True, True][0] <= HALF, worst[True, True]
    assert worst[True, True][1] <= 2.0 ** -16, worst[True, True]


def test_emulated_kernels_match_jax_vjp_of_the_jax_attention():
    """``jax.vjp`` of ``repro.models.common.attention`` (S = 96 takes its
    chunked flash under ``jax.checkpoint``) on the same bf16 inputs; both
    round q, k, v, the output and the gradients to bf16 at other points, so
    held within 2e-2 of max |jax| as in ``test_torch_flash_grad.py``."""
    cfg = reduced(get_config("qwen3-4b"))
    B, S, H, K, hd, window = 2, 96, 8, 2, 64, 40
    assert S >= cfg.flash_threshold
    q, k, v, out, lse, dout = bwd_inputs(11, B, S, S, H, K, hd, True, window)
    jx = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (q, k, v, dout)]
    _, vjp = jax.vjp(lambda a, b, c: jcommon.attention(
        cfg, a, b, c, causal=True, window=window), *jx[:3])
    want = vjp(jx[3])
    got = emulate_bwd_kernel(q, k, v, out, lse, dout, causal=True,
                             window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b.astype(jnp.float32))
        err = np.abs(a.float().numpy() - b).max() / np.abs(b).max()
        assert err <= 2e-2, name
