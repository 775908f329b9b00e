"""The precision design of the bf16 flash kernel, rehearsed on the CPU.

``flash_attention_kernel_mma`` (``kernels/csrc/flash_attention.cu``) runs
Q.K^T and P.V on the tensor cores, so it cannot keep the summation order of
``flash_attention_plain``; it is held to it by ``ATTN_TOL`` (bf16: rtol
2**-7, atol 1e-5), not by bit equality.  ``emulate_kernel`` below repeats
the kernel's arithmetic in plain f32 PyTorch: bf16 products summed in f32,
scores scaled into the log2 domain (``scale * log2(e)`` rounded once to
f32) and masked (-1e30, -inf past Sk), the online softmax over the kernel's
key tiles (64 keys, 32 at hd 256) with ``exp2``, and P split into
``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)`` for two P.V products.  The
emulation is held to ``flash_attention_plain`` within ``ATTN_TOL`` at the
card tests' bf16 shapes, and to the JAX package's Pallas kernel in
interpret mode at one shape.  One bf16 P instead of the split does not hold
the bound; that is why the kernel splits it."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as fa

TOL16 = dict(rtol=2.0 ** -7, atol=1e-5)   # ATTN_TOL[bfloat16] of the card
LOG2E = 1.4426950408889634


def emulate_kernel(q, k, v, *, causal=True, window=None, split=True):
    """The bf16 kernel's arithmetic on CPU tensors q [B, Sq, H, hd], k, v
    [B, Sk, K, hd] (bf16); returns [B, Sq, H, hd] in bf16."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    keys = 64 if hd <= 128 else 32
    # rows (position, group head) position-major, as the kernel's CTAs
    Q = q.float().reshape(B, Sq, K, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, K, Sq * G, hd)
    Kf = k.float().permute(0, 2, 1, 3)
    Vf = v.float().permute(0, 2, 1, 3)
    qpos = (torch.arange(Sq * G) // G)[:, None]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    m = torch.full((B, K, Sq * G, 1), -1e30)
    l = torch.zeros((B, K, Sq * G, 1))
    acc = torch.zeros((B, K, Sq * G, hd))
    for k0 in range(0, Sk, keys):
        kpos = torch.arange(k0, k0 + keys)[None, :]
        kt = torch.zeros((B, K, keys, hd))
        vt = torch.zeros((B, K, keys, hd))
        n = min(keys, Sk - k0)
        kt[:, :, :n], vt[:, :, :n] = Kf[:, :, k0:k0 + n], Vf[:, :, k0:k0 + n]
        x = (Q @ kt.transpose(-1, -2)) * scale_log2
        masked = torch.zeros((Sq * G, keys), dtype=torch.bool)
        if causal:
            masked |= kpos > qpos
        if window is not None:
            masked |= qpos - kpos >= window
        x = x.masked_fill(masked, -1e30).masked_fill(kpos >= Sk,
                                                     -math.inf)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr
        if split:
            hi = p.bfloat16().float()
            lo = (p - hi).bfloat16().float()
            acc = acc + hi @ vt + lo @ vt
        else:
            acc = acc + p.bfloat16().float() @ vt
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, K, Sq, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, Sq, H, hd).bfloat16()


def bf16_inputs(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .bfloat16() for s in (q_shape, kv_shape, kv_shape)]


# the bf16 shapes of tests/test_torch_kernels_cuda.py
# (test_flash_kernel_matches_plain_version), the longest cut to <= 200
@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (2, 128, 4, 4, 16, True, None), (2, 200, 8, 2, 32, True, None),
    (1, 200, 4, 1, 64, True, 100), (2, 200, 8, 2, 80, True, 64),
    (2, 200, 32, 8, 128, True, None), (1, 190, 8, 1, 256, True, None),
    (1, 70, 4, 2, 64, False, None), (1, 1, 4, 2, 128, True, None),
    (1, 65, 64, 1, 16, True, 7), (2, 150, 25, 5, 64, True, None),
    (1, 97, 25, 5, 128, True, 40), (1, 200, 8, 2, 128, True, 16),
    (2, 100, 10, 5, 80, False, 24), (1, 77, 8, 2, 16, True, None),
    (1, 45, 8, 2, 256, True, 20)])
def test_emulated_kernel_holds_attn_tol(B, S, H, K, hd, causal, window):
    q, k, v = bf16_inputs(S + hd, (B, S, H, hd), (B, S, K, hd))
    got = emulate_kernel(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL16)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (5, 1, True, None), (100, 37, True, None), (37, 100, True, None),
    (130, 70, True, 16), (64, 200, False, 50)])
def test_emulated_kernel_holds_attn_tol_other_key_lengths(Sq, Sk, causal,
                                                          window):
    rng = np.random.default_rng(Sq * 1000 + Sk)
    q, k, v = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .bfloat16() for s in ((2, Sq, 8, 128), (2, Sk, 2, 128),
                                     (2, Sk, 2, 128))]
    got = emulate_kernel(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL16)


def test_emulated_kernel_matches_pallas_interpret():
    B, S, H, K, hd = 1, 128, 4, 2, 64
    q, k, v = bf16_inputs(3, (B, S, H, hd), (B, S, K, hd))
    got = emulate_kernel(q, k, v, causal=True, window=48)
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (q, k, v))
    want = pallas_flash(jq, jk, jv, causal=True, window=48, bq=64, bk=64,
                        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **TOL16)


def test_one_bf16_p_would_not_hold_the_bound():
    q, k, v = bf16_inputs(7, (2, 200, 32, 128), (2, 200, 8, 128))
    want = fa.flash_attention_plain(q, k, v).float()
    bound = TOL16["atol"] + TOL16["rtol"] * want.abs()

    def outside(**kw):
        return int(((emulate_kernel(q, k, v, **kw).float() - want).abs()
                    > bound).sum())

    assert outside(split=True) == 0
    assert outside(split=False) > 0
