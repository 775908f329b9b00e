"""The gradient of the port's flash attention on the CPU.

``flash_attention`` goes through ``FlashAttentionFn`` whenever grad mode is
on and an input requires grad; on CPU tensors its forward is
``flash_attention_plain`` (with the log-sum-exp the kernel writes) and its
backward ``flash_attention_bwd_plain``, the explicit formula
dS = P (dP - D) that the card's ``flash_attention_bwd`` kernel computes.
Held here against autograd of ``flash_attention_plain`` and against
``jax.vjp`` of the JAX package's ``repro.models.common.attention``, which
the JAX package's training differentiates (``naive_attention`` below
``flash_threshold``, ``chunked_flash_attention`` from it), on the same numpy
inputs.  Tolerances, per tensor as max |delta| / max |reference|: 1e-5 in
f32 (the same f32 math summed in another order), 2e-2 with bf16 inputs
(both sides round q, k, v, the output and the gradients to bf16 at other
points)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models import common as jcommon
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.convert import to_torch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_flash_grad",
    Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

REL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def arrays(seed, B, Sq, Sk, H, K, hd, dtype):
    """q, k, v, dout as numpy arrays of ``dtype`` (bf16 as ml_dtypes)."""
    rng = np.random.default_rng(seed)
    shapes = ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd), (B, Sq, H, hd))
    return [np.asarray(jnp.asarray(rng.standard_normal(s, dtype=np.float32))
                       .astype(JDT[dtype])) for s in shapes]


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def port_grads(q, k, v, dout, causal, window, fn=fa.flash_attention):
    tq, tk, tv = (to_torch(a).requires_grad_() for a in (q, k, v))
    out = fn(tq, tk, tv, causal=causal, window=window)
    grads = torch.autograd.grad(out, (tq, tk, tv), to_torch(dout))
    return out, grads


# (B, Sq, Sk, H, K, hd, causal, window): G = 1, 2, 4, 5 and MQA, every head
# dim, causal, windowed and non-causal, ragged lengths, Sq != Sk
CASES = [
    (2, 37, 37, 4, 4, 16, True, None),
    (1, 40, 40, 8, 4, 32, True, 8),
    (2, 33, 33, 8, 2, 64, False, None),
    (1, 29, 29, 10, 2, 80, True, None),
    (1, 24, 24, 4, 1, 128, True, 5),
    (1, 17, 17, 2, 1, 256, False, 6),
    (2, 30, 30, 25, 5, 16, True, 11),
    (1, 21, 34, 8, 8, 64, False, None),
    (1, 34, 21, 6, 3, 32, True, 20),
]


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal,window", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_autograd_of_the_plain_forward(
        B, Sq, Sk, H, K, hd, causal, window, dtype):
    q, k, v, dout = arrays(Sq * 7 + hd, B, Sq, Sk, H, K, hd, dtype)
    fa_before = (fa.flash_attention.launches,
                 fa.flash_attention_bwd.launches)
    out, got = port_grads(q, k, v, dout, causal, window)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    want_out, want = port_grads(q, k, v, dout, causal, window,
                                fn=fa.flash_attention_plain)
    assert torch.equal(out, want_out)
    assert (fa.flash_attention.launches,
            fa.flash_attention_bwd.launches) == fa_before
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert rel(a.float(), b.float()) <= REL[dtype], name


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal,window", CASES[:6])
def test_plain_backward_direct_call_equals_the_function(
        B, Sq, Sk, H, K, hd, causal, window):
    """``flash_attention_bwd`` on CPU tensors is the plain formula, fed the
    forward's output and lse."""
    q, k, v, dout = (to_torch(a) for a in
                     arrays(3, B, Sq, Sk, H, K, hd, "float32"))
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    direct = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                    window=window)
    _, via_fn = port_grads(*(a.numpy() for a in (q, k, v, dout)), causal,
                           window)
    for a, b in zip(direct, via_fn):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", [48, 96])       # naive, chunked flash
@pytest.mark.parametrize("H,K,hd,causal,window", [
    (4, 4, 16, True, None), (4, 2, 64, True, 16), (10, 2, 80, False, None),
    (5, 1, 16, True, None), (25, 5, 16, False, 20)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradient_matches_jax_grad_of_the_jax_attention(S, H, K, hd, causal,
                                                       window, dtype):
    """``jax.vjp`` of ``repro.models.common.attention`` with the reduced
    config (flash_threshold 64, chunk 32): S = 48 takes ``naive_attention``,
    S = 96 ``chunked_flash_attention`` under ``jax.checkpoint``."""
    cfg = reduced(get_config("qwen3-4b"))
    assert (S >= cfg.flash_threshold) == (S == 96)
    assert 96 % cfg.attn_chunk == 0
    q, k, v, dout = arrays(S + H + hd, 2, S, S, H, K, hd, dtype)
    out, vjp = jax.vjp(lambda a, b, c: jcommon.attention(
        cfg, a, b, c, causal=causal, window=window), *(jnp.asarray(x)
                                                      for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tout, got = port_grads(q, k, v, dout, causal, window)
    assert rel(tout.detach().float(),
               np.asarray(out, np.float32)) <= REL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert rel(a.float(), np.asarray(b, np.float32)) <= REL[dtype], name


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None), (False, 9)])
def test_saved_lse_is_logsumexp_of_the_masked_scores(causal, window):
    B, S, H, K, hd = 2, 30, 6, 2, 32
    q, k, v, _ = arrays(5, B, S, S, H, K, hd, "float32")
    tq, tk, tv = (to_torch(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    saved = out.grad_fn.saved_tensors
    assert [t.shape for t in saved[:4]] == [tq.shape, tk.shape, tv.shape,
                                            out.shape]
    lse = saved[4]
    G = H // K
    s = np.einsum("bqkgh,bskh->bkgqs",
                  q.astype(np.float64).reshape(B, S, K, G, hd),
                  k.astype(np.float64)) / np.sqrt(hd)
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= qp - kp < window
    s = np.where(ok, s, -1e30)
    m = s.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(B, H, S)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


def test_no_grad_takes_no_function_and_plain_grad_is_plain():
    """Without grad no Function is taken; ``chip_smoke``'s reference for a
    training step on the card (the plain versions patched in where
    ``FlashAttentionFn`` launches the kernels) is the CPU Function's
    arithmetic, bit for bit."""
    arrs = arrays(7, 1, 20, 20, 4, 2, 16, "float32")
    q, k, v, _ = (to_torch(a) for a in arrs)
    assert fa.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert fa.flash_attention(q.requires_grad_(), k, v).grad_fn is None
    out, lse = chip_smoke.plain_launch_forward(q, k, v, True, 3, True)
    saved = fa.FlashAttentionFn.apply(q, k, v, True, 3).grad_fn.saved_tensors
    assert torch.equal(out, saved[3]) and torch.equal(lse, saved[4])
    out, none = chip_smoke.plain_launch_forward(q, k, v, False, None, False)
    assert none is None and torch.equal(
        out, fa.flash_attention_plain(q, k, v, causal=False))
    _, via_kernel_path = port_grads(*arrs, True, None)
    with chip_smoke.patched(chip_smoke.attention_plain_grad()):
        assert fa._launch_forward is chip_smoke.plain_launch_forward
        assert fa.flash_attention_bwd is fa.flash_attention_bwd_plain
        _, plain = port_grads(*arrs, True, None)
    for a, b in zip(via_kernel_path, plain):
        assert torch.equal(a, b)


def test_the_backward_refuses_what_it_cannot_define():
    q, k, v, dout = (to_torch(a) for a in
                     arrays(8, 1, 40, 10, 4, 2, 16, "float32"))
    # under a window of 30, query rows 39 and up see no key of 10
    with pytest.raises(ValueError, match="see no key"):
        fa.flash_attention(q.requires_grad_(), k, v, causal=True, window=30)
    out, lse = fa.flash_attention_plain(q.detach(), k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd(q.detach(), k, v, out, lse[:, :2], dout)
    with pytest.raises(ValueError, match="dout must be"):
        fa.flash_attention_bwd(q.detach(), k, v, out, lse, dout[:, :5])
