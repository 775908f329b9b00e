"""The port's ``common.chunked_time_scan`` and the Mamba branch's training
path against the JAX package on the CPU.

Inputs, initial carries and cotangents are drawn from numpy seeds; the
branch's params come from the JAX ``init_mamba`` (``branch_params``).
Both sides run in float32, and every value and gradient is held within
``REL`` = 1e-5 of the JAX one, relative to its max |JAX| (the same f32 math
summed in another order).  Lengths 32 and 100 take the scan's flat branch
(not more than a chunk, not a multiple of 64), 256 and 1,024 its chunked
one.  Three steps are scanned: a nonlinear step with a pytree carry (the
loop of steps), the Mamba step one step at a time, and the Mamba step's
``block`` (what training runs: the elementwise terms of a chunk at once,
the recurrence by ``MambaRecurrence``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.models import common, layers
from test_torch_hymba import branch_params

REL = 1e-5
LENGTHS = [32, 100, 256, 1024]
B, D, DI, N = 2, 8, 12, 4


def rel(got, want):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def tanh_steps(rng):
    """A nonlinear step with a (state, running sum) carry and two outputs,
    in JAX and in torch."""
    W = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)

    def jstep(carry, inp):
        h, c = carry
        x, u = inp
        h = jnp.tanh(h @ W + x)
        c = c * u + h.sum(-1)
        return (h, c), (h * u[:, None], c)

    Wt = torch.from_numpy(W)

    def tstep(carry, inp):
        h, c = carry
        x, u = inp
        h = torch.tanh(h @ Wt + x)
        c = c * u + h.sum(-1)
        return (h, c), (h * u[:, None], c)

    return jstep, tstep


def mamba_jstep(A):
    """The JAX ``mamba_branch``'s scan step (src/repro/models/layers.py),
    which is local to that function."""
    def step(h, inp):
        dt_t, B_t, C_t, x_t = inp
        dA = jnp.exp(dt_t[..., None] * A[None])
        dBx = dt_t[..., None] * B_t[:, None, :] * x_t[..., None]
        h = dA * h + dBx
        return h, jnp.einsum("bcn,bn->bc", h, C_t)
    return step


def mamba_inputs(rng, S):
    """A [DI, N], h0 [B, DI, N], xs (dt, B, C, x) [S, B, ...]: dt a
    softplus-sized positive step, A the init's -(1..N) scaled."""
    A = -np.exp(rng.uniform(0.0, 1.5, (DI, N))).astype(np.float32)
    h0 = rng.standard_normal((B, DI, N)).astype(np.float32)
    xs = ((0.1 * np.abs(rng.standard_normal((S, B, DI)))).astype(np.float32),
          rng.standard_normal((S, B, N)).astype(np.float32),
          rng.standard_normal((S, B, N)).astype(np.float32),
          rng.standard_normal((S, B, DI)).astype(np.float32))
    return A, h0, xs


def scan_case(kind, S, seed):
    """(JAX step, torch step, init, xs) for one of the three steps."""
    rng = np.random.default_rng(seed)
    if kind == "tanh":
        jstep, tstep = tanh_steps(rng)
        init = (rng.standard_normal((B, D)).astype(np.float32),
                rng.standard_normal((B,)).astype(np.float32))
        xs = (rng.standard_normal((S, B, D)).astype(np.float32),
              rng.uniform(0.5, 1.0, (S, B)).astype(np.float32))
        return jstep, tstep, init, xs
    A, h0, xs = mamba_inputs(rng, S)
    step = layers.mamba_step(torch.from_numpy(A))
    if kind == "mamba_step":   # the same step without its block
        return mamba_jstep(A), (lambda h, inp: step(h, inp)), h0, xs
    assert hasattr(step, "block")
    return mamba_jstep(A), step, h0, xs


def leaves_requiring_grad(tree):
    return tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(),
                    tree)


@pytest.mark.parametrize("kind", ["tanh", "mamba_step", "mamba_block"])
@pytest.mark.parametrize("S", LENGTHS)
def test_chunked_time_scan_matches_jax(S, kind):
    """The final carry, the stacked ys and the vjp with respect to the
    initial carry and every leaf of xs, against ``jax.vjp`` of the JAX
    ``chunked_time_scan`` with a random cotangent."""
    jstep, tstep, init, xs = scan_case(kind, S, seed=S)
    (jcarry, jys), vjp = jax.vjp(
        lambda c, x: jcommon.chunked_time_scan(jstep, c, x, S), init, xs)
    rng = np.random.default_rng(S + 7)
    cot = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        (jcarry, jys))
    jg_init, jg_xs = vjp(cot)

    tinit, txs = leaves_requiring_grad(init), leaves_requiring_grad(xs)
    carry, ys = common.chunked_time_scan(tstep, tinit, txs, S)
    for got, want in zip(tree_leaves([carry, ys]),
                         jax.tree.leaves((jcarry, jys))):
        assert rel(got, want) <= REL
    torch.autograd.backward(
        tree_leaves([carry, ys]),
        [torch.from_numpy(np.asarray(c)) for c in jax.tree.leaves(cot)])
    for got, want in zip(tree_leaves([tinit, txs]),
                         jax.tree.leaves((jg_init, jg_xs))):
        assert rel(got.grad, want) <= REL


@pytest.mark.parametrize("kind", ["mamba_step", "mamba_block"])
def test_the_scan_saves_chunk_carries_not_steps(kind):
    """At S = 1,024 the storage autograd keeps for the chunked scan's
    backward is its 16 chunks' input carries, S / 64 x the carry's bytes
    (each carry its own storage: a view would keep its whole chunk alive);
    the flat scan of the same steps (one chunk of 1,024) keeps at least a
    carry a step.  Both give the same gradients (within ``REL`` of max |g|:
    the block's einsum may sum a chunk and the whole sequence in other
    orders)."""
    S = 1024
    _, tstep, init, xs = scan_case(kind, S, seed=3)
    carry_bytes = init.nbytes
    grads, saved_bytes = {}, {}
    for chunk in (64, S):
        saved = {}

        def pack(t):
            storage = t.untyped_storage()
            saved[storage.data_ptr()] = storage.nbytes()
            return t

        h0, txs = leaves_requiring_grad(init), leaves_requiring_grad(xs)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            carry, ys = common.chunked_time_scan(tstep, h0, txs, S,
                                                 chunk=chunk)
        (carry.sum() + ys.square().sum()).backward()
        saved_bytes[chunk] = sum(saved.values())
        grads[chunk] = [t.grad for t in tree_leaves([h0, txs])]
    assert saved_bytes[64] == S // 64 * carry_bytes
    assert saved_bytes[S] >= S * carry_bytes
    for a, b in zip(grads[64], grads[S]):
        assert rel(a, b.numpy()) <= REL


@pytest.mark.parametrize("S", [32, 256])
def test_mamba_branch_train_matches_jax_vjp(S):
    """``mamba_branch(mode="train")`` (flat at 32, chunked at 256): its
    output, no cache, and the grads of every param and of x against
    ``jax.vjp`` of the JAX branch in train mode; the output also equals
    the prefill's (``selective_scan``)."""
    jcfg, tcfg, jp, tp = branch_params(S, jnp.float32)
    rng = np.random.default_rng(S + 2)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    y_j, vjp = jax.vjp(
        lambda p, x: jlayers.mamba_branch(p, jcfg, x, mode="train",
                                          cache=None)[0], jp, x)
    cot = rng.standard_normal(y_j.shape).astype(np.float32)
    gp_j, gx_j = vjp(cot)

    tp = tree_map(lambda t: t.clone().requires_grad_(), tp)
    tx = torch.from_numpy(x).requires_grad_()
    y, cache = layers.mamba_branch(tp, tcfg, tx, mode="train", cache=None)
    assert cache is None
    assert rel(y, y_j) <= REL
    y.backward(torch.from_numpy(cot))
    assert rel(tx.grad, gx_j) <= REL
    assert set(tp) == set(gp_j)
    for key, t in tp.items():
        assert rel(t.grad, gp_j[key]) <= REL, key
    with torch.no_grad():
        y_prefill, _ = layers.mamba_branch(tp, tcfg, tx, mode="prefill",
                                           cache=None)
    torch.testing.assert_close(y.detach(), y_prefill, rtol=1e-5, atol=1e-5)


def test_mamba_recurrence_backward_is_autograd_of_the_loop():
    """``MambaRecurrence``'s hand-written backward against autograd of the
    plain loop h_t = dA_t h_{t-1} + dBx_t, from a state and from zeros."""
    rng = np.random.default_rng(5)
    T = 40
    dA = rng.uniform(0.2, 1.0, (T, B, DI, N)).astype(np.float32)
    dBx = rng.standard_normal((T, B, DI, N)).astype(np.float32)
    cot = rng.standard_normal((T, B, DI, N)).astype(np.float32)
    for h0 in (rng.standard_normal((B, DI, N)).astype(np.float32),
               np.zeros((B, DI, N), np.float32)):
        outs = []
        for fn in ("function", "loop"):
            a, b, h = leaves_requiring_grad([dA, dBx, h0])
            if fn == "function":
                hs = layers.MambaRecurrence.apply(a, b, h)
            else:
                states, hh = [], h
                for t in range(T):
                    hh = a[t] * hh + b[t]
                    states.append(hh)
                hs = torch.stack(states)
            hs.backward(torch.from_numpy(cot))
            outs.append([hs.detach(), a.grad, b.grad, h.grad])
        for got, want in zip(*outs):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_hymba_trains_with_the_window_and_the_chunked_scan():
    """The reduced hymba with its 32-wide window binding at S = 256 (four
    chunks of the scan) trains through ``train_loss``: a finite loss, and a
    grad on every leaf, the Mamba params' among them, nonzero."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.training.train_step import loss_and_grads
    cfg = dataclasses.replace(reduced(get_config("hymba-1.5b")), remat=True)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 257)))
    loss, grads = loss_and_grads(model, params, {"tokens": toks[:, :-1],
                                                 "labels": toks[:, 1:]})
    assert torch.isfinite(loss)
    for g in tree_leaves(grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0
