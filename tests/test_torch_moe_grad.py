"""The port's MoE and MLA gradients against the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through ``jax.vjp``/``jax.grad`` of
the JAX model's ``_route_grouped``, ``moe_ffn`` and ``mla_sublayer`` and
through the port's functions on CPU tensors, where the router's gradient is
``MoeRoutingFn`` on ``moe_routing_plain`` and ``moe_routing_bwd_plain``
(the kernels' plain versions, which launch nothing).  Bound: max |delta| <=
1e-5 * max |JAX| for every f32 result (the same f32 math summed in another
order); a bf16 dx within one bf16 ulp of its largest element (both sides
round the same f32 gradient once, and two f32 values 1e-6 apart can round
to neighbouring bf16 values)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models import layers as jlayers
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.kernels import moe_routing as mr
from repro_torch.models import layers
from repro_torch.models.convert import to_torch
from repro_torch.models.registry import build_model
from repro_torch.training.train_step import loss_and_grads

PHI, DEEPSEEK = "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"
REL = 1e-5
BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def held(got, want, rel=REL):
    """max |got - want| <= rel * max |want|, in float64."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def jax_f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def route_case(T, D, E, k, case, seed):
    """x [T, D], W [D, E] (std 1/sqrt(D)) and the gates' cotangent [T, E],
    numpy f32 from a seed.  "underflow": logit 0 leads by > 110, so every
    other probability underflows to 0 and the later picks have p = 0;
    "tie": experts 2 and 3 copy expert 1's column, which leads."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D), dtype=np.float32)
    w = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    if case == "underflow":
        x[:, 0] = 1.0
        w[0, 0] = 120.0
    elif case == "tie":
        x[:, 0] = 1.0
        w[0, 1] = 12.0
        w[:, 2] = w[:, 3] = w[:, 1]
    return x, w, rng.standard_normal((T, E), dtype=np.float32)


def jax_route_vjp(x, w, dg, k):
    """(dx, dW) of ``jax.vjp`` of the JAX ``_route_grouped``'s gates (x as
    one group of one batch row), and its mask."""
    base = reduced(get_config(PHI))
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=w.shape[1], top_k=k))

    def gates(xx, ww):
        return jlayers._route_grouped({"router": ww}, cfg,
                                      xx[None, None])[0][0, 0]

    _, vjp = jax.vjp(gates, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(dg))
    mask = jlayers._route_grouped({"router": jnp.asarray(w)}, cfg,
                                  jnp.asarray(x)[None, None])[1][0, 0]
    return dx, dw, np.asarray(mask)


# (T, D, E, k, case): E = 4, 16 and 160 at top-k 2 and 6, a ragged T over
# two dW chunks, and the underflow and tie rows
BWD_CASES = [(40, 32, 4, 2, "random"), (64, 48, 16, 2, "random"),
             (37, 100, 16, 6, "random"), (300, 96, 160, 6, "random"),
             (96, 40, 160, 2, "random"), (mr.DW_CHUNK + 45, 24, 16, 2,
                                          "random"),
             (32, 24, 4, 2, "underflow"), (32, 24, 16, 6, "underflow"),
             (32, 24, 8, 2, "tie"), (32, 24, 8, 3, "tie")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,E,k,case", BWD_CASES)
def test_bwd_plain_matches_jax_vjp(T, D, E, k, case, dtype):
    x, w, dg = route_case(T, D, E, k, case, seed=T + D + E + k)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jdx, jdw, jmask = jax_route_vjp(jx, w, dg, k)
    tx = torch.from_numpy(jax_f32(jx)).to(getattr(torch, dtype))
    before = mr.moe_routing_bwd.launches
    dx, dw = mr.moe_routing_bwd(tx, torch.from_numpy(w), k,
                                torch.from_numpy(dg))
    assert mr.moe_routing_bwd.launches == before
    assert dx.dtype == tx.dtype and dw.dtype == torch.float32
    assert bool(torch.isfinite(dx.float()).all())
    assert bool(torch.isfinite(dw).all())
    held(dw, jdw)
    if case == "tie":
        # dx cancels to 0: the tied experts' dlogits are opposite and their
        # columns equal.  Both sides' rounding noise is held to 1e-5 of the
        # terms it sums, |dlogits| |W|
        dl = mr._dlogits_rows(tx.float(), torch.from_numpy(w), k,
                              torch.from_numpy(dg))
        terms = float((dl.abs() @ torch.from_numpy(w).abs().T).max())
        for a in (dx.float().numpy(), jax_f32(jdx)):
            assert np.abs(a).max() <= REL * terms
    else:
        held(dx.float(), jax_f32(jdx),
             REL if dtype == "float32" else BF16_ULP)
    _, mask = mr.moe_routing(tx, torch.from_numpy(w), k)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    if case == "underflow":      # picks of probability 0: dlogits 0 there
        assert ((mask.sum(-1) == k) & ((mask[:, 1:] > 0).sum(-1) > 0)).all()
    if case == "tie":            # the lower indices of the tie first
        assert (mask[:, 1:1 + k] == 1).all() and not mask[:, 1 + k:4].any()


def test_bwd_of_no_token_and_one_expert():
    x, w, dg = route_case(0, 16, 8, 2, "random", seed=0)
    dx, dw = mr.moe_routing_bwd(torch.from_numpy(x), torch.from_numpy(w), 2,
                                torch.from_numpy(dg))
    assert dx.shape == (0, 16) and torch.equal(dw, torch.zeros(16, 8))
    x, w, dg = route_case(5, 16, 1, 1, "random", seed=1)
    dx, dw = mr.moe_routing_bwd(torch.from_numpy(x), torch.from_numpy(w), 1,
                                torch.from_numpy(dg))
    # one expert: the gate is 1 whatever x is, so nothing moves it
    assert not dx.any() and not dw.any()
    with pytest.raises(ValueError, match="dgates"):
        mr.moe_routing_bwd(torch.from_numpy(x), torch.from_numpy(w), 1,
                           torch.from_numpy(dg).double())


def test_dw_chunks_sum_in_the_kernels_order():
    """dW over T > DW_CHUNK is the chunks' partials added in chunk order:
    the plain version's ``_dw`` equals that sum written out, bit for bit."""
    T, D, E = 2 * mr.DW_CHUNK + 7, 6, 5
    rng = np.random.default_rng(2)
    xf = torch.from_numpy(rng.standard_normal((T, D), dtype=np.float32))
    dl = torch.from_numpy(rng.standard_normal((T, E), dtype=np.float32))
    want = torch.zeros(D, E)
    for c0 in range(0, T, mr.DW_CHUNK):
        part = torch.zeros(D, E)
        for t in range(c0, min(T, c0 + mr.DW_CHUNK)):
            part = part + xf[t, :, None] * dl[t, None, :]
        want = want + part
    assert torch.equal(mr._dw(xf, dl), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D,E,k,case", [(48, 40, 16, 2, "random"),
                                          (20, 24, 160, 6, "random"),
                                          (32, 24, 8, 2, "underflow"),
                                          (32, 24, 8, 3, "tie")])
def test_routing_fn_grad_matches_autograd_of_the_plain_forward(T, D, E, k,
                                                               case, dtype):
    """``moe_routing`` under grad goes through ``MoeRoutingFn``: its gates
    and mask are the plain version's bits, the mask carries no gradient,
    and its backward (``moe_routing_bwd``) agrees with autograd through
    ``moe_routing_plain``."""
    x, w, dg = route_case(T, D, E, k, case, seed=T + E)
    tx = torch.from_numpy(x).to(dtype)
    tw, tdg = torch.from_numpy(w), torch.from_numpy(dg)
    leaves = [tx.clone().requires_grad_(), tw.clone().requires_grad_()]
    gates, mask = mr.moe_routing(*leaves, k)
    assert type(gates.grad_fn).__name__ == "MoeRoutingFnBackward"
    assert not mask.requires_grad
    want_gates, want_mask = mr.moe_routing_plain(tx, tw, k)
    assert torch.equal(gates.detach(), want_gates)
    assert torch.equal(mask, want_mask)
    got = torch.autograd.grad((gates * tdg).sum(), leaves)
    assert torch.equal(got[0], mr.moe_routing_bwd_plain(tx, tw, k, tdg)[0])
    plain = [tx.clone().requires_grad_(), tw.clone().requires_grad_()]
    want = torch.autograd.grad((mr.moe_routing_plain(*plain, k)[0]
                                * tdg).sum(), plain)
    held(got[1], want[1].numpy())
    if case == "tie":            # dx cancels to 0 (see above)
        dl = mr._dlogits_rows(tx.float(), tw, k, tdg)
        terms = float((dl.abs() @ tw.abs().T).max())
        for a in (got[0], want[0]):
            assert float(a.float().abs().max()) <= REL * terms
    else:
        held(got[0].float(), want[0].float().numpy(),
             REL if dtype == torch.float32 else BF16_ULP)


# ---------------------------------------------------------------------------
# the MoE FFN's gradients, with tokens dropped at capacity


def ffn_cfgs(arch, E, cf):
    """The reduced JAX and port configs of ``arch`` at width 32 with E
    experts, top-2 and capacity factor ``cf``."""
    jcfg = reduced(get_config(arch), d_model=32)
    tcfg = t_reduced(t_get_config(arch), d_model=32)
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, n_experts=E, top_k=2, capacity_factor=cf))
        for c in (jcfg, tcfg))


@pytest.mark.parametrize("S", [200, 512])
@pytest.mark.parametrize("cf", [1.0, 0.5])
@pytest.mark.parametrize("arch,E", [(PHI, 4), (PHI, 8), (DEEPSEEK, 8)])
def test_moe_ffn_grads_match_jax_with_tokens_dropped(arch, E, cf, S):
    """d(sum y . dy) with respect to x, the router, wi, wg, wo (and the
    shared experts' on deepseek-v2) against ``jax.grad`` of the JAX
    ``moe_ffn``, f32, at capacity factors 1.0 and 0.5, where tokens are
    dropped (asserted)."""
    jcfg, tcfg = ffn_cfgs(arch, E, cf)
    jp = jax.tree.map(np.asarray, jlayers.init_moe(jax.random.PRNGKey(E),
                                                   jcfg, jnp.float32))
    rng = np.random.default_rng(S + E)
    x = rng.standard_normal((2, S, 32), dtype=np.float32)
    dy = rng.standard_normal((2, S, 32), dtype=np.float32)

    def jloss(p, xx):
        return (jlayers.moe_ffn(p, jcfg, xx) * dy).sum()

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = jax.tree.map(lambda a: to_torch(a).requires_grad_(), jp)
    tx = torch.from_numpy(x).requires_grad_()
    y = layers.moe_ffn(tp, tcfg, tx)
    names, leaves = zip(*jax.tree_util.tree_flatten_with_path(tp)[0])
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                              [tx, *leaves])
    held(got[0], np.asarray(jgx))
    want = dict(jax.tree_util.tree_flatten_with_path(jgp)[0])
    assert ("shared" in jp) == (arch == DEEPSEEK)
    for name, g in zip(names, got[1:]):
        held(g, np.asarray(want[name]))
    g = min(layers.MOE_CHUNK, S) if S % min(layers.MOE_CHUNK, S) == 0 else S
    capacity = max(2, int(g / E * 2 * cf))
    _, mask = layers._route(tp, tcfg, tx.detach().reshape(-1, 32))
    m = mask.numpy().reshape(2, S // g, g, E)
    assert (m * (np.cumsum(m, axis=2) - 1 >= capacity)).sum() > 0


# ---------------------------------------------------------------------------
# MLA in train mode


@pytest.mark.parametrize("S", [32, 96])
def test_mla_sublayer_trains_as_jax(S):
    """``mla_sublayer(mode="train")`` is the JAX non-decode branch with no
    cache, causal: its output and the gradients of sum y . dy with respect
    to x and every param against JAX's, f32; S = 32 takes the naive
    attention, S = 96 the chunked one (reduced flash threshold 64)."""
    jcfg = reduced(get_config(DEEPSEEK))
    tcfg = t_reduced(t_get_config(DEEPSEEK))
    jp = jax.tree.map(np.asarray, jlayers.init_mla(jax.random.PRNGKey(S),
                                                   jcfg, jnp.float32))
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    dy = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)

    def jrun(p, xx):
        return jlayers.mla_sublayer(p, jcfg, xx, mode="train", cache=None,
                                    pos=None)[0]

    jy = jrun(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    jgp, jgx = jax.grad(lambda p, xx: (jrun(p, xx) * dy).sum(),
                        argnums=(0, 1))(jax.tree.map(jnp.asarray, jp),
                                        jnp.asarray(x))
    tp = {n: to_torch(a).requires_grad_() for n, a in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, cache = layers.mla_sublayer(tp, tcfg, tx, mode="train", cache=None,
                                   pos=None)
    assert cache is None
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    names = sorted(tp)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                              [tx] + [tp[n] for n in names])
    held(got[0], np.asarray(jgx))
    for name, g in zip(names, got[1:]):
        held(g, np.asarray(jgp[name]))


# ---------------------------------------------------------------------------
# the families train


@pytest.mark.parametrize("arch", [PHI, DEEPSEEK])
def test_moe_families_train_and_remat_recomputes_the_same_routing(arch):
    """Both MoE families train, and remat gives the loss and every grad of
    the plain run bit for bit: the recomputed router forward picks the same
    experts.  With remat the router runs twice a layer (the forward and its
    recomputation), its backward once."""
    cfg = t_reduced(t_get_config(arch))
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    calls = {"forward": 0, "backward": 0}
    route, bwd = mr._route, mr.moe_routing_bwd

    def counted_route(*args):
        calls["forward"] += 1
        return route(*args)

    def counted_bwd(*args):
        calls["backward"] += 1
        return bwd(*args)

    runs = []
    for remat in (False, True):
        m = build_model(dataclasses.replace(cfg, remat=remat), device="cpu")
        calls.update(forward=0, backward=0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mr, "_route", counted_route)
            mp.setattr(mr, "moe_routing_bwd", counted_bwd)
            runs.append(loss_and_grads(m, params, batch))
        L = cfg.n_layers
        assert calls == {"forward": L * (2 if remat else 1), "backward": L}
    (loss, grads), (loss_r, grads_r) = runs
    assert torch.isfinite(loss) and torch.equal(loss, loss_r)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_r)):
        assert torch.equal(a, b)
    router = [g for g in tree_leaves(grads) if g.shape[-1] ==
              cfg.moe.n_experts and g.dim() == 3]
    assert router and all(bool(g.any()) for g in router)
