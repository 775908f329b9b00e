"""The WKV scan's gradient (``RwkvScanFn``, ``rwkv_scan_bwd_plain``) and the
RWKV6 layers' training mode against the JAX package on the CPU.

Inputs, start states and cotangents are drawn from numpy seeds.  Both
sides run in float32, and every value and gradient is held within ``REL``
= 1e-5 of the reference, relative to its max |reference| (the same f32
math summed in another order).  The JAX side is ``jax.vjp`` of the JAX
time mix's step (local to ``rwkv_time_mix``, copied here) under JAX's
``chunked_time_scan``: flat at S = 32 and 100 (not more than a chunk, not
a multiple of 64), chunked at 256 and 1,024.  The backward kernel's
summation order is rehearsed in the lane layout (``lane_bwd``) and must
equal the plain version bit for bit, as the card holds the kernel to it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro_torch._tree import tree_map
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.kernels import rwkv_scan as rs
from repro_torch.models import common, layers
from test_torch_rwkv import layer_params, scan_inputs

REL = 1e-5
LENGTHS = [32, 100, 256, 1024]


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def rel(got, want):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def jax_step(u):
    """The JAX ``rwkv_time_mix``'s scan step (src/repro/models/layers.py),
    which is local to that function."""
    def step(state, inp):
        rt, kt, vt, wt = inp  # [B, H, hd]
        kv = kt[..., :, None] * vt[..., None, :]
        out = jnp.einsum("bhk,bhkv->bhv", rt,
                         state + u[None, :, :, None] * kv)
        return wt[..., :, None] * state + kv, out
    return step


def torch_step(u):
    """The same step in torch, for ``common.chunked_time_scan``."""
    def step(state, inp):
        rt, kt, vt, wt = inp
        kv = kt[..., :, None] * vt[..., None, :]
        out = torch.einsum("bhk,bhkv->bhv", rt,
                           state + u[None, :, :, None] * kv)
        return wt[..., :, None] * state + kv, out
    return step


def case(S, hd, from_state, B=1, H=2):
    """(r, k, v, w, u, s0) as f32 numpy (s0 zeros unless ``from_state``)
    and the cotangents (dy, d end state; the latter zeros unless
    ``from_state``, as in training)."""
    (r, k, v, w, u), s0 = scan_inputs(S + hd + from_state, B, S, H, hd,
                                      state=True)
    if not from_state:
        s0 = np.zeros_like(s0)
    rng = np.random.default_rng(S * hd + 1)
    dy = rng.standard_normal(r.shape, dtype=np.float32)
    ds = (rng.standard_normal(s0.shape, dtype=np.float32) if from_state
          else np.zeros_like(s0))
    return (r, k, v, w, u, s0), (dy, ds)


def jax_vjp(arrays, cot):
    """The end state, the ys and the vjp of JAX's chunked scan with respect
    to r, k, v, w, u and the start state."""
    S = arrays[0].shape[1]

    def f(r, k, v, w, u, s0):
        xs = tuple(a.transpose(1, 0, 2, 3) for a in (r, k, v, w))
        end, ys = jcommon.chunked_time_scan(jax_step(u), s0, xs, S)
        return ys.transpose(1, 0, 2, 3), end
    (y, end), vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    return y, end, vjp(tuple(jnp.asarray(c) for c in cot))


def port_grads(arrays, cot, from_state):
    """y, the end state and the grads of r, k, v, w, u (and the start
    state) through ``rwkv_scan``'s ``RwkvScanFn``."""
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    state = leaves[5] if from_state else None
    before = (rs.rwkv_scan.launches, rs.rwkv_scan_bwd.launches)
    y, end = rs.rwkv_scan(*leaves[:5], state)
    assert y.grad_fn is not None and "RwkvScanFn" in type(y.grad_fn).__name__
    torch.autograd.backward([y, end], [torch.from_numpy(c) for c in cot])
    assert (rs.rwkv_scan.launches, rs.rwkv_scan_bwd.launches) == before
    return y, end, [t.grad for t in leaves[:5 + from_state]]


@pytest.mark.parametrize("from_state", [False, True],
                         ids=["zeros", "state"])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("S", LENGTHS)
def test_scan_gradient_matches_jax_vjp(S, hd, from_state):
    """y, the end state and the gradients of r, k, v, w, u (and of the
    start state, with a nonzero end-state cotangent) against ``jax.vjp``
    of the JAX step under JAX's ``chunked_time_scan``."""
    arrays, cot = case(S, hd, from_state)
    y_j, end_j, grads_j = jax_vjp(arrays, cot)
    y, end, grads = port_grads(arrays, cot, from_state)
    assert rel(y, y_j) <= REL and rel(end, end_j) <= REL
    for name, got, want in zip("r k v w u s0".split(), grads, grads_j):
        assert rel(got, want) <= REL, name


@pytest.mark.parametrize("S", [100, 256])
def test_scan_gradient_matches_autograd_of_the_chunked_time_scan(S):
    """The same against torch autograd of the port's step under the port's
    ``common.chunked_time_scan`` (flat at 100, four checkpointed chunks at
    256), from a start state with a nonzero end-state cotangent."""
    arrays, cot = case(S, 32, True, B=2)
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    r, k, v, w, u, s0 = leaves
    end, ys = common.chunked_time_scan(
        torch_step(u), s0, tuple(a.transpose(0, 1) for a in (r, k, v, w)), S)
    torch.autograd.backward([ys.transpose(0, 1), end],
                            [torch.from_numpy(c) for c in cot])
    y_p, end_p, grads = port_grads(arrays, cot, True)
    assert rel(y_p, ys.transpose(0, 1).detach().numpy()) <= REL
    assert rel(end_p, end.detach().numpy()) <= REL
    for name, got, t in zip("r k v w u s0".split(), grads, leaves):
        assert rel(got, t.grad.numpy()) <= REL, name


def test_the_forward_under_grad_gives_the_bits_without_it():
    (r, k, v, w, u, s0), _ = case(130, 16, True, B=2)
    ins = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    y, end = rs.rwkv_scan(*ins)
    y_g, end_g = rs.rwkv_scan(*(t.clone().requires_grad_() for t in ins))
    assert torch.equal(y, y_g.detach()) and torch.equal(end, end_g.detach())


@pytest.mark.parametrize("S", [1, 64, 65, 200])
def test_ckpt_holds_the_states_at_chunk_starts(S):
    """``ckpt``[:, :, c] is the state before step 64 c, bit for bit: the
    start state at 0, then the end state of a scan over the first 64 c
    steps."""
    (r, k, v, w, u, s0), _ = case(S, 16, True, B=2)
    ins = [torch.from_numpy(a) for a in (r, k, v, w)]
    u, s0 = torch.from_numpy(u), torch.from_numpy(s0)
    ckpt = torch.full((2, 2, rs.n_chunks(S), 16, 16), float("nan"))
    y, end = rs.rwkv_scan_plain(*ins, u, s0, ckpt=ckpt)
    y0, end0 = rs.rwkv_scan_plain(*ins, u, s0)
    assert torch.equal(y, y0) and torch.equal(end, end0)
    for c in range(rs.n_chunks(S)):
        _, want = rs.rwkv_scan_plain(*(t[:, :rs.CHUNK * c] for t in ins), u,
                                     s0)
        assert torch.equal(ckpt[:, :, c], want), c


def lane_bwd(r, k, v, w, ckpt, dy, ds_end, split=None):
    """The backward kernel's arithmetic, in torch on the CPU, in its layout
    (``rs.BWD_LAYOUT``): a head's columns split over ``split`` CTAs (the
    wrapper's ``bwd_split`` by default), lane t of a column group of L
    lanes holding rows i = t + L m (m < M = hd / L) of NC adjacent columns,
    32 / L groups a warp; the chunk walked back in groups of
    ``BWD_STEPS`` steps, each group's states recomputed from the one kept
    before it.  Sums over i: the lane's rows as the forward's tree (m with
    m + M/2, ...), then the lanes at xor distances L/2 .. 1.  Sums over j:
    a thread's NC columns as the adjacent tree, then the column groups of
    a warp at xor distances 1, 2, ... (the kernel's reduce-scatter adds
    the same pairs), then the head's warps, CTA rank by rank, as one
    adjacent tree (the cluster's merge)."""
    B, S, H, hd = r.shape
    L, NC = rs.BWD_LAYOUT[hd]
    M, GW = hd // L, 32 // L
    leaves = hd // (GW * NC)
    split = rs.bwd_split(B, H, hd) if split is None else split
    nw = leaves // split                              # warps a CTA
    assert split in rs.bwd_splits(hd) and nw * split == leaves
    g = ds_end.clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))

    def step_to(s, t):
        return (w[:, t, :, :, None] * s
                + k[:, t, :, :, None] * v[:, t, :, None, :])

    for c in reversed(range(rs.n_chunks(S))):
        t0, t1 = c * rs.CHUNK, min(S, (c + 1) * rs.CHUNK)
        s = ckpt[:, :, c]
        kept = [s]                                    # before each group
        for t in range(t0, t1 - 1):
            s = step_to(s, t)
            if (t + 1 - t0) % rs.BWD_STEPS == 0:
                kept.append(s)
        for q in reversed(range(len(kept))):
            g0 = t0 + q * rs.BWD_STEPS
            states = [kept[q]]
            for t in range(g0, min(t1, g0 + rs.BWD_STEPS) - 1):
                states.append(step_to(states[-1], t))
            for t in reversed(range(g0, min(t1, g0 + rs.BWD_STEPS))):
                s = states[t - g0]
                x = (g * k[:, t, :, :, None]).reshape(B, H, M, L, hd)
                while x.shape[2] > 1:                 # a lane's own rows
                    x = (x[:, :, :x.shape[2] // 2]
                         + x[:, :, x.shape[2] // 2:])
                x = x[:, :, 0]                        # [B, H, lane, j]
                off = L // 2
                while off:                            # across the lanes
                    x = x + x[:, :, [lane ^ off for lane in range(L)]]
                    off //= 2
                dv[:, t] = x[:, :, 0]
                for out, p in ((dr, dy[:, t, :, None, :] * s),
                               (dk, g * v[:, t, :, None, :]), (dw, g * s)):
                    x = p.reshape(B, H, hd, split, nw, GW, NC)
                    while x.shape[-1] > 1:            # a thread's columns
                        x = x[..., 0::2] + x[..., 1::2]
                    x = x[..., 0]
                    bit = 1
                    while bit < GW:                   # a warp's groups
                        x = x + x[..., [gw ^ bit for gw in range(GW)]]
                        bit *= 2
                    x = x[..., 0].reshape(B, H, hd, leaves)  # rank, warp
                    while x.shape[-1] > 1:            # the cluster's merge
                        x = x[..., 0::2] + x[..., 1::2]
                    out[:, t] = x[..., 0]
                g = (w[:, t, :, :, None] * g
                     + r[:, t, :, :, None] * dy[:, t, :, None, :])
    return dr, dk, dv, dw, g


SHAPES = [(1, 64, 2, 16), (2, 130, 2, 32), (1, 100, 2, 64), (2, 1, 1, 64),
          (1, 333, 1, 16)]


def bwd_case(B, S, H, hd):
    (r, k, v, w, u, s0), (dy, ds) = case(S, hd, True, B=B, H=H)
    r, k, v, w, dy = (torch.from_numpy(a) for a in (r, k, v, w, dy))
    u, s0, ds = (torch.from_numpy(a) for a in (u, s0, ds))
    ckpt = torch.empty((B, H, rs.n_chunks(S), hd, hd))
    rs.rwkv_scan_plain(r, k, v, w, u, s0, ckpt=ckpt)
    return r, k, v, w, ckpt, dy, ds


@pytest.mark.parametrize("B,S,H,hd", SHAPES)
def test_kernel_order_is_the_plain_backwards(B, S, H, hd):
    """``lane_bwd`` at the split the wrapper picks equals
    ``rwkv_scan_bwd_plain`` bit for bit (all five outputs), from a start
    state with a nonzero end-state cotangent."""
    args = bwd_case(B, S, H, hd)
    got = lane_bwd(*args)
    want = rs.rwkv_scan_bwd(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,S,H,hd,split", [
    shape + (split,) for shape in SHAPES for split in rs.bwd_splits(shape[3])])
def test_kernel_order_is_the_plain_backwards_at_every_split(B, S, H, hd,
                                                            split):
    """The same at every split the backward kernel takes for hd 16 (1),
    32 (1, 2) and 64 (2, 4, 8): a CTA's columns are an aligned block, so
    its partials are subtrees of the plain version's adjacent tree."""
    args = bwd_case(B, S, H, hd)
    want = rs.rwkv_scan_bwd_plain(*args)
    for a, b in zip(lane_bwd(*args, split=split), want):
        assert torch.equal(a, b)


def test_the_backward_split_fills_the_card_a_warp_a_cta():
    """At rwkv6's training shape [2, 4096, 32, 64] the backward runs >= 128
    CTAs; every pick leaves a CTA a warp at least and ``BWD_MAX_WARPS`` at
    most, a cluster ``BWD_MAX_SPLIT`` CTAs at most, and reaches 128 CTAs
    where those allow it."""
    assert 2 * 32 * rs.bwd_split(2, 32, 64) >= rs.TARGET_CTAS
    for hd in rs.HEAD_DIMS:
        lanes, cols = rs.BWD_LAYOUT[hd]
        warps = hd // (32 // lanes * cols)            # warps a head
        for BH in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            split = rs.bwd_split(1, BH, hd)
            assert split in rs.bwd_splits(hd)
            assert 1 <= warps // split <= rs.BWD_MAX_WARPS
            assert split <= rs.BWD_MAX_SPLIT
            assert BH * split >= rs.TARGET_CTAS or split == max(
                rs.bwd_splits(hd))
            assert split == min(rs.bwd_splits(hd)) or (
                BH * split // 2 < rs.TARGET_CTAS)


def test_zero_steps_give_the_end_cotangent():
    (r, k, v, w, _, _), (dy, ds) = case(0, 16, True)
    ins = [torch.from_numpy(a) for a in (r, k, v, w, dy)]
    ckpt = torch.empty((1, 2, 0, 16, 16))
    dr, dk, dv, dw, ds0 = rs.rwkv_scan_bwd(*ins[:4], ckpt, ins[4],
                                           torch.from_numpy(ds))
    assert dr.shape == (1, 0, 2, 16) and torch.equal(ds0,
                                                     torch.from_numpy(ds))


def test_the_scan_saves_chunk_states_not_steps():
    """At S = 1,024 the storage autograd keeps for ``RwkvScanFn``'s
    backward is its inputs and 16 chunk states, S / 64 states (JAX's
    ``chunked_time_scan`` keeps the chunks' input carries); the gradient
    comes out as without the hooks."""
    S, B, H, hd = 1024, 1, 2, 16
    (r, k, v, w, u, _), (dy, _) = case(S, hd, False, B=B, H=H)
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (r, k, v, w, u)]
    saved = {}

    def pack(t):
        storage = t.untyped_storage()
        saved[storage.data_ptr()] = storage.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = rs.rwkv_scan(*leaves)
    y.backward(torch.from_numpy(dy))
    state_bytes = B * H * hd * hd * 4
    inputs = sum(a.nbytes for a in (r, k, v, w, u))
    assert sum(saved.values()) == inputs + S // 64 * state_bytes
    _, _, grads = port_grads((r, k, v, w, u, np.zeros((B, H, hd, hd),
                                                      np.float32)),
                             (dy, np.zeros((B, H, hd, hd), np.float32)),
                             False)
    for t, want in zip(leaves, grads):
        assert torch.equal(t.grad, want)


def test_the_backward_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 2, 16)
    ckpt = torch.zeros(1, 2, 1, 16, 16)
    b = x.to(torch.bfloat16)
    with pytest.raises(TypeError, match="takes float32"):
        rs.rwkv_scan_bwd(b, b, b, b, ckpt, b)
    with pytest.raises(ValueError, match="share shape"):
        rs.rwkv_scan_bwd(x, x, x, x, ckpt, torch.zeros(1, 5, 2, 16))
    with pytest.raises(ValueError, match="ckpt must be"):
        rs.rwkv_scan_bwd(x, x, x, x, torch.zeros(1, 2, 2, 16, 16), x)
    with pytest.raises(ValueError, match="ds_end must be"):
        rs.rwkv_scan_bwd(x, x, x, x, ckpt, x, torch.zeros(1, 2, 16, 8))
    with pytest.raises(ValueError, match="head_dim 48"):
        y = torch.zeros(1, 4, 2, 48)
        rs.rwkv_scan_bwd(y, y, y, y, torch.zeros(1, 2, 1, 48, 48), y)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 16, 2, 4).transpose(1, 3)
        rs.rwkv_scan_bwd(t, t, t, t, ckpt, t)
    # a gradient through the scan takes float32 and no state_out
    u = torch.zeros(2, 16, requires_grad=True)
    with pytest.raises(TypeError, match="gradient takes float32"):
        rs.rwkv_scan(b, b, b, b, u)
    with pytest.raises(ValueError, match="no state_out"):
        rs.rwkv_scan(x, x, x, x, u, state_out=torch.zeros(1, 2, 16, 16))


# ---------------------------------------------------------------------------
# the RWKV6 layers in training mode


@pytest.mark.parametrize("S", [32, 256])
def test_time_and_channel_mix_train_match_jax_vjp(S):
    """``rwkv_time_mix`` and ``rwkv_channel_mix`` with ``mode="train"``
    (the scan flat at 32, chunked at 256): no cache, and the output and the
    grads of every param and of x against ``jax.vjp`` of the JAX layers in
    train mode; the outputs equal the prefill's."""
    jcfg = reduced(get_config("rwkv6-1.6b"))
    tcfg = t_reduced(t_get_config("rwkv6-1.6b"))
    jp, tp = layer_params(jcfg, S)
    rng = np.random.default_rng(S + 3)
    x = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    for name, jfn, tfn in (("tm", jlayers.rwkv_time_mix, layers.rwkv_time_mix),
                           ("cm", jlayers.rwkv_channel_mix,
                            layers.rwkv_channel_mix)):
        out, vjp = jax.vjp(lambda p, x: jfn(p, jcfg, x, mode="train",
                                            cache=None)[0], jp, x)
        cot = rng.standard_normal(out.shape).astype(np.float32)
        gp_j, gx_j = vjp(jnp.asarray(cot))

        ptree = tree_map(lambda t: t.clone().requires_grad_(), tp)
        tx = torch.from_numpy(x).requires_grad_()
        y, cache = tfn(ptree, tcfg, tx, mode="train", cache=None)
        assert cache is None
        assert rel(y, out) <= REL, name
        y.backward(torch.from_numpy(cot))
        assert rel(tx.grad, gx_j) <= REL, name
        used = set(gp_j[name])
        assert used
        for key in used:
            g = ptree[name][key].grad
            assert g is not None, (name, key)
            assert rel(g, gp_j[name][key]) <= REL, (name, key)
        with torch.no_grad():
            y_prefill, _ = tfn(tp, tcfg, tx, mode="prefill", cache=None)
        assert torch.equal(y.detach(), y_prefill), name
