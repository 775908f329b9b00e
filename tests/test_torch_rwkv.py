"""The port's WKV scan (``kernels.rwkv_scan``) and RWKV6 layers against the
JAX package, on the CPU.

The same numpy inputs (from a seed) go through the Pallas ``rwkv_scan`` in
interpret mode, ``kernels/ref.py:rwkv_scan_ref``, the JAX ``rwkv_time_mix``
and ``rwkv_channel_mix``, and the port's functions on CPU tensors (which run
the plain version and launch nothing).  In f32 every output is held to
max |delta| <= 1e-5 * max |reference|: the same f32 math, summed in another
order (a torch time loop and ``rwkv_scan_ref`` differ by about 3.5e-7 of
max |y| at S = 1,024).  bf16 outputs are held to one bf16 ulp (2**-7 of
max |reference|): both sides round an f32 result once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.kernels import ref
from repro.kernels.rwkv_scan import rwkv_scan as pallas_rwkv_scan
from repro.models import layers as jlayers
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.kernels import rwkv_scan as rs
from repro_torch.models import layers
from repro_torch.models.convert import to_torch

REL = 1e-5


def held(got, want, rel=REL):
    """max |got - want| <= rel * max |want| (both as f32 numpy)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def scan_inputs(seed, B, S, H, hd, state=False):
    """r, k, v, w [B, S, H, hd], u [H, hd] (and a start state) as f32 numpy;
    w = exp(-exp(.)) in (0, 1) as the layer makes it."""
    rng = np.random.default_rng(seed)
    shape = (B, S, H, hd)
    r, k, v = (rng.standard_normal(shape, dtype=np.float32) for _ in "rkv")
    w = np.exp(-np.exp(rng.standard_normal(shape))).astype(np.float32)
    u = rng.standard_normal((H, hd), dtype=np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd), dtype=np.float32)
          if state else None)
    return (r, k, v, w, u), s0


def port_scan(arrays, s0=None, dtype=torch.float32, **kw):
    before = rs.rwkv_scan.launches
    r, k, v, w, u = (torch.from_numpy(np.array(a)) for a in arrays)
    y, s = rs.rwkv_scan(*(x.to(dtype) for x in (r, k, v, w)), u,
                        None if s0 is None else torch.from_numpy(s0), **kw)
    assert rs.rwkv_scan.launches == before     # CPU: the plain version
    return y, s


def numpy_scan(r, k, v, w, u, s0=None):
    """The recurrence in numpy (f64), with its end state: the oracle for a
    start state, which ``rwkv_scan_ref`` does not take."""
    r, k, v, w, u = (np.asarray(a, np.float64) for a in (r, k, v, w, u))
    B, S, H, hd = r.shape
    s = np.zeros((B, H, hd, hd)) if s0 is None else s0.astype(np.float64)
    y = np.zeros_like(r)
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        y[:, t] = np.einsum("bhk,bhkv->bhv", r[:, t], s + u[None, :, :, None]
                            * kv)
        s = w[:, t, :, :, None] * s + kv
    return y, s


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 64, 2, 16, 16), (2, 128, 4, 64, 64), (1, 96, 2, 32, 32)])
def test_plain_matches_pallas_interpret_and_ref(B, S, H, hd, chunk):
    arrays, _ = scan_inputs(S + hd, B, S, H, hd)
    y, s = port_scan(arrays)
    assert y.dtype == torch.float32 and y.shape == (B, S, H, hd)
    assert s.dtype == torch.float32 and s.shape == (B, H, hd, hd)
    jx = [jnp.asarray(a) for a in arrays]
    held(y, pallas_rwkv_scan(*jx, chunk=chunk, interpret=True))
    held(y, ref.rwkv_scan_ref(*jx))
    held(s, numpy_scan(*arrays)[1])


def lane_scan(r, k, v, w, u):
    """The CUDA kernel's arithmetic, in torch on the CPU: the plain step's
    terms, then the sum over the key index as the kernel takes it.  Lane t
    of a column group holds the rows i = t + LANES * m; it runs the plain
    tree's levels at distances hd/2 .. LANES on its own rows (m with
    m + M/2), then the lanes add at xor distances LANES/2 .. 1, each lane
    its own sum first."""
    L = rs.LANES
    rf, kf, vf, wf = (torch.from_numpy(np.array(a)) for a in (r, k, v, w))
    B, S, H, hd = rf.shape
    uf = torch.from_numpy(np.array(u))[None, :, :, None]
    s = torch.zeros((B, H, hd, hd))
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        p = rf[:, t, :, :, None] * (s + uf * kv)      # [B, H, hd_k, hd_v]
        s = wf[:, t, :, :, None] * s + kv
        q = p.reshape(B, H, hd // L, L, hd).transpose(2, 3)  # [.., t, m, j]
        while q.shape[3] > 1:                          # a lane's own rows
            half = q.shape[3] // 2
            q = q[:, :, :, :half] + q[:, :, :, half:]
        x = q[:, :, :, 0]                              # [B, H, lane, hd_v]
        off = L // 2
        while off:                                     # across the lanes
            x = x + x[:, :, [t ^ off for t in range(L)]]
            off //= 2
        ys.append(x[:, :, 0])
    return torch.stack(ys, dim=1), s


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 64, 2, 16, 16), (2, 128, 4, 64, 64), (1, 96, 2, 32, 32)])
def test_kernel_reduction_order_is_the_plain_versions(B, S, H, hd, chunk):
    """The lanes' split of the pairwise tree (``lane_scan``) reorders no sum
    of the plain version: y and the end state are equal bit for bit, on the
    inputs held to the Pallas kernel above."""
    arrays, _ = scan_inputs(S + hd, B, S, H, hd)
    y, s = lane_scan(*arrays)
    y_plain, s_plain = port_scan(arrays)
    assert torch.equal(y, y_plain) and torch.equal(s, s_plain)
    held(y, pallas_rwkv_scan(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                             interpret=True))


@pytest.mark.parametrize("B,H,hd", [(4, 32, 64), (2, 8, 64), (1, 1, 64),
                                    (2, 8, 16), (1, 4, 32), (64, 32, 64)])
def test_column_split_fills_the_card_with_whole_warps(B, H, hd):
    split = rs.column_split(B, H, hd)
    threads = hd // split // rs.COLS * rs.LANES
    assert split & (split - 1) == 0 and threads % 32 == 0
    # as many CTAs as the target asks, or as many as whole warps allow
    assert B * H * split >= rs.TARGET_CTAS or threads == 32


@pytest.mark.parametrize("B,S,H,hd", [(2, 1, 4, 16), (1, 37, 2, 64),
                                      (3, 100, 2, 32)])
def test_plain_ragged_lengths_match_ref(B, S, H, hd):
    arrays, _ = scan_inputs(S, B, S, H, hd)
    y, _ = port_scan(arrays)
    held(y, ref.rwkv_scan_ref(*(jnp.asarray(a) for a in arrays)))


def test_plain_bf16_inputs_match_ref_within_one_ulp():
    arrays, _ = scan_inputs(5, 2, 64, 2, 64)
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays[:4]]
    y, s = port_scan([np.asarray(a.astype(jnp.float32)) for a in jx]
                     + [arrays[4]], dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    held(y, ref.rwkv_scan_ref(*jx, jnp.asarray(arrays[4])).astype(
        jnp.float32), rel=2.0 ** -7)


def test_scan_from_a_state_and_its_split_match():
    """A scan over S1 + S2 equals a scan over S1, then over S2 from its end
    state; and the start state is held to the f64 recurrence."""
    (r, k, v, w, u), s0 = scan_inputs(11, 2, 50, 4, 16, state=True)
    y, s = port_scan((r, k, v, w, u), s0)
    want_y, want_s = numpy_scan(r, k, v, w, u, s0)
    held(y, want_y)
    held(s, want_s)
    cut = 17
    y1, s1 = port_scan([a[:, :cut] for a in (r, k, v, w)] + [u], s0)
    y2, s2 = port_scan([a[:, cut:] for a in (r, k, v, w)] + [u], s1.numpy())
    held(torch.cat([y1, y2], dim=1), y.numpy())
    held(s2, s.numpy())


def test_in_place_state_equals_out_of_place():
    arrays, s0 = scan_inputs(3, 2, 1, 4, 64, state=True)
    y, s = port_scan(arrays, s0)
    state = torch.from_numpy(s0.copy())
    y2, s2 = port_scan(arrays, state.numpy(), state_out=state)
    assert s2 is state and torch.equal(state, s) and torch.equal(y2, y)
    out = torch.empty_like(state)
    _, s3 = port_scan(arrays, s0, state_out=out)
    assert s3 is out and torch.equal(out, s)


def test_zero_steps_return_the_state_unchanged():
    (r, k, v, w, u), s0 = scan_inputs(4, 2, 0, 4, 16, state=True)
    y, s = port_scan((r, k, v, w, u), s0)
    assert y.shape == (2, 0, 4, 16)
    assert torch.equal(s, torch.from_numpy(s0))
    _, z = port_scan((r, k, v, w, u))
    assert not z.any() and z.shape == (2, 4, 16, 16)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 2, 48)
    with pytest.raises(ValueError, match="head_dim 48"):
        rs.rwkv_scan(x, x, x, x, torch.zeros(2, 48))
    x = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="share shape, dtype"):
        rs.rwkv_scan(x, x, x.to(torch.bfloat16), x, torch.zeros(2, 16))
    with pytest.raises(TypeError, match="float16"):
        h = x.half()
        rs.rwkv_scan(h, h, h, h, torch.zeros(2, 16))
    with pytest.raises(ValueError, match="u "):
        rs.rwkv_scan(x, x, x, x, torch.zeros(3, 16))
    with pytest.raises(ValueError, match="state must be"):
        rs.rwkv_scan(x, x, x, x, torch.zeros(2, 16), torch.zeros(1, 2, 16, 8))
    with pytest.raises(ValueError, match="state_out must be"):
        rs.rwkv_scan(x, x, x, x, torch.zeros(2, 16),
                     state_out=torch.zeros(1, 2, 16, 16, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 16, 2, 4).transpose(1, 3)
        rs.rwkv_scan(t, t, t, t, torch.zeros(2, 4))


# ---------------------------------------------------------------------------
# the RWKV6 layers against the JAX layers, on random params


def layer_params(cfg, seed):
    """Both layers' params with every leaf drawn from a numpy seed (the JAX
    init leaves the LoRA b, mu and ln_x at zero, which would hide them)."""
    shapes = jax.eval_shape(lambda: jlayers.init_rwkv_layer(
        jax.random.PRNGKey(0), cfg, jnp.float32))
    rng = np.random.default_rng(seed)
    tree = {part: {name: (0.3 * rng.standard_normal(sd.shape)).astype(
        np.float32) for name, sd in leaves.items()}
        for part, leaves in shapes.items()}
    jp = {part: {n: jnp.asarray(a) for n, a in d.items()}
          for part, d in tree.items()}
    tp = {part: {n: to_torch(a) for n, a in d.items()}
          for part, d in tree.items()}
    return jp, tp


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_time_and_channel_mix_match_jax(mode):
    jcfg = reduced(get_config("rwkv6-1.6b"))
    tcfg = t_reduced(t_get_config("rwkv6-1.6b"))
    jp, tp = layer_params(jcfg, 1)
    B, S, D = 2, (24 if mode == "prefill" else 1), jcfg.d_model
    hd = jcfg.ssm.rwkv_head_dim
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    cache = {"state": rng.standard_normal((B, D // hd, hd, hd),
                                          dtype=np.float32),
             "tm_shift": rng.standard_normal((B, D), dtype=np.float32),
             "cm_shift": rng.standard_normal((B, D), dtype=np.float32)}
    jcache = ({k: jnp.asarray(a) for k, a in cache.items()}
              if mode == "decode" else None)
    tcache = ({k: torch.from_numpy(a.copy()) for k, a in cache.items()}
              if mode == "decode" else None)

    want_y, want_c = jlayers.rwkv_time_mix(jp, jcfg, jnp.asarray(x),
                                           mode=mode, cache=jcache)
    y, c = layers.rwkv_time_mix(tp, tcfg, torch.from_numpy(x), mode=mode,
                                cache=tcache)
    held(y, want_y)
    held(c["state"], want_c["state"])
    np.testing.assert_array_equal(c["tm_shift"].numpy(), x[:, -1])
    want_y, want_shift = jlayers.rwkv_channel_mix(
        jp, jcfg, jnp.asarray(x), mode=mode,
        cache=jcache and jcache["cm_shift"])
    y, shift = layers.rwkv_channel_mix(
        tp, tcfg, torch.from_numpy(x), mode=mode,
        cache=tcache and tcache["cm_shift"])
    held(y, want_y)
    np.testing.assert_array_equal(shift.numpy(), np.asarray(want_shift))
    if mode == "decode":   # the cache was written in place
        assert c["state"] is tcache["state"]
        assert shift is tcache["cm_shift"]
        held(tcache["state"], want_c["state"])
        np.testing.assert_array_equal(tcache["tm_shift"].numpy(), x[:, -1])
