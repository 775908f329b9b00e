"""The port's MoE router (``kernels.moe_routing``), MoE FFN and phi3.5-moe
model against the JAX package, on the CPU.

The same numpy inputs (from a seed) go through the Pallas ``moe_routing``
in interpret mode, ``kernels/ref.py:moe_routing_ref``, the JAX model's
``_route``/``_route_grouped``/``moe_ffn``, and the port's functions on CPU
tensors (which run the plain version and launch nothing).  Gates are held
to max |delta| <= 1e-5 * max |reference| (the same f32 math summed in
another order; the x of the bf16 cases is cast to f32 exactly on both
sides, so the same bound holds there, well inside one bf16 ulp); masks are
held equal.  Layer and model outputs are held to rtol = atol = 1e-5."""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.kernels import ref
from repro.kernels.moe_routing import moe_routing as pallas_moe_routing
from repro.models import layers as jlayers
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.kernels import moe_routing as mr
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.convert import to_torch
from test_torch_models import both, leaves, run_both, to_numpy
from test_torch_serving import engines

ROOT_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT_SMOKE)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCH = "phi3.5-moe-42b-a6.6b"
REL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]


def held(got, want, rel=REL):
    """max |got - want| <= rel * max |want| (both as f32 numpy)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def port_route(x, w, top_k, dtype=torch.float32):
    """The port's routing of numpy x, w on the CPU (no launch)."""
    before = mr.moe_routing.launches
    gates, mask = mr.moe_routing(torch.from_numpy(np.array(x)).to(dtype),
                                 torch.from_numpy(np.array(w)), top_k)
    assert mr.moe_routing.launches == before
    assert gates.dtype == mask.dtype == torch.float32
    return gates, mask


def route_inputs(seed, T, D, E):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, D), dtype=np.float32),
            rng.standard_normal((D, E), dtype=np.float32))


def moe_cfg(E, k, **moe):
    """The reduced JAX phi3.5-moe config with E experts, top-k."""
    cfg = reduced(get_config(ARCH))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=E, top_k=k, **moe))


def jax_routes(x, w, k):
    """(gates, mask) of the JAX ``_route`` and of ``_route_grouped`` (x as
    one group of one batch row)."""
    cfg = moe_cfg(w.shape[1], k)
    p = {"router": jnp.asarray(w)}
    flat = jlayers._route(p, cfg, jnp.asarray(x))
    grouped = jlayers._route_grouped(p, cfg, jnp.asarray(x)[None, None])
    return ([np.asarray(a) for a in flat],
            [np.asarray(a)[0, 0] for a in grouped])


# ---------------------------------------------------------------------------
# the routing


@pytest.mark.parametrize("T,D,E,k,bt", [
    (96, 32, 8, 2, 128), (192, 64, 16, 1, 64), (128, 32, 6, 4, 128),
    (256, 32, 160, 6, 128)])
def test_plain_matches_pallas_interpret(T, D, E, k, bt):
    """The Pallas kernel's shapes of tests/test_kernels.py and the
    deepseek-v2 expert count; no probability underflows here, so the
    kernel's gates > 0 is the mask."""
    x, w = route_inputs(T + E, T, D, E)
    gates, mask = port_route(x, w, k)
    want = np.asarray(pallas_moe_routing(jnp.asarray(x), jnp.asarray(w), k,
                                         bt=bt, interpret=True))
    held(gates, want)
    np.testing.assert_array_equal(mask.numpy(), (want > 0).astype(np.float32))
    assert (mask.sum(-1) == k).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,E,k", [(64, 48, 16, 2), (37, 100, 8, 3),
                                     (40, 64, 160, 6)])
def test_plain_matches_ref_and_the_jax_routes(T, D, E, k, dtype):
    x, w = route_inputs(7 * T + D, T, D, E)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    x = np.asarray(jx.astype(jnp.float32))       # the values both sides see
    gates, mask = port_route(x, w, k, getattr(torch, dtype))
    held(gates, ref.moe_routing_ref(jx, jnp.asarray(w), k))
    for want_gates, want_mask in jax_routes(jx, w, k):
        held(gates, want_gates)
        np.testing.assert_array_equal(mask.numpy(), want_mask)


def test_underflow_picks_k_experts_as_lax_top_k():
    """One logit leads the rest by > 110, so every other probability
    underflows to 0 in f32.  ``lax.top_k`` (and the port) still pick k
    experts, the lower index among the zeros; the Pallas kernel picks one.
    The gates agree all the same: a zero probability adds a zero gate."""
    rng = np.random.default_rng(3)
    T, D, E, k = 32, 8, 4, 2
    x = rng.standard_normal((T, D), dtype=np.float32)
    x[:, 0] = 1.0
    w = 0.1 * rng.standard_normal((D, E), dtype=np.float32)
    w[0, 0] = 120.0
    gates, mask = port_route(x, w, k)
    (want_gates, want_mask), _ = jax_routes(x, w, k)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    assert (mask.sum(-1) == k).all() and (mask[:, :2] == 1).all()
    pallas = np.asarray(pallas_moe_routing(jnp.asarray(x), jnp.asarray(w), k,
                                           interpret=True))
    assert ((pallas > 0).sum(-1) < k).all()
    np.testing.assert_array_equal(gates.numpy(), pallas)
    held(gates, want_gates)


@pytest.mark.parametrize("k,want", [(1, [0, 1, 0, 0, 0]),
                                    (2, [0, 1, 1, 0, 0]),
                                    (4, [1, 1, 1, 1, 0])])
def test_ties_go_to_the_lower_index(k, want):
    """Experts 1, 2 and 3 have the same router column, which leads: the
    first k of them are picked, as ``lax.top_k`` picks them."""
    rng = np.random.default_rng(5)
    T, D, E = 16, 12, 5
    x = rng.standard_normal((T, D), dtype=np.float32)
    x[:, 0] = 1.0
    w = 0.1 * rng.standard_normal((D, E), dtype=np.float32)
    w[0, 1] = 8.0
    w[:, 2] = w[:, 3] = w[:, 1]
    w[0, 0] = 4.0
    gates, mask = port_route(x, w, k)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.tile(np.float32(want), (T, 1)))
    (_, want_mask), _ = jax_routes(x, w, k)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    if k > 1:     # tied picks share the gate exactly
        assert torch.equal(gates[:, 1], gates[:, 2])


def test_edge_cases():
    x, w = route_inputs(1, 0, 16, 8)
    gates, mask = port_route(x, w, 2)
    assert gates.shape == mask.shape == (0, 8)
    x, w = route_inputs(2, 29, 33, 6)          # ragged T and D
    gates, mask = port_route(x, w, 6)          # top_k = E: every expert
    assert (mask == 1).all()
    held(gates, ref.moe_routing_ref(jnp.asarray(x), jnp.asarray(w), 6))
    held(gates.sum(-1), np.ones(29, np.float32))
    x, w = route_inputs(3, 5, 16, 1)           # one expert
    gates, mask = port_route(x, w, 1)
    assert (gates == 1).all() and (mask == 1).all()


def bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D,E,k,case", [
    (4, 4096, 16, 2, "random"), (37, 100, 8, 3, "random"),
    (64, 256, 16, 2, "underflow"), (64, 256, 16, 2, "tie")])
def test_plain_routes_each_token_apart(T, D, E, k, case, dtype):
    """``moe_routing_plain`` on a batch equals it row by row, bit for bit:
    a token's gates and mask depend on its own row of x alone.  The
    kernel's decode design leans on that: it sums the tokens of a cluster
    apart, and its prefill design 32 tokens a CTA."""
    x, w = chip_smoke.routing_inputs(T, D, E, dtype, T + D + E, case,
                                     device="cpu")
    gates, mask = mr.moe_routing_plain(x, w, k)
    for t in range(T):
        g, m = mr.moe_routing_plain(x[t:t + 1].contiguous(), w, k)
        assert torch.equal(bits(g), bits(gates[t:t + 1]))
        assert torch.equal(bits(m), bits(mask[t:t + 1]))
    if case == "underflow":
        assert ((gates > 0).sum(-1) < k).all()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, w = torch.zeros(4, 8), torch.zeros(8, 4)
    with pytest.raises(ValueError, match="top_k 5"):
        mr.moe_routing(x, w, 5)
    with pytest.raises(ValueError, match="top_k 0"):
        mr.moe_routing(x, w, 0)
    with pytest.raises(ValueError, match="257 experts"):
        mr.moe_routing(x, torch.zeros(8, 257), 2)
    with pytest.raises(TypeError, match="float16"):
        mr.moe_routing(x.half(), w, 2)
    with pytest.raises(ValueError, match="float32"):
        mr.moe_routing(x, w.to(torch.bfloat16), 2)
    with pytest.raises(ValueError, match="width 8"):
        mr.moe_routing(x, torch.zeros(7, 4), 2)
    with pytest.raises(ValueError, match="contiguous"):
        mr.moe_routing(torch.zeros(8, 4).t(), w, 2)
    with pytest.raises(ValueError, match="2-D"):
        mr.moe_routing(torch.zeros(2, 4, 8), w, 2)
    with pytest.raises(ValueError, match="design 'fast'"):
        mr.moe_routing(x, w, 2, design="fast")


# ---------------------------------------------------------------------------
# the MoE FFN, with tokens dropped at capacity


def dropped(mask, B, S, g, capacity):
    """Tokens x experts picked but past their expert's capacity, in groups
    of g tokens."""
    m = mask.numpy().reshape(B, S // g, g, -1)
    return int((m * (np.cumsum(m, axis=2) - 1 >= capacity)).sum())


@pytest.mark.parametrize("S", [1, 200, 512])
@pytest.mark.parametrize("cf", [1.0, 0.5])
@pytest.mark.parametrize("E", [4, 8])
def test_moe_ffn_matches_jax_with_tokens_dropped(E, cf, S):
    """One layer's JAX params carried across with ``to_torch``; f32, D 32,
    top-2.  At capacity factors 1.0 and 0.5 tokens are dropped (asserted
    for the prompts; one decode token never is)."""
    jcfg = moe_cfg(E, 2, capacity_factor=cf)
    jcfg = dataclasses.replace(jcfg, d_model=32)
    tcfg = t_reduced(t_get_config(ARCH), d_model=32)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, n_experts=E, top_k=2, capacity_factor=cf))
    jp = jax.tree.map(np.asarray, jlayers.init_moe(
        jax.random.PRNGKey(E), jcfg, jnp.float32))
    tp = {n: to_torch(a) for n, a in jp.items()}
    B = 2
    x = np.random.default_rng(S + E).standard_normal((B, S, 32),
                                                     dtype=np.float32)
    want = np.asarray(jlayers.moe_ffn(jax.tree.map(jnp.asarray, jp), jcfg,
                                      jnp.asarray(x)))
    got = layers.moe_ffn(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    g = S if S % min(layers.MOE_CHUNK, S) else min(layers.MOE_CHUNK, S)
    capacity = max(2, int(g / E * 2 * cf))
    _, mask = layers._route(tp, tcfg, torch.from_numpy(x).reshape(-1, 32))
    n_dropped = dropped(mask, B, S, g, capacity)
    assert (n_dropped > 0) == (S > 1), n_dropped


# ---------------------------------------------------------------------------
# the model, the engine and the launcher


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_round_trip_keeps_the_router_f32(dtype):
    jm, jp, tm, tp = both(ARCH, dtype=dtype)
    jl, tl = dict(leaves(jp)), dict(leaves(tp))
    assert jl.keys() == tl.keys()
    routers = [p for p in tl if p[-1] == "router"]
    assert routers
    for path, a in jl.items():
        want = "float32" if path[-1] == "router" else dtype
        assert tl[path].dtype == getattr(torch, want), path
        np.testing.assert_array_equal(to_numpy(tl[path]).view(np.uint8),
                                      np.asarray(a).view(np.uint8))
    own = dict(leaves(tm.init_params(torch.Generator().manual_seed(0))))
    assert own.keys() == tl.keys()
    for path, t in own.items():
        assert (t.shape, t.dtype) == (tl[path].shape, tl[path].dtype), path
    wi = own[routers[0][:-1] + ("wi",)]      # [n, E, D, ff], fan-in D
    D = tm.cfg.d_model
    assert abs(float(wi.float().std()) - D ** -0.5) < 0.05 * D ** -0.5


@pytest.mark.parametrize("S,steps", [(12, 4), (512, 2)])
def test_moe_prefill_and_greedy_decode_match_jax(S, steps):
    """The reduced phi3.5-moe from the JAX params: one group of 12 tokens or
    two of 256 in prefill, one token in decode; logits within ``TOL``,
    greedy tokens equal."""
    want, got = run_both(ARCH, B=2, S=S, steps=steps, seed=S)
    assert len(got) == steps + 1
    for step, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, err_msg=f"step {step}", **TOL)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def test_generate_equals_the_jax_engine():
    jeng, teng = engines(ARCH)
    toks = np.random.default_rng(1).integers(0, 256, (2, 16), dtype=np.int32)
    want = jeng.generate({"tokens": jnp.asarray(toks)}, n_tokens=6)
    got = teng.generate({"tokens": torch.from_numpy(toks)}, n_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for key in ("prefill_tokens", "decoded_tokens", "batches"):
        assert getattr(teng.stats, key) == getattr(jeng.stats, key)


def test_serve_moe_runs_on_the_cpu(capsys):
    """The MoE family through the launcher: each request placed on the
    ``phi3.5-moe/bf16`` engine's plan, the router on its plain version."""
    before = mr.moe_routing.launches
    stats = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                        "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("req 0 -> ") and "(c*=" in lines[0]
    assert "generated 4 tokens x batch 2" in lines[1]
    assert stats.decoded_tokens == 16 and stats.batches == 2
    assert mr.moe_routing.launches == before


def test_subprocess_serve_moe_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['serve', '--arch', '{ARCH}', '--device', 'cpu']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.kernels.moe_routing' in sys.modules\n"
        "print('ISOLATED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.splitlines()
    assert out[-1] == "ISOLATED"
    assert out[-2].startswith("stats: prefill 96 tok")

