"""The port's Mamba branch and the reduced hymba model (attention and Mamba
heads side by side in every layer, windowed and global layers) against the
JAX package, on the CPU.

Params come from the JAX initialisers (``init_mamba``, ``init_params``) and
are carried across with ``convert``; inputs are drawn from a numpy seed.
In float32 both sides agree to rtol = atol = 1e-5 (the same math, summed in
another order) and greedy tokens are equal; one bfloat16 case holds the
branch's casts to 2e-2 of max |out|.  The attention kernels run their plain
versions (CPU tensors launch nothing)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models import layers as jlayers
from repro_torch._tree import tree_map
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.convert import to_torch
from repro_torch.models.decoder import build_layout
from test_torch_mla import held_caches, held_steps, run_models
from test_torch_models import both, to_numpy
from test_torch_serving import engines

ARCH = "hymba-1.5b"
TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want, what, **tol):
    np.testing.assert_allclose(to_numpy(got).astype(np.float32),
                               np.asarray(want).astype(np.float32),
                               err_msg=what, **(tol or TOL))


def branch_params(seed, jdtype):
    """The JAX ``init_mamba`` params of the reduced config (numpy), with
    Dskip and dt_bias drawn away from their constant init so that both
    count, and the port's copy of them."""
    jcfg = reduced(get_config(ARCH))
    jp = jax.tree.map(np.asarray, jlayers.init_mamba(
        jax.random.PRNGKey(seed), jcfg, jdtype))
    rng = np.random.default_rng(seed)
    for key, lo, hi in (("Dskip", 0.5, 1.5), ("dt_bias", -5.0, -1.0)):
        jp[key] = rng.uniform(lo, hi, jp[key].shape).astype(jp[key].dtype)
    assert jp["A_log"].dtype == np.float32
    return jcfg, t_reduced(t_get_config(ARCH)), jp, tree_map(to_torch, jp)


@pytest.mark.parametrize("S", [1, 12, 64])
def test_mamba_branch_prefill_and_decode_match_jax(S):
    """Prefill over S tokens from a zero state, then two decode tokens on
    the prefill's caches: outputs, the conv history and the f32 state match
    the JAX ``mamba_branch``; decode writes both caches in place."""
    jcfg, tcfg, jp, tp = branch_params(S, jnp.float32)
    B, D = 2, jcfg.d_model
    rng = np.random.default_rng(S + 1)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    y_j, c_j = jlayers.mamba_branch(jp, jcfg, jnp.asarray(x), mode="prefill",
                                    cache=None)
    y_t, c_t = layers.mamba_branch(tp, tcfg, torch.from_numpy(x),
                                   mode="prefill", cache=None)
    close(y_t, y_j, "prefill y")
    assert set(c_t) == set(c_j) == {"conv", "ssm"}
    assert c_t["ssm"].dtype == torch.float32
    for key in c_j:
        assert tuple(c_t[key].shape) == c_j[key].shape, key
        close(c_t[key], c_j[key], f"prefill {key}")

    for step in range(2):
        x1 = rng.standard_normal((B, 1, D), dtype=np.float32)
        ptrs = {k: t.data_ptr() for k, t in c_t.items()}
        y_j, c_j = jlayers.mamba_branch(jp, jcfg, jnp.asarray(x1),
                                        mode="decode", cache=c_j)
        y_t, c_t = layers.mamba_branch(tp, tcfg, torch.from_numpy(x1),
                                       mode="decode", cache=c_t)
        close(y_t, y_j, f"decode {step} y")
        for key in c_j:
            assert c_t[key].data_ptr() == ptrs[key], key
            close(c_t[key], c_j[key], f"decode {step} {key}")


def test_mamba_branch_bf16_keeps_the_casts():
    """In bf16 the convolution, the projections and dt's softplus run in
    bf16, the scan and the skip term in f32, and y returns to bf16 before
    the gate: the port is within 2e-2 of max |out| of the JAX branch in
    prefill and decode, and its state stays f32."""
    jcfg, tcfg, jp, tp = branch_params(5, jnp.bfloat16)
    tcfg = t_reduced(t_get_config(ARCH), dtype="bfloat16")
    assert tp["A_log"].dtype == torch.float32
    assert tp["in_proj"].dtype == torch.bfloat16
    B, D, S = 2, jcfg.d_model, 24
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((B, S, D)), jnp.bfloat16)
    x1 = jnp.asarray(rng.standard_normal((B, 1, D)), jnp.bfloat16)
    y_j, c_j = jlayers.mamba_branch(jp, jcfg, x, mode="prefill", cache=None)
    y_t, c_t = layers.mamba_branch(tp, tcfg, to_torch(np.asarray(x)),
                                   mode="prefill", cache=None)
    assert y_t.dtype == torch.bfloat16 and c_t["ssm"].dtype == torch.float32
    scale = float(np.abs(np.asarray(y_j, np.float32)).max())
    close(y_t, y_j, "bf16 prefill y", rtol=0, atol=2e-2 * scale)
    y_j, c_j = jlayers.mamba_branch(jp, jcfg, x1, mode="decode",
                                    cache=jax.tree.map(np.asarray, c_j))
    y_t, c_t = layers.mamba_branch(tp, tcfg, to_torch(np.asarray(x1)),
                                   mode="decode", cache=c_t)
    scale = float(np.abs(np.asarray(y_j, np.float32)).max())
    close(y_t, y_j, "bf16 decode y", rtol=0, atol=2e-2 * scale)
    ssm = np.asarray(c_j["ssm"])
    close(c_t["ssm"], ssm, "bf16 state", rtol=0,
          atol=2e-2 * float(np.abs(ssm).max()))


def test_hymba_layout_windows_and_globals():
    cfg = t_reduced(t_get_config(ARCH), n_layers=4, global_layers=(0, 3))
    assert [(g.spec.kind, g.spec.window, g.n) for g in build_layout(cfg)] \
        == [("hymba", None, 1), ("hymba", 32, 2), ("hymba", None, 1)]
    full = t_get_config(ARCH)
    assert [(g.spec.window, g.n) for g in build_layout(full)] == [
        (None, 1), (1024, 14), (None, 1), (1024, 15), (None, 1)]


@pytest.mark.parametrize("S,steps", [(64, 40), (32, 5)])
def test_hymba_prefill_and_greedy_decode_match_jax(S, steps):
    """The reduced hymba with 4 layers, layers 0 and 3 global, 1 and 2
    windowed at 32, from the JAX params: prefill, then ``steps`` greedy
    decode steps (64 + 40 wraps the windowed layers' 32-slot ring); logits
    within ``TOL`` every step, greedy tokens equal, and every cache (k, v,
    the conv history and the SSM state) after the last step.  The JAX side
    runs jitted, as its engine runs it."""
    jm, jp, tm, tp = both(ARCH, n_layers=4, global_layers=(0, 3))
    jm = dataclasses.replace(jm, prefill=jax.jit(jm.prefill),
                             decode=jax.jit(jm.decode))
    assert tm.cfg.sliding_window == 32
    toks = np.random.default_rng(S).integers(0, jm.cfg.vocab, (2, S),
                                             dtype=np.int32)
    counts = (fa.flash_attention.launches, da.decode_attention.launches)
    want, got, (jcache, tcache) = run_models(
        jm, jp, tm, tp, {"tokens": toks}, steps, S + steps + 8, False)
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == counts
    assert len(got) == steps + 1
    held_steps(want, got)
    held_caches(jcache, tcache, {"k", "v", "conv", "ssm"})
    assert [c["attn"]["k"].shape[2] for c in tcache] == [
        S + steps + 8, 32, S + steps + 8]


def test_generate_equals_the_jax_engine():
    jeng, teng = engines(ARCH)
    toks = np.random.default_rng(3).integers(0, 256, (2, 32), dtype=np.int32)
    want = jeng.generate({"tokens": jnp.asarray(toks)}, n_tokens=6)
    got = teng.generate({"tokens": torch.from_numpy(toks)}, n_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for key in ("prefill_tokens", "decoded_tokens", "batches"):
        assert getattr(teng.stats, key) == getattr(jeng.stats, key)
    assert teng.cache_footprint(2) == jeng.cache_footprint(2)


def test_serve_hymba_runs_on_the_cpu(capsys):
    """The hybrid family through the launcher, each request placed on the
    hymba engine's plan, the attention kernels on their plain versions."""
    counts = (fa.flash_attention.launches, da.decode_attention.launches)
    stats = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                        "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("req 0 -> ") and "(c*=" in lines[0]
    assert "generated 4 tokens x batch 2" in lines[1]
    assert stats.decoded_tokens == 16 and stats.batches == 2
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == counts
