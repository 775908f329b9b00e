"""The port's MLA (multi-head latent attention) sublayer and the reduced
deepseek-v2 model against the JAX package, on the CPU.

Params come from the JAX initialisers (``init_mla``, ``init_params``) and
are carried across with ``convert``; inputs are drawn from a numpy seed.
Both sides run in float32, so outputs, logits and latent caches agree to
rtol = atol = 1e-5 (the same math, summed in another order) and greedy
tokens are equal, in both ``absorb`` modes.  The MoE router runs its plain
version (CPU tensors launch nothing).  Prompts of 12 tokens take the naive
attention path, prompts of 64 the chunked one (the reduced config's
``flash_threshold`` is 64, its chunk 32)."""

import dataclasses
import functools
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models import layers as jlayers
from repro.serving.kvcache import pad_cache as jax_pad_cache
from repro_torch._tree import tree_map
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.kernels import moe_routing as mr
from repro_torch.launch import serve
from repro_torch.models import common, layers
from repro_torch.models.convert import to_torch
from repro_torch.models.registry import build_model
from repro_torch.serving.kvcache import pad_cache
from test_torch_models import both, greedy_run, leaves
from test_torch_serving import engines

ARCH = "deepseek-v2-236b"
TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **TOL)


def sublayer_params(seed):
    """The JAX ``init_mla`` params of the reduced config (numpy), with
    nonzero norm scales so that q_norm and kv_norm count."""
    jcfg = reduced(get_config(ARCH))
    jp = jax.tree.map(np.asarray, jlayers.init_mla(jax.random.PRNGKey(seed),
                                                   jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for key in ("q_norm", "kv_norm"):
        jp[key] = (0.3 * rng.standard_normal(jp[key].shape)).astype(
            np.float32)
    return jcfg, t_reduced(t_get_config(ARCH)), jp


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("S,buf", [(12, 20), (64, 96)])
def test_mla_sublayer_prefill_and_decode_match_jax(S, buf, absorb):
    """Prefill over S tokens, then one decode token at position S against
    the latent buffer of ``buf`` slots: the output and the latent cache
    (written in place by the port) match the JAX ``mla_sublayer``."""
    jcfg, tcfg, jp = sublayer_params(S)
    tp = tree_map(to_torch, jp)
    B, D = 2, jcfg.d_model
    rng = np.random.default_rng(S + 1)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    x1 = rng.standard_normal((B, 1, D), dtype=np.float32)

    y_j, c_j = jlayers.mla_sublayer(jp, jcfg, jnp.asarray(x), mode="prefill",
                                    cache=None, pos=None, absorb=absorb)
    y_t, c_t = layers.mla_sublayer(tp, tcfg, torch.from_numpy(x),
                                   mode="prefill", cache=None, pos=None,
                                   absorb=absorb)
    close(y_t, y_j, "prefill y")
    assert set(c_t) == set(c_j) == {"ckv", "krope"}
    for key in c_j:
        close(c_t[key], c_j[key], f"prefill {key}")

    jbuf = {k: jnp.zeros((B, buf) + v.shape[2:], v.dtype).at[:, :S].set(v)
            for k, v in c_j.items()}
    tbuf = {k: torch.from_numpy(np.array(v)) for k, v in jbuf.items()}
    ptrs = {k: t.data_ptr() for k, t in tbuf.items()}
    y_j, c_j = jlayers.mla_sublayer(jp, jcfg, jnp.asarray(x1), mode="decode",
                                    cache=jbuf, pos=jnp.int32(S),
                                    absorb=absorb)
    y_t, c_t = layers.mla_sublayer(tp, tcfg, torch.from_numpy(x1),
                                   mode="decode", cache=tbuf, pos=S,
                                   absorb=absorb)
    close(y_t, y_j, "decode y")
    for key in c_j:
        assert c_t[key].data_ptr() == ptrs[key], key
        close(c_t[key], c_j[key], f"decode {key}")
    assert tbuf["ckv"][:, S].abs().sum() > 0
    assert not tbuf["ckv"][:, S + 1:].any()


def test_decode_past_the_buffer_is_clamped_as_in_jax():
    """A decode position past the latent buffer writes the last slot, as
    ``dynamic_update_slice`` clamps it."""
    jcfg, tcfg, jp = sublayer_params(3)
    tp = tree_map(to_torch, jp)
    m = jcfg.mla
    rng = np.random.default_rng(3)
    cache = {"ckv": rng.standard_normal((2, 6, m.kv_lora_rank),
                                        dtype=np.float32),
             "krope": rng.standard_normal((2, 6, m.qk_rope_head_dim),
                                          dtype=np.float32)}
    x1 = rng.standard_normal((2, 1, jcfg.d_model), dtype=np.float32)
    for absorb in (False, True):
        y_j, c_j = jlayers.mla_sublayer(
            jp, jcfg, jnp.asarray(x1), mode="decode",
            cache={k: jnp.asarray(v) for k, v in cache.items()},
            pos=jnp.int32(9), absorb=absorb)
        tbuf = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        y_t, c_t = layers.mla_sublayer(tp, tcfg, torch.from_numpy(x1),
                                       mode="decode", cache=tbuf, pos=9,
                                       absorb=absorb)
        close(y_t, y_j, f"absorb={absorb}")
        for key in c_j:
            close(c_t[key], c_j[key], key)


def absorbed(model, absorb):
    return dataclasses.replace(
        model, decode=functools.partial(model.decode, absorb_mla=absorb))


def run_models(jm, jp, tm, tp, batch, steps, buf_len, absorb):
    """Prefill, then ``steps`` greedy decode steps on both sides; returns
    the logits of each step (numpy) and both sides' final caches."""
    caches = []
    want = greedy_run(
        absorbed(jm, absorb), jp,
        {k: jnp.asarray(v) for k, v in batch.items()}, steps, buf_len,
        lambda x: np.asarray(x), jax_pad_cache,
        lambda lg: jnp.argmax(lg, axis=-1).astype(jnp.int32),
        lambda tok, pos: {"token": tok[:, None], "pos": jnp.int32(pos)},
        caches)
    got = greedy_run(
        absorbed(tm, absorb), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()}, steps, buf_len,
        lambda x: x.numpy().copy(), pad_cache,
        lambda lg: torch.argmax(lg, dim=-1).to(torch.int32),
        lambda tok, pos: {"token": tok[:, None], "pos": pos}, caches)
    return want, got, caches


def held_steps(want, got):
    for step, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, err_msg=f"step {step}", **TOL)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def held_caches(jcache, tcache, keys):
    jl, tl = dict(leaves(jcache)), dict(leaves(tcache))
    assert jl.keys() == tl.keys()
    assert {path[-1] for path in tl} == keys
    for path, a in jl.items():
        assert tuple(tl[path].shape) == a.shape, path
        np.testing.assert_allclose(tl[path].numpy(), np.asarray(a),
                                   err_msg=str(path), **TOL)


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("S,steps,buf_extra", [(12, 8, 8), (64, 8, 24)])
def test_deepseek_prefill_and_greedy_decode_match_jax(S, steps, buf_extra,
                                                      absorb):
    """The reduced deepseek-v2 (MLA and MoE layers) from the JAX params:
    prefill, then ``steps`` greedy decode steps with ``absorb_mla``; logits
    within ``TOL`` every step, greedy tokens equal, and the latent caches
    after the last step; the router launches nothing on the CPU."""
    jm, jp, tm, tp = both(ARCH)
    toks = np.random.default_rng(S).integers(0, jm.cfg.vocab, (2, S),
                                             dtype=np.int32)
    before = mr.moe_routing.launches
    want, got, (jcache, tcache) = run_models(
        jm, jp, tm, tp, {"tokens": toks}, steps, S + steps + buf_extra,
        absorb)
    assert mr.moe_routing.launches == before
    assert len(got) == steps + 1
    held_steps(want, got)
    held_caches(jcache, tcache, {"ckv", "krope"})
    assert tcache[0]["ckv"].shape == (tm.cfg.n_layers, 2, S + steps
                                      + buf_extra, tm.cfg.mla.kv_lora_rank)


def test_absorbed_decode_is_the_expanded_decode_at_its_score_scale():
    """The absorbed decode attends in the latent space, where q is
    R + rope wide, and divides the scores by sqrt(R + rope), as the JAX
    layer does; the expanded decode divides by sqrt(nope + rope).  With q
    scaled by sqrt((nope + rope) / (R + rope)) in the expanded decode, the
    two give the same logits (the same function, contracted in another
    order); without it they differ (different softmax temperatures)."""
    cfg = t_reduced(t_get_config(ARCH))
    m = cfg.mla
    ratio = math.sqrt((m.qk_nope_head_dim + m.qk_rope_head_dim)
                      / (m.kv_lora_rank + m.qk_rope_head_dim))
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12)))

    def scaled(cfg_, q, k, v, **kw):
        if q.shape[1] == 1 and kw.get("k_valid") is not None:
            q = q * ratio
        return common.attention(cfg_, q, k, v, **kw)

    def run(absorb, attention=common.attention):
        logits, caches = model.prefill(params, {"tokens": toks})
        caches = pad_cache(caches, model.init_cache(2, 24))
        outs = []
        with mock.patch("repro_torch.models.layers.attention", attention):
            for i in range(8):
                logits, caches = model.decode(
                    params, caches, {"token": logits.argmax(-1)[:, None],
                                     "pos": 12 + i}, absorb_mla=absorb)
                outs.append(logits)
        return torch.stack(outs)

    lat, exp_scaled, exp = run(True), run(False, scaled), run(False)
    torch.testing.assert_close(lat, exp_scaled, rtol=1e-5, atol=1e-5)
    rel = float((lat[0] - exp[0]).abs().max() / exp[0].abs().max())
    assert rel > 1e-2, rel


def test_generate_equals_the_jax_engine():
    jeng, teng = engines(ARCH)
    toks = np.random.default_rng(1).integers(0, 256, (2, 16), dtype=np.int32)
    want = jeng.generate({"tokens": jnp.asarray(toks)}, n_tokens=8)
    got = teng.generate({"tokens": torch.from_numpy(toks)}, n_tokens=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for key in ("prefill_tokens", "decoded_tokens", "batches"):
        assert getattr(teng.stats, key) == getattr(jeng.stats, key)
    assert teng.cache_footprint(2) == jeng.cache_footprint(2)


def test_serve_deepseek_runs_on_the_cpu(capsys):
    """The MLA family through the launcher: each request placed on the
    deepseek-v2 engine's plan, the router on its plain version."""
    before = mr.moe_routing.launches
    stats = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                        "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("req 0 -> ") and "(c*=" in lines[0]
    assert "generated 4 tokens x batch 2" in lines[1]
    assert stats.decoded_tokens == 16 and stats.batches == 2
    assert mr.moe_routing.launches == before
