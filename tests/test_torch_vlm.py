"""The port's cross-attention sublayer and the reduced llama-3.2-vision
model (self-attention layers mixed with gated cross-attention layers over
the vision embeddings) against the JAX package, on the CPU.

Params come from the JAX initialisers and are carried across with
``convert``; inputs are drawn from a numpy seed.  Both sides run in
float32, so outputs, logits and caches agree to rtol = atol = 1e-5 and
greedy tokens are equal.  The JAX init sets every cross layer's
``gate_attn`` and ``gate_ffn`` to 0, and tanh(0) = 0 multiplies the whole
cross-attention path by zero, so the model cases set them to 0.5 (and one
case keeps them at 0).  The attention kernels run their plain versions
(CPU tensors launch nothing)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models import layers as jlayers
from repro.models.registry import build_model as jax_build_model
from repro.serving import sampling as jax_sampling
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.kvcache import pad_cache as jax_pad_cache
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.convert import from_jax, to_torch
from repro_torch.models.decoder import build_layout
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.kvcache import pad_cache
from test_torch_mla import held_caches, held_steps, run_models

ARCH = "llama-3.2-vision-11b"
TOL = dict(rtol=1e-5, atol=1e-5)
GATE = 0.5


def close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **TOL)


@pytest.mark.parametrize("S,S_ctx", [(12, 17), (16, 96)])
def test_cross_sublayer_prefill_and_decode_match_jax(S, S_ctx):
    """Prefill computes ck and cv from the context and returns them as the
    cache; decode attends over that cache (S_ctx 17 takes the naive path,
    96 the chunked one)."""
    jcfg = reduced(get_config(ARCH))
    tcfg = t_reduced(t_get_config(ARCH))
    jp = jax.tree.map(np.asarray, jlayers.init_cross_attention(
        jax.random.PRNGKey(S), jcfg, jnp.float32, gated=True))
    tp = tree_map(to_torch, jp)
    assert set(tp) == {"wq", "wk", "wv", "wo", "gate_attn", "gate_ffn"}
    B, D = 2, jcfg.d_model
    rng = np.random.default_rng(S)
    x, ctx, x1 = (rng.standard_normal(s, dtype=np.float32)
                  for s in ((B, S, D), (B, S_ctx, D), (B, 1, D)))

    y_j, c_j = jlayers.cross_sublayer(jp, jcfg, jnp.asarray(x),
                                      mode="prefill", cache=None,
                                      ctx=jnp.asarray(ctx))
    y_t, c_t = layers.cross_sublayer(tp, tcfg, torch.from_numpy(x),
                                     mode="prefill", cache=None,
                                     ctx=torch.from_numpy(ctx))
    close(y_t, y_j, "prefill y")
    assert set(c_t) == set(c_j) == {"ck", "cv"}
    for key in c_j:
        assert tuple(c_t[key].shape) == (B, S_ctx, jcfg.n_kv_heads,
                                         jcfg.head_dim)
        close(c_t[key], c_j[key], key)

    y_j, _ = jlayers.cross_sublayer(jp, jcfg, jnp.asarray(x1), mode="decode",
                                    cache=c_j, ctx=None)
    y_t, out = layers.cross_sublayer(tp, tcfg, torch.from_numpy(x1),
                                     mode="decode", cache=c_t, ctx=None)
    close(y_t, y_j, "decode y")
    assert out is c_t


def vlm_params(gate, n_layers):
    """(JAX model, JAX params, port model, port params) of the reduced
    llama-3.2-vision with ``n_layers`` layers, every cross layer's gates
    set to ``gate`` on both sides."""
    jcfg = reduced(get_config(ARCH), n_layers=n_layers)
    tcfg = t_reduced(t_get_config(ARCH), n_layers=n_layers)
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    kinds = [g.spec.kind for g in build_layout(tcfg)]
    assert "cross" in kinds and "dense" in kinds
    for kind, g in zip(kinds, jp["groups"]):
        if kind == "cross":
            assert not g["attn"]["gate_attn"].any()   # the JAX init: 0
            for key in ("gate_attn", "gate_ffn"):
                g["attn"][key] = np.full_like(g["attn"][key], gate)
    return jm, jp, build_model(tcfg, device="cpu"), from_jax(jp, tcfg,
                                                             device="cpu")


def vlm_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
            "vision_embeds": (0.02 * rng.standard_normal(
                (B, cfg.vision.n_vision_tokens, cfg.d_model))).astype(
                    np.float32)}


@pytest.mark.parametrize("gate,n_layers,S,buf_extra", [
    (GATE, 4, 12, 8), (GATE, 5, 64, 24), (0.0, 4, 12, 8)])
def test_vlm_prefill_and_greedy_decode_match_jax(gate, n_layers, S,
                                                 buf_extra):
    """The reduced llama-3.2-vision (cross layers at 0, 2, ...) from the
    JAX params with ``vision_embeds``: prefill, then 8 greedy decode steps;
    logits within ``TOL`` every step, greedy tokens equal, and every cache
    (the self layers' k and v, the cross layers' ck and cv) after the last
    step.  The self layers' attention shapes are the kernels' (their plain
    versions here), the cross layers' are not."""
    jm, jp, tm, tp = vlm_params(gate, n_layers)
    batch = vlm_batch(jm.cfg, 2, S, S)
    steps = 8
    counts = (fa.flash_attention.launches, da.decode_attention.launches)
    want, got, (jcache, tcache) = run_models(
        jm, jp, tm, tp, batch, steps, S + steps + buf_extra, False)
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == counts
    assert len(got) == steps + 1
    held_steps(want, got)
    held_caches(jcache, tcache, {"k", "v", "ck", "cv"})
    cross = [c for c in tcache if "ck" in c]
    assert cross and all(
        c["ck"].shape[2] == tm.cfg.vision.n_vision_tokens for c in cross)


def test_gates_move_the_output():
    """With the gates at 0.5 the cross layers change the logits; at 0 they
    do not reach them (so a fault there shows only with nonzero gates)."""
    outs = {}
    for gate in (0.0, GATE):
        _, _, tm, tp = vlm_params(gate, 4)
        batch = vlm_batch(tm.cfg, 2, 12, 5)
        logits = []
        for scale in (1.0, 2.0):
            b = {"tokens": torch.from_numpy(batch["tokens"]),
                 "vision_embeds": scale * torch.from_numpy(
                     batch["vision_embeds"])}
            logits.append(tm.prefill(tp, b)[0])
        outs[gate] = logits
    assert torch.equal(*outs[0.0])
    assert not torch.allclose(*outs[GATE])


def test_decode_reads_the_cross_cache_not_the_context():
    """Decode takes no context: its cross layers read ck and cv from the
    cache.  Scaling the cached cv after prefill moves the port's decode
    logits exactly as it moves the JAX model's."""
    jm, jp, tm, tp = vlm_params(GATE, 4)
    batch = vlm_batch(jm.cfg, 2, 12, 9)
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = tm.prefill(tp, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    jc = jax_pad_cache(jc, jm.init_cache(2, 20))
    tc = pad_cache(tc, tm.init_cache(2, 20))
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    results = {}
    for scale in (1.0, 3.0):
        jcs = [dict(c, cv=c["cv"] * scale) if "cv" in c else c for c in jc]
        tcs = [dict(c, cv=c["cv"] * scale) if "cv" in c else
               tree_map(lambda t: t.clone(), c) for c in tc]
        want, _ = jm.decode(jp, jcs, {"token": jnp.asarray(tok)[:, None],
                                      "pos": jnp.int32(12)})
        got, _ = tm.decode(tp, tcs, {"token": torch.from_numpy(tok)[:, None],
                                     "pos": 12})
        close(got, want, f"cv x {scale}")
        results[scale] = got
    assert not torch.allclose(results[1.0], results[3.0])


def test_generate_equals_the_jax_engine():
    jm, jp, tm, tp = vlm_params(GATE, 4)
    jeng = JaxEngine(jm, jp, max_len=32, sampler=jax_sampling.greedy)
    teng = InferenceEngine(tm, tp, max_len=32)
    batch = vlm_batch(jm.cfg, 2, 16, 1)
    want = jeng.generate({k: jnp.asarray(v) for k, v in batch.items()},
                         n_tokens=8)
    got = teng.generate({k: torch.from_numpy(v) for k, v in batch.items()},
                        n_tokens=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for key in ("prefill_tokens", "decoded_tokens", "batches"):
        assert getattr(teng.stats, key) == getattr(jeng.stats, key)
    assert teng.cache_footprint(2) == jeng.cache_footprint(2)


def test_pad_cache_keeps_the_template_where_a_leaf_is_none():
    """As the JAX ``pad_cache``: a None leaf (or subtree) takes the
    template's; a cross cache of the template's shape is copied whole."""
    template = [{"ck": torch.zeros(1, 2, 5, 2, 4), "cv": torch.ones(
        1, 2, 5, 2, 4)}, {"k": torch.zeros(1, 2, 9, 2, 4)}]
    ck = torch.randn(1, 2, 5, 2, 4)
    out = pad_cache([{"ck": ck, "cv": None}, None], template)
    assert all(a is b for a, b in zip(tree_leaves(out),
                                      tree_leaves(template)))
    assert torch.equal(out[0]["ck"], ck) and torch.equal(
        out[0]["cv"], torch.ones(1, 2, 5, 2, 4))
    assert not out[1]["k"].any()
    want = jax_pad_cache([{"ck": np.asarray(ck), "cv": None}, None],
                         [{"ck": np.zeros((1, 2, 5, 2, 4), np.float32),
                           "cv": np.ones((1, 2, 5, 2, 4), np.float32)},
                          {"k": np.zeros((1, 2, 9, 2, 4), np.float32)}])
    close(out[0]["cv"], want[0]["cv"], "cv")
    close(out[0]["ck"], want[0]["ck"], "ck")


def test_serve_vlm_runs_on_the_cpu(capsys):
    """The VLM family through the launcher, ``vision_embeds`` made as the
    JAX launcher makes them (0.02 x a standard normal), in the model's
    dtype; the attention kernels on their plain versions."""
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
    cfg = t_reduced(t_get_config(ARCH), dtype="bfloat16")
    ve = serve.vision_embeds(cfg, 3, torch.Generator().manual_seed(0),
                             "cpu")
    assert ve.dtype == torch.bfloat16
    assert ve.shape == (3, cfg.vision.n_vision_tokens, cfg.d_model)
    assert abs(float(ve.float().std()) - 0.02) < 0.002
