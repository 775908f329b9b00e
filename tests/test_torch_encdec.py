"""The port's encoder-decoder family (seamless-m4t: a bidirectional encoder
over stubbed audio frame embeddings, decoder layers of self-attention,
ungated cross-attention over the encoder's output and an MLP) against the
JAX package, on the CPU.

Params come from the JAX initialisers and are carried across with
``convert.from_jax`` (the ``encoder`` subtree too); inputs are drawn from a
numpy seed.  Both sides run in float32, so encoder outputs, logits and
caches agree to rtol = atol = 1e-5 and greedy tokens are equal.  The
attention kernels run their plain versions (CPU tensors launch nothing)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models import decoder as jdecoder
from repro.serving.kvcache import pad_cache as jax_pad_cache
from repro_torch._tree import tree_map
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import decoder
from repro_torch.models.convert import from_jax, to_torch
from repro_torch.serving.kvcache import pad_cache
from test_torch_mla import held_caches, held_steps
from test_torch_models import both
from test_torch_serving import engines

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **TOL)


def audio_batch(cfg, B, S, S_src, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
            "audio_embeds": (0.02 * rng.standard_normal(
                (B, S_src, cfg.d_model))).astype(np.float32)}


@pytest.mark.parametrize("S", [16, 24, 64])
def test_encoder_stack_matches_jax(S):
    """The bidirectional encoder (non-causal attention, RoPE, the final
    norm) on frame embeddings of S frames, from the JAX ``init_encoder``
    params with nonzero norm scales; S = 64 takes the JAX chunked path."""
    jcfg = reduced(get_config(ARCH))
    tcfg = t_reduced(t_get_config(ARCH))
    jp = jax.tree.map(np.asarray, jdecoder.init_encoder(
        jax.random.PRNGKey(S), jcfg))
    rng = np.random.default_rng(S)
    for key in ("ln1", "ln2"):
        a = jp["layers"][key]
        jp["layers"][key] = (0.3 * rng.standard_normal(a.shape)).astype(
            a.dtype)
    tp = tree_map(to_torch, jp)
    assert tp["layers"]["ln1"].shape[0] == jcfg.encdec.n_enc_layers
    x = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    want = jdecoder.encoder_stack(jp, jcfg, jnp.asarray(x))
    counts = fa.flash_attention.launches
    got = decoder.encoder_stack(tp, tcfg, torch.from_numpy(x))
    assert fa.flash_attention.launches == counts
    close(got, want, "encoder")
    # bidirectional: the first frame's output sees the last frame
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved = decoder.encoder_stack(tp, tcfg, torch.from_numpy(x2))
    assert not torch.allclose(moved[:, 0], got[:, 0])


def run_encdec(jm, jp, tm, tp, batch, steps, buf_len):
    """Prefill, then ``steps`` greedy decode steps on both sides, the cross
    caches sized to the audio length (``init_cache``'s ``ctx_len``, as the
    engines size them); returns each step's logits and both final caches.
    The JAX side runs jitted."""
    ctx_len = batch["audio_embeds"].shape[1]
    sides = (
        (dataclasses.replace(jm, prefill=jax.jit(jm.prefill),
                             decode=jax.jit(jm.decode)), jp, jnp.asarray,
         np.asarray, jax_pad_cache,
         lambda lg: jnp.argmax(lg, axis=-1).astype(jnp.int32), jnp.int32),
        (tm, tp, torch.from_numpy, lambda t: t.numpy().copy(), pad_cache,
         lambda lg: torch.argmax(lg, dim=-1).to(torch.int32), int))
    runs = []
    for model, params, put, host, pad, argmax, as_pos in sides:
        logits, caches = model.prefill(
            params, {k: put(v) for k, v in batch.items()})
        B, S = batch["tokens"].shape
        caches = pad(caches, model.init_cache(B, buf_len, ctx_len))
        outs = [host(logits)]
        for i in range(steps):
            tok = argmax(logits)
            logits, caches = model.decode(
                params, caches, {"token": tok[:, None], "pos": as_pos(S + i)})
            outs.append(host(logits))
        runs.append((outs, caches))
    (want, jcache), (got, tcache) = runs
    return want, got, jcache, tcache


@pytest.mark.parametrize("S_src", [16, 24])
def test_encdec_prefill_and_greedy_decode_match_jax(S_src):
    """The reduced seamless-m4t from the JAX params, a 16-token prompt over
    ``S_src`` audio frames (equal to the prompt: the cross prefill is
    flash-shaped; unequal: it is not): prefill, then 8 greedy decode steps;
    logits within ``TOL`` every step, greedy tokens equal, and every cache
    (self k and v, cross ck and cv) after the last step."""
    jm, jp, tm, tp = both(ARCH)
    batch = audio_batch(jm.cfg, 2, 16, S_src, S_src)
    steps = 8
    counts = (fa.flash_attention.launches, da.decode_attention.launches)
    want, got, jcache, tcache = run_encdec(jm, jp, tm, tp, batch, steps,
                                           16 + steps + 8)
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == counts
    assert len(got) == steps + 1
    held_steps(want, got)
    held_caches(jcache, tcache, {"k", "v", "ck", "cv"})
    L, K, hd = tm.cfg.n_layers, tm.cfg.n_kv_heads, tm.cfg.head_dim
    assert [tuple(c["cross"]["ck"].shape) for c in tcache] == [
        (L, 2, S_src, K, hd)]
    assert [tuple(c["attn"]["k"].shape) for c in tcache] == [
        (L, 2, 16 + steps + 8, K, hd)]


def test_cross_caches_come_from_the_encoded_audio():
    """Prefill's cross caches are ck, cv of the encoder's output: scaling
    the audio moves them (and the logits) as it moves the JAX model's."""
    jm, jp, tm, tp = both(ARCH)
    batch = audio_batch(jm.cfg, 2, 16, 24, 4)
    results = []
    for scale in (1.0, 3.0):
        b = dict(batch, audio_embeds=scale * batch["audio_embeds"])
        jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in b.items()})
        tl, tc = tm.prefill(tp, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
        close(tl, jl, f"logits x {scale}")
        for key in ("ck", "cv"):
            close(tc[0]["cross"][key], jc[0]["cross"][key], key)
        results.append(tc[0]["cross"]["ck"])
    assert not torch.allclose(*results)


def test_from_jax_takes_the_encoder_subtree():
    """The ``encoder`` subtree is carried across (its leaves bit for bit:
    ``test_from_jax_round_trip``); a tree without it, or with its layers
    stacked to another depth, is refused."""
    jm, jp, tm, tp = both(ARCH)
    assert set(tp) == {"embed", "groups", "encoder"}
    assert set(tp["encoder"]) == {"layers", "final_norm"}
    with pytest.raises(ValueError, match="not a"):
        from_jax({"embed": jp["embed"], "groups": jp["groups"]}, tm.cfg,
                 device="cpu")
    short = dict(jp, encoder=dict(jp["encoder"], layers=jax.tree.map(
        lambda a: a[:1], jp["encoder"]["layers"])))
    with pytest.raises(ValueError, match="leading dims"):
        from_jax(short, tm.cfg, device="cpu")


def test_engine_sizes_the_cross_cache_from_audio_embeds():
    """The engine passes ``audio_embeds``' length to ``init_cache`` as the
    JAX engine does, and generates the JAX engine's tokens."""
    jeng, teng = engines(ARCH, max_len=32)
    sizes = []
    init_cache = teng.model.init_cache

    def spy(B, buf_len, ctx_len=None, **kw):
        sizes.append((B, buf_len, ctx_len))
        return init_cache(B, buf_len, ctx_len, **kw)

    teng.model = dataclasses.replace(teng.model, init_cache=spy)
    batch = audio_batch(jeng.model.cfg, 2, 16, 24, 1)
    want = jeng.generate({k: jnp.asarray(v) for k, v in batch.items()},
                         n_tokens=6)
    got = teng.generate({k: torch.from_numpy(v) for k, v in batch.items()},
                        n_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sizes == [(2, 32, 24)]
    for key in ("prefill_tokens", "decoded_tokens", "batches"):
        assert getattr(teng.stats, key) == getattr(jeng.stats, key)
    assert teng.cache_footprint(2) == jeng.cache_footprint(2)


def test_serve_encdec_runs_on_the_cpu(capsys):
    """The encoder-decoder family through the launcher, ``audio_embeds``
    made as the JAX launcher makes them (0.02 x a standard normal of the
    prompt's length), in the model's dtype."""
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
    ae = serve.audio_embeds(cfg, 3, 20, torch.Generator().manual_seed(0),
                            "cpu")
    assert ae.dtype == torch.bfloat16 and ae.shape == (3, 20, cfg.d_model)
    assert abs(float(ae.float().std()) - 0.02) < 0.002
