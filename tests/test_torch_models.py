"""The port's decoder models against the JAX package on the CPU.

Params come from the JAX package's ``init_params`` and are carried across
with ``convert.from_jax``; tokens are drawn from a numpy seed.  Both sides
run in float32 (the reduced configs), so logits agree to 1e-5 (rtol and
atol: the same math, summed in another order) and greedy tokens are equal.
On CPU tensors the port's attention kernels run their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models import common as jcommon
from repro.models.registry import build_model as jax_build_model
from repro.serving.kvcache import pad_cache as jax_pad_cache
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.models import common
from repro_torch.models.convert import from_jax, to_torch
from repro_torch.models.registry import build_model
from repro_torch.serving.kvcache import pad_cache

DENSE = ["qwen3-4b", "qwen3-32b", "gemma-2b", "h2o-danube-1.8b"]
PORTED = DENSE + ["rwkv6-1.6b", "deepseek-v2-236b", "llama-3.2-vision-11b",
                  "hymba-1.5b", "seamless-m4t-medium"]
TOL = dict(rtol=1e-5, atol=1e-5)


def to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def jax_params(cfg, seed=0):
    model = jax_build_model(cfg)
    return model, jax.tree.map(np.asarray, model.init_params(
        jax.random.PRNGKey(seed)))


def both(arch, **overrides):
    """(JAX model, JAX params, port model, port params) for ``arch``."""
    jm, jp = jax_params(reduced(get_config(arch), **overrides))
    tcfg = t_reduced(t_get_config(arch), **overrides)
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, from_jax(jp, tcfg, device="cpu")


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PORTED)
def test_from_jax_round_trip(arch, dtype):
    jm, jp, tm, tp = both(arch, dtype=dtype)
    jl, tl = dict(leaves(jp)), dict(leaves(tp))
    assert jl.keys() == tl.keys()
    for path, a in jl.items():
        t = tl[path]
        # the router and Mamba's A_log stay f32
        want = "float32" if path[-1] in ("router", "A_log") else dtype
        assert t.device.type == "cpu" and str(t.dtype).endswith(want), path
        np.testing.assert_array_equal(to_numpy(t).view(np.uint8),
                                      np.asarray(a).view(np.uint8))
    # the port's own init has the same keys, shapes and dtypes
    own = dict(leaves(tm.init_params(torch.Generator().manual_seed(0))))
    assert own.keys() == tl.keys()
    for path, t in own.items():
        assert (t.shape, t.dtype) == (tl[path].shape, tl[path].dtype), path


def test_from_jax_refuses_a_tree_of_another_config():
    jm, jp = jax_params(reduced(get_config("qwen3-4b"), n_layers=3))
    with pytest.raises(ValueError, match="leading dims"):
        from_jax(jp, t_reduced(t_get_config("qwen3-4b")), device="cpu")
    with pytest.raises(ValueError, match="not a"):
        from_jax({"embed": jp["embed"]}, t_reduced(t_get_config("qwen3-4b")),
                 device="cpu")


def test_port_init_follows_the_jax_distributions():
    cfg = t_reduced(t_get_config("qwen3-4b"), d_model=256, vocab=1024)
    p = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    wq = p["groups"][0]["attn"]["wq"]          # [n, D, H, hd], fan-in D
    assert abs(float(wq.std()) - 256 ** -0.5) < 0.02 * 256 ** -0.5
    wo = p["groups"][0]["attn"]["wo"]          # [n, H, hd, D], fan-in D
    assert abs(float(wo.std()) - 256 ** -0.5) < 0.02 * 256 ** -0.5
    assert abs(float(p["embed"]["tok"].std()) - 0.02) < 0.001
    assert not p["groups"][0]["ln1"].any() and not p["embed"][
        "final_norm"].any()


CASES = [
    # (Sq, Sk, causal, window, q_offset, k_valid): the prefill shape, the
    # decode shape, and shapes that take the JAX package's own rule
    (16, 16, True, None, 0, None),
    (96, 96, True, None, 0, None),
    (96, 96, True, 20, 0, None),
    (1, 16, False, None, 0, 10),
    (1, 96, False, None, 0, 70),
    (5, 16, False, None, 0, None),
    (5, 96, True, None, 91, None),
    (3, 96, False, None, 0, 50),
]


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset,k_valid", CASES)
def test_attention_dispatch_matches_jax(monkeypatch, Sq, Sk, causal, window,
                                       q_offset, k_valid):
    jcfg = reduced(get_config("qwen3-4b"))
    tcfg = t_reduced(t_get_config("qwen3-4b"))
    assert jcfg.flash_threshold == tcfg.flash_threshold == 64
    rng = np.random.default_rng(Sq * 100 + Sk)
    B, H, K, hd = 2, 4, 2, 16
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))
    calls = []
    for name in ("flash_attention", "decode_attention"):
        real = getattr(common, name)
        monkeypatch.setattr(common, name,
                            lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              k_valid=k_valid)
    out = common.attention(tcfg, *map(torch.from_numpy, (q, k, v)), **kw)
    want = jcommon.attention(jcfg, *map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    expect = ("flash_attention" if Sq == Sk and k_valid is None else
              "decode_attention" if Sq == 1 and k_valid is not None else None)
    assert calls == ([expect] if expect else [])


def greedy_run(model, params, prefill_batch, steps, buf_len, to_host,
               pad, argmax, step_batch, caches_out=None):
    logits, caches = model.prefill(params, prefill_batch)
    caches = pad(caches, model.init_cache(logits.shape[0], buf_len))
    S = prefill_batch["tokens"].shape[1]
    outs = [to_host(logits)]
    for i in range(steps):
        tok = argmax(logits)
        logits, caches = model.decode(params, caches, step_batch(tok, S + i))
        outs.append(to_host(logits))
    if caches_out is not None:
        caches_out.append(caches)
    return outs


def run_both(arch, B, S, steps, seed, buf_extra=8, caches_out=None):
    jm, jp, tm, tp = both(arch)
    toks = np.random.default_rng(seed).integers(0, jm.cfg.vocab, (B, S),
                                                dtype=np.int32)
    want = greedy_run(
        jm, jp, {"tokens": jnp.asarray(toks)}, steps, S + steps + buf_extra,
        lambda x: np.asarray(x), jax_pad_cache,
        lambda lg: jnp.argmax(lg, axis=-1).astype(jnp.int32),
        lambda tok, pos: {"token": tok[:, None], "pos": jnp.int32(pos)},
        caches_out)
    got = greedy_run(
        tm, tp, {"tokens": torch.from_numpy(toks)}, steps,
        S + steps + buf_extra, lambda x: x.numpy().copy(), pad_cache,
        lambda lg: torch.argmax(lg, dim=-1).to(torch.int32),
        lambda tok, pos: {"token": tok[:, None], "pos": pos}, caches_out)
    return want, got


@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_and_greedy_decode_match_jax(arch):
    want, got = run_both(arch, B=2, S=12, steps=4, seed=7)
    assert len(got) == 5
    for step, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, err_msg=f"step {step}", **TOL)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("S,steps", [(28, 10), (64, 4)])
def test_danube_ring_buffer_matches_jax(S, steps):
    """The reduced danube's window is 32: a prompt shorter than the window
    decodes across the ring's wrap; a prompt of two windows starts from a
    full ring (the JAX package assumes S % window == 0 there)."""
    want, got = run_both("h2o-danube-1.8b", B=2, S=S, steps=steps, seed=S)
    for step, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, err_msg=f"step {step}", **TOL)


def test_decode_writes_the_preallocated_cache_in_place():
    tcfg = t_reduced(t_get_config("qwen3-4b"))
    model = build_model(tcfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, tcfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    logits, caches = model.prefill(params, {"tokens": toks})
    cache = pad_cache(caches, model.init_cache(2, 12))
    k = cache[0]["k"]
    ptr = k.data_ptr()
    _, out = model.decode(params, cache, {"token": toks[:, :1], "pos": 6})
    assert out[0]["k"].data_ptr() == ptr
    assert k[:, :, 6].abs().sum() > 0 and not k[:, :, 7:].any()


@pytest.mark.parametrize("S,steps", [(12, 4), (33, 6)])
def test_rwkv_prefill_decode_and_cache_match_jax(S, steps):
    """The reduced rwkv6 (hd 16) from the JAX params: prefill and decode
    logits within ``TOL``, greedy tokens equal, and every cache leaf (the
    f32 WKV state and the two token shifts) after the decode steps."""
    caches = []
    want, got = run_both("rwkv6-1.6b", B=2, S=S, steps=steps, seed=S,
                         caches_out=caches)
    assert len(got) == steps + 1
    for step, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, err_msg=f"step {step}", **TOL)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    jcache, tcache = caches
    jl, tl = dict(leaves(jcache)), dict(leaves(tcache))
    assert jl.keys() == tl.keys() and len(tl) == 3
    for path, a in jl.items():
        assert tuple(tl[path].shape) == a.shape, path
        np.testing.assert_allclose(tl[path].numpy(), np.asarray(a),
                                   err_msg=str(path), **TOL)


def test_rwkv_decode_writes_its_cache_in_place():
    tcfg = t_reduced(t_get_config("rwkv6-1.6b"))
    model = build_model(tcfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    g = params["groups"][0]
    assert float(g["tm"]["w0"].min()) == float(g["tm"]["w0"].max()) == -1.0
    assert not any(g["tm"][f"lora_{n}_b"].any() for n in "rkvwg")
    assert g["tm"]["u"].shape == (tcfg.n_layers, tcfg.d_model)
    toks = torch.randint(0, tcfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    _, caches = model.prefill(params, {"tokens": toks})
    cache = pad_cache(caches, model.init_cache(2, 12))
    before = {k: (t.data_ptr(), t.clone()) for k, t in cache[0].items()}
    _, out = model.decode(params, cache, {"token": toks[:, :1], "pos": 6})
    for key, (ptr, old) in before.items():
        assert out[0][key].data_ptr() == ptr, key
        assert not torch.equal(out[0][key], old), key


def test_to_torch_keeps_bfloat16_bits():
    a = np.asarray(jnp.asarray([1.0, -2.5, 3.14159, 1e-3], jnp.bfloat16))
    t = to_torch(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(t).view(np.uint16),
                                  a.view(np.uint16))
