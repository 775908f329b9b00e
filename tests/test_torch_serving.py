"""The port's serving engine, samplers, cache utilities and launcher against
the JAX package, on the CPU (f32 reduced configs; converted params)."""

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
from repro.models.registry import build_model as jax_build_model
from repro.serving import sampling as jax_sampling
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.kvcache import cache_bytes as jax_cache_bytes
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.launch import serve
from repro_torch.models.convert import from_jax
from repro_torch.models.registry import build_model
from repro_torch.serving import sampling
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.kvcache import cache_bytes

ROOT = Path(__file__).resolve().parents[1]


def engines(arch, max_len=48):
    jcfg = reduced(get_config(arch))
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tcfg = t_reduced(t_get_config(arch))
    tm = build_model(tcfg, device="cpu")
    tp = from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return (JaxEngine(jm, jp, max_len=max_len, sampler=jax_sampling.greedy),
            InferenceEngine(tm, tp, max_len=max_len))


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b", "h2o-danube-1.8b",
                                  "rwkv6-1.6b"])
def test_generate_equals_the_jax_engine(arch):
    jeng, teng = engines(arch)
    toks = np.random.default_rng(1).integers(0, 256, (2, 16), dtype=np.int32)
    want = jeng.generate({"tokens": jnp.asarray(toks)}, n_tokens=6)
    got = teng.generate({"tokens": torch.from_numpy(toks)}, n_tokens=6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for key in ("prefill_tokens", "decoded_tokens", "batches"):
        assert getattr(teng.stats, key) == getattr(jeng.stats, key)
    again = teng.generate({"tokens": torch.from_numpy(toks)}, n_tokens=6)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    assert teng.stats.batches == 2 and teng.stats.decoded_tokens == 24


@pytest.mark.parametrize("arch,B,L", [("qwen3-4b", 2, 48),
                                      ("h2o-danube-1.8b", 3, 100),
                                      ("gemma-2b", 1, 7),
                                      ("rwkv6-1.6b", 2, 48)])
def test_cache_bytes_and_footprint_equal_the_jax_package(arch, B, L):
    jeng, teng = engines(arch, max_len=L)
    want = jax_cache_bytes(jeng.model.init_cache(B, L))
    assert cache_bytes(teng.model.init_cache(B, L)) == want
    assert teng.cache_footprint(B) == jeng.cache_footprint(B) == want


def test_top_k_stays_within_its_support():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 100), dtype=np.float32))
    top5 = torch.argsort(logits, dim=-1)[:, -5:]
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(20):
        tok = sampling.top_k(logits, gen, k=5)
        assert tok.dtype == torch.int32
        for b in range(4):
            assert int(tok[b]) in top5[b].tolist()
            seen.add((b, int(tok[b])))
    assert len(seen) > 4          # it samples, not only the argmax


def test_samplers_follow_their_generator_and_greedy_takes_the_first_tie():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 0.0, 5.0]])
    assert sampling.greedy(logits).tolist() == [1, 0]
    assert np.asarray(jax_sampling.greedy(jnp.asarray(logits.numpy()))
                      ).tolist() == [1, 0]
    wide = torch.randn(8, 50, generator=torch.Generator().manual_seed(3))
    for fn in (sampling.temperature, sampling.top_k):
        a = fn(wide, torch.Generator().manual_seed(9))
        b = fn(wide, torch.Generator().manual_seed(9))
        assert torch.equal(a, b)
    cold = sampling.temperature(wide, torch.Generator().manual_seed(1),
                                temp=1e-9)
    assert torch.equal(cold, sampling.greedy(wide))


def test_serve_entry_point_runs_on_the_cpu(capsys):
    stats = serve.main(["--arch", "qwen3-4b", "--device", "cpu",
                        "--requests", "2", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("req 0 -> cloud-pod (c*=")
    assert "generated 4 tokens x batch 2" in lines[1]
    assert lines[2].startswith("stats: prefill 64 tok")
    assert stats.decoded_tokens == 16


def test_serve_rwkv_runs_on_the_cpu(capsys):
    """The RWKV family through the launcher: each request placed on the
    ``rwkv6-1.6b/bf16`` engine's plan, the WKV scan on its plain version."""
    from repro_torch.kernels import rwkv_scan as rs
    before = rs.rwkv_scan.launches
    stats = serve.main(["--arch", "rwkv6-1.6b", "--device", "cpu",
                        "--requests", "2", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("req 0 -> ") and "(c*=" in lines[0]
    assert "generated 4 tokens x batch 2" in lines[1]
    assert lines[2].startswith("stats: prefill 64 tok")
    assert stats.decoded_tokens == 16 and stats.batches == 2
    assert rs.rwkv_scan.launches == before


def test_serve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-4b"])


def test_subprocess_serve_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (
        "import sys, runpy\n"
        "sys.argv = ['serve', '--arch', 'qwen3-4b', '--device', 'cpu']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.kernels.decode_attention' in sys.modules\n"
        "print('ISOLATED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.splitlines()
    assert out[-1] == "ISOLATED"
    assert out[-2].startswith("stats: prefill 96 tok")
