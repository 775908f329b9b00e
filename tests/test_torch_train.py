"""The port's training against the JAX package's on the CPU.

Params come from the JAX package's ``init_params`` through
``convert.from_jax`` (a train state through ``train_state_from_jax``);
tokens and gradients are drawn from numpy seeds.  Both sides run in float32
at the reduced configs' size, where the port's flash attention runs its
plain versions (``FlashAttentionFn`` on ``flash_attention_plain`` and
``flash_attention_bwd_plain``).  Tolerances: the loss and every leaf's
gradient within 1e-5 of the JAX value (the gradient relative to its leaf's
max |g|): the same f32 math summed in another order; the optimizer within
1e-6 (the same f32 expressions in the same order; ``cos`` and ``pow`` may
round differently)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models.registry import build_model as jax_build_model
from repro.training import checkpoint as jax_checkpoint
from repro.training import optimizer as jax_optimizer
from repro.training.data import DataLoader as JaxDataLoader
from repro.training.train_step import init_train_state as jax_init_state
from repro.training.train_step import make_train_step as jax_make_step
from repro_torch._tree import tree_leaves, tree_leaves_with_paths, tree_map
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.launch import train as launcher
from repro_torch.models.convert import from_jax, to_torch, \
    train_state_from_jax
from repro_torch.models.registry import CE_CHUNK, build_model
from repro_torch.training import checkpoint, optimizer
from repro_torch.training.data import DataLoader
from repro_torch.training.train_step import (init_train_state,
                                             loss_and_grads, make_train_step)

TRAINED = ["qwen3-4b", "gemma-2b", "h2o-danube-1.8b", "qwen3-32b",
           "seamless-m4t-medium", "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b",
           "hymba-1.5b", "llama-3.2-vision-11b", "rwkv6-1.6b"]
REL = 1e-5
# the VLM's cross gates in both trees: the init's 0 would multiply the
# whole cross path by tanh(0) = 0, and every cross weight's grad with it
GATE = 0.5


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def jax_paths(tree):
    return {"/".join(str(p) for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return np.abs(a - b).max() / scale if scale else np.abs(a).max()


def batch_of(cfg, B, S, seed):
    """tokens, labels (and a frontend stub) as numpy from a seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        out["audio_embeds"] = (0.02 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32)
    if cfg.family == "vlm":
        out["vision_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.vision.n_vision_tokens, cfg.d_model))).astype(np.float32)
    return out


def with_gates(params):
    """A copy of the numpy ``params`` tree with every cross layer's
    ``gate_attn`` and ``gate_ffn`` at ``GATE`` (no change without them)."""
    def visit(tree):
        if isinstance(tree, dict):
            return {k: (np.full_like(np.asarray(v), GATE)
                        if k in ("gate_attn", "gate_ffn") else visit(v))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [visit(v) for v in tree]
        return tree
    return visit(params)


def both(arch, **overrides):
    jcfg = reduced(get_config(arch), **overrides)
    jm = jax_build_model(jcfg)
    tcfg = t_reduced(t_get_config(arch), **overrides)
    tm = build_model(tcfg, device="cpu")
    return jcfg, jm, tcfg, tm


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# (arch, remat, S): every trained family with remat off and on at S = 32
# (the JAX attention naive, the loss in one piece, the Mamba and WKV scans
# flat), and at S = 1,024 (the JAX chunked flash attention, MLA's on the
# chunked path, chunked_ce_loss's chunked branch; hymba's reduced 32-wide
# window and the Mamba scan's chunked branch; the JAX WKV scan's chunked
# branch against the port's 16 chunk states)
LOSS_CASES = ([(arch, remat, 32) for arch in TRAINED
               for remat in (False, True)]
              + [("qwen3-4b", True, 1024), ("gemma-2b", False, 1024),
                 ("h2o-danube-1.8b", True, 1024),
                 ("qwen3-32b", False, 1024),
                 ("seamless-m4t-medium", True, 1024),
                 ("phi3.5-moe-42b-a6.6b", True, 1024),
                 ("deepseek-v2-236b", False, 1024),
                 ("hymba-1.5b", True, 1024), ("rwkv6-1.6b", True, 1024)])


@pytest.mark.parametrize("arch,remat,S", LOSS_CASES)
def test_train_loss_and_grads_match_jax(arch, remat, S):
    jcfg, jm, tcfg, tm = both(arch, remat=remat)
    assert (S > CE_CHUNK) == (S == 1024)
    jp = with_gates(jax.tree.map(np.asarray,
                                 jm.init_params(jax.random.PRNGKey(0))))
    batch = batch_of(jcfg, 2, S, seed=S)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.train_loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(tm, from_jax(jp, tcfg, device="cpu"),
                                 tbatch(batch))
    assert abs(float(loss) - float(jloss)) <= REL * abs(float(jloss))
    want = jax_paths(jgrads)
    got = dict(tree_leaves_with_paths(grads))
    assert set(got) == set(want)
    for key, g in got.items():
        assert g.shape == want[key].shape, key
        assert rel(to_numpy(g), want[key]) <= REL, key


def test_train_mode_runs_no_cache_and_remat_gives_the_same_numbers():
    _, _, tcfg, tm = both("seamless-m4t-medium")
    params = tm.init_params(torch.Generator().manual_seed(0))
    batch = tbatch(batch_of(tcfg, 2, 16, seed=1))
    loss, grads = loss_and_grads(tm, params, batch)
    rm = build_model(dataclasses.replace(tcfg, remat=True), device="cpu")
    loss_r, grads_r = loss_and_grads(rm, params, batch)
    assert torch.equal(loss, loss_r)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_r)):
        assert torch.equal(a, b)
    x = torch.zeros((1, 4, tcfg.d_model))
    from repro_torch.models.decoder import decoder_stack
    _, caches = decoder_stack(params, tcfg, x, mode="train", ctx=x)
    assert caches == [None] * len(params["groups"])


# ---------------------------------------------------------------------------
# the optimizer


def opt_tree(rng, dtype=np.float32):
    return {"stack": rng.standard_normal((3, 5, 7)).astype(dtype),
            "mat": rng.standard_normal((6, 4)).astype(dtype),
            "vec": rng.standard_normal((9,)).astype(dtype),
            "gate": np.asarray(rng.standard_normal(), dtype)}


def test_adamw_update_matches_jax_through_warmup_and_decay():
    """10 steps of warmup 3, cosine to step 8 and past it, with clipping
    (the grads' norm is above 1 on every step)."""
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=8)
    jcfg = jax_optimizer.AdamWConfig(**cfg)
    tcfg = optimizer.AdamWConfig(**cfg)
    rng = np.random.default_rng(0)
    p0 = opt_tree(rng)
    jp, jstate = ({k: jnp.asarray(v) for k, v in p0.items()},
                  jax_optimizer.init_opt_state(p0))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstate = optimizer.init_opt_state(tp)
    assert tstate["step"].dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in tree_leaves(tstate["m"]))
    for step in range(10):
        g = opt_tree(rng)
        jp, jstate, jm = jax_optimizer.adamw_update(
            jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tp, tstate, tm = optimizer.adamw_update(
            tcfg, tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for tree_t, tree_j in ((tp, jp), (tstate["m"], jstate["m"]),
                               (tstate["v"], jstate["v"])):
            for k in p0:
                np.testing.assert_allclose(tree_t[k].numpy(),
                                           np.asarray(tree_j[k]),
                                           rtol=1e-6, atol=1e-6, err_msg=k)


def test_adamw_keeps_bf16_params_and_slices_give_the_same_bits(monkeypatch):
    """A bf16 leaf is updated in f32 and cast back as JAX casts it (within
    one bf16 rounding of JAX's: the f32 values may differ in their last
    bit); leaves updated in slices of ``CHUNK`` elements agree with leaves
    updated whole, to the global norm's summation order (slice by slice):
    m and v within 1e-6, params within one bf16 rounding."""
    rng = np.random.default_rng(1)
    p0 = {k: to_torch(np.asarray(jnp.asarray(v).astype(jnp.bfloat16)))
          for k, v in opt_tree(rng).items()}
    grads = [{k: torch.from_numpy(v) for k, v in opt_tree(rng).items()}
             for _ in range(3)]
    cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)

    def run():
        p = tree_map(lambda t: t.clone(), p0)
        state = optimizer.init_opt_state(p)
        for g in grads:
            p, state, _ = optimizer.adamw_update(cfg, p, g, state)
        return p, state

    whole = run()
    monkeypatch.setattr(optimizer, "CHUNK", 7)
    # a row of the [3, 5, 7] stack holds 35 > 7 elements: each row is cut
    # along its own first dimension, 5 slices of 7 a row
    assert [s.numel() for s in optimizer._slices(p0["stack"])] == [7] * 15
    assert [s.numel() for s in optimizer._slices(p0["vec"])] == [7, 2]
    sliced = run()
    for a, b in zip(tree_leaves(whole[0]), tree_leaves(sliced[0])):
        torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -8,
                                   atol=1e-6)
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(whole[1][key]),
                        tree_leaves(sliced[1][key])):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert all(t.dtype == torch.bfloat16 for t in whole[0].values())
    jp = {k: jnp.asarray(to_numpy(v)) for k, v in p0.items()}
    jstate = jax_optimizer.init_opt_state(jp)
    jcfg = jax_optimizer.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    for g in grads:
        jp, jstate, _ = jax_optimizer.adamw_update(
            jcfg, jp, {k: jnp.asarray(v.numpy()) for k, v in g.items()},
            jstate)
    for k in p0:
        np.testing.assert_allclose(
            whole[0][k].float().numpy(), np.asarray(jp[k], np.float32),
            rtol=2.0 ** -8, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the train step


def noise_floor(jstep, jstate, batches):
    """For each step, each metric's relative move of the JAX trajectory
    when the initial params are perturbed by 1e-7 relative (numpy seed 0)."""
    rng = np.random.default_rng(0)
    moved = dict(jstate, params=jax.tree.map(
        lambda a: (a * (1 + 1e-7 * rng.standard_normal(a.shape))).astype(
            a.dtype), jstate["params"]))
    floor = []
    for batch in batches:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jstate, m = jstep(jstate, jb)
        moved, mm = jstep(moved, jb)
        floor.append({k: abs(float(mm[k]) - float(m[k])) / abs(float(m[k]))
                      for k in ("loss", "grad_norm", "lr")})
    return floor


@pytest.mark.parametrize("arch,accum_steps", [
    ("h2o-danube-1.8b", 1), ("h2o-danube-1.8b", 2),
    ("phi3.5-moe-42b-a6.6b", 1), ("deepseek-v2-236b", 2),
    ("hymba-1.5b", 1), ("llama-3.2-vision-11b", 1), ("rwkv6-1.6b", 1)],
    ids=["1", "2", "moe-1", "mla-2", "hymba-1", "vlm-1", "rwkv-1"])
def test_train_step_matches_jax_over_three_steps(arch, accum_steps):
    """Three steps of ``make_train_step`` against the JAX step from the same
    state and batches: loss, grad norm and lr within ``REL`` at each step.
    The reduced random rwkv6 is ill-conditioned: JAX's own trajectory moves
    by more than ``REL`` (its grad norm by ~1e-4) when its initial params
    are perturbed by one f32 rounding, 1e-7 relative (``noise_floor``).
    So that case is held within the larger of ``REL`` and its reference's
    own move at that step, the way the card run holds hymba's bf16 logits
    to the plain run's own bf16 noise."""
    jcfg, jm, tcfg, tm = both(arch)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jstate = jax.tree.map(np.asarray,
                          jax_init_state(jm, jax.random.PRNGKey(0)))
    jstate["params"] = with_gates(jstate["params"])
    state = train_state_from_jax(jstate, tcfg, device="cpu")
    jstep = jax.jit(jax_make_step(jm, jax_optimizer.AdamWConfig(**opt),
                                  accum_steps=accum_steps))
    step = make_train_step(tm, optimizer.AdamWConfig(**opt),
                           accum_steps=accum_steps)
    batches = [batch_of(jcfg, 4, 16, seed=10 + i) for i in range(3)]
    floor = (noise_floor(jstep, jstate, batches) if jcfg.family == "ssm"
             else None)
    for i, batch in enumerate(batches):
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        state, metrics = step(state, tbatch(batch))
        for key in ("loss", "grad_norm", "lr"):
            rtol = max(REL, floor[i][key]) if floor else REL
            np.testing.assert_allclose(float(metrics[key]),
                                       float(jmetrics[key]), rtol=rtol,
                                       err_msg=f"{key} step {i} {floor}")
    want = jax_paths({"params": jstate["params"], "opt": jstate["opt"]})
    got = dict(tree_leaves_with_paths(state))
    assert set(got) == set(want)
    assert int(state["opt"]["step"]) == 3


def test_grad_shardings_wait_for_the_sharding_slice(tmp_path):
    """The sharding slice is in: ``make_train_step`` takes
    ``grad_shardings`` (``to_shardings`` of ``opt_pspecs``).  On a (1, 1)
    mesh of a one-rank ``gloo`` group, two steps of the state distributed
    by ``TRAIN_RULES`` and ``opt_pspecs`` take each gradient to its
    sharding and equal the plain steps bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    jcfg, jm, tcfg, tm = both("qwen3-4b")
    jstate = jax.tree.map(np.asarray,
                          jax_init_state(jm, jax.random.PRNGKey(0)))
    opt = optimizer.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    batches = [tbatch(batch_of(jcfg, 4, 16, seed=30 + i)) for i in range(2)]
    plain = train_state_from_jax(jstate, tcfg, device="cpu")
    step = make_train_step(tm, opt)
    want = [step(plain, b)[1] for b in batches]
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        state = train_state_from_jax(jstate, tcfg, device="cpu")
        p_sh = sh.to_shardings(sh.param_pspecs(state["params"], mesh,
                                               sh.TRAIN_RULES), mesh)
        o_sh = sh.to_shardings(sh.opt_pspecs(state["params"], mesh), mesh)
        state = {"params": sh.distribute(state["params"], p_sh),
                 "opt": {"m": sh.distribute(state["opt"]["m"], o_sh),
                         "v": sh.distribute(state["opt"]["v"], o_sh),
                         "step": state["opt"]["step"]}}
        sstep = make_train_step(tm, opt, grad_shardings=o_sh)
        sh.set_active_mesh(mesh)
        try:
            got = [sstep(state, sh.distribute(b, sh.to_shardings(
                sh.batch_pspecs(b, mesh), mesh)))[1] for b in batches]
        finally:
            sh.set_active_mesh(None)
        for w, g in zip(want, got):
            for key in ("loss", "grad_norm", "lr"):
                v = g[key]
                v = v.full_tensor() if isinstance(v, DTensor) else v
                assert torch.equal(v, w[key]), key
        for (key, a), (_, b) in zip(tree_leaves_with_paths(plain),
                                    tree_leaves_with_paths(state)):
            b = b.full_tensor() if isinstance(b, DTensor) else b
            assert torch.equal(a, b), key
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# checkpoints


def small_state(dtype="float32"):
    jcfg, jm, tcfg, tm = both("h2o-danube-1.8b", dtype=dtype)
    jstate = jax.tree.map(np.asarray,
                          jax_init_state(jm, jax.random.PRNGKey(0)))
    return jstate, tcfg, train_state_from_jax(jstate, tcfg, device="cpu")


def test_a_failed_write_leaves_the_previous_checkpoint(tmp_path,
                                                       monkeypatch):
    _, _, state = small_state()
    checkpoint.save(str(tmp_path), 1, state)

    def broken(f, **arrays):
        f.write(b"PK partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save(str(tmp_path), 2, state)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_1.npz", "manifest.json"]
    assert checkpoint.latest_step(str(tmp_path)) == 1
    monkeypatch.undo()
    back = checkpoint.restore(str(tmp_path), state)
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert torch.equal(a, b)


def test_keep_prunes_and_a_mismatch_raises(tmp_path):
    _, tcfg, state = small_state()
    for step in range(1, 6):
        checkpoint.save(str(tmp_path), step, state, keep=2)
    assert checkpoint.all_steps(str(tmp_path)) == [4, 5]
    bad = tree_map(lambda t: t, state)
    bad["params"]["embed"]["tok"] = torch.zeros((3, tcfg.d_model))
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(str(tmp_path), bad)
    bad["params"]["embed"] = {"other": torch.zeros(1)}
    with pytest.raises(KeyError, match="missing leaf"):
        checkpoint.restore(str(tmp_path), bad)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_jax_checkpoint_is_restored_bit_for_bit(tmp_path, dtype):
    jstate, tcfg, template = small_state(dtype)
    rng = np.random.default_rng(3)   # moments that are not zeros
    jstate["opt"]["m"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jstate["opt"]["m"])
    jstate["opt"]["step"] = np.asarray(7, np.int32)
    jax_checkpoint.save(str(tmp_path), 7, jstate)
    with np.load(tmp_path / "ckpt_7.npz") as data:
        kinds = {data[k].dtype.str for k in data.files}
    assert ("|V2" in kinds) == (dtype == "bfloat16")
    back = checkpoint.restore(str(tmp_path), template)
    want = jax_paths(jstate)
    for key, t in tree_leaves_with_paths(back):
        a = to_numpy(t)
        assert a.dtype == want[key].dtype, key
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(want[key]).view(np.uint8),
                                      err_msg=key)


def test_a_port_checkpoint_is_restored_by_jax(tmp_path):
    jstate, tcfg, state = small_state()
    tm = build_model(tcfg, device="cpu")
    state, _ = make_train_step(tm)(state, tbatch(batch_of(tcfg, 2, 8, 4)))
    checkpoint.save(str(tmp_path), 1, state)
    back = jax_checkpoint.restore(str(tmp_path), jstate)
    got = jax_paths(back)
    for key, t in tree_leaves_with_paths(state):
        np.testing.assert_array_equal(got[key], to_numpy(t), err_msg=key)


def test_training_resume_equivalence(tmp_path):
    """Restarting from a checkpoint reproduces the uninterrupted run (the
    JAX package's test, on the port; here bit for bit)."""
    cfg = t_reduced(t_get_config("h2o-danube-1.8b"))
    model = build_model(cfg, device="cpu")
    opt_cfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step_fn = make_train_step(model, opt_cfg)
    gen = DataLoader(cfg.vocab, 4, 16, seed=0)
    bs = [tbatch(next(gen)) for _ in range(10)]
    gen.close()

    def fresh():
        return init_train_state(model, torch.Generator().manual_seed(0))

    state = fresh()
    for b in bs:
        state, _ = step_fn(state, b)
    ref_loss = step_fn(tree_map(lambda t: t.clone(), state), bs[0])[1]["loss"]
    state2 = fresh()
    for b in bs[:5]:
        state2, _ = step_fn(state2, b)
    checkpoint.save(str(tmp_path), 5, state2)
    restored = checkpoint.restore(str(tmp_path), fresh())
    for b in bs[5:]:
        restored, _ = step_fn(restored, b)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(a, b)
    assert torch.equal(step_fn(restored, bs[0])[1]["loss"], ref_loss)


def test_the_data_pipeline_is_the_jax_one():
    a, b = DataLoader(256, 3, 20, seed=5), JaxDataLoader(256, 3, 20, seed=5)
    for _ in range(3):
        x, y = next(a), next(b)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(x[k], y[k])
    a.close()
    b.close()


def test_train_state_from_jax_keeps_dtypes():
    jstate, tcfg, state = small_state("bfloat16")
    assert state["opt"]["step"].dtype == torch.int32
    for key, t in tree_leaves_with_paths(state):
        want = np.asarray(jax_paths(jstate)[key])
        assert to_numpy(t).dtype == want.dtype, key
    assert all(t.dtype == torch.float32
               for t in tree_leaves(state["opt"]["m"]))


# ---------------------------------------------------------------------------
# the launcher


def test_the_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen3-4b", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"]
    first = launcher.main(argv + ["--steps", "10"])
    out = capsys.readouterr().out
    assert "[qwen3-4b] step   10 loss " in out and "it/s)" in out
    assert first["start"] == 0 and len(first["losses"]) == 10
    assert checkpoint.all_steps(str(tmp_path)) == [5, 10]
    again = launcher.main(argv + ["--steps", "12"])
    assert "resumed from step 10" in capsys.readouterr().out
    assert again["start"] == 10 and len(again["losses"]) == 2
    assert int(again["state"]["opt"]["step"]) == 12
    assert all(np.isfinite(again["losses"]))


def test_the_launcher_trains_the_encoder_decoder_and_refuses_the_rest():
    """Every other family trains through the launcher, RWKV6 too (at
    S = 128, where its scan saves two chunk states); none is refused."""
    for arch, seq in (("seamless-m4t-medium", 8), ("phi3.5-moe-42b-a6.6b", 8),
                      ("hymba-1.5b", 8), ("llama-3.2-vision-11b", 8),
                      ("rwkv6-1.6b", 128)):
        out = launcher.main(["--arch", arch, "--device", "cpu", "--steps",
                             "2", "--batch", "2", "--seq", str(seq)])
        assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
