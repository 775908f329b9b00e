"""A sharded training step and a sharded decode on four real ``gloo`` ranks.

One spawn of four processes (this file run as a script, one rank each, on a
``FileStore`` under the test's temporary directory) builds a (2, 2)
``data x model`` mesh and runs, on DTensors laid out by the port's rules:

- one ``make_train_step`` step (``TRAIN_RULES`` params, ``opt_pspecs``
  moments and ``grad_shardings``, ``batch_pspecs`` batch, remat on, f32) of
  the reduced qwen3-4b, phi3.5-moe and rwkv6-1.6b, against the unsharded
  port step on the same ``convert.from_jax`` params, and its loss against
  JAX's ``value_and_grad``;
- a prefill and 4 decode steps of the reduced qwen3-4b (``PARAM_RULES``
  params, ``cache_pspecs`` caches), with ``ONEHOT_CACHE_UPDATE`` off and on,
  against the JAX decode with the switch off and on.

Each rank records the layouts its hooks and kernel wrappers saw: the
residual stream sharded over the sequence by ``constrain_seq``, whole
again at every attention call, and the MoE constraints' redistributions.
"""

import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models import layers as jax_layers
from repro.models.registry import build_model as jax_build_model
from repro.serving.kvcache import pad_cache as jax_pad_cache
from repro.training import optimizer as jax_optimizer
from repro.training.train_step import make_train_step as jax_make_step
from repro_torch._tree import tree_leaves_with_paths, tree_map
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import decoder, layers
from repro_torch.models.convert import from_jax
from repro_torch.models.registry import build_model
from repro_torch.serving.kvcache import pad_cache
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import loss_and_grads, make_train_step

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240             # seconds for the whole spawn
TRAIN_ARCHS = ["qwen3-4b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b"]
B, S = 4, 32              # training batch: both divide over the 2 x 2 mesh
DEC_B, DEC_S, STEPS = 4, 16, 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
LOSS_REL, GRAD, M_TOL, V_TOL, DEC_TOL = 1e-5, 1e-5, 1e-4, 2e-4, 1e-4


# ---------------------------------------------------------------------------
# one rank (run as a script)


def _full(tree):
    """numpy copies of a tree's leaves, DTensors gathered (a collective:
    every rank calls it)."""
    return tree_map(lambda t: (t.full_tensor() if isinstance(t, DTensor)
                               else t).detach().numpy().copy(), tree)


def _flat(tree):
    return dict(tree_leaves_with_paths(tree))


class _Layouts:
    """Records the placements that the hooks and the attention wrappers
    produce, by patching the names the model code calls."""

    def __init__(self):
        self.seq, self.attn, self.moe = [], [], []
        self._saved = []

    def _wrap(self, module, name, log, tag=None):
        fn = getattr(module, name)

        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            pl = out if isinstance(out, list) else getattr(out, "placements",
                                                           None)
            log.append((tag, [repr(p) for p in pl]) if tag
                       else [repr(p) for p in pl])
            return out

        self._saved.append((module, name, fn))
        setattr(module, name, recorded)

    def __enter__(self):
        self._wrap(decoder, "constrain_seq", self.seq)
        self._wrap(flash_mod, "local_placements", self.attn)
        self._wrap(decode_mod, "local_placements", self.attn)
        self._wrap(layers, "constrain_moe_groups", self.moe, "groups")
        self._wrap(layers, "constrain_moe_expert", self.moe, "expert")
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def _train_case(mesh, arch, params_np, batch_np, moved_np):
    cfg = t_reduced(t_get_config(arch), remat=True)
    model = build_model(cfg, device="cpu")
    opt = AdamWConfig(**OPT)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}

    def fresh(p_np):
        params = from_jax(p_np, cfg, device="cpu")
        return {"params": params, "opt": init_opt_state(params)}

    def plain(p_np):
        loss, grads = loss_and_grads(model, fresh(p_np)["params"], batch)
        state, metrics = make_train_step(model, opt)(fresh(p_np), batch)
        return {"loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
                "grads": _flat(_full(grads)),
                "m": _flat(_full(state["opt"]["m"])),
                "v": _flat(_full(state["opt"]["v"])),
                "params": _flat(_full(state["params"]))}

    state = fresh(params_np)
    p_sh = sh.to_shardings(sh.param_pspecs(state["params"], mesh,
                                           sh.TRAIN_RULES), mesh)
    o_sh = sh.to_shardings(sh.opt_pspecs(state["params"], mesh), mesh)
    dstate = {"params": sh.distribute(state["params"], p_sh),
              "opt": {"m": sh.distribute(state["opt"]["m"], o_sh),
                      "v": sh.distribute(state["opt"]["v"], o_sh),
                      "step": state["opt"]["step"]}}
    dbatch = sh.distribute(batch, sh.to_shardings(sh.batch_pspecs(batch,
                                                                   mesh),
                                                  mesh))
    sh.set_active_mesh(mesh)
    try:
        with _Layouts() as seen:
            loss, grads = sh.mesh_aware(loss_and_grads)(
                model, dstate["params"], dbatch, grad_shardings=o_sh)
            grad_layouts = {k: ",".join(map(repr, g.placements))
                            for k, g in _flat(grads).items()}
            dstate, metrics = make_train_step(model, opt,
                                              grad_shardings=o_sh)(dstate,
                                                                   dbatch)
    finally:
        sh.set_active_mesh(None)
    sharded = {"loss": float(loss.full_tensor()),
               "grad_norm": float(metrics["grad_norm"]),
               "grads": _flat(_full(grads)),
               "m": _flat(_full(dstate["opt"]["m"])),
               "v": _flat(_full(dstate["opt"]["v"])),
               "params": _flat(_full(dstate["params"]))}
    want_layouts = _flat(tree_map(lambda _, s: ",".join(map(repr, s[1])),
                                  state["params"], o_sh))
    return {"plain": plain(params_np), "sharded": sharded,
            "moved": plain(moved_np) if moved_np is not None else None,
            "seq": seen.seq, "attn": seen.attn, "moe": seen.moe,
            "grad_layouts": grad_layouts, "want_layouts": want_layouts}


def _decode_case(mesh, params_np, tokens_np, step_tokens):
    cfg = t_reduced(t_get_config("qwen3-4b"))
    model = build_model(cfg, device="cpu")
    params = from_jax(params_np, cfg, device="cpu")
    dparams = sh.distribute(params, sh.to_shardings(
        sh.param_pspecs(params, mesh), mesh))

    def on_mesh(batch):
        return sh.distribute(batch, sh.to_shardings(
            sh.batch_pspecs(batch, mesh), mesh))

    out = {}
    for onehot in (False, True):
        layers.ONEHOT_CACHE_UPDATE = onehot
        sh.set_active_mesh(mesh)
        try:
            logits, caches = model.prefill(
                dparams, on_mesh({"tokens": torch.from_numpy(tokens_np)}))
            template = model.init_cache(DEC_B, DEC_S + STEPS + 4)
            caches = pad_cache(caches, sh.distribute(
                template, sh.to_shardings(sh.cache_pspecs(template, mesh),
                                          mesh)))
            steps = [_full(logits)]
            for i, tok in enumerate(step_tokens):
                token = on_mesh({"token": torch.from_numpy(tok)})["token"]
                logits, caches = model.decode(
                    dparams, caches, {"token": token, "pos": DEC_S + i})
                steps.append(_full(logits))
        finally:
            sh.set_active_mesh(None)
            layers.ONEHOT_CACHE_UPDATE = False
        out[onehot] = steps
    return out


def rank_main(rank, store, inputs, output):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=TIMEOUT))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with open(inputs, "rb") as f:
            cases = pickle.load(f)
        result = {"train": {arch: _train_case(mesh, arch, *cases["train"][arch])
                            for arch in TRAIN_ARCHS},
                  "decode": _decode_case(mesh, *cases["decode"])}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(output, "wb") as f:
            pickle.dump(result, f)


# ---------------------------------------------------------------------------
# the test process: JAX references, the spawn, the holds


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _moved(params):
    """The params perturbed by 1e-7 relative (numpy seed 0), as
    ``test_torch_train.noise_floor`` perturbs them."""
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: (a * (1 + 1e-7 * rng.standard_normal(
        a.shape))).astype(a.dtype), params)


def _jax_decode(jm, jp, tokens, step_tokens):
    logits, caches = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    caches = jax_pad_cache(caches, jm.init_cache(DEC_B, DEC_S + STEPS + 4))
    out = [np.asarray(logits)]
    for i, tok in enumerate(step_tokens):
        logits, caches = jm.decode(jp, caches, {"token": jnp.asarray(tok),
                                                "pos": jnp.int32(DEC_S + i)})
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    cases, ref = {"train": {}}, {"train": {}}
    for i, arch in enumerate(TRAIN_ARCHS):
        jcfg = reduced(get_config(arch), remat=True)
        jm = jax_build_model(jcfg)
        jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(i)))
        batch = _batch(jcfg, seed=20 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss = jax.value_and_grad(jm.train_loss)(jp, jb)[0]
        moved = None
        if jcfg.family == "ssm":
            moved = _moved(jp)
            jstate = {"params": jp,
                      "opt": jax_optimizer.init_opt_state(jp)}
            jstep = jax.jit(jax_make_step(
                jm, jax_optimizer.AdamWConfig(**OPT)))
            m0 = jstep(jstate, jb)[1]
            m1 = jstep(dict(jstate, params=moved), jb)[1]
            ref["train"][arch + "/floor"] = {
                k: abs(float(m1[k]) - float(m0[k])) / abs(float(m0[k]))
                for k in ("loss", "grad_norm")}
        cases["train"][arch] = (jp, batch, moved)
        ref["train"][arch] = float(loss)
    jcfg = reduced(get_config("qwen3-4b"))
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(7)))
    tokens = np.random.default_rng(7).integers(
        0, jcfg.vocab, (DEC_B, DEC_S)).astype(np.int32)
    # the greedy tokens of the JAX run, fed to every run alike
    logits, caches = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    caches = jax_pad_cache(caches, jm.init_cache(DEC_B, DEC_S + STEPS + 4))
    step_tokens = []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
        step_tokens.append(tok)
        logits, caches = jm.decode(jp, caches, {"token": jnp.asarray(tok),
                                                "pos": jnp.int32(DEC_S + i)})
    ref["decode"] = {}
    saved = jax_layers.ONEHOT_CACHE_UPDATE
    try:
        for onehot in (False, True):
            jax_layers.ONEHOT_CACHE_UPDATE = onehot
            ref["decode"][onehot] = _jax_decode(jm, jp, tokens, step_tokens)
    finally:
        jax_layers.ONEHOT_CACHE_UPDATE = saved
    cases["decode"] = (jp, tokens, step_tokens)

    inputs, output = tmp / "inputs.pkl", tmp / "result.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp / "store"), str(inputs),
         str(output)], env=env, cwd=str(ROOT), stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT + 30
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    tails = "\n".join((tmp / f"rank{r}.log").read_text()[-3000:]
                      for r in range(WORLD))
    assert all(p.returncode == 0 for p in procs), tails
    with open(output, "rb") as f:
        return pickle.load(f), ref


def _rel(a, b):
    scale = float(np.abs(b).max())
    return float(np.abs(np.asarray(a, np.float64) - b).max()) / scale


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_the_sharded_step_matches_the_unsharded_one(ranks, arch):
    got, ref = ranks
    case = got["train"][arch]
    plain, sharded, moved = case["plain"], case["sharded"], case["moved"]
    floor = ref["train"].get(arch + "/floor", {})

    def tol(what, base):
        """rwkv6: the larger of ``base`` and the move of ``what`` under a
        1e-7 perturbation of the params (JAX's trajectory for the
        metrics, the port's own unsharded step for the leaves)."""
        if moved is None:
            return base
        if what in floor:
            return max(base, floor[what])
        return max(base, max(_rel(moved[what][k], want)
                             for k, want in plain[what].items()
                             if np.abs(want).max() > 0))

    assert abs(sharded["loss"] - plain["loss"]) <= tol(
        "loss", LOSS_REL) * abs(plain["loss"])
    assert abs(plain["loss"] - ref["train"][arch]) <= tol(
        "loss", LOSS_REL) * abs(ref["train"][arch])
    assert abs(sharded["grad_norm"] - plain["grad_norm"]) <= tol(
        "grad_norm", LOSS_REL) * plain["grad_norm"]
    for what, bound in (("grads", GRAD), ("m", M_TOL), ("v", V_TOL)):
        assert set(sharded[what]) == set(plain[what])
        limit = tol(what, bound)
        for key, want in plain[what].items():
            if np.abs(want).max() == 0:
                assert np.abs(sharded[what][key]).max() == 0, (what, key)
                continue
            assert _rel(sharded[what][key], want) <= limit, (what, key)
    # the step's gradients took their ZeRO layouts
    assert case["grad_layouts"] == case["want_layouts"]


def test_the_residual_stream_is_sequence_sharded_and_attention_sees_it_whole(
        ranks):
    for arch in ("qwen3-4b", "phi3.5-moe-42b-a6.6b"):
        case = ranks[0]["train"][arch]
        assert case["seq"] and all("Shard(dim=1)" in pl
                                   for pl in case["seq"]), case["seq"]
        assert case["attn"]
        for pl in case["attn"]:
            assert "Shard(dim=1)" not in pl, pl       # the sequence whole
            assert "Shard(dim=0)" in pl, pl           # the batch kept


def test_the_moe_constraints_redistribute(ranks):
    moe = ranks[0]["train"]["phi3.5-moe-42b-a6.6b"]["moe"]
    kinds = {tag for tag, _ in moe}
    assert kinds == {"groups", "expert"}
    # 4 experts over the 2-way model axis; the batch over data
    for tag, pl in moe:
        if tag == "expert":
            assert pl == ["Shard(dim=0)", "Shard(dim=2)"], pl
        else:
            assert pl[0] == "Shard(dim=0)", pl


@pytest.mark.parametrize("onehot", [False, True], ids=["slot", "onehot"])
def test_the_sharded_decode_matches_jax(ranks, onehot):
    got, want = ranks[0]["decode"][onehot], ranks[1]["decode"][onehot]
    assert len(got) == STEPS + 1
    for step, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= DEC_TOL, (step, _rel(g, w))


def test_the_one_hot_cache_write_is_bit_equal_to_the_slot_write(ranks):
    off, on = ranks[0]["decode"][False], ranks[0]["decode"][True]
    for step, (a, b) in enumerate(zip(off, on)):
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), step


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
