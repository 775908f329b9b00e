"""``chip_smoke.py``'s MLA, VLM, hybrid and encoder-decoder serving phases
(4d-4g) and its training phases (5a-5g) rehearsed on the CPU at the reduced
configs' size.

The phases are the functions the card run calls (``serve_mla``,
``serve_vlm``, ``serve_hymba``, ``serve_encdec``), with the serving sizes
cut (2 requests of batch 2 x 16 + 4 tokens) and the CUDA calls of the
harness made no-ops.  On CPU tensors the kernel wrappers run their plain
versions and count nothing, so each wrapper is replaced by one that counts
its calls: the phases' own launch checks (the router alone on the MLA path;
flash in prefill and decode attention in decode on the VLM's self layers,
none on its cross layers; both on every hymba layer; on seamless-m4t, flash
on the encoder, cross and self layers, non-causal and causal counted apart,
and decode attention on the self layers) and their parity holds then run as
on the card.  The training phases (``train_cell``) run three steps with
remat on, so each step launches flash twice a layer (the forward and its
recomputation) and its backward once, counted by mask on seamless-m4t, and
the router likewise on the MoE layers and the WKV scan on the RWKV layers
(MLA's attention launches neither flash kernel, nor do the VLM's cross
layers); their holds (i)-(iii) run as on the card."""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_routing as mr
from repro_torch.kernels import rwkv_scan as rs
from repro_torch.models import common, layers

ROOT_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke_phases",
                                               ROOT_SMOKE)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def counting(fn, launches=lambda: True):
    """``fn`` counting its calls as the card's wrapper counts launches:
    each call where ``launches()`` says a kernel would launch."""
    def counted(*args, **kw):
        counted.launches += int(launches())
        return fn(*args, **kw)
    counted.launches = 0
    return counted


@pytest.fixture
def rehearsal(monkeypatch):
    """Small serving sizes, no-op CUDA calls, counting wrappers on every
    name the model and the harness look the kernels up by."""
    for name, value in (("REQUESTS", 2), ("SERVE_BATCH", 2), ("PROMPT", 16),
                        ("GEN", 4)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    counted = {}
    # a forward launches nothing where chip_smoke's plain reference has
    # patched the plain version in over its launch (``_launch_forward``,
    # ``_launch``)
    launch_forward, launch_routing = fa._launch_forward, mr._launch
    launch_rwkv = rs._launch
    forward_launches = {"flash_attention":
                        lambda: fa._launch_forward is launch_forward,
                        "moe_routing": lambda: mr._launch is launch_routing,
                        "rwkv_scan": lambda: rs._launch is launch_rwkv}
    for module, name, homes in (
            (fa, "flash_attention", [common]),
            (fa, "flash_attention_bwd", []),
            (da, "decode_attention", [common]),
            (mr, "moe_routing", [layers]),
            (mr, "moe_routing_bwd", []),
            (rs, "rwkv_scan", [layers]),
            (rs, "rwkv_scan_bwd", [])):
        fn = counting(getattr(module, name),
                      forward_launches.get(name, lambda: True))
        for home in [module] + homes:
            monkeypatch.setattr(home, name, fn)
        counted[name] = fn
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield counted
    torch.set_num_threads(threads)


def test_mla_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 4d on the reduced deepseek-v2 in bf16 (3 layers; f32 parity on
    the first 2): the router launches 3 x 2 times in prefill and 3 x 3 x 2
    in decode, nothing else; every parity line holds, and the absorbed
    decode is held to the expanded one at its score scale."""
    cfg = dataclasses.replace(reduced(get_config("deepseek-v2-236b")),
                              n_layers=3, dtype="bfloat16")
    launches, expanded, absorbed = chip_smoke.serve_mla(cfg, 2, 60,
                                                        device="cpu")
    assert launches == {"moe_routing": 24, "flash_attention": 0,
                        "decode_attention": 0, "rwkv_scan": 0}
    out = capsys.readouterr().out
    for tag in ("serving ", "routing_parity ", "moe_parity ",
                "absorb_scales ", "absorb_parity ", "decode_profile "):
        assert tag in out, tag
    assert out.count("moe_parity ") == out.count("absorb_parity ") == 2
    assert "depth cut to 3" in out
    assert (expanded["mode"], absorbed["mode"]) == ("expanded", "absorb_mla")


def test_vlm_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 4e on the reduced llama-3.2-vision in bf16 (5 layers, cross
    layers at 0, 2 and 4; f32 parity on the first 3): flash launches on the
    2 self layers, 2 x 2 in prefill, decode attention 2 x 3 x 2 in decode,
    the cross layers on neither; the gates set on all 3 cross layers."""
    cfg = dataclasses.replace(reduced(get_config("llama-3.2-vision-11b")),
                              n_layers=5, dtype="bfloat16")
    launches, profile = chip_smoke.serve_vlm(cfg, 3, device="cpu")
    assert launches == {"flash_attention": 4, "decode_attention": 12,
                        "moe_routing": 0, "rwkv_scan": 0}
    out = capsys.readouterr().out
    assert "(2 self-attention, 3 cross-attention)" in out
    assert out.count("parity ") == 2 and "decode_profile " in out
    assert profile["arch"] == cfg.name


def test_hymba_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 4f on the reduced hymba in bf16 (4 layers, 0 and 3 global, 1
    and 2 windowed at 32): flash launches 4 x 2 times in prefill and decode
    attention 4 x 3 x 2 in decode, nothing else; both parity lines hold, and
    the prefill profile reports the recurrence's share."""
    cfg = dataclasses.replace(reduced(get_config("hymba-1.5b")), n_layers=4,
                              global_layers=(0, 3), dtype="bfloat16")
    launches, profile, prefill = chip_smoke.serve_hymba(cfg, device="cpu")
    assert launches == {"flash_attention": 8, "decode_attention": 24,
                        "moe_routing": 0, "rwkv_scan": 0}
    out = capsys.readouterr().out
    assert "(2 global, 2 windowed at 32)" in out
    assert out.count("parity ") == 2 and "decode_profile " in out
    assert "prefill_profile " in out and "bf16_floor " in out
    assert profile["arch"] == prefill["arch"] == cfg.name
    assert prefill["host_s"] > 0 and "mamba_recurrence_share" in prefill


def test_encdec_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 4g on the reduced seamless-m4t in bf16 (2 encoder and 2
    decoder layers, audio as long as the prompt): flash launches (2 + 2 x
    2) x 2 times in prefill, 4 x 2 of them non-causal and 2 x 2 causal, and
    decode attention 2 x 3 x 2 in decode (the cross layers' decode on
    neither kernel)."""
    cfg = dataclasses.replace(reduced(get_config("seamless-m4t-medium")),
                              dtype="bfloat16")
    launches, profile = chip_smoke.serve_encdec(cfg, device="cpu")
    assert launches == {"flash_attention": 12, "decode_attention": 12,
                        "moe_routing": 0, "rwkv_scan": 0}
    out = capsys.readouterr().out
    assert '"calls": {"causal": 4, "non_causal": 8}' in out
    assert "2 encoder + 2 decoder layers" in out
    assert out.count("parity ") == 2 and "decode_profile " in out
    assert profile["arch"] == cfg.name


def train_configs(arch, f32_layers=None):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16",
                              remat=True)
    f32 = dataclasses.replace(cfg, dtype="float32")
    if f32_layers:
        f32 = dataclasses.replace(f32, n_layers=f32_layers)
    return cfg, f32


def test_train_dense_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 5a on the reduced qwen3-4b in bf16 with remat (2 layers; the
    f32 step on its first layer): each of 3 steps launches flash 2 x 2
    times and its backward 2 times, nothing else; holds (i)-(iii) pass."""
    cfg, f32 = train_configs("qwen3-4b", f32_layers=1)
    totals, profile, peak = chip_smoke.train_cell(cfg, 2, 64, f32,
                                                  resume=True, device="cpu")
    assert totals == {"flash_attention": 12, "flash_attention_bwd": 6,
                      "decode_attention": 0, "moe_routing": 0,
                      "moe_routing_bwd": 0, "rwkv_scan": 0,
                      "rwkv_scan_bwd": 0}
    out = capsys.readouterr().out
    assert out.count("train_step ") == 3
    for tag in ("train_loss_hold ", "train_profile ", "training ",
                "train_f32_step ", '"bit_equal": true'):
        assert tag in out, tag
    assert profile["arch"] == cfg.name and peak == 0


def test_train_encdec_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 5b on the reduced seamless-m4t in bf16 with remat (2 encoder,
    2 decoder layers): each step launches flash (2 + 2 x 2) x 2 times, 8 of
    them non-causal (encoder and cross layers), and its backward 6 times, 4
    non-causal; the f32 step at full (reduced) depth."""
    cfg, f32 = train_configs("seamless-m4t-medium")
    totals, _, _ = chip_smoke.train_cell(cfg, 2, 32, f32, device="cpu")
    assert totals == {"flash_attention": 36, "flash_attention_bwd": 18,
                      "decode_attention": 0, "moe_routing": 0,
                      "moe_routing_bwd": 0, "rwkv_scan": 0,
                      "rwkv_scan_bwd": 0}
    out = capsys.readouterr().out
    assert out.count('"forward": {"causal": 4, "non_causal": 8}, '
                     '"backward": {"causal": 2, "non_causal": 4}') == 3
    assert "train_f32_step " in out and "train_resume " not in out


def test_train_moe_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 5c on the reduced phi3.5-moe in bf16 with remat (2 layers; the
    f32 step on its first layer): each of 3 steps launches the router 2 x 2
    times and its backward 2 times, flash 2 x 2 times and its backward 2
    times; holds (i)-(iii) pass, the plain runs launching nothing."""
    cfg, f32 = train_configs("phi3.5-moe-42b-a6.6b", f32_layers=1)
    totals, profile, _ = chip_smoke.train_cell(cfg, 2, 64, f32, resume=True,
                                               device="cpu", full_layers=32)
    assert totals == {"flash_attention": 12, "flash_attention_bwd": 6,
                      "decode_attention": 0, "moe_routing": 12,
                      "moe_routing_bwd": 6, "rwkv_scan": 0,
                      "rwkv_scan_bwd": 0}
    out = capsys.readouterr().out
    assert out.count("train_step ") == 3 and "2 of 32 layers" in out
    for tag in ("train_loss_hold ", "train_profile ", "train_f32_step ",
                '"bit_equal": true', "4 experts top-2"):
        assert tag in out, tag
    assert profile["arch"] == cfg.name


def test_train_mla_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 5d on the reduced deepseek-v2 in bf16 with remat, cut to 1
    layer: each of 3 steps launches the router twice and its backward
    once, flash never (MLA takes the XLA-path attention); the f32 loss and
    grads held in place of a full f32 step."""
    cfg, f32 = train_configs("deepseek-v2-236b", f32_layers=1)
    cfg = dataclasses.replace(cfg, n_layers=1)
    totals, _, _ = chip_smoke.train_cell(cfg, 1, 64, f32, device="cpu",
                                         f32_hold="grads", full_layers=60)
    assert totals == {"flash_attention": 0, "flash_attention_bwd": 0,
                      "decode_attention": 0, "moe_routing": 6,
                      "moe_routing_bwd": 3, "rwkv_scan": 0,
                      "rwkv_scan_bwd": 0}
    out = capsys.readouterr().out
    assert out.count("train_step ") == 3 and "1 of 60 layers" in out
    assert "train_f32_grads " in out and "train_f32_step " not in out


def test_train_hybrid_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 5e on the reduced hymba in bf16 with remat (2 layers, global
    layer 0 and layer 1 windowed at 32) at S = 128, where the window binds
    and the Mamba scan takes its chunked branch: each of 3 steps launches
    flash 2 x 2 times and its backward 2 times, nothing else; holds (i)
    and (ii) pass; the profiled step runs on the first layer alone and
    reports the Mamba recurrence's share."""
    cfg, f32 = train_configs("hymba-1.5b", f32_layers=2)
    totals, profile, _ = chip_smoke.train_cell(cfg, 2, 128, f32, device="cpu",
                                               profile_layers=1)
    assert totals == {"flash_attention": 12, "flash_attention_bwd": 6,
                      "decode_attention": 0, "moe_routing": 0,
                      "moe_routing_bwd": 0, "rwkv_scan": 0,
                      "rwkv_scan_bwd": 0}
    out = capsys.readouterr().out
    assert out.count("train_step ") == 3
    for tag in ("train_loss_hold ", "train_f32_step ", '"profiled_layers": 1'):
        assert tag in out, tag
    assert profile["arch"] == cfg.name and profile["layers"] == 1
    assert "mamba_recurrence_share" in profile


def test_train_vlm_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 5f on the reduced llama-3.2-vision in bf16 with remat (5
    layers, cross layers at 0, 2 and 4; the f32 step on the first 3): each
    of 3 steps launches flash 2 x 2 times and its backward 2 times, on the
    2 self layers alone; the gates set on the cross layers; the full
    model's cut is 20 layers, reckoned at 64.96 GB."""
    cfg, f32 = train_configs("llama-3.2-vision-11b", f32_layers=3)
    cfg = dataclasses.replace(cfg, n_layers=5)
    totals, profile, _ = chip_smoke.train_cell(cfg, 2, 32, f32, device="cpu",
                                               full_layers=40)
    assert totals == {"flash_attention": 12, "flash_attention_bwd": 6,
                      "decode_attention": 0, "moe_routing": 0,
                      "moe_routing_bwd": 0, "rwkv_scan": 0,
                      "rwkv_scan_bwd": 0}
    out = capsys.readouterr().out
    assert out.count("train_step ") == 3 and "5 of 40 layers" in out
    assert "3 gated cross layers (gates 0.5)" in out
    assert "train_f32_step " in out and profile["arch"] == cfg.name
    assert chip_smoke.vlm_train_cut(get_config("llama-3.2-vision-11b")) == 20
    assert '"20": 64.955007072' in capsys.readouterr().out


def test_train_rwkv_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 5g on the reduced rwkv6 in bf16 with remat (2 layers, head dim
    16) at S = 128, where the scan saves two chunk states: each of 3 steps
    launches the WKV scan 2 x 2 times and its backward 2 times, nothing
    else; holds (i) and (ii) pass, the plain runs launching nothing; the
    profiled step splits the WKV kernels' device time from the rest."""
    cfg, f32 = train_configs("rwkv6-1.6b")
    totals, profile, _ = chip_smoke.train_cell(cfg, 2, 128, f32,
                                               device="cpu")
    assert totals == {"flash_attention": 0, "flash_attention_bwd": 0,
                      "decode_attention": 0, "moe_routing": 0,
                      "moe_routing_bwd": 0, "rwkv_scan": 12,
                      "rwkv_scan_bwd": 6}
    out = capsys.readouterr().out
    assert out.count("train_step ") == 3
    for tag in ("train_loss_hold ", "train_profile ", "train_f32_step "):
        assert tag in out, tag
    assert profile["arch"] == cfg.name and profile["layers"] == 2
    assert {"wkv_forward", "wkv_backward"} <= set(
        profile["device_ms_by_kind"])


def test_mesh_phase_runs_on_the_cpu(rehearsal, capsys):
    """Phase 5h on the reduced qwen3-4b, phi3.5-moe and rwkv6 in bf16 with
    remat on a (1, 1) mesh of a world-size-1 ``gloo`` group: every step's
    loss and grad norm, every param, m and v leaf, and the serving run's
    logits (the slot write, the one-hot write and the sharded
    flash-decode) bit-equal to the plain tensors' through the same counted
    wrappers, the launches equal; the group is gone afterwards and no mesh
    is left active."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as sh
    cells = [(dataclasses.replace(train_configs(arch)[0], n_layers=n), steps)
             for arch, n, steps in (("qwen3-4b", 2, 2),
                                    ("phi3.5-moe-42b-a6.6b", 1, 1),
                                    ("rwkv6-1.6b", 2, 1))]
    serve = dataclasses.replace(reduced(get_config("qwen3-4b")),
                                dtype="bfloat16")
    paths = chip_smoke.mesh_phase(cells, serve, 2, 64, device="cpu")
    assert not dist.is_initialized() and sh.get_active_mesh() is None
    assert paths["mesh train qwen3-4b"]["flash_attention"] == 2 * 2 * 2
    assert paths["mesh train qwen3-4b"]["flash_attention_bwd"] == 2 * 2
    assert paths["mesh train phi3.5-moe-42b-a6.6b"]["moe_routing_bwd"] == 1
    assert paths["mesh train rwkv6-1.6b"]["rwkv_scan_bwd"] == 2
    assert paths["mesh serve qwen3-4b"] == {
        "flash_attention": 2 * 2, "decode_attention": 2 * 2 * 8}
    # the sharded flash-decode: the same launches, every step merged
    assert paths["mesh serve qwen3-4b sharded-decode"] == paths[
        "mesh serve qwen3-4b"]
    out = capsys.readouterr().out
    assert out.count("mesh_train ") == 3 and "mesh_serve " in out
    assert '"merges": 32, "calls": 32' in out


def test_children_take_turns_in_the_order_they_were_started():
    """``Children``: every child forked at once, at most ``limit`` running,
    in the order started; each result comes back to its waiter, and a
    child's failure fails its waiter."""
    import time
    children = chip_smoke.Children(2)

    def task(i):
        t0 = time.monotonic()
        time.sleep(0.3)
        return i, t0, time.monotonic()

    waits = [children.start(lambda i=i: task(i)) for i in range(5)]
    got = [w() for w in waits]
    assert [g[0] for g in got] == list(range(5))
    starts = [g[1] for g in got]
    assert starts == sorted(starts)
    for _, t0, _ in got:
        assert sum(s <= t0 < e for _, s, e in got) <= 2
    failing = chip_smoke.Children(1).start(lambda: 1 / 0)
    with pytest.raises(SystemExit, match="ZeroDivisionError"):
        failing()


def test_phase3_runs_are_held_to_their_forked_references(monkeypatch,
                                                         capsys):
    """Phase 3's orchestration at a small size: each run's CPU and numpy
    references forked first (``main_path_references``,
    ``resident_references``), the card runs after (on the CPU here, each
    wrapper call counted as a launch, patched in after the forks so the
    children count none), every card run held to its forked CPU run; a card
    run that differs from its reference fails."""
    from repro_torch.core import scoring
    from repro_torch.core.offline import characterize
    from repro_torch.core.workers import synth_fleet
    from repro_torch.core.workload import scenario
    from repro_torch.kernels import scheduler_score as ss
    torch.set_num_threads(1)
    cd = characterize()
    fleet = synth_fleet(2, 4, 4)
    jobs = scenario(cd, "mmpp", n_jobs=120, fleet=fleet, seed=0)
    children = chip_smoke.Children(2)
    refs = {"job-v1": chip_smoke.main_path_references(
                children, cd, fleet, jobs, "job", False),
            "job-resident": chip_smoke.resident_references(
                children, cd, fleet, jobs, "job", chip_smoke.synergai),
            "short": chip_smoke.resident_references(
                children, cd, fleet, jobs, "job", chip_smoke.synergai)}
    host = chip_smoke.start_comparison(children, cd, fleet, jobs)
    make = scoring.make_torch_score_fn
    monkeypatch.setattr(scoring, "make_torch_score_fn",
                        lambda *a, device=None, **kw: make(*a, device="cpu",
                                                           **kw))
    v1 = counting(scoring.scheduler_score)
    monkeypatch.setattr(scoring, "scheduler_score", v1)
    for name in ("tick_score", "greedy_place"):
        monkeypatch.setattr(ss, name, counting(getattr(ss, name)))
    launches, _, _ = chip_smoke.main_path_run(
        "job-v1", cd, fleet, jobs, "job", False, v1, refs["job-v1"])
    assert launches > 0
    run = chip_smoke.resident_run("job-resident", cd, fleet, jobs, "job",
                                  chip_smoke.synergai, refs["job-resident"])
    assert run.launches["tick_score_kernel"] > 0
    with pytest.raises(SystemExit, match="card results differ"):
        chip_smoke.resident_run("short", cd, fleet, jobs[:-1], "job",
                                chip_smoke.synergai, refs["short"])
    chip_smoke.comparison(jobs, fleet, run, host)
    out = capsys.readouterr().out
    assert out.count("main_path ") == 2 and "comparison " in out
    assert '"identical_to_cpu_run": true' in out


def test_the_paper_experiments_hold_their_forked_references(monkeypatch,
                                                            capsys):
    """3g's paper experiments with every run off the card made in a child
    (``paper_references``): the card's resident SynergAI (the CPU here,
    each tick kernel call counted) held to the child's CPU run, seed by
    seed; the totals are those of running every policy in this process."""
    from repro_torch.core import scoring
    from repro_torch.core.job import make_experiment
    from repro_torch.core.metrics import summarize
    from repro_torch.core.offline import characterize
    from repro_torch.core.scheduler import SynergAI
    from repro_torch.core.simulator import Simulator
    from repro_torch.kernels import scheduler_score as ss
    torch.set_num_threads(1)
    cd = characterize()
    monkeypatch.setattr(chip_smoke, "EXPERIMENT_SEEDS", (1,))
    refs = chip_smoke.Children(1).start(
        lambda: chip_smoke.paper_references(cd))
    make = scoring.make_torch_score_fn
    monkeypatch.setattr(scoring, "make_torch_score_fn",
                        lambda *a, device=None, **kw: make(*a, device="cpu",
                                                           **kw))
    for name in ("tick_score", "greedy_place"):
        monkeypatch.setattr(ss, name, counting(getattr(ss, name)))
    launches = chip_smoke.paper_experiments(cd, refs)
    assert launches["tick_score_kernel"] > 0
    line = capsys.readouterr().out.split("paper ", 1)[1]
    totals = __import__("json").loads(line)["totals"]
    want = 0
    for _, demand, freq in chip_smoke.EXPERIMENTS:
        res = Simulator(cd, SynergAI(), seed=1).run(
            make_experiment(cd, demand, freq, seed=1))
        want += summarize(res)["violations"]
    assert totals["SynergAI-numpy"] == want
