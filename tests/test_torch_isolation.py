"""The port stands alone and never falls back silently.

``repro_torch`` and ``chip_smoke.py`` import neither JAX nor anything of the
JAX package ``repro``, and the port's entry points refuse to run without a
Hopper card unless the caller asks for the CPU."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import _device
from repro_torch._device import resolve_device
from repro_torch.core.scoring import make_torch_score_fn
from repro_torch.launch import schedule, train

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|from\s+repro(\.|\s+import)"
    r"|import\s+repro(\.|\s*$|\s*,|\s+as\b))", re.MULTILINE)


def test_source_scan_finds_no_jax_or_reference_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits


def test_source_scan_pattern_catches_each_form():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "    from repro.core.job import Job", "import repro.core",
                 "from repro import core", "import repro"):
        assert FORBIDDEN.search(line), line
    for line in ("from repro_torch.core import job", "import repro_torch",
                 "# see repro.core.job", "import jaxlib_free"):
        assert not FORBIDDEN.search(line), line


def test_subprocess_simulation_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.core import (recharacterize, slo_mael, baselines, "
        "energy, simulator_legacy)\n"
        "from repro_torch.launch.schedule import main\n"
        "stats = main(['--device', 'cpu', '--jobs', '60', '--pools', '1', "
        "'2', '2', '--serving', 'batched', '--streaming', '2.0', '2.5', "
        "'--v2'])\n"
        "assert stats['jobs'] == 60, stats\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ISOLATED"


@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-medium"])
def test_subprocess_serving_loads_no_jax_and_no_reference(arch):
    """The hybrid and encoder-decoder families serve through the launcher
    with nothing of JAX or the JAX package loaded."""
    code = (
        "import sys\n"
        "from repro_torch.launch.serve import main\n"
        f"stats = main(['--arch', '{arch}', '--device', 'cpu', "
        "'--requests', '1', '--gen', '2'])\n"
        "assert stats.decoded_tokens == 4, stats\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ISOLATED"


@pytest.mark.parametrize("arch", ["qwen3-4b", "seamless-m4t-medium"])
def test_subprocess_training_loads_no_jax_and_no_reference(arch, tmp_path):
    """The training slice (the launcher, ``training/``, the flash gradient,
    a checkpoint written and resumed) runs with nothing of JAX or the JAX
    package loaded."""
    code = (
        "import sys\n"
        "from repro_torch.launch.train import main\n"
        "from repro_torch.models.convert import train_state_from_jax\n"
        f"argv = ['--arch', '{arch}', '--device', 'cpu', '--batch', '2', "
        f"'--seq', '8', '--ckpt-dir', r'{tmp_path}', '--ckpt-every', '2']\n"
        "first = main(argv + ['--steps', '2'])\n"
        "again = main(argv + ['--steps', '3'])\n"
        "assert again['start'] == 2 and len(again['losses']) == 1, again\n"
        "want = {'repro_torch.training.' + m for m in ('data', 'optimizer', "
        "'train_step', 'checkpoint')}\n"
        "assert want <= set(sys.modules), sorted(want - set(sys.modules))\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ISOLATED"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_without_cuda_the_default_device_raises(monkeypatch):
    _no_cuda(monkeypatch)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)
    for v2 in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_torch_score_fn(v2=v2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        schedule.main(["--jobs", "5"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen3-4b", "--steps", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_a_card_that_is_not_hopper_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "an sm_80 card")
    with pytest.raises(RuntimeError, match=r"capability \(8, 0\)"):
        _device.resolve_device()
    with pytest.raises(RuntimeError, match="unsupported device"):
        resolve_device("meta")


def test_entry_point_runs_on_the_cpu_when_asked(capsys):
    stats = schedule.main(["--device", "cpu", "--jobs", "40", "--pools",
                           "1", "2", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["jobs"] == stats["jobs"] == 40
    assert printed["device"] == "cpu"


def test_without_cuda_the_resident_backend_raises(monkeypatch):
    from repro_torch.core.devicecache import DeviceScoreCache
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_torch_score_fn(device_cache=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceScoreCache()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        schedule.main(["--jobs", "5", "--resident", "--regions", "2"])


@pytest.mark.parametrize("argv", [["--resident"], ["--regions", "2"],
                                  ["--resident", "--regions", "2",
                                   "--serving", "batched"]])
def test_entry_point_runs_resident_and_regions_on_the_cpu(capsys, argv):
    stats = schedule.main(["--device", "cpu", "--jobs", "40", "--pools",
                           "1", "2", "2", *argv])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["jobs"] == stats["jobs"] == 40
    assert printed["device"] == "cpu"


def test_resident_and_v1_entry_points_give_the_same_summary():
    base = ["--device", "cpu", "--jobs", "60", "--pools", "1", "2", "2",
            "--regions", "2", "--serving", "batched", "--streaming", "2.0",
            "2.5"]
    v1 = schedule.main(base)
    resident = schedule.main(base + ["--resident"])
    for key in ("violations", "e2e_avg_s", "goodput_jps", "ttft_avg_s"):
        assert v1[key] == resident[key]
    with pytest.raises(SystemExit):
        schedule.main(base + ["--resident", "--v2"])   # one backend only


def test_subprocess_resident_run_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "from repro_torch.launch.schedule import main\n"
        "stats = main(['--device', 'cpu', '--jobs', '60', '--pools', '1', "
        "'2', '2', '--resident', '--regions', '2'])\n"
        "assert stats['jobs'] == 60, stats\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.core.devicecache' in sys.modules\n"
        "print('ISOLATED')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ISOLATED"


@pytest.fixture
def one_torch_thread():
    """The CPU plain runs are thousands of small tensor ops; torch's
    intra-op threads only spin on them and starve the other test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("argv,policy,device", [
    (["--kind", "drift", "--degrade", "5.0", "0.35", "--recharacterize",
      "online", "--resident"], "SynergAI", "cpu"),
    (["--kind", "drift", "--degrade", "5.0", "0.35", "--recharacterize",
      "oracle", "--resident", "--regions", "3"], "SynergAI-H", "cpu"),
    (["--policy", "slo-mael"], "SLO-MAEL", "host"),
    (["--policy", "slo-mael", "--kind", "drift", "--degrade", "5.0", "0.35",
      "--recharacterize", "online"], "SLO-MAEL", "host"),
    (["--policy", "be", "--serving", "batched", "--streaming", "2.0", "2.5"],
     "BE", "host"),
])
def test_entry_point_runs_the_loop_and_the_comparison_policies_on_the_cpu(
        capsys, argv, policy, device):
    stats = schedule.main(["--device", "cpu", "--jobs", "300", "--pools",
                           "2", "5", "5", *argv])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == stats and stats["jobs"] == 300
    assert (stats["policy"], stats["device"]) == (policy, device)
    if "online" in argv:
        assert stats["refreshes"] >= 1
    if "--resident" in argv and "online" in argv:
        assert stats["profile_reclaims"] > 0
    if "--recharacterize" not in argv:
        assert stats["refreshes"] == stats["profile_reclaims"] == 0


def test_entry_point_refuses_what_a_policy_cannot_run(monkeypatch):
    base = ["--device", "cpu", "--jobs", "20", "--pools", "1", "2", "2"]
    for bad in (["--policy", "rr", "--resident"], ["--policy", "mru", "--v2"],
                ["--policy", "lru", "--recharacterize", "online"],
                ["--policy", "slo-mael", "--regions", "2"],
                ["--recharacterize", "oracle", "--resident"]):
        with pytest.raises(SystemExit):
            schedule.main(base + bad)
    # the v1 kernel does not read the profile overlay (the reference's rule)
    with pytest.raises(ValueError, match="reads the profile overlay"):
        schedule.main(base + ["--recharacterize", "online"])
    _no_cuda(monkeypatch)
    for argv in (["--policy", "slo-mael"], ["--kind", "drift", "--resident",
                                            "--recharacterize", "online"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            schedule.main(["--jobs", "5", *argv])


def test_subprocess_sharding_loads_no_jax_and_no_reference():
    """The mesh and the sharding rules (``launch.mesh``,
    ``distributed.sharding``): a (2, 2) mesh of a fake process group, the
    specs of a shape-only model at full config, with nothing of JAX or the
    JAX package loaded."""
    code = (
        "import sys\n"
        "import torch, torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch.distributed import sharding as sh\n"
        "from repro_torch.launch.mesh import make_mesh\n"
        "from repro_torch.models.registry import build_model\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=0, "
        "world_size=4)\n"
        "mesh = make_mesh((2, 2), ('data', 'model'), device_type='cpu')\n"
        "m = build_model('qwen3-4b', device='meta')\n"
        "specs = sh.param_pspecs(m.init_params(torch.Generator()), mesh, "
        "sh.TRAIN_RULES)\n"
        "assert tuple(specs['embed']['tok']) == ('model', 'data'), specs\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ISOLATED"
