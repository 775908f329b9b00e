"""The port's copies of the host layer are copies.

Every module under ``src/repro_torch/{core,configs,training}`` that has a
counterpart of the same name under ``src/repro/`` is the counterpart with
its imports rewritten: drop its first line (``# Port of
repro/<dir>/<name>.py: ...``), rename ``repro_torch`` to ``repro``, and the
two files are equal.  The modules the port writes itself, and the lines
where a copy must differ, are listed below with their reasons; the tests
check that each list is exact."""

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
DIRS = ("core", "configs", "training")

# the port's own modules: no counterpart, or one it does not copy
OWN = {
    "core/__init__.py": "an empty package marker; the reference's holds a "
                        "template comment",
    "configs/__init__.py": "the reference's configs is a namespace package",
    "core/devicecache.py": "the device cache's pools are torch tensors and "
                           "its tick runs the port's kernels",
    "core/scoring.py": "the score_fn backends on the port's kernels; the "
                       "reference's counterpart is core/pallas_scoring.py",
    "training/__init__.py": "the reference's training is a namespace "
                            "package",
    "training/optimizer.py": "the counterpart imports JAX; the port's AdamW "
                             "is the same f32 expressions on tensors, "
                             "updated in place slice by slice",
    "training/train_step.py": "the counterpart imports JAX; the port takes "
                              "torch.autograd.grad over the param leaves",
    "training/checkpoint.py": "the counterpart imports JAX; the port "
                              "flattens tensors with the same key strings "
                              "and writes bfloat16 as numpy's |V2",
}
# (copy's line, counterpart's line) of every line where a copy differs
EXCEPTIONS = {
    "core/scheduler.py": [
        # the device-resident marker names the card where the reference
        # names Pallas's interpret mode
        ('                device=getattr(score_fn, "device", None))',
         '                interpret=getattr(score_fn, "interpret", None))'),
    ],
}
FIRST_LINE = re.compile(r"# Port of repro/(\w+)/(\w+)\.py: .+")


def port_modules():
    return sorted(str(p.relative_to(PORT)) for d in DIRS
                  for p in (PORT / d).glob("*.py"))


COPIES = [m for m in port_modules() if m not in OWN]


def body(rel):
    """The copy without its first line, ``repro_torch`` renamed."""
    lines = (PORT / rel).read_text().splitlines()
    return [line.replace("repro_torch", "repro") for line in lines[1:]]


def test_lists_are_exact():
    assert set(OWN) <= set(port_modules())
    assert set(EXCEPTIONS) <= set(COPIES)
    assert len(COPIES) >= 30
    # every module that is not the port's own is a copy of a counterpart
    for rel in COPIES:
        assert (REF / rel).is_file(), rel


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_counterpart(rel):
    first = (PORT / rel).read_text().splitlines()[0]
    m = FIRST_LINE.fullmatch(first)
    assert m and f"{m.group(1)}/{m.group(2)}.py" == rel, first
    mine = body(rel)
    ref = (REF / rel).read_text().splitlines()
    assert len(mine) == len(ref), rel
    differ = [(a, b) for a, b in zip(mine, ref) if a != b]
    want = [(a.replace("repro_torch", "repro"), b)
            for a, b in EXCEPTIONS.get(rel, [])]
    assert differ == want, rel


def test_the_port_imports_only_its_own_copies():
    """A copy's imports name ``repro_torch``, never ``repro``."""
    for rel in COPIES:
        text = (PORT / rel).read_text()
        assert not re.search(r"^\s*(from|import)\s+repro\b(?!_torch)", text,
                             re.MULTILINE), rel
