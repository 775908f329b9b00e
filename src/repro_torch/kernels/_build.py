"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` at first use into
``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), as a shared library with a plain C interface that is loaded
through ``ctypes``.  The file name carries a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

_lock = threading.Lock()
_loaded: dict = {}
_functions: dict = {}
build_log: dict = {}      # source name -> nvcc's output (register counts)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def compile_source(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Safe to run for several sources in parallel (one process each)."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)      # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(compile_source(name)))
        return lib


def build_all() -> None:
    """Compile every source in ``csrc/`` at once (one ``nvcc`` each, all
    started together) and load the libraries."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(compile_source, SOURCES))
    for name in SOURCES:
        load(name)


def refuse_grad(what: str, waits_for: str, *tensors) -> None:
    """Raise where a kernel that has no backward would be asked for a
    gradient: grad mode on and an input on the card that requires grad.
    Its output would be cut off from the graph, so the parameters upstream
    would silently get no gradient.  (On the CPU the plain version runs,
    which autograd differentiates.)"""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.is_cuda and t.requires_grad
            for t in tensors):
        raise NotImplementedError(
            f"{what} has no backward kernel: a gradient through it waits for "
            f"{waits_for}")


def launch(name: str, fn_name: str, argtypes, err_fn_name: str, *args):
    """Call the C function ``fn_name`` of ``csrc/<name>.cu`` (its argument
    types set on first use), which launches on the stream it is given and
    returns a CUDA error code; raise if CUDA refused the launch."""
    bound = _functions.get((name, fn_name))
    if bound is None:
        lib = load(name)
        fn, err = getattr(lib, fn_name), getattr(lib, err_fn_name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        bound = _functions[(name, fn_name)] = (fn, err)
    fn, err = bound
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: {err(rc).decode()}")
