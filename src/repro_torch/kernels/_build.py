"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``.
The library's file name carries a hash of its source, so an edited
source is rebuilt and an unchanged one is loaded as it is. Libraries go
to ``build/`` at the root of the checkout. Nothing is built while a
module is imported: ``library(name)`` builds at first use, and
``build_all()`` builds every source at once, one ``nvcc`` per source,
all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the element types and head dims the kernels are instantiated for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return nvcc


def _target(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{src.stem}-{digest}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all in parallel,
    then load them all. Returns the seconds each build took (0.0 for a
    library found built). Raises with the compiler's output on failure."""
    with _lock:
        todo = {n: s for n, s in sources().items() if n not in _libs}
        started = {}
        if todo:
            BUILD.mkdir(parents=True, exist_ok=True)
        for name, src in todo.items():
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            started[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), time.monotonic(), tmp, out)
        secs = {n: 0.0 for n in todo}
        failed = []
        for name, (proc, t0, tmp, out) in started.items():
            log, _ = proc.communicate()
            secs[name] = time.monotonic() - t0
            (BUILD / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name, src in todo.items():
            _libs[name] = ctypes.CDLL(str(_target(src)))
        return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def entry(source: str, name: str, n_ptrs: int, n_ints: int):
    """The C function ``name`` of ``csrc/<source>.cu``, typed once: it
    takes ``n_ptrs`` pointers, ``n_ints`` ints, the softmax scale (float)
    and the stream, and returns a cudaError_t."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(library(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_void_p])
        _entries[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def count_launch(wrapper) -> None:
    """Add one to a wrapper's ``launches`` (workers of the wall-clock
    server launch from several threads)."""
    with _count_lock:
        wrapper.launches += 1
