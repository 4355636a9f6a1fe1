"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``.
The library's file name carries a hash of its source and of the shared
headers ``csrc/*.cuh``, so an edited source is rebuilt and an unchanged
one is loaded as it is. Libraries go to ``build/`` at the root of the
checkout. Nothing is built while a module is imported: ``library(name)``
builds at first use, and ``build_all()`` builds every source at once, one
``nvcc`` per source, all started together.
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
from torch.distributed.tensor import DTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the element types and head dims the attention kernels are instantiated
# for
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
    """The library's path, named by a hash of its source and of the shared
    headers (``csrc/*.cuh``) it may include."""
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


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


def entry(source: str, name: str, n_ptrs: int, n_ints: int,
          n_floats: int = 1):
    """The C function ``name`` of ``csrc/<source>.cu``, typed once: it
    takes ``n_ptrs`` pointers, ``n_ints`` ints, ``n_floats`` floats (the
    attention kernels' one is the softmax scale) and the stream, and
    returns a cudaError_t."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(library(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        _entries[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def refuse_autograd(what: str, *tensors) -> None:
    """Raise if autograd would record any of ``tensors``. The kernels are
    forward-only (the reference's Pallas kernels have no VJP either) and
    write through raw pointers into fresh outputs, so their results carry
    no graph: a loss through them would give no gradient to anything
    upstream, without an error. The check holds on every device, so a
    training path that reaches a wrapper fails in the CPU tests as it
    would on the card; training runs the plain versions
    (``transformer.PLAIN_OPS``, ``xlstm.PLAIN_SCAN_OPS``)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and the kernel has no "
            f"backward; run the plain version under autograd")


def refuse_dtensor(what: str, *tensors) -> None:
    """Raise if any of ``tensors`` is a DTensor. The wrappers pass raw
    pointers to the kernels, and a DTensor's pointer is its local shard's
    alone; under a mesh the model hands the kernels local shards
    (``models.transformer.local_call``), never a DTensor, and never falls
    back to the plain version on the card."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{what}: a DTensor input; call the kernel on its local "
            f"shards (local_map)")


def count_launch(wrapper) -> None:
    """Add one to a wrapper's ``launches`` (workers of the wall-clock
    server launch from several threads)."""
    with _count_lock:
        wrapper.launches += 1
