"""Build and load the port's CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` is compiled on its own by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go to
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing is built when a module is imported: the first launch of a
kernel builds its library, or :func:`build_all` builds every one at once.

Every C entry point returns the ``cudaGetLastError()`` seen right after its
launch; :func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()     # one build of a library, whatever the threads


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is missing."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []) \
            + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path):
    """Start nvcc on ``csrc/<name>.cu``; returns what :func:`_finish` needs."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def _finish(job) -> None:
    proc, tmp, out, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)   # atomic: concurrent builders agree


def build_all() -> float:
    """Build every source that has no current library, all ``nvcc`` runs at
    once, and load them.  Returns the wall seconds it took."""
    t0 = time.perf_counter()
    jobs = [_start(n, _lib_path(n)) for n in sources()
            if not _lib_path(n).is_file()]
    try:
        for job in jobs:
            _finish(job)
    finally:
        for proc, tmp, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    for n in sources():
        library(n)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        with _LOCK:
            if name not in _LIBS:
                path = _lib_path(name)
                if not path.is_file():
                    _finish(_start(name, path))
                _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def event_marks(marks, n: int):
    """``marks`` (None, or ``n`` ``torch.cuda.Event`` each recorded once,
    so that it exists) as the C array of their handles that a backward
    entry records at its launches' boundaries; None passes None."""
    if marks is None:
        return None
    if len(marks) != n or not all(m.cuda_event for m in marks):
        raise ValueError(f"marks: {n} CUDA events, each recorded once")
    return (ctypes.c_void_p * n)(*(m.cuda_event for m in marks))


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
