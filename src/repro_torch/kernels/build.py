"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``.  Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of the source, every header beside it (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.  Nothing here runs at import time: a machine
without ``nvcc`` can import every module of the port.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


@dataclasses.dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float      # 0.0 when an earlier build was reused
    log: str                  # nvcc's output (ptxas register / smem report)


_LOADED: dict[str, Library] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use")
    return nvcc


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: named by a hash of the source, of
    every ``csrc/*.cuh`` (any of them may be included) and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load_library(name: str) -> Library:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    out = library_path(name)
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed to build {src.name}:\n{log}")
        os.replace(tmp, out)          # atomic: concurrent builders agree
    lib = Library(ctypes.CDLL(str(out)), out, seconds, log)
    _LOADED[name] = lib
    return lib


def load_libraries(names: list[str]) -> dict[str, Library]:
    """Build (one ``nvcc`` per source, all started together) and load."""
    with concurrent.futures.ThreadPoolExecutor(max(len(names), 1)) as pool:
        futures = {n: pool.submit(load_library, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def entry(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, built and loaded
    at first use, with its argument types set; it returns a cudaError_t."""
    fn = getattr(load_library(name).lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
