"""Build a CUDA source under ``csrc/`` into a shared library and load it.

``load(name)`` compiles ``csrc/<name>.cu`` with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``build/kernels/<name>-<hash>.so`` at the repository root, keyed on a hash
of the source, every header under ``csrc/`` (``*.cuh``, found by nvcc through
``-I csrc``) and the flags: a fresh checkout builds at its first launch, an
unchanged tree reuses the library, and an edited header rebuilds every
source.  Each library exposes a plain C
interface and is loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  One library per source lets several sources build side by
side: ``load_all`` starts one nvcc per source at once.  Nothing here runs
at import time.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
# No --use_fast_math: it would change division and rounding in the epilogue.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Library:
    """A loaded kernel library and how it was obtained."""
    cdll: ctypes.CDLL
    path: pathlib.Path
    build_s: float        # nvcc wall time in this process; 0.0 when reused
    log: str              # nvcc / ptxas output (registers, spills)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = candidate if os.path.exists(candidate) else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def source_digest(name: str, csrc: pathlib.Path = CSRC) -> str:
    """The build key of ``csrc/<name>.cu``: a hash of it, of every
    ``csrc/*.cuh`` (names and contents) and of the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load(name: str) -> Library:
    """Build (if needed) and load ``csrc/<name>.cu``; raises if nvcc fails."""
    source = CSRC / f"{name}.cu"
    path = BUILD_DIR / f"{name}-{source_digest(name)}.so"
    log_path = path.with_suffix(".log")
    build_s = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC),
                                   "-o", tmp, str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name} "
                                   f"(rc={proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, path)   # atomic: a concurrent build is harmless
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_s = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    return Library(ctypes.CDLL(str(path)), path, build_s, log)


def load_all(names: list[str]) -> list[Library]:
    """``load`` every source in ``names``, one nvcc per source, all started
    together (each build waits in its own thread); raises if any fails."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(load, names))
