"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o _kernels/lib<name>-<hash>.so

The library lands in ``audio_processor_tpu_torch/_kernels/`` (listed in
``.gitignore``), named by a hash of the sources, so an edited kernel is
rebuilt and a stale one is never loaded. The compiler's output (with
``-Xptxas=-v``: registers, shared memory and spills per kernel) is kept
beside it as ``lib<name>-<hash>.log``. :func:`build_all` compiles
several sources in parallel, one nvcc process each.

Nothing here runs at import: the CPU-only test machines have no nvcc,
and only a launch on a CUDA tensor asks for a build
(``models/_cuda_call.py`` launches what this module loads).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels can only be built where the CUDA toolkit is installed")
    return str(path)


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name)}.so"


def build_all(names) -> dict:
    """Compile every out-of-date ``csrc/<name>.cu`` of ``names`` at
    once, one nvcc process per source, all started together; returns
    {name: library path}. Raises RuntimeError, with the compiler's
    output, if any build fails (after every build has ended)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in dict.fromkeys(names):
        lib = _library(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        log = lib.with_suffix(".log")
        with open(log, "w") as f:
            f.write(" ".join(cmd) + "\n")
            f.flush()
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                    text=True)
        jobs.append((name, lib, tmp, log, proc))
    failed = []
    for name, lib, tmp, log, proc in jobs:
        if proc.wait() != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{name}:\n{log.read_text()}")
        else:
            os.replace(tmp, lib)   # atomic: never load half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _library(name) for name in names}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library path. Raises RuntimeError if nvcc fails."""
    return build_all([name])[name]


def build_log(name: str) -> str:
    """The command and compiler output of the current build of ``name``."""
    return _library(name).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per
    process. The caller declares argtypes/restype of what it calls."""
    return ctypes.CDLL(str(build(name)))

