"""Build the port's CUDA kernels (nvcc) and native I/O library (g++).

Each ``csrc/<name>.cu`` is compiled on first use into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o _kernels/lib<name>-<hash>.so

The library lands in ``audio_processor_tpu_torch/_kernels/`` (listed in
``.gitignore``), named by a hash of the sources, so an edited kernel is
rebuilt and a stale one is never loaded. The compiler's output (with
``-Xptxas=-v``: registers, shared memory and spills per kernel) is kept
beside it as ``lib<name>-<hash>.log``. :func:`build_all` compiles
several sources in parallel, one nvcc process each, and with
``native=True`` the host I/O library beside them:

    g++ -O3 -march=native -fPIC -shared -std=c++17 -pthread
        native/audioio.cpp native/vorbis.cpp native/flac.cpp
        -o io/_native/libaudioio-<hash>.so

``io/native.py`` loads that library when it exists (its pure-Python
fallback covers a checkout where it was never built); ``io/_native/`` is
listed in ``.gitignore``.

Nothing here builds at import: the CPU-only test machines have no nvcc,
and only a launch on a CUDA tensor asks for a kernel build
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
NATIVE_SRC = Path(__file__).resolve().parent.parent / "native"
NATIVE_SOURCES = ("audioio.cpp", "vorbis.cpp", "flac.cpp")
NATIVE_DIR = Path(__file__).parent / "io" / "_native"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread")


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


def native_library() -> Path:
    """Where the native I/O library of the current sources lives (it
    exists only once :func:`build_all` with ``native=True`` ran)."""
    h = hashlib.sha256()
    for f in sorted(NATIVE_SRC.glob("*.cpp")) + sorted(
            NATIVE_SRC.glob("*.inc")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return NATIVE_DIR / f"libaudioio-{h.hexdigest()[:16]}.so"


def _start(cmd, lib: Path, tmp: Path):
    """Start one compiler process writing ``tmp``, its output in
    ``lib``'s ``.log``; returns (lib, tmp, log, process)."""
    log = lib.with_suffix(".log")
    with open(log, "w") as f:
        f.write(" ".join(cmd) + "\n")
        f.flush()
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                text=True)
    return lib, tmp, log, proc


def build_all(names, native: bool = False) -> dict:
    """Compile every out-of-date ``csrc/<name>.cu`` of ``names`` at
    once, one nvcc process per source, all started together, and with
    ``native`` the native I/O library (one g++) beside them; returns
    {name: library path} (the native library under "native"). Raises
    RuntimeError, with the compiler's output, if any build fails (after
    every build has ended)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in dict.fromkeys(names):
        lib = _library(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        jobs.append((name, *_start(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")], lib, tmp)))
    lib = native_library()
    if native and not lib.exists():
        NATIVE_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        jobs.append(("native", *_start(
            ["g++", *GXX_FLAGS, *(str(NATIVE_SRC / s)
                                  for s in NATIVE_SOURCES),
             "-o", str(tmp)], lib, tmp)))
    failed = []
    for name, lib, tmp, log, proc in jobs:
        if proc.wait() != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"build failed ({proc.returncode}) for "
                          f"{name}:\n{log.read_text()}")
        else:
            os.replace(tmp, lib)   # atomic: never load half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    out = {name: _library(name) for name in names}
    if native:
        out["native"] = native_library()
    return out


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

