"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Each source under ``ops/csrc/`` exposes a plain C interface and is compiled
by hand into its own shared library (no PyTorch headers, so a build takes
seconds) under ``<repo>/build/``, keyed by a hash of the source, the
``csrc/*.cuh`` headers it includes (``hopper.cuh``, ``flash_fwd_wgmma.cuh``)
and the flags. The first call in a process builds what is missing; later calls load
the cached library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(src: Path) -> list:
    """``src`` and every header under its directory that it includes, directly
    or through another header, each once, in the order first reached."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.exists():
            continue
        seen.append(path)
        todo.extend(path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes()))
    return seen


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """The library of ``<csrc>/<name>.cu``, keyed by the source, the headers it
    includes and the flags: an edited header builds a new library."""
    h = hashlib.sha256()
    for path in _sources(csrc / f"{name}.cu"):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns its path.
    Raises with the compiler log on failure."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    return ctypes.CDLL(str(build(name)))
