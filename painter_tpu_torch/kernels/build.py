"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. It is
compiled by ``nvcc`` into ``_build/<name>-<hash>.so`` (the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source rebuilds) and loaded with
``ctypes``. Nothing is compiled at import: the first CUDA call of a
kernel builds it, and :func:`build_all` builds every source at once, one
``nvcc`` process each. The compiler's output (``-Xptxas -v``: registers,
spills) is kept beside the library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
SOURCES = ("flash_relpos_fwd", "flash_relpos_bwd", "decoder_tail_fwd",
           "decoder_tail_bwd", "int8_mlp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> str:
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Build every ``csrc/<name>.cu`` not yet built, all ``nvcc`` processes
    started together; returns {name: library path}. Raises if any fails."""
    targets = {name: _target(name) for name in names}
    procs = {}
    for name, target in targets.items():
        if os.path.exists(target):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", target + ".tmp",
             os.path.join(CSRC, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        with open(targets[name][:-3] + ".log", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(targets[name] + ".tmp", targets[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def build(name: str) -> str:
    """Build ``csrc/<name>.cu`` unless built; returns the library's path."""
    return build_all((name,))[name]


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return ctypes.CDLL(build(name))
