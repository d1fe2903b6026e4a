"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. It is
compiled by ``nvcc`` into ``_build/<name>-<hash>.so`` (the hash covers the
source and the flags, so an edited source rebuilds) and loaded with
``ctypes``. Nothing is compiled at import: the first CUDA call of a
kernel builds it. The compiler's output (``-Xptxas -v``: registers,
spills) is kept beside the library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
SOURCES = ("flash_relpos_fwd",)
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
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Build ``csrc/<name>.cu`` unless built; returns the library's path."""
    target = _target(name)
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = target + ".tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with open(target[:-3] + ".log", "w") as f:
        f.write(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, target)
    return target


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return ctypes.CDLL(build(name))
