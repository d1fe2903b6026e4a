"""Build and load the port's CUDA kernels and its host C++ image ops.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. It is
compiled by ``nvcc`` into ``_build/<name>-<hash>.so`` (the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source rebuilds) and loaded with
``ctypes``. Nothing is compiled at import: the first CUDA call of a
kernel builds it, and :func:`build_all` builds every source at once, one
``nvcc`` process each. The compiler's output (``-Xptxas -v``: registers,
spills) is kept beside the library as ``<name>-<hash>.log``.

The host sources (``HOST_SOURCES``: ``painter_tpu_torch/native/<name>.cpp``,
the data workers' image ops) go the same way through ``g++`` with
``-march=native``; their hash also covers the host's ISA (the CPU flags),
since such a library does not run on another CPU. Each library is written
under a name of its own process and renamed into place, so processes that
build the same source at once leave one whole library.

A wrapper caches the symbols it looks up in a library with :func:`lookup`;
:func:`swapped` runs the wrappers on other builds of a source (the edited
variants of ``utils/kernel_variants.py``) and forgets those lookups on
entry and on exit.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, List, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
SOURCES = ("flash_relpos_fwd", "flash_relpos_bwd", "decoder_tail_fwd",
           "decoder_tail_bwd", "int8_mlp")
HOST_SOURCES = ("image_ops",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX = "g++"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-fno-math-errno")


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


def _host_isa() -> str:
    """The CPU's architecture and feature flags (``-march=native``)."""
    import platform
    bits = platform.machine()
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith(("flags", "Features")):
                return bits + line
    return bits


def _source(name: str):
    """(source path, files hashed, compiler flags) of source ``name``."""
    if name in HOST_SOURCES:
        src = os.path.join(NATIVE_SRC, f"{name}.cpp")
        return src, [src], GXX_FLAGS
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return (os.path.join(CSRC, f"{name}.cu"),
            [os.path.join(CSRC, f) for f in [f"{name}.cu", *headers]],
            NVCC_FLAGS)


def _target(name: str) -> str:
    _, hashed, flags = _source(name)
    digest = hashlib.sha256()
    for path in hashed:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
    if name in HOST_SOURCES:
        digest.update(_host_isa().encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Build every named source not yet built (``SOURCES`` with ``nvcc``,
    ``HOST_SOURCES`` with ``g++``), all compilers started together;
    returns {name: library path}. Raises if any fails."""
    targets = {name: _target(name) for name in names}
    procs = {}
    for name, target in targets.items():
        if os.path.exists(target):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        src, _, flags = _source(name)
        compiler = GXX if name in HOST_SOURCES else _nvcc()
        tmp = f"{target}.{os.getpid()}.tmp"
        try:
            procs[name] = (tmp, subprocess.Popen(
                [compiler, *flags, "-o", tmp, src], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        except OSError as e:
            raise RuntimeError(f"cannot run {compiler} for {name}: "
                               f"{e}") from e
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        with open(targets[name][:-3] + ".log", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"{proc.args[0]} failed for "
                          f"{os.path.basename(proc.args[-1])}:\n{out}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def build(name: str) -> str:
    """Build source ``name`` unless built; returns the library's path."""
    return build_all((name,))[name]


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return ctypes.CDLL(build(name))


_lookups: List[Callable] = []


def lookup(fn: Callable) -> Callable:
    """``functools.cache`` for a wrapper's lookup of its symbols in a
    :func:`library`, forgotten whenever :func:`swapped` changes the
    libraries."""
    cached = functools.cache(fn)
    _lookups.append(cached)
    return cached


@contextlib.contextmanager
def swapped(libs: Dict[str, str]):
    """Inside, :func:`library` of each source in ``libs`` (name -> path of
    a library built elsewhere) is that library, so the wrappers run it."""
    global library
    real = library
    loaded = {name: ctypes.CDLL(path) for name, path in libs.items()}

    def swapped_library(name: str) -> ctypes.CDLL:
        return loaded[name] if name in loaded else real(name)

    library = swapped_library
    for fn in _lookups:
        fn.cache_clear()
    try:
        yield
    finally:
        library = real
        for fn in _lookups:
            fn.cache_clear()
