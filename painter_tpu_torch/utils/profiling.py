"""Profiling hooks: ``torch.profiler`` traces, step timing, device memory.

The reference has no tracer, only wall-clock meters with a forced
``cuda.synchronize`` per step (``Painter/util/misc.py:124-168``,
``engine_train.py:93``). As in ``painter_tpu/utils/profiling.py``: launches
stay asynchronous, :func:`trace` writes a trace that TensorBoard's profile
plugin or Perfetto opens, and :class:`StepTimer` synchronizes only at its
sampling steps.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Sequence

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    a card, of its kernels into ``log_dir`` (a Chrome-trace JSON that
    TensorBoard and Perfetto open); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.pt.trace.json"))


def _sync(output) -> None:
    """Wait for ``output`` (a tensor or a nest of them): the stream of the
    last CUDA tensor found."""
    found = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            found.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(output)
    cuda = [x for x in found if x.is_cuda]
    if cuda:
        torch.cuda.current_stream(cuda[-1].device).synchronize()


class StepTimer:
    """Steps per second without a synchronization per step: waits only
    every ``sync_every`` steps, on the last output's device."""

    def __init__(self, sync_every: int = 10):
        self.sync_every = sync_every
        self._count = 0
        self._t0: Optional[float] = None
        self.rate: float = 0.0

    def step(self, last_output=None) -> Optional[float]:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._count += 1
        if self._count % self.sync_every == 0:
            if last_output is not None:
                _sync(last_output)
            dt = time.perf_counter() - self._t0
            self.rate = self.sync_every / dt
            self._t0 = time.perf_counter()
            return self.rate
        return None


def device_memory_stats(devices: Optional[Sequence] = None) -> dict:
    """{str(device): {bytes_in_use, peak_bytes_in_use, bytes_limit}} of
    every CUDA device (or of ``devices``); a device without such stats
    (the CPU) gets an entry with no keys, as the JAX package gives a
    backend without them."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    out = {}
    for d in map(torch.device, devices):
        if d.type != "cuda":
            out[str(d)] = {}
            continue
        stats = torch.cuda.memory_stats(d)
        _, total = torch.cuda.mem_get_info(d)
        out[str(d)] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total}
    return out
