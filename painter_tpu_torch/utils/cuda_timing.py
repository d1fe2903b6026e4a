"""Time a call on the GPU two ways.

:func:`event_ms` is the mean time per call between CUDA events around
repeated calls: the caller's host work is in it where the host is slower
than the device. :func:`device_ms` (:func:`device_ms_by_kernel`) is the
device time per call spent in kernels of given names (each of them), from
``torch.profiler``: the kernels alone.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch


def event_ms(fn: Callable[[], object], iters: int, warmup: int = 1) -> float:
    """Mean time per call of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# captures of one window before device_ms_by_kernel gives up on a
# profiler that records no device activity at all
CAPTURES = 3


def _device_events(fn: Callable[[], object], iters: int):
    """torch.profiler's device events of ``iters`` calls of ``fn``, taken
    again (up to ``CAPTURES`` times) while a capture holds none: the
    profiler has been seen on the H100 to return a window of launched
    kernels with none of them in it. The host's ops are not recorded: the
    kernels' times come out the same without them, and a Painter ViT-L
    training update's capture took ~3.6-4.2 s instead of ~10.5 s (H100
    80GB HBM3, 700 W)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(CAPTURES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in events):
            break
    return events


def device_ms_by_kernel(fn: Callable[[], object], iters: int,
                        names: Sequence[str]) -> Dict[str, float]:
    """Device ms per call of ``fn`` in each kernel whose name contains one
    of ``names`` (torch.profiler over ``iters`` calls after one warm-up),
    keyed by the kernel's name up to its argument list."""
    fn()
    torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in _device_events(fn, iters):
        found = [e.key.find(n) for n in names if n in e.key]
        if e.device_type != torch.autograd.DeviceType.CUDA or not found:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)
        cut = e.key.find("(", found[0])
        key = (e.key[:cut] if cut > 0 else e.key).replace("void ", "")
        out[key] = out.get(key, 0.0) + us / iters / 1e3
    return out


def device_ms(fn: Callable[[], object], iters: int,
              names: Sequence[str]) -> Optional[float]:
    """The sum of :func:`device_ms_by_kernel`, or None where the profiler
    saw no such kernel."""
    by_kernel = device_ms_by_kernel(fn, iters, names)
    return sum(by_kernel.values()) if by_kernel else None
