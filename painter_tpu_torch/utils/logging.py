"""Metric logging for the port's trainer.

The PyTorch port's copy of ``painter_tpu/utils/logging.py``, its
multi-process parts over ``torch.distributed``. ``SmoothedValue`` /
``MetricLogger`` behavior from ``Painter/util/misc.py:25-168``: windowed +
global averages, periodic log lines with ETA and iter/data timing, the
meters summed over processes (``synchronize_between_processes``), print
silenced on the non-master ranks (``setup_for_distributed``); the
JSON-lines epoch log
(``main_train.py:375-383``), the per-step scalar stream with a
TensorBoard event file beside it, and the sample panels
(``engine_train.py:104-139``).
"""
from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from painter_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD
from painter_tpu_torch.parallel.mesh import collective_device
from painter_tpu_torch.utils.tb_writer import EventWriter


class SmoothedValue:
    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                else:
                    eta_str = "?"
                print(f"{header} [{i}{'/' + str(total) if total else ''}] "
                      f"eta: {eta_str} {self} "
                      f"time: {iter_time} data: {data_time}", flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: "
              f"{datetime.timedelta(seconds=int(elapsed))} "
              f"({elapsed / max(i, 1):.4f} s / it)", flush=True)

    def summary(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def synchronize_between_processes(self) -> None:
        """Sum each meter's (count, total) over the ranks -- the
        reference's ``SmoothedValue.synchronize_between_processes``
        (misc.py:43-54). The windowed deque stays local, as there."""
        if not _distributed():
            return
        names = sorted(self.meters)
        local = torch.tensor([[self.meters[n].count, self.meters[n].total]
                              for n in names], dtype=torch.float64,
                             device=collective_device())
        dist.all_reduce(local)
        for n, (count, total) in zip(names, local.tolist()):
            self.meters[n].count = int(count)
            self.meters[n].total = float(total)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def setup_for_distributed(is_master: bool) -> None:
    """Silence builtin print on non-master processes (misc.py:152-168).

    As in the reference, ``print(..., force=True)`` still prints
    everywhere -- used for per-process rendezvous diagnostics."""
    import builtins
    builtin_print = getattr(builtins.print, "_builtin", builtins.print)

    def print_fn(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            builtin_print(*args, **kwargs)

    print_fn._builtin = builtin_print
    builtins.print = print_fn


def append_log_line(output_dir: str, stats: Dict) -> None:
    """JSON-lines epoch log (main_train.py:379-383)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "log.txt"), "a") as f:
        f.write(json.dumps(stats) + "\n")


class ScalarWriter:
    """Per-step scalar stream: JSON-lines with the reference's TB axis.

    The reference logs train scalars on an ``epoch_1000x`` x-axis
    ("calibrating curves when batch size changes",
    engine_train.py:104-110). One record per write:
    {"step", "epoch_1000x", **scalars} -> <output_dir>/scalars.jsonl, and
    the same scalars into an ``events.out.tfevents.*`` file beside it
    (``main_train.py:280-284``) unless ``tb=False``.
    """

    def __init__(self, output_dir: str, fname: str = "scalars.jsonl",
                 tb: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, fname)
        self._f = open(self.path, "a")
        self._tb = EventWriter(output_dir) if tb else None

    def write(self, step: int, epoch_frac: float, **scalars) -> None:
        rec = {"step": int(step), "epoch_1000x": int(epoch_frac * 1000)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalars(rec["epoch_1000x"],
                                 {f"train/{k}": v
                                  for k, v in scalars.items()})

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def render_sample_panel(imgs, tgts, mask, pred, patch_size: int,
                        max_samples: int = 8):
    """[x, masked target, prediction, target] grid as one uint8 image.

    The reference's wandb image panels (engine_train.py:112-139): per
    sample a row of the four views, up to ``max_samples`` rows. imgs and
    tgts are ImageNet-normalized (B, H, W, 3); mask is (B, L) with 1 =
    masked patch; pred is the de-normalized [0, 1] prediction.
    """
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    imgs = np.asarray(imgs)[:max_samples] * std + mean
    tgts = np.asarray(tgts)[:max_samples] * std + mean
    pred = np.asarray(pred)[:max_samples]
    mask = np.asarray(mask)[:max_samples]
    b, h, w, _ = imgs.shape
    gh, gw = h // patch_size, w // patch_size
    mask_px = mask.reshape(b, gh, gw)[:, :, None, :, None]
    mask_px = np.broadcast_to(
        mask_px, (b, gh, patch_size, gw, patch_size)).reshape(b, h, w, 1)
    masked = tgts * (1 - mask_px) + 0.5 * mask_px  # gray masked patches
    rows = [np.concatenate([imgs[i], masked[i], pred[i], tgts[i]], axis=1)
            for i in range(b)]
    panel = np.concatenate(rows, axis=0)
    return (np.clip(panel, 0, 1) * 255).astype(np.uint8)


def dump_sample_panel(output_dir: str, step: int, imgs, tgts, mask, pred,
                      patch_size: int, max_samples: int = 8) -> str:
    """Write the panel PNG -> <output_dir>/panels/panel_step{K}.png."""
    from PIL import Image
    panel = render_sample_panel(imgs, tgts, mask, pred, patch_size,
                                max_samples)
    d = os.path.join(output_dir, "panels")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"panel_step{step}.png")
    Image.fromarray(panel).save(path)
    return path
