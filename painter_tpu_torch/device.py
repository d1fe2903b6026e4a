"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
card and no explicit ``device="cpu"`` they raise instead of quietly
running on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "painter_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host")
    return dev
