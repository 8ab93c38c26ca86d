"""Device selection for the port's entry points.

Counterpart of ``rafiki_tpu/utils/platform.py``: where the JAX package
pins a backend through ``jax.config``, the port resolves an explicit
``torch.device``. The rule is one-sided on purpose: ``device=None`` means
the CUDA card, and a host without one raises instead of quietly serving
from the CPU (a CPU run must be asked for, as the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; anything else → ``torch.device(device)`` as
    given. A CUDA device (asked for by name or by default) raises
    ``RuntimeError`` when no CUDA device is present: a process that was
    given a card and finds none never carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "the plain PyTorch versions on the host")
    return dev


def same_device(a: torch.device, b: Optional[torch.device]) -> bool:
    """Device equality that treats ``cuda`` and ``cuda:<current>`` alike."""
    if b is None or a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == \
        (b.index if b.index is not None else cur)
