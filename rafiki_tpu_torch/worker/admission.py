"""Admission control: the device memory limit a serving budget is held to.

The port's own copy of ``resolve_device_limit`` from
``rafiki_tpu/worker/admission.py``. Where the JAX function reads
``memory_stats()["bytes_limit"]`` of ``jax.local_devices()[0]``, this one
reads the total of ``torch.cuda.mem_get_info`` for a CUDA device. The
estimators live with the templates (``LlamaLoRA.
estimate_serving_device_bytes``); the worker owns the refusal.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from rafiki_tpu_torch.utils.device import DeviceLike

log = logging.getLogger(__name__)


def resolve_device_limit(device: DeviceLike = None) -> Optional[int]:
    """Bytes of device memory one deployment may plan against.

    Order: the ``RAFIKI_DEVICE_HBM_BYTES`` env override (a malformed
    value warns and falls through — a config typo must not fail every
    deployment closed), then the CUDA device's total memory. ``None``
    (the CPU, or no device given) means "no limit known" and callers skip
    their check."""
    env = os.environ.get("RAFIKI_DEVICE_HBM_BYTES")
    if env:
        try:
            return int(float(env))
        except ValueError:
            log.warning(
                "RAFIKI_DEVICE_HBM_BYTES=%r is not a number; ignoring "
                "it for admission control", env)
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[1])
    return None
