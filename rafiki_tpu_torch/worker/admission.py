"""Admission control: the device memory limit a serving budget is held to.

The port's own copy of ``resolve_device_limit`` from
``rafiki_tpu/worker/admission.py``. Where the JAX function reads
``memory_stats()["bytes_limit"]`` of ``jax.local_devices()[0]``, this one
reads the total of ``torch.cuda.mem_get_info`` for a CUDA device. The
estimators live with the templates (``LlamaLoRA.
estimate_serving_device_bytes``); the worker owns the refusal.

That total is the whole card, while a train estimate is the caching
allocator's peak of allocated bytes; :func:`train_reserve` is what a
train step needs beside it, and the train worker admits a trial only
where its estimate and that reserve fit under the limit.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from rafiki_tpu_torch.utils.device import DeviceLike

log = logging.getLogger(__name__)

#: what a process holds on the card outside the caching allocator (the
#: CUDA context, the kernels' modules: 0.65-0.82 GB on an H100), and
#: the allocator's slack above its peak of allocated bytes, as a share
#: of that peak (at 5 % a checkpointed Llama-3-8B-wide step ran out of
#: memory). ``chip_smoke.py`` phase 35 runs each of its train steps with
#: the allocator capped at ``estimate + train_reserve(estimate)`` less
#: the memory outside it
TRAIN_RESERVE_BYTES = 1 << 30
TRAIN_RESERVE_SHARE = 0.10

#: the caching allocator's settings in a process that trains: segments
#: that grow in place. With fixed segments a sequence-parallel step
#: fragments the reserve: at Llama-3-8B widths on (data 1, sp 4) the
#: f32 LM head gradient (1.96 GiB) found no place with 2.79 GiB of the
#: reserve free in pieces (``chip_smoke.py`` phase 37 on an H100)
TRAIN_ALLOC_CONF = "expandable_segments:True"


def train_reserve(total: int) -> int:
    """Bytes a train step of estimated peak ``total`` needs on the card
    beyond it: :data:`TRAIN_RESERVE_BYTES` plus
    :data:`TRAIN_RESERVE_SHARE` of ``total``."""
    return TRAIN_RESERVE_BYTES + int(TRAIN_RESERVE_SHARE * total)


def use_train_allocator() -> None:
    """Give the caching allocator :data:`TRAIN_ALLOC_CONF` unless
    ``PYTORCH_CUDA_ALLOC_CONF`` already says how to run it. The allocator
    reads the variable when the process first touches the card, so call
    this before that: the train worker's ``main`` does it first."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", TRAIN_ALLOC_CONF)


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
