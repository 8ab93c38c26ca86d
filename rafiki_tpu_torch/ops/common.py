"""Shared helpers for the port's ops.

Ports ``gqa_repeat_factor`` of ``rafiki_tpu/ops/common.py``. The JAX
module's dispatch policy (``use_xla_fallback``) becomes
:func:`runs_kernel`: the tensor's device decides — a CPU tensor takes the
plain version, any other device the kernel.
"""

from __future__ import annotations

import torch

#: the kernels' element-type codes (their C entries take one int)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def runs_kernel(t: torch.Tensor) -> bool:
    """The dispatch rule: CPU tensors take the plain version, every other
    device the CUDA kernel."""
    return t.device.type != "cpu"


def check_launch(err: int, what: str) -> None:
    """Raise when a kernel's C entry returned a CUDA error (a refused
    launch never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def gqa_repeat_factor(n_heads: int, n_kv_heads: int) -> int:
    """Validate the GQA head pairing (q head i ↔ kv head ``i // rep``,
    the ``repeat_interleave`` convention) and return
    ``rep = n_heads / n_kv_heads``."""
    if n_heads % n_kv_heads:
        raise ValueError(f"q heads {n_heads} must be a multiple of kv "
                         f"heads {n_kv_heads}")
    return n_heads // n_kv_heads
