"""Shared helpers for the port's ops.

Ports ``gqa_repeat_factor`` of ``rafiki_tpu/ops/common.py``. The JAX
module's dispatch policy (``use_xla_fallback``) has no counterpart: in the
port the tensor's device decides — a CPU tensor takes the plain version,
a CUDA tensor the kernel.
"""

from __future__ import annotations


def gqa_repeat_factor(n_heads: int, n_kv_heads: int) -> int:
    """Validate the GQA head pairing (q head i ↔ kv head ``i // rep``,
    the ``repeat_interleave`` convention) and return
    ``rep = n_heads / n_kv_heads``."""
    if n_heads % n_kv_heads:
        raise ValueError(f"q heads {n_heads} must be a multiple of kv "
                         f"heads {n_kv_heads}")
    return n_heads // n_kv_heads
