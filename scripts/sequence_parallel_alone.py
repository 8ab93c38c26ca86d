"""``chip_smoke.py``'s phase 37 (``sequence_parallel``) alone on one CUDA
card.

    python3 scripts/sequence_parallel_alone.py

Run from the root of a checkout. Sets the train worker's allocator
settings, as ``chip_smoke.py`` does first, builds the kernels and makes
one flash-attention call (as the phases before 37 do, so the library is
loaded before the phase's first step), then runs the phase: prints the
card's name and power limit, the phase's JSON line and its seconds, and
exits non-zero if a gate fails.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sequence_parallel_alone: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from rafiki_tpu_torch.worker.admission import use_train_allocator
    use_train_allocator()
    import chip_smoke as cs
    from rafiki_tpu_torch.model.base import TrainContext
    from rafiki_tpu_torch.models import llama_lora as ll
    from rafiki_tpu_torch.ops import _build
    from rafiki_tpu_torch.ops import attention as fa
    from rafiki_tpu_torch.store import params as store_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_kernels(_build)
    fa.ATTN_BLOCK_H = 1
    dev = torch.device("cuda")
    q = torch.randn(1, 4, 128, 128, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    fa.flash_attention(q, q, q, causal=True).sum().backward()
    cs.sequence_parallel_phase(torch, np, ll, fa, store_params,
                               TrainContext, dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
