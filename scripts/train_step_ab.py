"""Time the port's Llama training step (chip_smoke.py's phase 7:
Llama-3-8B widths, bf16 compute, f32 LoRA leaves, batch 4 x 1024, 4
steps, then one profiled step) in one or more checkouts, one process
each, in the order given, so two commits compare on one card.

    python3 scripts/train_step_ab.py --trees build/parent . . build/parent

Each tree is a checkout of this repository whose ``chip_smoke.py`` has
``training_phase(torch, np, ll, fa, depth, dev)``; it builds its own
kernels under its own ``build/``. Prints the card's name and power
limit, then per tree one JSON line: the tree, its phase 7 line's
``step_s``, ``peak_mem_gb``, ``losses`` and ``profiled_step``. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path


def child(tree: Path, depth: int) -> None:
    """Phase 7 of ``tree``'s chip_smoke, in this process."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke
    from rafiki_tpu_torch.models import llama_lora as ll
    from rafiki_tpu_torch.ops import attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    fa.ATTN_BLOCK_H = 1
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        chip_smoke.training_phase(torch, np, ll, fa, depth,
                                  torch.device("cuda"))
    line = next(json.loads(x) for x in out.getvalue().splitlines()
                if x.startswith("{") and '"phase": "training"' in x)
    print(json.dumps({"tree": str(tree), **{
        key: line[key] for key in ("depth", "batch", "step_s",
                                   "peak_mem_gb", "losses",
                                   "profiled_step")}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", type=Path, default=[Path(".")])
    ap.add_argument("--depth", type=int, default=32)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child.resolve(), args.depth)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for tree in args.trees:
        subprocess.run([sys.executable, __file__, "--child",
                        str(tree.resolve()), "--depth", str(args.depth)],
                       cwd=tree, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
