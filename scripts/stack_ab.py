"""Run chip_smoke.py's stack phases (23 and 30, ``stack_phase``) or its
scale-out phase (32, ``scaleout_phase``) alone, in one or more checkouts,
one process each, in the order given, so two commits compare on one card.

    python3 scripts/stack_ab.py --trees build/parent . . build/parent
    python3 scripts/stack_ab.py --phase scaleout

Each tree is a checkout of this repository; it builds its own kernels
under its own ``build/`` first (``chip_smoke.build_kernels``). Phase
23's job runs ``--trials`` trials in every tree (phase 30 replays that
job's WAL, so its replay figures follow the count; its rolling restart
does not). Prints the card's name and power limit, then per tree the
phase's own output and one JSON line: the tree, and for ``stack`` phase
30's rolling restart (``drain_s`` and the traffic's answers, 503s and
failures) and seconds, for ``scaleout`` phase 32's line. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path


def child(tree: Path, phase: str, trials: int) -> None:
    """One phase of ``tree``'s chip_smoke, in this process."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke
    from rafiki_tpu_torch.models import llama_lora as ll
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.models.bert import HashTokenizer
    from rafiki_tpu_torch.ops import _build
    from rafiki_tpu_torch.ops import attention as fa
    from rafiki_tpu_torch.store import params as store_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.ATTN_BLOCK_H = 1
    # the trial count's name differs between commits
    for name in ("STACK_TUNE_TRIALS", "VIT_TUNE_TRIALS"):
        if hasattr(chip_smoke, name):
            setattr(chip_smoke, name, trials)
    chip_smoke.build_kernels(_build)
    dev = torch.device("cuda")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if phase == "stack":
            chip_smoke.stack_phase(torch, np, vit, dev)
        else:
            chip_smoke.scaleout_phase(torch, np, vit, ll, store_params,
                                      HashTokenizer, dev)
    text = out.getvalue()
    print(text, flush=True)
    lines = [json.loads(x) for x in text.splitlines()
             if x.startswith('{"phase"')]
    if phase == "stack":
        rec = next(r for r in lines if r["phase"] == "recovery")
        summary = {"rolling_restart": rec["rolling_restart"],
                   "t_s": rec.get("t_s")}
    else:
        summary = next(r for r in lines if r["phase"] == "scaleout")
    print(json.dumps({"tree": str(tree), "phase": phase,
                      "trials": trials, **summary}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", type=Path, default=[Path(".")])
    ap.add_argument("--phase", choices=("stack", "scaleout"),
                    default="stack")
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child.resolve(), args.phase, args.trials)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    rc = 0
    for tree in args.trees:
        rc |= subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             str(tree.resolve()), "--phase", args.phase, "--trials",
             str(args.trials)], cwd=tree).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
