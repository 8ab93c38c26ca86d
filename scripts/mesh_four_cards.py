"""Phase 36's mesh loop with one shard per card, on a host with four
CUDA cards (``chip_smoke.py``'s phase 36 puts every shard on one card).

    python3 scripts/mesh_four_cards.py

Run from the root of a checkout; builds the kernels first. Two legs:

- f32 at width 64 (``chip_smoke.MESH_F32_KNOBS``): the template's mesh
  loop on a (2, 2) mesh over four cards, over one card holding all four
  shards, and over the CPU, from one init: the four-card losses and
  trained leaves bit-equal to the one-card ones, and within 1e-6
  relative of the CPU's;
- Llama-3-8B widths at phase 36 (a)'s knobs (``chip_smoke.MESH_KNOBS``):
  a (2, 2) mesh over four cards, each card's peak allocated bytes against
  the template's per-device ``estimate_device_budget(4)``.

Prints the cards' names and power limits, then one JSON line; exits
non-zero if a gate fails (bit equality, 1e-6 against the CPU, each card's
peak within 5 % of the estimate, B3/B5/B6 launching once per shard,
layer and step).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if torch.cuda.device_count() < 4:
        print("mesh_four_cards: needs four CUDA cards", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from rafiki_tpu_torch.model.base import TrainContext
    from rafiki_tpu_torch.models import llama_lora as ll
    from rafiki_tpu_torch.ops import _build
    from rafiki_tpu_torch.ops import attention as fa
    from rafiki_tpu_torch.store import params as store_params

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build_s = cs.build_kernels(_build)[1]
    fa.ATTN_BLOCK_H = 1
    work = ROOT / "build" / "mesh_four_cards"
    cards = [f"cuda:{k}" for k in range(4)]

    train = cs.write_corpus(np, work / "f32.jsonl", 32, cs.SEED + 39,
                            vocab=200, max_words=60)
    host = ll.LlamaLoRA(device="cpu", **cs.MESH_F32_KNOBS)
    blob = {"params": store_params.params_to_jax(
        host._module().state_dict()), "meta": {"id2tok": {}}}
    runs = {}
    for name, devs in (("four_cards", cards), ("one_card", ["cuda:0"] * 4),
                       ("cpu", ["cpu"] * 4)):
        m = ll.LlamaLoRA(device="cpu" if name == "cpu" else "cuda:0",
                         **cs.MESH_F32_KNOBS)
        m.load_parameters(blob)
        ctx = TrainContext(devices=devs)
        cs.zero_flash_launches(fa)
        m.train(train, ctx)
        runs[name] = (ctx.logger.get_values("loss"), cs.flash_launches(fa),
                      cs._flat_tree(m.dump_parameters()["params"]))
    four, one, cpu = runs["four_cards"], runs["one_card"], runs["cpu"]
    rep = {"build_s": build_s,
           "f32_losses": {k: r[0] for k, r in runs.items()},
           "f32_launches": four[1],
           "four_vs_one_bit_equal": four[0] == one[0] and all(
               np.array_equal(four[2][k], one[2][k]) for k in four[2]),
           "four_vs_cpu_max_rel": max(abs(a - b) / abs(b)
                                      for a, b in zip(four[0], cpu[0]))}

    corpus = cs._mesh_corpus(np, work / "llama3.jsonl", 4, cs.SEED + 36,
                             1024)
    m = ll.LlamaLoRA(device="cuda:0", **dict(cs.MESH_KNOBS,
                                             model_parallel=2))
    est = m.estimate_device_budget(4)
    base = []
    for k in range(4):
        torch.cuda.synchronize(k)
        torch.cuda.reset_peak_memory_stats(k)
        base.append(torch.cuda.memory_allocated(k))
    ctx = TrainContext(devices=cards)
    cs.zero_flash_launches(fa)
    t = time.perf_counter()
    m.train(corpus, ctx)
    for k in range(4):
        torch.cuda.synchronize(k)
    peaks = [(torch.cuda.max_memory_allocated(k) - base[k]) / 1e9
             for k in range(4)]
    rep["llama3_2x2"] = {
        "depth": cs.MESH_KNOBS["depth"],
        "losses": ctx.logger.get_values("loss"),
        "train_s": time.perf_counter() - t,
        "launches": cs.flash_launches(fa),
        "estimate_per_card_gb": {k: v / 1e9 for k, v in est.items()},
        "peaks_gb": peaks,
        "peak_over_estimate": [p * 1e9 / est["total"] for p in peaks],
        "note": "card 0 also drew the template's init"}
    rep["seconds"] = time.perf_counter() - t0
    print(json.dumps(rep), flush=True)

    steps = cs.MESH_F32_KNOBS["max_epochs"] * 4  # 32 texts, batch 8
    want = 4 * cs.MESH_F32_KNOBS["depth"] * steps
    fails = []
    if not rep["four_vs_one_bit_equal"]:
        fails.append("four cards differ from one")
    if rep["four_vs_cpu_max_rel"] > cs.MESH_F32_TOL:
        fails.append("four cards differ from the CPU")
    if any(n != want for n in four[1].values()):
        fails.append(f"f32 launches {four[1]} != {want}")
    if any(abs(r - 1) > cs.MESH_PEAK_TOL
           for r in rep["llama3_2x2"]["peak_over_estimate"][1:]):
        fails.append("a card's peak is off its estimate")
    if fails:
        raise AssertionError("; ".join(fails))
    return 0


if __name__ == "__main__":
    sys.exit(main())
