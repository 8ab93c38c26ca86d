#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

Run from a checkout of the repository, with one Hopper card (sm_90a) and
the CUDA toolkit's ``nvcc``::

    python3 chip_smoke.py            # the full check, Llama-3-8B depth 32
    python3 chip_smoke.py --depth 8  # the serving leg at a cut depth

Phases; each raises on failure, so the script exits non-zero:

1. Device and build: the card's name and power limit, TF32 off, every
   ``rafiki_tpu_torch/csrc/*.cu`` built with ``nvcc`` (in parallel, timed,
   with ptxas's register/shared-memory report).
2. Kernels against their plain versions at Llama-3-8B attention shapes
   (8 slots, 32 query / 8 kv heads, head dim 128, page 16, bf16 pools,
   max_len 2048): error against the plain version run in f32, kernel /
   plain / library times, and the least time the card could take.
3. f32 exactness: the full-width Llama at depth 2 in f32 (random weights
   from a seed, nonzero LoRA) behind a paged ``DecodeEngine`` must emit
   exactly the tokens of ``greedy_generate`` over a contiguous cache.
4. Serving, the main path: Llama-3-8B (bf16, depth 32 unless cut, rope
   theta 500000, LoRA rank 16, random weights) behind ``DecodeEngine`` +
   ``TextDecodeEngine`` with a paged pool; 8 text requests of 64..1024
   prompt tokens, 64 new tokens each, submitted over the first steps.
   The kernels' launch counters are zeroed just before and read just
   after; both kernels must have launched.

The last lines are the ``kernels`` JSON line and then the device line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing a result.
"""

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
#: H100 SXM, published peaks (dense): memory rate and bf16 / f32 rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_SOURCE = "rafiki_tpu_torch/csrc/paged_attention.cu"
REPLACES = {
    "paged_decode_attention": "rafiki_tpu/ops/paged_attention.py:177",
    "paged_window_attention": "rafiki_tpu/ops/paged_attention.py:337",
}


def bf16_tol(ref):
    """max |kernel - plain(f32)| allowed for bf16 pools and output: one
    rounding of the output to bf16 (at most 2^-8 of its magnitude) plus
    1e-3 for the f32 sums taken in another order."""
    return 1e-3 + 2.0 ** -8 * ref.abs().max().item()


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_kernels(build):
    """One nvcc per source, all started together; returns ptxas's
    per-kernel resource lines and the wall time."""
    sources = sorted(build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        logs = list(pool.map(
            lambda s: build.build(s.stem, extra_flags=("-Xptxas", "-v")),
            sources))
    seconds = time.perf_counter() - t0
    report = [ln.strip() for log in logs for ln in log.splitlines()
              if "registers" in ln or "spill" in ln]
    return [s.name for s in sources], seconds, report


def time_ms(torch, fn, iters=10):
    """Median device time of one call, each launch timed by its own CUDA
    events with a 64 MB write in between, so every call finds the L2
    cache (50 MB) cold, as a layer's call does in a decode step."""
    fn()
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def bound_ms(n_bytes, flops, dtype_name):
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate for the type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, np, F, pa, dev):
    """Phase 2: B1 and B2 against their plain versions."""
    b, n_heads, n_kv, dh, page, max_len = 8, 32, 8, 128, 16, 2048
    rng = np.random.default_rng(SEED)
    last = np.array([0, 17, 300, 555, 1023, 1500, 1900, 2047], np.int32)
    n_live = last // page + 1
    width = 1
    while width < n_live.max():  # the engine's live-width slice
        width *= 2
    width = min(width, max_len // page)
    n_pages = 1 + b * (max_len // page)
    tables = np.zeros((b, width), np.int32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    used = 0
    for i, n in enumerate(n_live):
        tables[i, :n] = perm[used:used + n]
        used += n

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t if dtype is None else t.to(dtype)

    bf16 = torch.bfloat16
    shape = (n_pages, page, n_kv, dh)
    k_pool = put(rng.standard_normal(shape, np.float32), bf16)
    v_pool = put(rng.standard_normal(shape, np.float32), bf16)
    k_pool[0] = put(1e3 * rng.standard_normal(shape[1:], np.float32), bf16)
    v_pool[0] = put(1e3 * rng.standard_normal(shape[1:], np.float32), bf16)
    tab = put(tables)
    sm = 1.0 / float(np.sqrt(dh))
    kv_token_bytes = n_kv * dh * 2 * 2  # K and V rows, bf16

    # gathered logical K/V for the library yardstick (not timed)
    length = width * page
    kl = k_pool[tab.long()].reshape(b, length, n_kv, dh).transpose(1, 2)
    vl = v_pool[tab.long()].reshape(b, length, n_kv, dh).transpose(1, 2)
    k_pos = torch.arange(length, device=dev)

    results = {}
    # --- B1: one query token per slot
    q = put(rng.standard_normal((b, n_heads, dh), np.float32), bf16)
    pos = put(last)
    out = pa.paged_decode_attention(q, k_pool, v_pool, tab, pos, sm)
    ref = pa._paged_attention_reference(q.float(), k_pool.float(),
                                        v_pool.float(), tab, pos, sm)
    err1 = (out.float() - ref).abs().max().item()
    win1 = pa.paged_window_attention(q[:, None], k_pool, v_pool, tab,
                                     pos[:, None], sm)[:, 0]
    torch.cuda.synchronize()
    window_of_one_identical = bool(torch.equal(win1, out))
    mask1 = (k_pos[None, :] <= pos[:, None].long())[:, None, None, :]
    keys = (last.astype(np.int64) + 1)
    n_bytes = int(keys.sum()) * kv_token_bytes + 2 * q.numel() * 2
    flops = 4 * n_heads * dh * int(keys.sum())
    bnd, by = bound_ms(n_bytes, flops, "bfloat16")
    results["paged_decode_attention"] = dict(
        max_abs_err=err1, tol=bf16_tol(ref),
        ms=time_ms(torch, lambda: pa.paged_decode_attention(
            q, k_pool, v_pool, tab, pos, sm)),
        plain_ms=time_ms(torch, lambda: pa._paged_attention_reference(
            q, k_pool, v_pool, tab, pos, sm)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kl, vl, attn_mask=mask1, scale=sm,
            enable_gqa=True)),
        bound_ms=bnd, bound_by=by, bytes=n_bytes, flops=flops,
        shapes=f"q ({b}, {n_heads}, {dh}) bf16; pool {shape} bf16; "
               f"table ({b}, {width}); positions {last.tolist()}")

    # --- B2: a 32-token window per slot: 31 real tokens ending at the
    # slot's position, then one overhang row repeating the last
    c = 32
    wpos = np.maximum(0, last[:, None] - np.arange(c - 2, -1, -1)[None, :])
    wpos = np.concatenate([wpos, wpos[:, -1:]], axis=1).astype(np.int32)
    qw = put(rng.standard_normal((b, c, n_heads, dh), np.float32), bf16)
    wp = put(wpos)
    outw = pa.paged_window_attention(qw, k_pool, v_pool, tab, wp, sm)
    refw = pa._paged_window_reference(qw.float(), k_pool.float(),
                                      v_pool.float(), tab, wp, sm)
    err2 = (outw.float() - refw).abs().max().item()
    mask2 = (k_pos[None, None, :] <= wp[:, :, None].long())[:, None]
    keys = wpos[:, -1].astype(np.int64) + 1  # the tile's page horizon
    n_bytes = int(keys.sum()) * kv_token_bytes + 2 * qw.numel() * 2
    flops = 4 * n_heads * dh * int((wpos.astype(np.int64) + 1).sum())
    bnd, by = bound_ms(n_bytes, flops, "bfloat16")
    results["paged_window_attention"] = dict(
        max_abs_err=err2, tol=bf16_tol(refw),
        ms=time_ms(torch, lambda: pa.paged_window_attention(
            qw, k_pool, v_pool, tab, wp, sm)),
        plain_ms=time_ms(torch, lambda: pa._paged_window_reference(
            qw, k_pool, v_pool, tab, wp, sm)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qw.transpose(1, 2), kl, vl, attn_mask=mask2, scale=sm,
            enable_gqa=True)),
        bound_ms=bnd, bound_by=by, bytes=n_bytes, flops=flops,
        shapes=f"q ({b}, {c}, {n_heads}, {dh}) bf16; pool {shape} bf16; "
               f"table ({b}, {width}); window ends {last.tolist()}")
    emit({"phase": "kernels",
          "window_of_one_identical": window_of_one_identical, **results})
    for name, r in results.items():
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{name} disagrees with its plain version:"
                                 f" {r['max_abs_err']} > {r['tol']}")
    if not window_of_one_identical:
        raise AssertionError("a window of one is not bit-identical to the "
                             "decode kernel")
    return results


def randomize_lora_b(model, gen):
    """Nonzero adapters, so the LoRA path does real work."""
    for name, p in model.named_parameters():
        if name.endswith("lora_b"):
            p.normal_(0.0, 0.02, generator=gen)


def exactness_phase(torch, np, ll, de, dev):
    """Phase 3: paged engine (kernels) vs greedy_generate (contiguous),
    full width, depth 2, f32: token-identical."""
    max_len, page, max_new = 128, 16, 16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = ll.Llama(vocab_size=128256, max_len=max_len, depth=2,
                     lora_rank=16, rope_theta=500000.0, device=dev,
                     generator=gen)
    randomize_lora_b(model, gen)
    rng = np.random.default_rng(SEED + 1)
    lens = np.array([40, 75, 20, 100], np.int32)
    ids = np.zeros((4, int(lens.max())), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(2, 128256, size=n)
    want = ll.greedy_generate(model, ids, lens, max_new).cpu().numpy()
    eng = de.DecodeEngine(model.with_kv_layout(page, 1 + 4 * max_len // page),
                          max_slots=4, max_len=max_len, steps_per_sync=4,
                          prefill_chunk=32, device=dev)
    for i, n in enumerate(lens):
        eng.submit(i, ids[i, :n], max_new)
    got = {}
    for _ in range(1000):
        eng.step()
        got.update(dict(eng.poll()))
        if len(got) == len(lens):
            break
    mismatches = []
    for i in range(len(lens)):
        row = np.asarray(got.get(i, []))
        if len(row) == max_new and np.array_equal(row, want[i]):
            continue
        j = next((j for j in range(max_new)
                  if j >= len(row) or row[j] != want[i, j]), 0)
        seq = np.concatenate([ids[i, :lens[i]], want[i, :j]])
        logits = model(torch.from_numpy(seq[None]).long().to(dev),
                       cache=model.init_cache(1))[0, -1].float()
        top2 = torch.topk(logits, 2).values
        mismatches.append({"request": i, "step": int(j),
                           "top2_gap": float(top2[0] - top2[1])})
    emit({"phase": "f32_exactness", "requests": len(lens),
          "max_new": max_new, "token_identical": not mismatches,
          "mismatches": mismatches, "engine": eng.stats_snapshot()})
    if mismatches:
        raise AssertionError(f"paged engine diverged from greedy_generate: "
                             f"{mismatches}")
    del eng, model


def serving_phase(torch, np, ll, de, pa, HashTokenizer, depth, dev):
    """Phase 4, the main path: Llama-3-8B widths behind the engines."""
    vocab, max_len, page, slots, max_new = 128256, 2048, 16, 8, 64
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = ll.Llama(vocab_size=vocab, max_len=max_len, depth=depth,
                     lora_rank=16, dtype=torch.bfloat16,
                     rope_theta=500000.0, kv_page_size=page,
                     kv_pages=1 + slots * (max_len // page), device=dev,
                     generator=gen)
    randomize_lora_b(model, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = HashTokenizer(vocab)

    def encode(text):
        row, n = tok.encode(str(text), max_len)
        return np.asarray(row[:max(1, int(n))], np.int32)

    def detok(ids):
        return " ".join(f"<{int(t)}>" for t in ids)

    core = de.DecodeEngine(model, max_slots=slots, max_len=max_len,
                           steps_per_sync=4, prefill_chunk=32, device=dev)
    eng = de.TextDecodeEngine(core, encode, detok, max_new=max_new)
    rng = np.random.default_rng(SEED + 2)
    plens = rng.integers(64, 1025, size=slots)
    texts = [" ".join(f"w{int(w)}" for w in rng.integers(0, 10**6,
                                                         size=n - 1))
             for n in plens]  # n - 1 words + the leading CLS = n tokens

    pa.paged_decode_attention.launches = 0
    pa.paged_window_attention.launches = 0
    t_submit, t_first, done = {}, {}, {}
    decode_s = decode_tokens = prefill_s = 0.0
    n_steps = 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    while len(done) < slots:
        if n_steps < slots:  # one arrival per step: mid-flight admission
            eng.submit(n_steps, texts[n_steps])
            t_submit[n_steps] = time.perf_counter()
        before = core.stats_snapshot()
        s0 = time.perf_counter()
        eng.step()
        s1 = time.perf_counter()
        after = core.stats_snapshot()
        if after["prefill_calls"] == before["prefill_calls"]:
            decode_s += s1 - s0
            decode_tokens += (after["tokens_generated"]
                              - before["tokens_generated"])
        else:
            prefill_s += s1 - s0
        for rid, _delta in eng.poll_partial():
            t_first.setdefault(rid, s1)
        for rid, text in eng.poll():
            done[rid] = text
            t_first.setdefault(rid, s1)
        n_steps += 1
        if n_steps > 10000:
            raise AssertionError(f"serving did not drain: {core.stats}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {"paged_decode_attention": pa.paged_decode_attention.launches,
                "paged_window_attention": pa.paged_window_attention.launches}
    stats = core.stats_snapshot()
    n_tokens = {rid: len(text.split()) for rid, text in done.items()}
    ids_ok = all(0 <= int(t[1:-1]) < vocab
                 for text in done.values() for t in text.split())
    emit({"phase": "serving", "model": "Llama-3-8B widths", "depth": depth,
          "dtype": "bfloat16", "init_s": init_s, "requests": slots,
          "prompt_tokens": [int(n) for n in plens], "max_new": max_new,
          "engine_calls": n_steps, "wall_s": wall,
          "calls_with_prefill_s": prefill_s, "decode_only_calls_s": decode_s,
          "output_tok_per_s": stats["tokens_generated"] / wall,
          "decode_tok_per_s": (decode_tokens / decode_s if decode_s
                               else None),
          "mean_ttft_s": float(np.mean([t_first[r] - t_submit[r]
                                        for r in t_submit])),
          "launches": launches, "peak_mem_gb":
              torch.cuda.max_memory_allocated() / 1e9, "engine": stats})
    if sorted(done) != list(range(slots)) or any(
            n != max_new for n in n_tokens.values()) or not ids_ok:
        raise AssertionError(f"bad completions: {n_tokens}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if stats["kv_pages_used"] != 0:
        raise AssertionError(f"pages leaked: {stats['kv_pages_used']}")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=32,
                    help="decoder depth of the serving leg (widths are "
                         "never cut)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "rafiki_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(rafiki_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    from rafiki_tpu_torch.models import llama_lora as ll
    from rafiki_tpu_torch.models.bert import HashTokenizer
    from rafiki_tpu_torch.ops import _build
    from rafiki_tpu_torch.ops import paged_attention as pa
    from rafiki_tpu_torch.serving import decode_engine as de

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources, build_s, ptxas = build_kernels(_build)
    emit({"phase": "build", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sources": sources,
          "build_s": build_s, "ptxas": ptxas})

    dev = torch.device("cuda")
    kres = kernel_phase(torch, np, F, pa, dev)
    exactness_phase(torch, np, ll, de, dev)
    torch.cuda.empty_cache()
    launches = serving_phase(torch, np, ll, de, pa, HashTokenizer,
                             args.depth, dev)

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "tol": r["tol"], "ms": r["ms"],
         "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "card": smi}
        for name, r in kres.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
