#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

Run from a checkout of the repository, with one Hopper card (sm_90a) and
the CUDA toolkit's ``nvcc``::

    python3 chip_smoke.py            # the full check, Llama-3-8B depth 32
    python3 chip_smoke.py --depth 8  # the Llama serving leg at a cut depth
    python3 chip_smoke.py --train-depth 8  # the Llama training leg, cut

ViT-B/16 and BERT-base always run at full width and depth.

Phases; each raises on failure, so the script exits non-zero:

1. Device and build: the card's name and power limit, TF32 off, every
   ``rafiki_tpu_torch/csrc/*.cu`` built with ``nvcc`` (in parallel, timed,
   with ptxas's register/shared-memory report parsed per kernel: phases
   5, 9 and 10 print B3's, B4's, B5's, B6's and B7's).
2. B1/B2 against their plain versions at Llama-3-8B attention shapes
   (8 slots, 32 query / 8 kv heads, head dim 128, page 16, bf16 pools,
   max_len 2048): each element within 1e-3 + 2^-8·|plain| of the plain
   version run in f32, a window of one and a second call bit-identical,
   the split plan (splits, blocks), kernel / plain / library times, the
   least time the card could take, the rate (GB/s) and share of it. Then
   the same for their int8 instances (``paged_attention_int8.cu``) over
   the pools quantized row by row (int8 rows, one f32 scale each): bf16
   queries held to the bf16 tolerance and timed beside SDPA on the K/V
   gathered and dequantized to bf16, f32 queries to 1e-5 + 1e-5·|plain|,
   a second call bit-identical, and ptxas's registers and spills of the
   int8 bodies (those at d 64 and 128 must not spill).
3. f32 exactness: the full-width Llama at depth 2 in f32 (random weights
   from a seed, nonzero LoRA) behind a paged ``DecodeEngine`` must emit
   exactly the tokens of ``greedy_generate`` over a contiguous cache.
4. Serving, the main path: Llama-3-8B (bf16, depth 32 unless cut, rope
   theta 500000, LoRA rank 16, random weights) behind ``DecodeEngine`` +
   ``TextDecodeEngine`` with a paged pool; 8 text requests of 64..1024
   prompt tokens, 64 new tokens each, submitted over the first steps.
   The kernels' launch counters are zeroed just before and read just
   after; both kernels must have launched. One decode-only engine call
   runs under ``torch.profiler``: its device busy share and top kernels.
   Phase 16 runs right after it, once phase 4's model is freed.

5. Flash kernels against their plain versions at Llama-3-8B attention
   shapes (b 4, 32 heads with K/V repeated from 8, s 1024, head dim 128,
   bf16, causal, kv_lens 1024/700/1/0): the errors of out, lse, dq, dk
   and dv against the plain versions run in f32, kernel / plain /
   library times, the least time; B3's, B5's and B6's plans (tensor-core
   or FMA body, padded head dim, copy width, stages), ptxas registers
   and spills (the bf16 B5/B6 at d 64 and 128 must not spill) and a
   second call bit-identical; B5 and B6 again on full-length rows beside
   SDPA's backward with ``is_causal=True`` (the second yardstick); plus
   an f32 case at head dim 16.
6. f32 training exactness: the full-width Llama at depth 2 in f32
   (nonzero LoRA) takes 4 functional train steps through the kernels,
   then the same 4 steps from the same weights with the attention bound
   to the plain version: per-step losses within 1e-4 relative.
7. Training, the main path of the training slice: Llama-3-8B (bf16
   compute, f32 trainable leaves, depth 32 unless ``--train-depth`` cuts
   it, LoRA rank 16) takes 4 steps on one 4 x 1024-token batch. The
   flash kernels' counters are zeroed just before and read just after:
   each must have launched depth x steps times; the loss must fall.
8. The ``LlamaLoRA`` template end to end at its largest knobs: train on
   a seeded ``.jsonl`` corpus, evaluate, dump, reload, evaluate, predict.
9. B7 (``matmul_bias``) against its plain version at ViT-B/16's serving
   shape, (64·196, 768) x (768, 768) + (768,), bf16 and f32; kernel /
   plain / ``torch.addmm`` times and the least time; the plan (body,
   tile, copy width, blocks), ptxas registers, a second call
   bit-identical.
10. The flash kernels on the classifier paths: B3/B5/B6 non-causal at
    ViT-B/16's shape (b 64, 12 heads, s 197, d 64, bf16) with times, and
    with BERT's padded keys (s 128), B5/B6 timed there beside SDPA's
    masked backward; B4 at block_h 4 on the ViT shape
    against its plain version and bit for bit against B3, a second call
    bit-identical, its time beside B3's in the same (no-LSE) call, both
    plans and ptxas registers; B3/B5/B6 at
    every compiled head dim (8 .. 192) on a small ragged shape, f32 and
    bf16, causal and not.
11. f32 exactness of a small ViT (head dim 96) and a small BERT (head dim
    24) through the kernels against the plain attention and plain
    ``matmul_bias``: logits and 4 AdamW steps' losses within 1e-5
    relative.
12. ViT-B/16 serving (bf16, random weights from a seed, 1000 classes):
    ``ViTBase16.predict`` over 256 seeded 224 x 224 x 3 images (4 buckets
    of 64; B7 = 4 and B3 = 48 launches), the p50 latency of a 1-image
    predict, then the same with the ``block_h`` default at 4 (B4 = 48, B3
    = 0, the same probabilities), then dump → reload → predict.
13. ViT-B/16 training: ``ViTBase16.train`` on a seeded 512-image npz,
    batch 64, one epoch of 8 steps (B7 = 8; B3, B5, B6 = 96); step time,
    images/s, peak memory, one profiled step's device-time split; the
    loss must fall; dump → reload → predict.
14. BERT-base (vocab 32768, ``max_len`` 128, bf16): ``BertClassifier``
    trains 8 steps at batch 64 on a seeded corpus (B3, B5, B6 = 96), then
    predicts 256 texts (B3 = 48); the loss must fall; dump → reload →
    predict.
15. Paged serving at the smallest head dim: a head-dim-8 Llama (hidden
    32, 4 heads, 2 kv heads, ``max_len`` 32, f32, random weights from a
    seed) behind ``DecodeEngine`` at pages 8 and 4 on the card must emit
    exactly the tokens of the same model and requests on the CPU; B1 and
    B2 must launch.
16. int8 serving (``quantize_int8`` + ``kv_cache_int8``): phase 4's model
    and request mix with int8 base kernels (per-channel f32 scales) and an
    int8 KV pool (one f32 scale per row); every request must complete and
    both int8 kernels launch. Reports decode tokens/s, TTFT, the weight
    and pool bytes beside a bf16 deployment's, and the device time of the
    per-forward int8 -> bf16 weight converts.
17. Phase 15's model and requests with int8 base kernels and an int8 KV
    pool, f32 queries through the int8 kernels: token-identical to the
    CPU at pages 8 and 4.

Each path's launch counts are zeroed just before it and read just after;
the ``kernels`` line gives each kernel's sum over the paths and the
per-path counts. The last lines are the ``kernels`` JSON line and then the device line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing a result.
"""

import argparse
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
VOCAB = 128256  # Llama-3-8B's vocabulary
#: H100 SXM, published peaks (dense): memory rate and bf16 / f32 rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SOURCES = {
    "paged_decode_attention": "rafiki_tpu_torch/csrc/paged_attention.cu",
    "paged_window_attention": "rafiki_tpu_torch/csrc/paged_attention.cu",
    "paged_decode_attention_int8":
        "rafiki_tpu_torch/csrc/paged_attention_int8.cu",
    "paged_window_attention_int8":
        "rafiki_tpu_torch/csrc/paged_attention_int8.cu",
    "flash_attention_fwd": "rafiki_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_fwd_mh": "rafiki_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq": "rafiki_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkv": "rafiki_tpu_torch/csrc/flash_attention.cu",
    "matmul_bias": "rafiki_tpu_torch/csrc/patch_embed.cu",
}
REPLACES = {
    "paged_decode_attention": "rafiki_tpu/ops/paged_attention.py:177",
    "paged_window_attention": "rafiki_tpu/ops/paged_attention.py:337",
    # the quantized=True branch of the same Pallas kernels
    "paged_decode_attention_int8": "rafiki_tpu/ops/paged_attention.py:177",
    "paged_window_attention_int8": "rafiki_tpu/ops/paged_attention.py:337",
    "flash_attention_fwd": "rafiki_tpu/ops/attention.py:98",
    "flash_attention_fwd_mh": "rafiki_tpu/ops/attention.py:156",
    "flash_attention_bwd_dq": "rafiki_tpu/ops/attention.py:222",
    "flash_attention_bwd_dkv": "rafiki_tpu/ops/attention.py:275",
    "matmul_bias": "rafiki_tpu/ops/patch_embed.py:19",
}
FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv")


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_kernels(build):
    """One nvcc per source, all started together; returns the sources,
    the wall time and ptxas's per-kernel resources
    (:func:`ptxas_resources`)."""
    sources = sorted(build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        logs = list(pool.map(
            lambda s: build.build(s.stem, extra_flags=("-Xptxas", "-v")),
            sources))
    seconds = time.perf_counter() - t0
    return [s.name for s in sources], seconds, ptxas_resources(
        "\n".join(logs))


def ptxas_resources(log):
    """``-Xptxas -v``'s report, per compiled kernel: its mangled name,
    registers per thread, spill stores and loads (bytes) and static
    shared memory (bytes; a kernel's dynamic shared memory is its plan's,
    set at launch)."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"mangled": ln.split("'")[1], "registers": None,
                   "spill_bytes": None, "static_smem": 0}
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            cur["spill_bytes"] = nums[1] + nums[2]  # stores + loads
        elif cur is not None and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            cur["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                cur["static_smem"] = int(words[words.index("smem") - 2])
    return out


def kernel_resources(ptxas, mangled_part):
    """The ptxas entries whose mangled name contains ``mangled_part``
    (e.g. ``16flash_fwd_kernelI13__nv_bfloat16Li64E``: the B3 bf16 body at
    d = 64)."""
    return [{k: v for k, v in e.items() if k != "mangled"}
            for e in ptxas if mangled_part in e["mangled"]]


#: the mangled-name parts of the kernels phases 2, 5, 9 and 10 report
#: (int8_t is ``signed char``, mangled ``a``; ``q`` is ``f`` or the bf16)
PAGED_INT8 = "19paged_{kind}_kernelI{q}aLi{d}E"
B3_BF16 = "16flash_fwd_kernelI13__nv_bfloat16Li{d}E"
B4_BF16 = "19flash_fwd_mh_kernelI13__nv_bfloat16Li{d}E"
B5_BF16 = "23flash_bwd_dq_mma_kernelILi{d}E"
B6_BF16 = "24flash_bwd_dkv_mma_kernelILi{d}E"
B7_MMA = "22matmul_bias_mma_kernelILb1EE"


#: clock cycles (~1 ms on an H100) the card spins before each timed call:
#: longer than the host takes to enqueue the call, so the timing events
#: bracket device work only, not the card waiting on the host
SPIN_CYCLES = 2_000_000


def time_ms(torch, fn, iters=10):
    """Median device time of one call, each launch timed by its own CUDA
    events with a 64 MB write in between, so every call finds the L2
    cache (50 MB) cold, as a layer's call does in a decode step. A spin
    kernel keeps the card busy while the host enqueues the call: without
    it a call shorter than its own host enqueue (a few tens of us of
    Python and launch overhead) would be timed with the card idle."""
    fn()
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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


def int8_resources(ptxas, dims=(64, 128)):
    """ptxas's registers and spills of the int8 instances of B1 and B2 at
    head dims ``dims``, both query types, both key-group counts."""
    out = {}
    for d in dims:
        for qname, qm in (("bf16", "13__nv_bfloat16"), ("f32", "f")):
            for kind in ("decode", "window"):
                out[f"{kind} {qname} d{d}"] = kernel_resources(
                    ptxas, PAGED_INT8.format(kind=kind, q=qm, d=d))
    return out


def kernel_phase(torch, np, F, pa, ll, dev, ptxas=()):
    """Phase 2: B1 and B2 against their plain versions, each element
    within its own tolerance (``FLASH_TOL``), a window of one and a second
    call bit-identical to the first, and each launch's split plan, rate
    and share of its bound; then the same for their int8 instances, on
    the pools quantized row by row (bf16 queries, timed, beside SDPA on
    the K/V gathered and dequantized to bf16; and f32 queries, held to
    the f32 tolerance), with ptxas's registers and spills of the int8
    bodies (those at d 64 and 128 must not spill)."""
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
    floor, rel = FLASH_TOL["bfloat16"]

    # gathered logical K/V for the library yardstick (not timed)
    length = width * page
    kl = k_pool[tab.long()].reshape(b, length, n_kv, dh).transpose(1, 2)
    vl = v_pool[tab.long()].reshape(b, length, n_kv, dh).transpose(1, 2)
    k_pos = torch.arange(length, device=dev)

    def measure(kernel, plain, library, ref, got, n_bytes, flops, plan):
        again = kernel()
        torch.cuda.synchronize()
        err, over = elementwise_err(got, ref, floor, rel)
        bnd, by = bound_ms(n_bytes, flops, "bfloat16")
        ms = time_ms(torch, kernel)
        # one warm call under the profiler: the split kernel's and the
        # merge's device time
        split = _profile_call(torch, kernel).get("kernels_ms", {})
        return dict(
            profiled_warm_us={k: v * 1e3 for k, v in split.items() if v},
            max_abs_err=err, err_over_tol=over,
            tol="per element: 1e-3 + 2^-8 * |plain|",
            bit_identical_second_call=bool(torch.equal(again, got)),
            ms=ms, plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, library),
            library_covers="SDPA on K/V gathered beforehand (the gather "
                           "not timed), with the same mask",
            bound_ms=bnd, bound_by=by, bound_share=bnd / ms,
            gb_per_s=n_bytes / (ms * 1e-3) / 1e9, bytes=n_bytes,
            flops=flops, plan=plan._asdict())

    results = {}
    # --- B1: one query token per slot
    q = put(rng.standard_normal((b, n_heads, dh), np.float32), bf16)
    pos = put(last)
    out = pa.paged_decode_attention(q, k_pool, v_pool, tab, pos, sm)
    ref = pa._paged_attention_reference(q.float(), k_pool.float(),
                                        v_pool.float(), tab, pos, sm)
    win1 = pa.paged_window_attention(q[:, None], k_pool, v_pool, tab,
                                     pos[:, None], sm)[:, 0]
    torch.cuda.synchronize()
    window_of_one_identical = bool(torch.equal(win1, out))
    mask1 = (k_pos[None, :] <= pos[:, None].long())[:, None, None, :]
    keys = (last.astype(np.int64) + 1)
    n_bytes = int(keys.sum()) * kv_token_bytes + 2 * q.numel() * 2
    flops = 4 * n_heads * dh * int(keys.sum())
    results["paged_decode_attention"] = measure(
        lambda: pa.paged_decode_attention(q, k_pool, v_pool, tab, pos, sm),
        lambda: pa._paged_attention_reference(q, k_pool, v_pool, tab, pos,
                                              sm),
        lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kl, vl, attn_mask=mask1, scale=sm,
            enable_gqa=True),
        ref, out, n_bytes, flops,
        pa._launch_plan(b, 1, n_heads, n_kv, width, page, bf16, dh))
    results["paged_decode_attention"]["shapes"] = (
        f"q ({b}, {n_heads}, {dh}) bf16; pool {shape} bf16; table ({b}, "
        f"{width}); positions {last.tolist()}")

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
    mask2 = (k_pos[None, None, :] <= wp[:, :, None].long())[:, None]
    keys = wpos[:, -1].astype(np.int64) + 1  # the tile's page horizon
    n_bytes = int(keys.sum()) * kv_token_bytes + 2 * qw.numel() * 2
    flops = 4 * n_heads * dh * int((wpos.astype(np.int64) + 1).sum())
    results["paged_window_attention"] = measure(
        lambda: pa.paged_window_attention(qw, k_pool, v_pool, tab, wp, sm),
        lambda: pa._paged_window_reference(qw, k_pool, v_pool, tab, wp, sm),
        lambda: F.scaled_dot_product_attention(
            qw.transpose(1, 2), kl, vl, attn_mask=mask2, scale=sm,
            enable_gqa=True),
        refw, outw, n_bytes, flops,
        pa._launch_plan(b, c, n_heads, n_kv, width, page, bf16, dh))
    results["paged_window_attention"]["shapes"] = (
        f"q ({b}, {c}, {n_heads}, {dh}) bf16; pool {shape} bf16; table "
        f"({b}, {width}); window ends {last.tolist()}")
    # --- the int8 instances: the same shapes over the pools quantized
    # row by row as the model's cache write does (scratch page 0's 1e3
    # garbage included), 264 bytes a token and kv head (two 128-byte
    # rows, two f32 scales)
    kq, ks = ll._quantize_int8(k_pool, -1)
    vq, vs = ll._quantize_int8(v_pool, -1)
    kl8 = (kq[tab.long()].float() * ks[tab.long()][..., None]).to(bf16) \
        .reshape(b, length, n_kv, dh).transpose(1, 2)
    vl8 = (vq[tab.long()].float() * vs[tab.long()][..., None]).to(bf16) \
        .reshape(b, length, n_kv, dh).transpose(1, 2)
    kv_token_bytes = n_kv * (2 * dh + 2 * 4)
    i8 = (kq, vq, tab)
    win1_8 = pa.paged_window_attention(q[:, None], kq, vq, tab, pos[:, None],
                                       sm, ks, vs)[:, 0]
    out8 = pa.paged_decode_attention(q, *i8, pos, sm, ks, vs)
    ref8 = pa._paged_attention_reference(q.float(), *i8, pos, sm, ks, vs)
    torch.cuda.synchronize()
    window_of_one_identical_int8 = bool(torch.equal(win1_8, out8))
    keys = (last.astype(np.int64) + 1)
    n_bytes = int(keys.sum()) * kv_token_bytes + 2 * q.numel() * 2
    flops = 4 * n_heads * dh * int(keys.sum())
    results["paged_decode_attention_int8"] = measure(
        lambda: pa.paged_decode_attention(q, *i8, pos, sm, ks, vs),
        lambda: pa._paged_attention_reference(q, *i8, pos, sm, ks, vs),
        lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kl8, vl8, attn_mask=mask1, scale=sm,
            enable_gqa=True),
        ref8, out8, n_bytes, flops,
        pa._launch_plan(b, 1, n_heads, n_kv, width, page, bf16, dh))
    outw8 = pa.paged_window_attention(qw, *i8, wp, sm, ks, vs)
    refw8 = pa._paged_window_reference(qw.float(), *i8, wp, sm, ks, vs)
    keys = wpos[:, -1].astype(np.int64) + 1
    n_bytes = int(keys.sum()) * kv_token_bytes + 2 * qw.numel() * 2
    flops = 4 * n_heads * dh * int((wpos.astype(np.int64) + 1).sum())
    results["paged_window_attention_int8"] = measure(
        lambda: pa.paged_window_attention(qw, *i8, wp, sm, ks, vs),
        lambda: pa._paged_window_reference(qw, *i8, wp, sm, ks, vs),
        lambda: F.scaled_dot_product_attention(
            qw.transpose(1, 2), kl8, vl8, attn_mask=mask2, scale=sm,
            enable_gqa=True),
        refw8, outw8, n_bytes, flops,
        pa._launch_plan(b, c, n_heads, n_kv, width, page, bf16, dh))
    lib_covers = ("SDPA on K/V gathered and dequantized to bf16 beforehand "
                  "(gather and dequantization not timed), with the same "
                  "mask")
    resources = int8_resources(ptxas)
    for name, kind in (("paged_decode_attention_int8", "decode"),
                       ("paged_window_attention_int8", "window")):
        r = results[name]
        r["library_covers"] = lib_covers
        r["ptxas"] = {k: v for k, v in resources.items()
                      if k.startswith(kind)}
        r["shapes"] = results[name[:-5]]["shapes"].replace(
            "bf16; table", "int8 + f32 scales (n_pages, page, n_kv); table")
    # f32 queries over the same int8 pools: the exactness legs' body
    q32, qw32 = q.float(), qw.float()
    f32_floor, f32_rel = FLASH_TOL["float32"]
    f32_int8 = {}
    for name, kernel, plain in (
            ("paged_decode_attention_int8",
             lambda: pa.paged_decode_attention(q32, *i8, pos, sm, ks, vs),
             lambda: pa._paged_attention_reference(q32, *i8, pos, sm, ks,
                                                   vs)),
            ("paged_window_attention_int8",
             lambda: pa.paged_window_attention(qw32, *i8, wp, sm, ks, vs),
             lambda: pa._paged_window_reference(qw32, *i8, wp, sm, ks,
                                                vs))):
        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err, over = elementwise_err(got, ref, f32_floor, f32_rel)
        f32_int8[name] = {"max_abs_err": err, "err_over_tol": over,
                          "tol": "per element: 1e-5 + 1e-5 * |plain|",
                          "bit_identical_second_call":
                              bool(torch.equal(got, again)),
                          "ms": time_ms(torch, kernel)}
        results[name]["f32_queries"] = f32_int8[name]
    emit({"phase": "kernels",
          "window_of_one_identical": window_of_one_identical,
          "window_of_one_identical_int8": window_of_one_identical_int8,
          **results})
    for name, r in list(results.items()) + [
            (f"{n} (f32 queries)", r) for n, r in f32_int8.items()]:
        if not r["err_over_tol"] <= 1.0:
            raise AssertionError(
                f"{name} disagrees with its plain version: max abs error "
                f"{r['max_abs_err']}, {r['err_over_tol']} x its element's "
                f"tolerance")
        if not r["bit_identical_second_call"]:
            raise AssertionError(f"{name}: a second call on the same inputs "
                                 f"gave other bits")
    if not (window_of_one_identical and window_of_one_identical_int8):
        raise AssertionError("a window of one is not bit-identical to the "
                             "decode kernel")
    spills = {k: e["spill_bytes"] for k, es in resources.items() for e in es
              if e["spill_bytes"]}
    if spills or not all(resources.values()):
        raise AssertionError(f"the int8 B1/B2 bodies at d 64/128 spill or "
                             f"were not reported: {spills or resources}")
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


def int8_bytes(model, cache):
    """The int8 deployment's device bytes beside a bf16 one's of the same
    widths: the weights (int8 base kernels and their f32 scales, against
    bf16 kernels; embedding, norms and adapters as they are) and the KV
    pool (int8 rows and f32 scales, against bf16 rows)."""
    weights = bf16_weights = 0
    for name, p in model.named_parameters():
        n = p.numel() * p.element_size()
        weights += n
        leaf = name.rsplit(".", 1)[-1]
        bf16_weights += (p.numel() * 2 if leaf == "qkernel"
                         else 0 if leaf == "qscale" else n)
    pool = sum(t.numel() * t.element_size() for c in cache
               for t in c.values())
    bf16_pool = sum(c[k].numel() * 2 for c in cache for k in ("k", "v"))
    return {"weight_bytes": weights, "bf16_weight_bytes": bf16_weights,
            "weight_share_of_bf16": weights / bf16_weights,
            "pool_bytes": pool, "bf16_pool_bytes": bf16_pool,
            "pool_share_of_bf16": pool / bf16_pool}


def serving_phase(torch, np, ll, de, pa, HashTokenizer, depth, dev,
                  int8=False):
    """Phase 4, the main path: Llama-3-8B widths behind the engines; with
    ``int8``, phase 16: the same with int8 base kernels and an int8 KV
    pool (``quantize_int8`` + ``kv_cache_int8``), whose launches count as
    the int8 kernels'."""
    vocab, max_len, page, slots, max_new = 128256, 2048, 16, 8, 64
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ll.Llama(vocab_size=vocab, max_len=max_len, depth=depth,
                     lora_rank=16, dtype=torch.bfloat16,
                     rope_theta=500000.0, kv_page_size=page,
                     kv_pages=1 + slots * (max_len // page), device=dev,
                     generator=gen, quantized=int8, kv_int8=int8)
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
    profiled, last_decode_only = None, False
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    while len(done) < slots:
        if n_steps < slots:  # one arrival per step: mid-flight admission
            eng.submit(n_steps, texts[n_steps])
            t_submit[n_steps] = time.perf_counter()
        # one decode-only call (every request past its first token) under
        # the profiler; the profiler lengthens it, so it stays out of the
        # decode totals
        profile_now = (profiled is None and n_steps >= slots
                       and last_decode_only and len(t_first) == slots)
        before = core.stats_snapshot()
        s0 = time.perf_counter()
        if profile_now:
            profiled = _profile_call(torch, eng.step)
        else:
            eng.step()
        s1 = time.perf_counter()
        after = core.stats_snapshot()
        last_decode_only = after["prefill_calls"] == before["prefill_calls"]
        if profile_now:
            profiled.update(decode_only=last_decode_only, call_s=s1 - s0,
                            tokens=(after["tokens_generated"]
                                    - before["tokens_generated"]))
        elif last_decode_only:
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
    # the profiled call (the profiler's start and trace processing
    # included) is left out of the wall time and of its tokens
    wall = time.perf_counter() - t_start - (profiled or {}).get("call_s", 0)
    suffix = "_int8" if int8 else ""
    launches = {
        "paged_decode_attention" + suffix:
            pa.paged_decode_attention.launches,
        "paged_window_attention" + suffix:
            pa.paged_window_attention.launches}
    stats = core.stats_snapshot()
    n_tokens = {rid: len(text.split()) for rid, text in done.items()}
    ids_ok = all(0 <= int(t[1:-1]) < vocab
                 for text in done.values() for t in text.split())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    extra = {}
    if int8:
        # what each forward's int8 -> bf16 weight converts cost on the
        # device: every quantized kernel converted once and dropped, as
        # one decode step's forward does; its bound reads each int8
        # kernel once and writes its bf16 copy once
        qkernels = [m.qkernel for m in model.modules()
                    if isinstance(m, ll.LoRADense) and m.quantized]

        def convert_all():
            for k in qkernels:
                k.to(torch.bfloat16)

        n_elems = sum(k.numel() for k in qkernels)
        extra = dict(int8_bytes(model, core._cache),
                     weight_convert_ms_per_forward=time_ms(
                         torch, convert_all, iters=5),
                     weight_convert_bound_ms=bound_ms(
                         3 * n_elems, 0, "bfloat16")[0],
                     quantized_kernels=len(qkernels))
    emit({"phase": "int8_serving" if int8 else "serving",
          "model": "Llama-3-8B widths", "depth": depth,
          "dtype": "bfloat16", "kv_cache": "int8" if int8 else "bfloat16",
          "weights": "int8" if int8 else "bfloat16",
          "init_s": init_s, "requests": slots,
          "prompt_tokens": [int(n) for n in plens], "max_new": max_new,
          "engine_calls": n_steps, "wall_s": wall,
          "calls_with_prefill_s": prefill_s, "decode_only_calls_s": decode_s,
          "output_tok_per_s": (stats["tokens_generated"] - (
              profiled or {}).get("tokens", 0)) / wall,
          "decode_tok_per_s": (decode_tokens / decode_s if decode_s
                               else None),
          "mean_ttft_s": float(np.mean([t_first[r] - t_submit[r]
                                        for r in t_submit])),
          "launches": launches, "peak_mem_gb": peak_gb, "engine": stats,
          **extra})
    if profiled is not None:
        if "device_idle_share" in profiled:
            profiled["device_busy_share"] = 1 - profiled["device_idle_share"]
        emit({"phase": f"{'int8_' if int8 else ''}serving_decode_profile",
              "steps_per_call": core.K, **profiled})
    if sorted(done) != list(range(slots)) or any(
            n != max_new for n in n_tokens.values()) or not ids_ok:
        raise AssertionError(f"bad completions: {n_tokens}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if stats["kv_pages_used"] != 0:
        raise AssertionError(f"pages leaked: {stats['kv_pages_used']}")
    return launches


#: (floor, relative) of the per-element tolerance |kernel - plain(f32)|
#: <= floor + relative * |plain|. bf16: one rounding of the output to bf16
#: (at most 2^-8 of the element's magnitude) plus 1e-3 for the f32 sums
#: taken in another order; f32: those sums alone. Each element is held to
#: its own magnitude: a key that every row sees (the kv_len = 1 example's
#: key 0 sums 1024 rows of dO into dv) must not loosen the check on the
#: softmax-weighted entries, which are two to three orders smaller.
FLASH_TOL = {"bfloat16": (1e-3, 2.0 ** -8), "float32": (1e-5, 1e-5)}

#: max |kernel - plain| of a live row's LSE (f32 out of f32 sums over up
#: to 1024 keys, taken in another order; LSE is about 7..10 here)
LSE_TOL = 1e-4


def elementwise_err(got, ref, floor, rel):
    """(max |got - ref|, max over elements of |got - ref| / (floor +
    rel * |ref|)): the second is at most 1 when every element is within
    its own tolerance."""
    diff = (got.float() - ref).abs()
    return (diff.max().item(),
            (diff / (floor + rel * ref.abs())).max().item())


def visible_pairs(lens, s):
    """(query, key) pairs a causal call computes for one head: row i of
    example b sees keys < min(i + 1, lens[b])."""
    return sum(sum(min(i + 1, int(n)) for i in range(s)) for n in lens)


def flash_case(torch, fa, q, k, v, do, lens, sm, causal=True):
    """Run B3, B5 and B6 once and their plain versions in f32 on the same
    inputs; B5/B6 take the plain forward's lse and delta, so each kernel
    is held alone. Returns, per output, (max abs error, largest error
    over its element's tolerance), whether the rows with no visible key
    are exact, and the plain lse and delta."""
    f32 = [t.float() for t in (q, k, v, do)]
    ref_o, ref_lse = fa._flash_fwd_reference(*f32[:3], lens, sm, causal)
    delta = fa._delta(f32[3], ref_o)
    ref_dq = fa._flash_bwd_dq_reference(*f32, ref_lse, delta, lens, sm,
                                        causal)
    ref_dk, ref_dv = fa._flash_bwd_dkv_reference(*f32, ref_lse, delta,
                                                 lens, sm, causal)
    out, lse = fa.flash_attention_fwd(q, k, v, lens, sm, causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, lens, sm,
                                   causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, lens,
                                        sm, causal)
    torch.cuda.synchronize()
    floor, rel = FLASH_TOL[str(q.dtype).split(".")[-1]]
    live = ref_lse < 1e29
    errs = {name: elementwise_err(got, ref, floor, rel)
            for name, got, ref in (("out", out, ref_o), ("dq", dq, ref_dq),
                                   ("dk", dk, ref_dk), ("dv", dv, ref_dv))}
    lse_err = (lse[live] - ref_lse[live]).abs().max().item()
    errs["lse"] = (lse_err, lse_err / LSE_TOL)
    empty = (lens == 0).nonzero().flatten().tolist()
    masked_exact = all(
        bool(torch.all(lse[i] == fa.LSE_MASKED)) and all(
            bool(torch.all(t[i] == 0)) for t in (out, dq, dk, dv))
        for i in empty)
    return errs, masked_exact, ref_lse, delta


def flash_phase(torch, np, F, fa, dev, shape=(4, 32, 8, 1024, 128),
                ptxas=()):
    """Phase 5: B3, B5 and B6 against their plain versions at Llama-3-8B
    attention shapes (b, heads, kv heads, s, head dim), and an f32 case
    at a template head dim; ``ptxas`` is the build's report."""
    b, h, n_kv, s, d = shape
    lens_np = np.array([s, s * 700 // 1024, 1, 0], np.int32)
    rng = np.random.default_rng(SEED + 5)

    def rand(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(dtype)

    bf16 = torch.bfloat16
    q = rand((b, h, s, d), bf16)
    k = rand((b, n_kv, s, d), bf16).repeat_interleave(h // n_kv, dim=1)
    v = rand((b, n_kv, s, d), bf16).repeat_interleave(h // n_kv, dim=1)
    do = rand((b, h, s, d), bf16)
    lens = torch.from_numpy(lens_np).to(dev)
    sm = 1.0 / math.sqrt(d)
    errs, masked_exact, lse, delta = flash_case(torch, fa, q, k, v, do,
                                                lens, sm)

    # the f32 case at head dim 16 (a template width), ragged s
    lens16 = torch.tensor([300, 123], dtype=torch.int32, device=dev)
    small = [rand((2, 4, 300, 16), torch.float32) for _ in range(4)]
    errs16, masked16, _, _ = flash_case(torch, fa, *small, lens16, 0.25)

    pairs = h * visible_pairs(lens_np, s)
    # bytes the function must move: the keys below kv_len of K and V, the
    # rows of q / dO (and their f32 lse / delta) that see a key (every row
    # of an example with kv_len > 0, none of one with 0), read once; out,
    # lse, dq, dk and dv written in full
    kv_in = h * int(np.minimum(lens_np, s).sum()) * d * 2  # K or V, bf16
    q_rows = h * s * int((lens_np > 0).sum())
    q_in, row_in = q_rows * d * 2, q_rows * 4  # q or dO; lse or delta
    full, rows = b * h * s * d * 2, b * h * s * 4  # outputs
    work = {
        "flash_attention_fwd": (q_in + 2 * kv_in + full + rows,
                                4 * d * pairs),
        "flash_attention_bwd_dq": (2 * q_in + 2 * kv_in + 2 * row_in + full,
                                   6 * d * pairs),
        "flash_attention_bwd_dkv": (2 * q_in + 2 * kv_in + 2 * row_in
                                    + 2 * full, 8 * d * pairs),
    }
    kernel_calls = {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(
            q, k, v, lens, sm, True),
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, lens, sm, True),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, lens, sm, True),
    }
    plain_calls = {
        "flash_attention_fwd": lambda: fa._flash_fwd_reference(
            q, k, v, lens, sm, True),
        "flash_attention_bwd_dq": lambda: fa._flash_bwd_dq_reference(
            q, k, v, do, lse, delta, lens, sm, True),
        "flash_attention_bwd_dkv": lambda: fa._flash_bwd_dkv_reference(
            q, k, v, do, lse, delta, lens, sm, True),
    }
    # the library yardstick: SDPA with the same mask, forward and its
    # autograd backward (dq, dk and dv in one call: B5 + B6)
    mask = fa._visible(s, s, lens, True)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=sm))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                           scale=sm)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, leaves, do, retain_graph=True))
    del o_lib, leaves
    library = {"flash_attention_fwd": lib_fwd,
               "flash_attention_bwd_dq": lib_bwd,
               "flash_attention_bwd_dkv": None}
    # B6's line carries whichever of dk and dv is nearer its tolerance
    worst_kv = max(("dk", "dv"), key=lambda n: errs[n][1])
    checked = {"flash_attention_fwd": errs["out"],
               "flash_attention_bwd_dq": errs["dq"],
               "flash_attention_bwd_dkv": errs[worst_kv]}
    shapes = (f"q/k/v/dO ({b}, {h}, {s}, {d}) bf16 (K/V repeated from "
              f"{n_kv} heads), causal, kv_lens {lens_np.tolist()}")
    results = {}
    for name in FLASH:
        n_bytes, flops = work[name]
        bnd, by = bound_ms(n_bytes, flops, "bfloat16")
        results[name] = dict(
            max_abs_err=checked[name][0],
            tol="per element: 1e-3 + 2^-8 * |plain|",
            err_over_tol=checked[name][1],
            ms=time_ms(torch, kernel_calls[name]),
            plain_ms=time_ms(torch, plain_calls[name]),
            library_ms=library[name], bound_ms=bnd, bound_by=by,
            bytes=n_bytes, flops=flops, visible_pairs=pairs, shapes=shapes)
    results["flash_attention_bwd_dq"]["library_covers"] = \
        "SDPA backward: dq, dk and dv in one call (B5 + B6)"
    # B3's plan and resources at this head dim, and a second call's bits
    first = fa.flash_attention_fwd(q, k, v, lens, sm, True)
    second = fa.flash_attention_fwd(q, k, v, lens, sm, True)
    torch.cuda.synchronize()
    b3_same = all(torch.equal(a, b) for a, b in zip(first, second))
    results["flash_attention_fwd"].update(
        plan=fa._flash_plan(d, q.dtype)._asdict(),
        ptxas=kernel_resources(ptxas, B3_BF16.format(d=d)),
        bit_identical_second_call=b3_same)
    del first, second
    # B5's and B6's plans and resources, and a second call's bits
    bwd_plan = fa._flash_bwd_plan(d, q.dtype)
    bwd_same = {}
    for name in FLASH[1:]:
        first = kernel_calls[name]()
        second = kernel_calls[name]()
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        bwd_same[name] = all(torch.equal(a, b_)
                             for a, b_ in zip(first, second))
        del first, second
    for name, part, mangled in (("flash_attention_bwd_dq", "dq", B5_BF16),
                                ("flash_attention_bwd_dkv", "dkv",
                                 B6_BF16)):
        results[name].update(
            plan=getattr(bwd_plan, part)._asdict(),
            ptxas=kernel_resources(ptxas, mangled.format(d=d)),
            bit_identical_second_call=bwd_same[name])
    spills = {f"{name} d{d_}": e["spill_bytes"]
              for d_ in (64, 128)
              for name, mangled in (("B5", B5_BF16), ("B6", B6_BF16))
              for e in kernel_resources(ptxas, mangled.format(d=d_))
              if e["spill_bytes"]}

    # the second library yardstick: SDPA's backward with is_causal=True on
    # full-length rows (every kv_len s), B5 and B6 on the same inputs
    full_lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    out_f, lse_f = fa.flash_attention_fwd(q, k, v, full_lens, sm, True)
    delta_f = fa._delta(do, out_f)
    del out_f
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=sm)
    lib_causal = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, leaves, do, retain_graph=True))
    del o_lib, leaves
    pairs_f = b * h * s * (s + 1) // 2
    rows_f = b * h * s
    full_work = {  # every row and key live: bytes and operations
        "flash_attention_bwd_dq": (rows_f * d * 2 * 5 + rows_f * 4 * 2,
                                   6 * d * pairs_f),
        "flash_attention_bwd_dkv": (rows_f * d * 2 * 6 + rows_f * 4 * 2,
                                    8 * d * pairs_f)}
    full_calls = {
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse_f, delta_f, full_lens, sm, True),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse_f, delta_f, full_lens, sm, True)}
    for name, call in full_calls.items():
        bnd, by = bound_ms(*full_work[name], "bfloat16")
        results[name]["full_length"] = dict(
            ms=time_ms(torch, call), bound_ms=bnd, bound_by=by,
            library_ms=lib_causal if name == "flash_attention_bwd_dq"
            else None,
            library_covers="SDPA backward, is_causal=True, no mask: dq, dk "
                           "and dv in one call (B5 + B6)",
            shapes=f"q/k/v/dO ({b}, {h}, {s}, {d}) bf16, causal, every "
                   f"kv_len {s}")
    del lse_f, delta_f

    def named(e):
        return {n: {"max_abs_err": a, "err_over_tol": r}
                for n, (a, r) in e.items()}

    emit({"phase": "flash_kernels", "errors": named(errs),
          "tol": f"per element: 1e-3 + 2^-8 * |plain|; lse {LSE_TOL}",
          "masked_rows_exact": masked_exact,
          "f32_d16": {"errors": named(errs16),
                      "tol": f"per element: 1e-5 + 1e-5 * |plain|; lse "
                             f"{LSE_TOL}",
                      "masked_rows_exact": masked16},
          **results})
    for case, e in (("bf16 d128", errs), ("f32 d16", errs16)):
        for what, (err, over) in e.items():
            if not over <= 1.0:
                raise AssertionError(
                    f"{case} {what} disagrees with the plain version: max "
                    f"abs error {err}, {over} x its element's tolerance")
    if not (masked_exact and masked16):
        raise AssertionError("a row with no visible key is not exactly "
                             "zero / LSE_MASKED")
    if not b3_same:
        raise AssertionError("B3: a second call on the same inputs gave "
                             "other bits")
    if not all(bwd_same.values()):
        raise AssertionError(f"B5/B6: a second call on the same inputs gave "
                             f"other bits: {bwd_same}")
    if any(results[n]["plan"]["body"] != "wgmma" for n in FLASH[1:]):
        raise AssertionError("B5/B6 bf16 did not plan the tensor-core body")
    if spills:
        raise AssertionError(f"the bf16 B5/B6 spill: {spills}")
    return results


def flash_launches(fa):
    return {name: getattr(fa, name).launches for name in FLASH}


def zero_flash_launches(fa):
    for name in FLASH:
        getattr(fa, name).launches = 0


def train_exactness_phase(torch, np, ll, fa, dev):
    """Phase 6: 4 functional train steps, f32, full width, depth 2,
    through the kernels and again from the same weights with the
    attention bound to the plain version."""
    depth, steps, lr, b, s = 2, 4, 1e-4, 2, 256
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = ll.Llama(vocab_size=VOCAB, max_len=s, depth=depth,
                     lora_rank=16, rope_theta=500000.0, device=dev,
                     generator=gen)
    randomize_lora_b(model, gen)
    trainable = ll.make_trainable(model, ll.lora_trainable_names(model))
    init = {n: p.detach().clone() for n, p in trainable.items()}
    rng = np.random.default_rng(SEED + 6)
    batch = ll.batch_to_device(
        {"ids": rng.integers(2, VOCAB, size=(b, s)).astype(np.int32),
         "lens": rng.integers(s // 2, s + 1, size=b).astype(np.int32)}, dev)

    def run():
        with torch.no_grad():
            for n, p in trainable.items():
                p.copy_(init[n])
        opt = ll.adamw(trainable, lr)
        losses = [float(ll.train_step(model, trainable, opt, 1.0, batch))
                  for _ in range(steps)]
        return losses, {n: p.detach().clone() for n, p in trainable.items()}

    def plain_attention(q, k, v, sm_scale=None, causal=False, kv_lens=None,
                        block_h=None):
        scale = sm_scale or 1.0 / math.sqrt(q.shape[-1])
        return fa._attention_reference(q, k, v, scale, causal, kv_lens)

    zero_flash_launches(fa)
    k_losses, k_params = run()
    k_launches = flash_launches(fa)
    kernel_attention = ll.flash_attention
    ll.flash_attention = plain_attention  # rebinding local to this check
    try:
        p_losses, p_params = run()
    finally:
        ll.flash_attention = kernel_attention
    plain_launches = {n: c - k_launches[n]
                      for n, c in flash_launches(fa).items()}
    rel = [abs(a - b_) / abs(b_) for a, b_ in zip(k_losses, p_losses)]
    max_abs = max((k_params[n] - p_params[n]).abs().max().item()
                  for n in init)
    num = sum(float(((k_params[n] - p_params[n]) ** 2).sum()) for n in init)
    den = sum(float(((p_params[n] - init[n]) ** 2).sum()) for n in init)
    update_rel = math.sqrt(num / den)
    emit({"phase": "train_f32_exactness", "depth": depth, "steps": steps,
          "batch": [b, s], "kernel_losses": k_losses,
          "plain_losses": p_losses, "max_loss_rel": max(rel),
          "leaf_max_abs_diff": max_abs, "update_rel_diff": update_rel,
          "kernel_launches": k_launches, "plain_run_launches":
              plain_launches})
    if max(rel) > 1e-4:
        raise AssertionError(f"kernel and plain losses differ: {rel}")
    # the trained leaves: their updates (trained - init) agree to 1e-3 in
    # norm; Adam divides each gradient by its own root-mean-square, so a
    # leaf entry whose gradient is at noise level may move differently
    if update_rel > 1e-3:
        raise AssertionError(f"trained leaves differ: {update_rel}")
    if min(k_launches.values()) != depth * steps or \
            max(plain_launches.values()) != 0:
        raise AssertionError(f"launch counts: {k_launches}, "
                             f"{plain_launches}")
    del model, trainable, init, k_params, p_params


#: the port's kernels by their CUDA function names (a profiler row's name)
KERNEL_FUNCTIONS = {
    "paged_decode_attention": "paged_decode_kernel",
    "paged_window_attention": "paged_window_kernel",
    "paged_merge": "paged_merge_kernel",
    "flash_attention_fwd": "flash_fwd_kernel",
    "flash_attention_fwd_mh": "flash_fwd_mh_kernel",
    "flash_attention_bwd_dq": ("flash_bwd_dq_kernel",
                               "flash_bwd_dq_mma_kernel"),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_kernel",
                                "flash_bwd_dkv_mma_kernel"),
    "matmul_bias": ("matmul_bias_mma_kernel", "matmul_bias_fma_kernel"),
}


def _kernel_time_split(torch, prof):
    """Device time by class from a profiler run, in ms, over the device's
    kernel rows only (a CPU operator's row, and a ``record_function``
    range drawn on the device, repeat the time of the kernels under
    them): the total, each port kernel's, cuBLAS's, the rest, and the
    largest rows."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    total = sum(t for _, t in rows)
    ours = {name: sum(t for n, t in rows if any(
        f + "<" in n or f + "(" in n or n.endswith(f)
        for f in ((fn,) if isinstance(fn, str) else fn)))
        for name, fn in KERNEL_FUNCTIONS.items()}
    mm = sum(t for n, t in rows if any(w in n.lower() for w in (
        "gemm", "xmma", "nvjet", "cutlass", "cublas")))
    top = sorted(rows, key=lambda r: -r[1])[:12]
    return {"device_ms": total, "kernels_ms": ours, "cublas_ms": mm,
            "other_ms": total - sum(ours.values()) - mm,
            "top_kernels": [(n[:90], t) for n, t in top]}


def training_phase(torch, np, ll, fa, depth, dev):
    """Phase 7, the training main path: Llama-3-8B widths, bf16 compute,
    f32 trainable leaves, 4 steps on one repeated batch."""
    vocab, s, steps, lr = VOCAB, 1024, 4, 1e-4
    rng = np.random.default_rng(SEED + 7)
    ids = rng.integers(2, vocab, size=(4, s)).astype(np.int32)
    lens = rng.integers(512, s + 1, size=4).astype(np.int32)
    cuts = []

    def attempt(b, depth):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        t0 = time.perf_counter()
        model = ll.Llama(vocab_size=vocab, max_len=s, depth=depth,
                         lora_rank=16, dtype=torch.bfloat16,
                         rope_theta=500000.0, device=dev, generator=gen)
        randomize_lora_b(model, gen)
        trainable = ll.make_trainable(model, ll.lora_trainable_names(model))
        opt = ll.adamw(trainable, lr)
        batch = ll.batch_to_device({"ids": ids[:b], "lens": lens[:b]}, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        zero_flash_launches(fa)
        for _ in range(steps):
            t = time.perf_counter()
            losses.append(float(ll.train_step(model, trainable, opt, 1.0,
                                              batch)))  # syncs
            step_s.append(time.perf_counter() - t)
        launches = flash_launches(fa)
        peak = torch.cuda.max_memory_allocated() / 1e9
        # one more step under the profiler: device time by kernel class.
        # Only the profiler's own failures are recorded and passed over;
        # an error of the step itself (a kernel's launch) propagates.
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            float(ll.train_step(model, trainable, opt, 1.0, batch))
            prof_wall = (time.perf_counter() - t) * 1e3
        try:
            split = _kernel_time_split(torch, prof)
            attn = sum(split["kernels_ms"].values())
            profile_line = {"wall_ms": prof_wall,
                            "device_ms": split["device_ms"],
                            "flash_ms": attn, "matmul_ms": split["cublas_ms"],
                            "other_ms": split["other_ms"],
                            "device_idle_share":
                                1 - split["device_ms"] / prof_wall,
                            "top_kernels": split["top_kernels"]}
        except Exception as exc:  # reading the trace: a measurement
            profile_line = {"failed": repr(exc)}
        return dict(b=b, depth=depth, init_s=init_s, losses=losses,
                    step_s=step_s, launches=launches, peak_mem_gb=peak,
                    profile=profile_line)

    b = 4
    while True:
        try:
            r = attempt(b, depth)
            break
        except torch.cuda.OutOfMemoryError:
            pass
        torch.cuda.empty_cache()
        if b > 1:
            b //= 2
            cuts.append(f"out of memory: batch cut to {b}")
        elif depth > 1:
            depth //= 2
            cuts.append(f"out of memory: depth cut to {depth}")
        else:
            raise AssertionError("the training leg does not fit")
        print(f"chip_smoke: {cuts[-1]}", flush=True)
    tokens = r["b"] * s
    steady = r["step_s"][1:]
    emit({"phase": "training", "model": "Llama-3-8B widths",
          "depth": r["depth"], "dtype": "bfloat16 compute, f32 trainable",
          "batch": [r["b"], s], "lens": lens[:r["b"]].tolist(),
          "steps": steps, "lr": lr, "init_s": r["init_s"],
          "losses": r["losses"], "step_s": r["step_s"],
          "tokens_per_step": tokens, "real_tokens_per_step":
              int(lens[:r["b"]].sum()),
          "train_tok_per_s": tokens * len(steady) / sum(steady),
          "peak_mem_gb": r["peak_mem_gb"], "launches": r["launches"],
          "cuts": cuts, "profiled_step": r["profile"]})
    want = r["depth"] * steps
    if any(n != want for n in r["launches"].values()):
        raise AssertionError(f"flash launches {r['launches']} != depth x "
                             f"steps = {want}")
    if not all(math.isfinite(x) for x in r["losses"]):
        raise AssertionError(f"non-finite loss: {r['losses']}")
    if not r["losses"][-1] < r["losses"][0]:
        raise AssertionError(f"the loss did not fall: {r['losses']}")
    return r["launches"]


def write_corpus(np, path, n, seed, vocab=500, n_classes=4, max_words=120):
    """A learnable ``.jsonl`` text corpus: class-conditional unigram
    mixtures over ``tok<i>`` words, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    dists = np.random.default_rng(7 + vocab).dirichlet(
        np.ones(vocab) * 0.05, size=n_classes)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"n_classes": n_classes}) + "\n")
        for _ in range(n):
            c = int(rng.integers(0, n_classes))
            words = rng.choice(vocab, size=int(rng.integers(5, max_words)),
                               p=dists[c])
            f.write(json.dumps({"text": " ".join(f"tok{w}" for w in words),
                                "label": c}) + "\n")
    return str(path)


def template_phase(torch, np, ll, TrainContext, dev):
    """Phase 8: the LlamaLoRA template at its largest knobs, train →
    evaluate → dump → reload → evaluate → predict."""
    knobs = {"max_epochs": 2, "vocab_size": 1 << 14, "hidden_dim": 512,
             "depth": 8, "n_heads": 4, "kv_ratio": 2, "lora_rank": 16,
             "max_len": 128, "model_parallel": 1, "learning_rate": 3e-3,
             "lora_scale": 1.0, "batch_size": 32, "bf16": True}
    work = ROOT / "build" / "chip_smoke"
    train = write_corpus(np, work / "train.jsonl", 512, SEED + 8)
    val = write_corpus(np, work / "val.jsonl", 128, SEED + 9)
    m = ll.LlamaLoRA(device=dev, **knobs)
    ctx = TrainContext()
    t0 = time.perf_counter()
    m.train(train, ctx)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    score = m.evaluate(val)
    blob = m.dump_parameters()
    fresh = ll.LlamaLoRA(device=dev, **knobs)
    fresh.load_parameters(blob)
    reloaded = fresh.evaluate(val)
    preds = fresh.predict(["tok1 tok5 tok9", "tok3"], max_new_tokens=8)
    emit({"phase": "template", "knobs": knobs, "train_s": train_s,
          "epoch_losses": ctx.logger.get_values("loss"), "score": score,
          "reloaded_score": reloaded, "predictions": preds})
    if not 0.0 < score <= 1.0:
        raise AssertionError(f"score {score} is not in (0, 1]")
    if reloaded != score:
        raise AssertionError(f"reloaded score {reloaded} != {score}")
    if len(preds) != 2 or any(len(p.split()) != 8 for p in preds):
        raise AssertionError(f"bad predictions: {preds}")


# ---------------------------------------------------------------- ViT / BERT

#: training knobs: one epoch of 8 steps, the first two warming up (step
#: 0 at lr 0, as optax's schedule gives). At lr 3e-4 without warmup the
#: ViT-B/16 leg diverged from its random weights (loss 3.0 -> 6.0 by
#: step 3 on an H100); these rates with the warmup make both losses fall
VIT_KNOBS = {"patch_size": 16, "hidden_dim": 768, "depth": 12,
             "n_heads": 12, "batch_size": 64, "max_epochs": 1,
             "learning_rate": 5e-5, "weight_decay": 1e-4,
             "warmup_frac": 0.25, "bf16": True, "remat": False,
             "quick_train": False, "share_params": False}
BERT_KNOBS = {"vocab_size": 32768, "hidden_dim": 768, "depth": 12,
              "n_heads": 12, "max_len": 128, "batch_size": 64,
              "max_epochs": 1, "learning_rate": 2e-5, "weight_decay": 1e-4,
              "warmup_frac": 0.25, "bf16": True, "quick_train": False,
              "share_params": False}
VIT_IMAGE = (224, 224, 3)
#: per-element tolerance of B7 against its plain version run in f32:
#: bf16, one rounding of the output plus 1e-3; f32, the sums alone
MATMUL_TOL = FLASH_TOL


def matmul_bias_phase(torch, np, pe, dev, ptxas=()):
    """Phase 9: B7 against its plain version at ViT-B/16's serving shape,
    (64·196, 768) x (768, 768) + (768,), in bf16 and f32; ``ptxas`` is the
    build's report."""
    p, n = VIT_KNOBS["patch_size"], VIT_KNOBS["hidden_dim"]
    rng = np.random.default_rng(SEED + 9)
    images = torch.from_numpy(rng.uniform(-1, 1, (64, *VIT_IMAGE)).astype(
        np.float32)).to(dev)
    x32 = pe.extract_patches(images, p)
    x32 = x32.reshape(-1, x32.shape[-1]).contiguous()
    m, k = x32.shape
    w32 = torch.from_numpy((rng.standard_normal((k, n)) / math.sqrt(k))
                           .astype(np.float32)).to(dev)
    b32 = torch.from_numpy(0.02 * rng.standard_normal(n).astype(
        np.float32)).to(dev)
    errs = {}
    for name, dt in (("bfloat16", torch.bfloat16),
                     ("float32", torch.float32)):
        x, w, b = (t.to(dt) for t in (x32, w32, b32))
        got = pe.matmul_bias(x, w, b)
        ref = pe._matmul_bias_reference(x.float(), w.float(), b.float())
        torch.cuda.synchronize()
        errs[name] = elementwise_err(got, ref, *MATMUL_TOL[name])
    x, w, b = (t.to(torch.bfloat16) for t in (x32, w32, b32))
    first = pe.matmul_bias(x, w, b)
    second = pe.matmul_bias(x, w, b)
    torch.cuda.synchronize()
    same = bool(torch.equal(first, second))
    del first, second
    n_bytes = 2 * (m * k + k * n + n + m * n)
    flops = 2 * m * n * k
    bnd, by = bound_ms(n_bytes, flops, "bfloat16")
    result = dict(
        max_abs_err=errs["bfloat16"][0], err_over_tol=errs["bfloat16"][1],
        tol="per element: 1e-3 + 2^-8 * |plain|",
        ms=time_ms(torch, lambda: pe.matmul_bias(x, w, b)),
        plain_ms=time_ms(torch, lambda: pe._matmul_bias_reference(x, w, b)),
        library_ms=time_ms(torch, lambda: torch.addmm(b, x, w)),
        library_covers="torch.addmm in bf16 (cuBLAS)",
        bound_ms=bnd, bound_by=by, bytes=n_bytes, flops=flops,
        plan=pe._matmul_plan(m, n, k, torch.bfloat16)._asdict(),
        ptxas=kernel_resources(ptxas, B7_MMA),
        bit_identical_second_call=same,
        shapes=f"x ({m}, {k}) bf16 (64 ViT-B/16 images' patches), "
               f"w ({k}, {n}), b ({n},)")
    emit({"phase": "matmul_bias", "errors": {
        dt: {"max_abs_err": a, "err_over_tol": r}
        for dt, (a, r) in errs.items()},
        "tol": "per element: bf16 1e-3 + 2^-8 * |plain|, f32 1e-5 + "
               "1e-5 * |plain|", **result})
    for dt, (err, over) in errs.items():
        if not over <= 1.0:
            raise AssertionError(f"B7 {dt} disagrees with its plain version:"
                                 f" max abs error {err}, {over} x tolerance")
    if not same:
        raise AssertionError("B7: a second call on the same inputs gave "
                             "other bits")
    return {"matmul_bias": result}


def classifier_flash_phase(torch, np, F, fa, dev, vit_shape=(64, 12, 197, 64),
                           bert_shape=(64, 12, 128, 64), ptxas=()):
    """Phase 10: the flash kernels on the ViT and BERT paths. B3/B5/B6
    non-causal at ViT-B/16's shape (b 64, 12 heads, s 197, d 64, bf16) and
    with BERT's padded keys (s 128); B4 at block_h 4 on the ViT shape
    against its plain version and against B3 (bit-identical); B3/B5/B6 at
    every compiled head dim on a small ragged shape, f32 and bf16;
    ``ptxas`` is the build's report."""
    rng = np.random.default_rng(SEED + 10)

    def rand(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(dtype)

    bf16 = torch.bfloat16
    b, h, s, d = vit_shape
    q, k, v, do = (rand((b, h, s, d), bf16) for _ in range(4))
    full = torch.full((b,), s, dtype=torch.int32, device=dev)
    sm = 1.0 / math.sqrt(d)
    vit_errs, vit_exact, lse, delta = flash_case(torch, fa, q, k, v, do,
                                                 full, sm, causal=False)

    # B4 at block_h 4: the serving forward (no LSE) and the training one
    out3, lse3 = fa.flash_attention_fwd(q, k, v, full, sm, False)
    out4, lse4 = fa.flash_attention_fwd_mh(q, k, v, full, sm, False, 4)
    ref_o, _ = fa._flash_fwd_reference(q.float(), k.float(), v.float(), full,
                                       sm, False)
    again4, _ = fa.flash_attention_fwd_mh(q, k, v, full, sm, False, 4)
    torch.cuda.synchronize()
    b4_err = elementwise_err(out4, ref_o, *FLASH_TOL["bfloat16"])
    b4_identical = bool(torch.equal(out4, out3) and torch.equal(lse4, lse3))
    b4_same = bool(torch.equal(again4, out4))
    del again4

    pairs = b * h * s * s
    qkv_bytes = b * h * s * d * 2  # one of q / k / v / out / dO, bf16
    rows = b * h * s * 4           # one f32 per row: lse or delta
    work = {
        "flash_attention_fwd": (4 * qkv_bytes + rows, 4 * d * pairs),
        "flash_attention_fwd_mh": (4 * qkv_bytes, 4 * d * pairs),
        "flash_attention_bwd_dq": (5 * qkv_bytes + 2 * rows, 6 * d * pairs),
        "flash_attention_bwd_dkv": (6 * qkv_bytes + 2 * rows,
                                    8 * d * pairs),
    }
    calls = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, full, sm, False),
            lambda: fa._flash_fwd_reference(q, k, v, full, sm, False)),
        "flash_attention_fwd_mh": (
            lambda: fa.flash_attention_fwd_mh(q, k, v, full, sm, False, 4,
                                              with_lse=False),
            lambda: fa._flash_fwd_reference(q, k, v, full, sm, False)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, full,
                                              sm, False),
            lambda: fa._flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                               full, sm, False)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, full,
                                               sm, False),
            lambda: fa._flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                full, sm, False)),
    }
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, scale=sm))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, scale=sm)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, leaves, do, retain_graph=True))
    del o_lib, leaves
    library = {"flash_attention_fwd": lib_fwd,
               "flash_attention_fwd_mh": lib_fwd,
               "flash_attention_bwd_dq": lib_bwd,
               "flash_attention_bwd_dkv": None}
    worst_kv = max(("dk", "dv"), key=lambda n: vit_errs[n][1])
    checked = {"flash_attention_fwd": vit_errs["out"],
               "flash_attention_fwd_mh": b4_err,
               "flash_attention_bwd_dq": vit_errs["dq"],
               "flash_attention_bwd_dkv": vit_errs[worst_kv]}
    shapes = f"q/k/v/dO ({b}, {h}, {s}, {d}) bf16, non-causal, no mask"
    vit = {}
    for name, (kern, plain) in calls.items():
        n_bytes, flops = work[name]
        bnd, by = bound_ms(n_bytes, flops, "bfloat16")
        vit[name] = dict(
            max_abs_err=checked[name][0], err_over_tol=checked[name][1],
            tol="per element: 1e-3 + 2^-8 * |plain|",
            ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
            library_ms=library[name], bound_ms=bnd, bound_by=by,
            bytes=n_bytes, flops=flops, shapes=shapes)
    # B3 at the same shape and the same (serving, no-LSE) forward: what
    # the head tile buys
    plan = fa._flash_plan(d, bf16)._asdict()
    vit["flash_attention_fwd_mh"].update(
        shapes=shapes + ", block_h 4, no LSE (the serving forward)",
        identical_to_b3=b4_identical, bit_identical_second_call=b4_same,
        b3_same_call_ms=time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, full, sm, False, with_lse=False)),
        plan=plan, ptxas=kernel_resources(ptxas, B4_BF16.format(d=d)))
    vit["flash_attention_fwd"].update(
        plan=plan, ptxas=kernel_resources(ptxas, B3_BF16.format(d=d)))
    vit["flash_attention_bwd_dq"]["library_covers"] = \
        "SDPA backward: dq, dk and dv in one call (B5 + B6)"
    for name, part in (("flash_attention_bwd_dq", "dq"),
                       ("flash_attention_bwd_dkv", "dkv")):
        vit[name].update(plan=getattr(fa._flash_bwd_plan(d, bf16),
                                      part)._asdict())
    del q, k, v, do, lse, delta, out3, out4, lse3, lse4, ref_o

    # BERT-base's padded keys: b 64, 12 heads, s 128, d 64
    bb, _, bs, bd = bert_shape
    lens_np = rng.integers(6, bs + 1, size=bb).astype(np.int32)
    lens_np[:2] = (bs, 1)
    bert_in = [rand(bert_shape, bf16) for _ in range(4)]
    blens = torch.from_numpy(lens_np).to(dev)
    bsm = 1.0 / math.sqrt(bd)
    bert_errs, bert_exact, blse, bdelta = flash_case(
        torch, fa, *bert_in, blens, bsm, causal=False)
    # B5 and B6 at BERT's shape beside SDPA's backward with the same mask
    bmask = fa._visible(bs, bs, blens, False)
    leaves = [t.detach().clone().requires_grad_() for t in bert_in[:3]]
    o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=bmask,
                                           scale=bsm)
    bert_bwd = {
        "flash_attention_bwd_dq": time_ms(
            torch, lambda: fa.flash_attention_bwd_dq(
                *bert_in, blse, bdelta, blens, bsm, False)),
        "flash_attention_bwd_dkv": time_ms(
            torch, lambda: fa.flash_attention_bwd_dkv(
                *bert_in, blse, bdelta, blens, bsm, False)),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            o_lib, leaves, bert_in[3], retain_graph=True)),
        "library_covers": "SDPA backward with the same boolean mask: dq, "
                          "dk and dv in one call (B5 + B6)",
        "shapes": f"q/k/v/dO {tuple(bert_shape)} bf16, non-causal, kv_lens "
                  f"{bs}, 1 and 6..{bs}"}
    del bert_in, o_lib, leaves, blse, bdelta
    # their least time there: each input read once (K and V only up to
    # each example's kv_len), each output written once; every row sees
    # its example's kv_len keys
    bh = bert_shape[1]
    rows_b = bb * bh * bs * bd * 2           # q, dO, dq, dk or dv, bf16
    kv_vis = int(lens_np.sum()) * bh * bd * 2  # the visible K (or V) rows
    bpairs = bh * bs * int(lens_np.sum())
    for name, n_bytes, flops in (
            ("flash_attention_bwd_dq", 3 * rows_b + 2 * kv_vis
             + 2 * bb * bh * bs * 4, 6 * bd * bpairs),
            ("flash_attention_bwd_dkv", 4 * rows_b + 2 * kv_vis
             + 2 * bb * bh * bs * 4, 8 * bd * bpairs)):
        bnd, by = bound_ms(n_bytes, flops, "bfloat16")
        bert_bwd[name + "_bound"] = {"bound_ms": bnd, "bound_by": by,
                                     "bytes": n_bytes, "flops": flops}

    # every compiled head dim: b 2 (kv_lens 150 and 0, or 1), 3 heads,
    # s 150, both masks
    sweep = {}
    for d_ in fa.HEAD_DIMS:
        for dt in ("float32", "bfloat16"):
            for causal in (False, True):
                lens = torch.tensor([150, 0 if causal else 1],
                                    dtype=torch.int32, device=dev)
                ins = [rand((2, 3, 150, d_), getattr(torch, dt))
                       for _ in range(4)]
                e, exact, _, _ = flash_case(torch, fa, *ins, lens,
                                            1.0 / math.sqrt(d_), causal)
                sweep[f"d{d_} {dt} {'causal' if causal else 'full'}"] = (
                    max(r for _, r in e.values()), exact)

    def named(e):
        return {n: {"max_abs_err": a, "err_over_tol": r}
                for n, (a, r) in e.items()}

    emit({"phase": "classifier_flash_kernels",
          "vit": {"errors": named(vit_errs), "masked_rows_exact": vit_exact,
                  "b4": {"max_abs_err": b4_err[0],
                         "err_over_tol": b4_err[1],
                         "identical_to_b3": b4_identical}, **vit},
          "bert": {"errors": named(bert_errs), "kv_lens": lens_np.tolist(),
                   "masked_rows_exact": bert_exact,
                   "backward_ms": bert_bwd},
          "head_dim_sweep_worst_err_over_tol": {
              key: r for key, (r, _) in sweep.items()},
          "tol": f"per element: bf16 1e-3 + 2^-8 * |plain|, f32 1e-5 + "
                 f"1e-5 * |plain|; lse {LSE_TOL}"})
    failed = [f"vit {w}" for w, (_, r) in vit_errs.items() if r > 1.0]
    failed += [f"bert {w}" for w, (_, r) in bert_errs.items() if r > 1.0]
    failed += [key for key, (r, exact) in sweep.items()
               if r > 1.0 or not exact]
    if b4_err[1] > 1.0:
        failed.append("b4")
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    if not b4_identical:
        raise AssertionError("B4 is not bit-identical to B3")
    if not b4_same:
        raise AssertionError("B4: a second call on the same inputs gave "
                             "other bits")
    if not bert_exact:
        raise AssertionError("a BERT row with no visible key is not exact")
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        vit[name]["bert_ms"] = bert_bwd[name]
        vit[name]["bert_bound"] = bert_bwd[name + "_bound"]
    vit["flash_attention_bwd_dq"]["bert_library_ms"] = bert_bwd["library_ms"]
    return vit


def all_launches(fa, pe):
    out = flash_launches(fa)
    out["flash_attention_fwd_mh"] = fa.flash_attention_fwd_mh.launches
    out["matmul_bias"] = pe.matmul_bias.launches
    return out


def zero_all_launches(fa, pe):
    zero_flash_launches(fa)
    fa.flash_attention_fwd_mh.launches = 0
    pe.matmul_bias.launches = 0


def classifier_exactness_phase(torch, np, vit, bert, fa, pe, lp, optim, dev):
    """Phase 11: a small ViT (head dim 96) and a small BERT (head dim 24)
    in f32 through the kernels, against the same modules with the plain
    attention and plain matmul_bias: logits, then the per-step losses of
    4 AdamW steps from the same weights, within 1e-5 relative."""
    rng = np.random.default_rng(SEED + 11)
    steps = 4

    def plain_attention(q, k, v, sm_scale=None, causal=False, kv_lens=None,
                        block_h=None):
        scale = sm_scale or 1.0 / math.sqrt(q.shape[-1])
        return fa._attention_reference(q, k, v, scale, causal, kv_lens)

    cases = {
        "vit": (lambda gen: vit.ViT(
            patch_size=16, hidden_dim=384, depth=2, n_heads=4, mlp_dim=1536,
            n_classes=10, image_shape=(64, 64, 3), device=dev,
            generator=gen),
            (torch.from_numpy(rng.uniform(-1, 1, (8, 64, 64, 3)).astype(
                np.float32)).to(dev),)),
        "bert": (lambda gen: bert.Bert(
            vocab_size=1024, max_len=64, hidden_dim=192, depth=2, n_heads=8,
            mlp_dim=768, n_classes=4, device=dev, generator=gen),
            (torch.from_numpy(rng.integers(2, 1024, (8, 64))).to(dev),
             torch.tensor([64, 1, 30, 5, 64, 17, 2, 50], dtype=torch.int32,
                          device=dev))),
    }
    y = torch.from_numpy(rng.integers(0, 4, 8)).to(dev)
    mask = torch.ones(8, device=dev)
    report = {}
    for name, (make, inputs) in cases.items():
        model = make(torch.Generator(device=dev).manual_seed(SEED))
        init = {n: p.detach().clone() for n, p in model.state_dict().items()}

        def run():
            model.load_state_dict(init)
            with torch.no_grad():
                logits = model(*inputs)
            opt, sched = optim.adamw(model.parameters(), 3e-5, 1, steps,
                                     1e-4)
            losses = []
            for _ in range(steps):
                opt.zero_grad(set_to_none=True)
                loss = lp.masked_ce(model(*inputs), y, mask)
                loss.backward()
                opt.step()
                sched.step()
                losses.append(float(loss.detach()))
            return logits, losses

        zero_all_launches(fa, pe)
        k_logits, k_losses = run()
        k_launches = all_launches(fa, pe)
        saved = (vit.flash_attention, bert.flash_attention, pe.matmul_bias)
        vit.flash_attention = bert.flash_attention = plain_attention
        pe.matmul_bias = pe._matmul_bias_reference  # local to this check
        try:
            p_logits, p_losses = run()
        finally:
            vit.flash_attention, bert.flash_attention, pe.matmul_bias = saved
        plain_launches = {n: c - k_launches[n]
                          for n, c in all_launches(fa, pe).items()}
        logit_rel = ((k_logits - p_logits).abs().max()
                     / p_logits.abs().max()).item()
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses,
                                                           p_losses))
        report[name] = {"logits_max_rel": logit_rel,
                        "kernel_losses": k_losses, "plain_losses": p_losses,
                        "max_loss_rel": loss_rel,
                        "kernel_launches": k_launches,
                        "plain_run_launches": plain_launches}
        del model, init
    emit({"phase": "classifier_f32_exactness", "steps": steps,
          "vit": "patch 16, 64x64x3, hidden 384, 4 heads (d 96), depth 2",
          "bert": "hidden 192, 8 heads (d 24), depth 2, s 64, padded keys",
          **report})
    for name, r in report.items():
        if r["logits_max_rel"] > 1e-5 or r["max_loss_rel"] > 1e-5:
            raise AssertionError(f"{name}: kernels and plain versions "
                                 f"differ: {r}")
        want = {"flash_attention_fwd": 2 + 2 * steps,  # eval + train
                "flash_attention_bwd_dq": 2 * steps,
                "flash_attention_bwd_dkv": 2 * steps,
                "matmul_bias": (1 + steps) if name == "vit" else 0,
                "flash_attention_fwd_mh": 0}
        if r["kernel_launches"] != want or \
                max(r["plain_run_launches"].values()) != 0:
            raise AssertionError(f"{name} launch counts: {r}, want {want}")


def vit_blob(torch, vit, store, dev, n_classes):
    """A seeded ViT-B/16 as a template blob (random weights, seed 0)."""
    k = VIT_KNOBS
    net = vit.ViT(patch_size=k["patch_size"], hidden_dim=k["hidden_dim"],
                  depth=k["depth"], n_heads=k["n_heads"],
                  mlp_dim=4 * k["hidden_dim"], n_classes=n_classes,
                  image_shape=VIT_IMAGE, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    blob = {"params": store.params_to_jax(net.state_dict()),
            "meta": {"n_classes": n_classes, "image_shape": list(VIT_IMAGE),
                     "prep_version": 2}}
    del net
    return blob


def _profile_call(torch, fn):
    """``fn()`` once under ``torch.profiler``: its wall time, the device
    time by class and the device's idle share of the call. Only reading
    the trace is guarded; an error of ``fn`` propagates."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    try:
        split = _kernel_time_split(torch, prof)
        return dict(wall_ms=wall, **split,
                    device_idle_share=1 - split["device_ms"] / wall)
    except Exception as exc:  # reading the trace: a measurement
        return {"wall_ms": wall, "failed": repr(exc)}


def _serve(torch, np, m, queries, fa, pe):
    """One timed ``predict`` over ``queries`` with the launch counts zeroed
    just before and read just after."""
    torch.cuda.synchronize()
    zero_all_launches(fa, pe)
    t0 = time.perf_counter()
    probs = np.asarray(m.predict(queries))
    wall = time.perf_counter() - t0
    return probs, wall, all_launches(fa, pe)


def vit_serving_phase(torch, np, vit, store, fa, pe, dev):
    """Phase 12, the ViT serving path: ViT-B/16 (bf16, random weights
    from seed 0, 1000 classes) behind ``ViTBase16.predict``: 256 seeded
    224 x 224 x 3 images (4 buckets of 64), the p50 latency of a 1-image
    predict over 20 calls, then the same 256 with the block_h default at
    4 (B4), then dump → reload → predict."""
    n_img, buckets = 256, 4
    m = vit.ViTBase16(device=dev, **VIT_KNOBS)
    m.load_parameters(vit_blob(torch, vit, store, dev, 1000))
    rng = np.random.default_rng(SEED + 12)
    images = list(rng.integers(0, 256, (n_img, *VIT_IMAGE), dtype=np.uint8))
    m.warmup()  # builds the serving net; one bucket
    torch.cuda.reset_peak_memory_stats()
    probs, wall, launches = _serve(torch, np, m, images, fa, pe)
    peak = torch.cuda.max_memory_allocated() / 1e9
    lat = []
    for i in range(20):
        t0 = time.perf_counter()
        m.predict([images[i]])
        lat.append(time.perf_counter() - t0)
    profiled = _profile_call(torch, lambda: m.predict(images[:64]))
    try:
        fa.ATTN_BLOCK_H = 4  # the fleet-wide default, as the env sets it
        probs4, wall4, launches4 = _serve(torch, np, m, images, fa, pe)
    finally:
        fa.ATTN_BLOCK_H = 1
    fresh = vit.ViTBase16(device=dev, **VIT_KNOBS)
    fresh.load_parameters(m.dump_parameters())
    reloaded = np.asarray(fresh.predict(images[:64]))
    del fresh
    emit({"phase": "vit_serving", "model": "ViT-B/16", "dtype": "bfloat16",
          "images": n_img, "buckets": buckets, "wall_s": wall,
          "images_per_s": n_img / wall,
          "p50_latency_1_image_s": float(np.median(lat)),
          "latencies_1_image_s": lat, "peak_mem_gb": peak,
          "launches": launches, "profiled_64_images": profiled,
          "block_h4": {"wall_s": wall4, "images_per_s": n_img / wall4,
                       "launches": launches4,
                       "probs_identical": bool(np.array_equal(probs4,
                                                              probs)),
                       "probs_max_abs_diff":
                           float(np.abs(probs4 - probs).max())},
          "reload_identical": bool(np.array_equal(reloaded, probs[:64]))})
    if probs.shape != (n_img, 1000) or not np.isfinite(probs).all() or \
            np.abs(probs.sum(-1) - 1).max() > 1e-3:
        raise AssertionError(f"bad probabilities: {probs.shape}")
    depth = VIT_KNOBS["depth"]
    if launches["matmul_bias"] != buckets or \
            launches["flash_attention_fwd"] != depth * buckets or \
            launches["flash_attention_fwd_mh"] != 0:
        raise AssertionError(f"ViT serving launches {launches}")
    if launches4["flash_attention_fwd_mh"] != depth * buckets or \
            launches4["flash_attention_fwd"] != 0 or \
            launches4["matmul_bias"] != buckets:
        raise AssertionError(f"block_h 4 launches {launches4}")
    if not np.array_equal(probs4, probs):
        raise AssertionError("block_h 4 changed the probabilities")
    if not np.array_equal(reloaded, probs[:64]):
        raise AssertionError("dump → reload → predict differs")
    return {"vit_serving": launches, "vit_serving_block_h4": launches4}


def write_images(np, path, n, seed, n_classes=10):
    """A learnable ``.npz`` image set: each class a fixed low-frequency
    7 x 7 x 3 pattern upsampled to 224 x 224, plus noise, as uint8."""
    rng = np.random.default_rng(seed)
    coarse = np.random.default_rng(7).normal(0, 1, (n_classes, 7, 7, 3))
    h, w, _ = VIT_IMAGE
    reps = -(-max(h, w) // 7)
    templates = np.repeat(np.repeat(coarse, reps, axis=1), reps, axis=2)[
        :, :h, :w].astype(np.float32)
    labels = rng.integers(0, n_classes, n).astype(np.int64)
    x = templates[labels]
    x += 0.5 * rng.standard_normal(x.shape, dtype=np.float32)
    images = np.clip((x + 4.5) * (255 / 9.0), 0, 255).astype(np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, images=images, labels=labels,
             n_classes=np.asarray(n_classes))
    return str(path), images


def _train_timed(torch, template, path, ctx, lp, fa, pe, profile_step):
    """``template.train(path)`` with every step timed (synchronized) and
    its loss read, one step under ``torch.profiler``, and the launch
    counts zeroed just before and read just after. ``train_epoch`` is
    rebound for this run only."""
    from torch.profiler import ProfilerActivity, profile

    losses, step_s, prof_line = [], [], {}
    real_epoch = lp.train_epoch

    def timed_epoch(step, state, batches):
        def timed(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if len(losses) == profile_step:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    state, loss = step(state, batch)
                    value = float(loss)  # syncs
                wall = (time.perf_counter() - t) * 1e3
                try:
                    split = _kernel_time_split(torch, prof)
                    prof_line.update(wall_ms=wall, **split,
                                     device_idle_share=1 - split["device_ms"]
                                     / wall)
                except Exception as exc:  # reading the trace only
                    prof_line.update(failed=repr(exc))
            else:
                state, loss = step(state, batch)
                value = float(loss)
            step_s.append(time.perf_counter() - t)
            losses.append(value)
            return state, loss
        return real_epoch(timed, state, batches)

    lp.train_epoch = timed_epoch
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_all_launches(fa, pe)
        t0 = time.perf_counter()
        template.train(path, ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches(fa, pe)
    finally:
        lp.train_epoch = real_epoch
    return dict(losses=losses, step_s=step_s, wall_s=wall,
                launches=launches, profiled_step=prof_line,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def _idle(r, steady):
    """1 - the profiled step's device time over the mean steady step's
    wall time (the profiler lengthens the step it records)."""
    device_ms = r["profiled_step"].get("device_ms")
    if device_ms is None:
        return None
    return 1 - device_ms / (1e3 * float(sum(steady) / len(steady)))


def _check_training(name, r, want):
    """Launch counts, finite losses, and a falling loss: each step sees a
    new batch, so the mean of the last two steps must be below that of
    the first two."""
    if r["launches"] != want:
        raise AssertionError(f"{name} launches {r['launches']} != {want}")
    losses = r["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    if not sum(losses[-2:]) < sum(losses[:2]):
        raise AssertionError(f"{name}: the loss did not fall: {losses}")


def vit_training_phase(torch, np, vit, lp, TrainContext, fa, pe, dev):
    """Phase 13, the ViT training path: ``ViTBase16.train`` at ViT-B/16
    (bf16 compute, f32 params) on a seeded 512-image npz, batch 64, one
    epoch of 8 steps; step 7 under the profiler; then dump → reload →
    predict."""
    steps, batch = 8, VIT_KNOBS["batch_size"]
    path, images = write_images(np, ROOT / "build" / "chip_smoke" /
                                "vit_train.npz", steps * batch, SEED + 13)
    m = vit.ViTBase16(device=dev, **VIT_KNOBS)
    ctx = TrainContext()
    r = _train_timed(torch, m, path, ctx, lp, fa, pe, profile_step=steps - 1)
    steady = r["step_s"][1:-1]  # not the first, not the profiled one
    queries = list(images[:64])
    probs = np.asarray(m.predict(queries))
    fresh = vit.ViTBase16(device=dev, **VIT_KNOBS)
    fresh.load_parameters(m.dump_parameters())
    reloaded = np.asarray(fresh.predict(queries))
    del fresh, m
    emit({"phase": "vit_training", "model": "ViT-B/16",
          "dtype": "bfloat16 compute, f32 params", "batch": batch,
          "steps": steps, "knobs": VIT_KNOBS, "losses": r["losses"],
          "epoch_loss": ctx.logger.get_values("loss"), "step_s": r["step_s"],
          "steady_step_s": float(np.mean(steady)),
          "images_per_s": batch / float(np.mean(steady)),
          "wall_s": r["wall_s"], "peak_mem_gb": r["peak_mem_gb"],
          "launches": r["launches"], "profiled_step": r["profiled_step"],
          "device_idle_share_of_steady_step": _idle(r, steady),
          "reload_identical": bool(np.array_equal(reloaded, probs))})
    depth = VIT_KNOBS["depth"]
    _check_training("ViT", r, {
        "flash_attention_fwd": depth * steps,
        "flash_attention_bwd_dq": depth * steps,
        "flash_attention_bwd_dkv": depth * steps,
        "flash_attention_fwd_mh": 0, "matmul_bias": steps})
    if not np.array_equal(reloaded, probs):
        raise AssertionError("ViT dump → reload → predict differs")
    return {"vit_training": r["launches"]}


def bert_phase(torch, np, bert, lp, TrainContext, fa, pe, dev):
    """Phase 14, the BERT path: ``BertClassifier`` at BERT-base (bf16
    compute, f32 params, vocab 32768, max_len 128) trains one epoch of 8
    steps at batch 64 on a seeded corpus, then predicts 256 texts (4
    buckets); dump → reload → predict."""
    steps, batch = 8, BERT_KNOBS["batch_size"]
    work = ROOT / "build" / "chip_smoke"
    train = write_corpus(np, work / "bert_train.jsonl", steps * batch,
                         SEED + 14, max_words=200)
    val = write_corpus(np, work / "bert_val.jsonl", 256, SEED + 15,
                       max_words=200)
    m = bert.BertClassifier(device=dev, **BERT_KNOBS)
    ctx = TrainContext()
    r = _train_timed(torch, m, train, ctx, lp, fa, pe, profile_step=steps - 1)
    steady = r["step_s"][1:-1]
    with open(val) as f:
        texts = [json.loads(line)["text"] for line in list(f)[1:]]
    probs, wall, launches = _serve(torch, np, m, texts, fa, pe)
    score = m.evaluate(val)
    fresh = bert.BertClassifier(device=dev, **BERT_KNOBS)
    fresh.load_parameters(m.dump_parameters())
    reloaded = np.asarray(fresh.predict(texts))
    _, lens = m._encode(texts)
    del fresh, m
    emit({"phase": "bert", "model": "BERT-base", "dtype":
          "bfloat16 compute, f32 params", "batch": batch, "steps": steps,
          "knobs": BERT_KNOBS, "losses": r["losses"], "step_s": r["step_s"],
          "steady_step_s": float(np.mean(steady)),
          "train_examples_per_s": batch / float(np.mean(steady)),
          "train_peak_mem_gb": r["peak_mem_gb"],
          "train_launches": r["launches"],
          "profiled_step": r["profiled_step"],
          "device_idle_share_of_steady_step": _idle(r, steady),
          "predict_texts": len(texts),
          "predict_wall_s": wall, "texts_per_s": len(texts) / wall,
          "predict_launches": launches, "mean_len": float(lens.mean()),
          "val_accuracy": score,
          "reload_identical": bool(np.array_equal(reloaded, probs))})
    depth = BERT_KNOBS["depth"]
    _check_training("BERT", r, {
        "flash_attention_fwd": depth * steps,
        "flash_attention_bwd_dq": depth * steps,
        "flash_attention_bwd_dkv": depth * steps,
        "flash_attention_fwd_mh": 0, "matmul_bias": 0})
    if launches["flash_attention_fwd"] != depth * 4 or \
            sum(launches.values()) != depth * 4:
        raise AssertionError(f"BERT serving launches {launches}")
    if probs.shape != (256, 4) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities {probs.shape}")
    if not np.array_equal(reloaded, probs):
        raise AssertionError("BERT dump → reload → predict differs")
    return {"bert_training": r["launches"], "bert_serving": launches}


def hd8_serving_phase(torch, np, ll, de, pa, dev, int8=False):
    """Phase 15: a head-dim-8 Llama (hidden 32, 4 heads, 2 kv heads,
    max_len 32, f32, LoRA rank 4 with nonzero adapters, random weights
    from a seed: the LlamaLoRA knob grid's smallest head dim) served
    paged through ``DecodeEngine`` on the card at pages 8 and 4 must give
    exactly the tokens of the same model and requests served on the CPU
    (the plain versions); B1 and B2 must launch. With ``int8``, phase 17:
    the same model with int8 base kernels and an int8 KV pool, through
    the int8 kernels with f32 queries."""
    knobs = dict(vocab_size=1024, max_len=32, hidden_dim=32, depth=2,
                 n_heads=4, n_kv_heads=2, mlp_dim=128, lora_rank=4,
                 quantized=int8, kv_int8=int8)
    suffix = "_int8" if int8 else ""
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED)
    host = ll.Llama(device=cpu, generator=gen, **knobs)
    randomize_lora_b(host, gen)
    card = ll.Llama(device=dev, **knobs)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(SEED + 16)
    reqs = [(i, rng.integers(1, 1024, size=int(rng.integers(2, 15)))
             .astype(np.int32), 8) for i in range(8)]

    def serve(model, device, page):
        """Half the requests, two steps, the rest (admission mid-flight),
        then steps until every request is done."""
        eng = de.DecodeEngine(model.with_kv_layout(page, 1 + 4 * 32 // page),
                              max_slots=4, max_len=32, steps_per_sync=4,
                              prefill_chunk=8, device=device)
        done = {}
        for n in range(600):
            for rid, prompt, max_new in reqs[:4] if n == 0 else \
                    reqs[4:] if n == 2 else ():
                eng.submit(rid, prompt, max_new)
            eng.step()
            done.update({rid: [int(t) for t in toks]
                         for rid, toks in eng.poll()})
            if len(done) == len(reqs):
                break
        return done

    out, total = {}, {"paged_decode_attention" + suffix: 0,
                      "paged_window_attention" + suffix: 0}
    for page in (8, 4):
        want = serve(host, cpu, page)
        torch.cuda.synchronize()
        pa.paged_decode_attention.launches = 0
        pa.paged_window_attention.launches = 0
        got = serve(card, dev, page)
        torch.cuda.synchronize()
        launches = {"paged_decode_attention" + suffix:
                        pa.paged_decode_attention.launches,
                    "paged_window_attention" + suffix:
                        pa.paged_window_attention.launches}
        for name, n in launches.items():
            total[name] += n
        out[f"page_{page}"] = {
            "requests": len(reqs), "completed": len(got),
            "token_identical": got == want and len(got) == len(reqs),
            "mismatched_requests": sorted(r for r in want
                                          if got.get(r) != want[r]),
            "launches": launches}
    emit({"phase": f"hd8{suffix}_paged_serving", "knobs": knobs,
          "dtype": "float32", **out})
    for page, r in out.items():
        if not r["token_identical"]:
            raise AssertionError(f"head-dim-8 paged serving at {page} "
                                 f"differs from the CPU: {r}")
        if min(r["launches"].values()) <= 0:
            raise AssertionError(f"a paged kernel never launched at {page}: "
                                 f"{r['launches']}")
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=32,
                    help="decoder depth of the serving leg (widths are "
                         "never cut)")
    ap.add_argument("--train-depth", type=int, default=32,
                    help="decoder depth of the training leg (widths are "
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

    from rafiki_tpu_torch.model import loop as lp
    from rafiki_tpu_torch.model import optim
    from rafiki_tpu_torch.model.base import TrainContext
    from rafiki_tpu_torch.models import bert
    from rafiki_tpu_torch.models import llama_lora as ll
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.models.bert import HashTokenizer
    from rafiki_tpu_torch.ops import _build
    from rafiki_tpu_torch.ops import attention as fa
    from rafiki_tpu_torch.ops import paged_attention as pa
    from rafiki_tpu_torch.ops import patch_embed as pe
    from rafiki_tpu_torch.serving import decode_engine as de
    from rafiki_tpu_torch.store import params as store_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    sources, build_s, ptxas = build_kernels(_build)
    emit({"phase": "build", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sources": sources,
          "build_s": build_s, "kernels_compiled": len(ptxas),
          "spilling": [e["mangled"] for e in ptxas if e["spill_bytes"]],
          "most_registers": max((e["registers"] or 0) for e in ptxas)})
    if args.depth != 32 or args.train_depth != 32:
        print(f"chip_smoke: Llama legs cut to depth {args.depth} (serving)"
              f" and {args.train_depth} (training) of 32", flush=True)

    dev = torch.device("cuda")
    # the paths' launch counts assume the per-head forward (B3) whatever
    # RAFIKI_ATTN_BLOCK_H says; the ViT serving leg sets 4 for its B4 run
    fa.ATTN_BLOCK_H = 1
    paths = {}  # main path -> {kernel: launches}
    kres = kernel_phase(torch, np, F, pa, ll, dev, ptxas)
    exactness_phase(torch, np, ll, de, dev)
    torch.cuda.empty_cache()
    paths["llama_serving"] = serving_phase(torch, np, ll, de, pa,
                                           HashTokenizer, args.depth, dev)
    torch.cuda.empty_cache()  # phase 4's model is gone: free its memory
    paths["llama_int8_serving"] = serving_phase(
        torch, np, ll, de, pa, HashTokenizer, args.depth, dev, int8=True)
    torch.cuda.empty_cache()
    kres.update(flash_phase(torch, np, F, fa, dev, ptxas=ptxas))
    torch.cuda.empty_cache()
    train_exactness_phase(torch, np, ll, fa, dev)
    torch.cuda.empty_cache()
    paths["llama_training"] = training_phase(torch, np, ll, fa,
                                             args.train_depth, dev)
    torch.cuda.empty_cache()
    template_phase(torch, np, ll, TrainContext, dev)
    torch.cuda.empty_cache()
    kres.update(matmul_bias_phase(torch, np, pe, dev, ptxas))
    classifier = classifier_flash_phase(torch, np, F, fa, dev, ptxas=ptxas)
    kres["flash_attention_fwd_mh"] = classifier["flash_attention_fwd_mh"]
    lib_vit = classifier["flash_attention_bwd_dq"]["library_ms"]
    lib_bert = classifier["flash_attention_bwd_dq"]["bert_library_ms"]
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        c = classifier[name]
        kres[name]["classifier_shapes"] = {
            "vit": {"ms": c["ms"], "bound_ms": c["bound_ms"],
                    "library_ms": lib_vit, "shapes": c["shapes"]},
            "bert": {"ms": c["bert_ms"], "library_ms": lib_bert,
                     **c["bert_bound"]},
            "library_covers": "SDPA backward: dq, dk and dv in one call"}
    torch.cuda.empty_cache()
    classifier_exactness_phase(torch, np, vit, bert, fa, pe, lp, optim, dev)
    torch.cuda.empty_cache()
    paths.update(vit_serving_phase(torch, np, vit, store_params, fa, pe,
                                   dev))
    torch.cuda.empty_cache()
    paths.update(vit_training_phase(torch, np, vit, lp, TrainContext, fa,
                                    pe, dev))
    torch.cuda.empty_cache()
    paths.update(bert_phase(torch, np, bert, lp, TrainContext, fa, pe, dev))
    torch.cuda.empty_cache()
    paths["llama_hd8_serving"] = hd8_serving_phase(torch, np, ll, de, pa,
                                                   dev)
    paths["llama_hd8_int8_serving"] = hd8_serving_phase(
        torch, np, ll, de, pa, dev, int8=True)

    by_path = {name: {path: counts[name] for path, counts in paths.items()
                      if counts.get(name)}
               for name in kres}
    for name in ("paged_decode_attention", "paged_window_attention"):
        kres[name]["int8_launches_by_path"] = by_path[name + "_int8"]
    emit({"phase": "done", "seconds_after_start": time.perf_counter()
          - t_start})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name],
         "max_abs_err": r["max_abs_err"], "tol": r["tol"], "ms": r["ms"],
         "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "card": smi, "shapes": r["shapes"],
         **{key: r[key] for key in ("err_over_tol", "library_covers",
                                    "identical_to_b3", "plan", "gb_per_s",
                                    "bound_share", "b3_same_call_ms",
                                    "ptxas", "bit_identical_second_call",
                                    "full_length", "classifier_shapes",
                                    "f32_queries", "int8_launches_by_path")
            if key in r}}
        for name, r in kres.items()]})
    missing = [name for name in kres if not by_path[name]]
    if missing:
        raise AssertionError(f"kernels no main path launched: {missing}")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
