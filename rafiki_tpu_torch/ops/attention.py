"""Fused causal / padded attention with a flash-style backward.

Ports ``rafiki_tpu/ops/attention.py``:

- :func:`flash_attention` ← ``flash_attention``: (b, h, s, d) tensors,
  differentiable in q, k and v through a ``torch.autograd.Function``
  that saves ``(q, k, v, out, lse)`` (``_flash_attention_full`` /
  ``_flash_attention_varlen``'s residuals).
- :func:`flash_attention_fwd` ← Pallas ``_attn_fwd_kernel`` (B3).
- :func:`flash_attention_fwd_mh` ← Pallas ``_attn_fwd_mh_kernel`` (B4),
  the head-tiled forward that ``block_h > 1`` selects; its plain version
  is B3's.
- :func:`flash_attention_bwd_dq` ← Pallas ``_attn_bwd_dq_kernel`` (B5).
- :func:`flash_attention_bwd_dkv` ← Pallas ``_attn_bwd_dkv_kernel`` (B6).
- :func:`_attention_reference` ← the same-named XLA oracle; with
  :func:`_flash_fwd_reference` and :func:`_flash_bwd_reference` these are
  the kernels' plain versions.
- :func:`_flash_plan` is how the forward runs for a head dim and dtype
  (the bf16 tensor-core body or the f32 FMA one, padded head dim, copy
  width, ring stages, threads, shared memory), :func:`_flash_bwd_plan` how
  B5 and B6 run; :func:`_flash_mma_reference` and
  :func:`_flash_bwd_mma_reference` are plain models of the bf16 bodies'
  numerics, held against the plain versions by the tests. Nothing on a
  model's path calls any of them.

Semantics kept from the JAX module: masked scores are ``NEG_INF``; key
``j`` is hidden from every row when ``j >= kv_lens[b]`` and, with
``causal``, from row ``i`` when ``j > i`` (positions from 0 in both
sequences); a row with no visible key outputs exact zeros and carries
``LSE_MASKED``, so its gradient is exactly zero. ``delta = rowsum(dO·O)``
is computed in plain torch, outside the kernels, as JAX computes it in
XLA. The LSE travels as one f32 per row, (b, h, s_q): JAX's replication
over 128 lanes is TPU tiling and has no counterpart.

Each wrapper takes the plain version for tensors on the CPU and launches
its CUDA kernel (``csrc/flash_attention.cu``, built by ``ops/_build.py``
at first use) for any other device, or raises; it counts kernel launches
in a plain integer attribute, ``launches``. JAX's short-sequence routing
to XLA (``XLA_SHORT_SEQ``) was a TPU measurement and has no counterpart:
every CUDA call takes the kernel. ``ATTN_BLOCK_H`` (``RAFIKI_ATTN_BLOCK_H``)
and :func:`_env_block_h` are the port's copies of the JAX module's
fleet-wide ``block_h`` default and its per-shape fallback; as in JAX, the
backward of a head-tiled forward is B5/B6.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import math
import os
from typing import NamedTuple, Optional, Tuple

import torch

from rafiki_tpu_torch.ops import _build
from rafiki_tpu_torch.ops.common import KERNEL_DTYPES as _DTYPE_CODES
from rafiki_tpu_torch.ops.common import check_launch as _raise_on
from rafiki_tpu_torch.ops.common import runs_kernel as _runs_kernel

NEG_INF = -1e30  # rafiki_tpu/ops/attention.py NEG_INF
#: LSE of a row whose every key is masked: exp(s - 1e30) == 0 for any
#: finite score, so such rows contribute exactly zero gradient
LSE_MASKED = 1e30
#: head dims the kernels are compiled for: every hidden_dim / n_heads the
#: LlamaLoRA, ViT and BERT knobs give (8..192) and Llama-3-8B's 128
HEAD_DIMS = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192)
#: fleet-wide default of :func:`flash_attention`'s ``block_h`` for callers
#: that pass none: ``RAFIKI_ATTN_BLOCK_H=4`` puts every template on the
#: head-tiled forward (B4) without code edits; 1 = per-head B3
ATTN_BLOCK_H = max(1, int(os.environ.get("RAFIKI_ATTN_BLOCK_H", "1")))

#: query rows and keys per tile of every forward body
_TILE = 64

# (block_h, heads) pairs already warned about by _env_block_h: once per
# shape, not per call
_ENV_BLOCK_H_WARNED = set()

Tensor = torch.Tensor


def _prep_lens(kv_lens, b: int, s_kv: int, device: torch.device) -> Tensor:
    """(b,) valid-key counts as int32 on ``device``, clipped to
    [0, s_kv]; None → every key valid."""
    if kv_lens is None:
        return torch.full((b,), s_kv, dtype=torch.int32, device=device)
    lens = torch.as_tensor(kv_lens, device=device).to(torch.int32)
    if tuple(lens.shape) != (b,):
        raise ValueError(f"kv_lens must be ({b},), got {tuple(lens.shape)}")
    return lens.clamp(0, s_kv)


def _visible(s_q: int, s_kv: int, lens: Tensor, causal: bool) -> Tensor:
    """(b, 1, s_q, s_kv) bool: which keys each row sees."""
    k_pos = torch.arange(s_kv, device=lens.device)
    vis = (k_pos[None, :] < lens.long()[:, None])[:, None, None, :]
    if causal:
        q_pos = torch.arange(s_q, device=lens.device)
        vis = vis & (k_pos[None, :] <= q_pos[:, None])[None, None]
    return vis


def _env_block_h(heads: int) -> int:
    """``ATTN_BLOCK_H`` resolved against this call's head count: a value
    that does not divide it falls back to 1, with one warning per
    ``(block_h, heads)`` shape (an explicit ``block_h`` raises instead)."""
    block_h = ATTN_BLOCK_H
    if block_h > 1 and heads % block_h:
        key = (block_h, heads)
        if key not in _ENV_BLOCK_H_WARNED:
            _ENV_BLOCK_H_WARNED.add(key)
            logging.getLogger(__name__).warning(
                "RAFIKI_ATTN_BLOCK_H=%d does not divide the local head "
                "count (%d); falling back to block_h=1 for this shape",
                block_h, heads)
        return 1
    return block_h


def _scores(q: Tensor, k: Tensor, sm_scale: float) -> Tensor:
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale


# ---------------------------------------------------------------- plain

def _attention_reference(q: Tensor, k: Tensor, v: Tensor, sm_scale: float,
                         causal: bool, kv_lens=None) -> Tensor:
    """Masked f32 softmax attention. A row whose every key is masked
    outputs exact zeros, like the kernels' ``LSE_MASKED`` path."""
    b, _, s_q, _ = q.shape
    s_kv = k.shape[2]
    lens = _prep_lens(kv_lens, b, s_kv, q.device)
    vis = _visible(s_q, s_kv, lens, causal)
    s = torch.where(vis, _scores(q, k, sm_scale), NEG_INF)
    p = torch.softmax(s, dim=-1) * vis.any(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _flash_fwd_reference(q: Tensor, k: Tensor, v: Tensor, lens: Tensor,
                         sm_scale: float, causal: bool
                         ) -> Tuple[Tensor, Tensor]:
    """Plain B3: ``(out in q's dtype, lse (b, h, s_q) f32)``."""
    s_q, s_kv = q.shape[2], k.shape[2]
    vis = _visible(s_q, s_kv, lens, causal)
    s = torch.where(vis, _scores(q, k, sm_scale), NEG_INF)
    any_vis = vis.any(-1)  # (b, 1, s_q)
    lse = torch.where(any_vis, torch.logsumexp(s, dim=-1), LSE_MASKED)
    p = torch.exp(s - lse[..., None]) * vis
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return out, lse


def _flash_mma_reference(q: Tensor, k: Tensor, v: Tensor, lens: Tensor,
                         sm_scale: float, causal: bool, p_terms: int = 2
                         ) -> Tuple[Tensor, Tensor]:
    """Plain model of the bf16 forward's numerics (``fwd_heads_wgmma``):
    64-key tiles in order, each 64-row query tile walking the tiles below
    ``min(kv_len, its causal horizon)``; f32 scores of q·k times
    ``sm_scale·log2(e)``; an online softmax in base 2; P carried into P·V
    as ``p_terms`` bf16 terms (2: hi + lo, the kernel's; 1: one rounding)
    against V's values, summed in f32; out normalized once and rounded to
    q's dtype, LSE ``m·ln 2 + ln l``. ``(out, lse)`` as the kernels give
    them."""
    b, h, s_q, _ = q.shape
    s_kv = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    q_pos = torch.arange(s_q, device=q.device)
    # the keys a row's query tile walks: (b, 1, s_q, 1)
    end = lens.long()[:, None].expand(b, s_q)
    if causal:
        end = torch.minimum(end, (q_pos // _TILE + 1)[None] * _TILE)
    end = end[:, None, :, None]
    m = torch.full((b, h, s_q, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    scale_log2 = sm_scale / math.log(2.0)
    for k0 in range(0, s_kv, _TILE):
        k_pos = torch.arange(k0, min(k0 + _TILE, s_kv), device=q.device)
        vis = _visible(s_q, s_kv, lens, causal)[..., k0:k0 + _TILE]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k_pos]) * scale_log2
        s = torch.where(vis, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        p_v = p.to(torch.bfloat16).float()
        if p_terms == 2:
            p_v = p_v + (p - p_v).to(torch.bfloat16).float()
        walked = k0 < end
        acc = torch.where(walked, acc * alpha + p_v @ vf[:, :, k_pos], acc)
        l = torch.where(walked, l * alpha + p.sum(-1, keepdim=True), l)
        m = torch.where(walked, m_new, m)
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    lse = torch.where(l > 0, m * math.log(2.0) + torch.log(l), LSE_MASKED)
    return out, lse[..., 0]


def _bwd_terms(q, k, v, do, lse, delta, lens, sm_scale, causal):
    """The backward's per-pair terms in f32: ``p = exp(s·scale − lse)``
    and ``ds = p·(dO·Vᵀ − delta)·scale``, zero where masked."""
    s_q, s_kv = q.shape[2], k.shape[2]
    vis = _visible(s_q, s_kv, lens, causal)
    p = torch.exp(torch.where(vis, _scores(q, k, sm_scale), NEG_INF)
                  - lse.float()[..., None]) * vis
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta.float()[..., None]) * sm_scale
    return p, ds


def _flash_bwd_dq_reference(q, k, v, do, lse, delta, lens, sm_scale,
                            causal) -> Tensor:
    """Plain B5: dQ = Σ_k ds·K, in q's dtype."""
    _, ds = _bwd_terms(q, k, v, do, lse, delta, lens, sm_scale, causal)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def _flash_bwd_dkv_reference(q, k, v, do, lse, delta, lens, sm_scale,
                             causal) -> Tuple[Tensor, Tensor]:
    """Plain B6: dK = Σ_q dsᵀ·Q, dV = Σ_q pᵀ·dO, in k's / v's dtype."""
    p, ds = _bwd_terms(q, k, v, do, lse, delta, lens, sm_scale, causal)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float()).to(v.dtype)
    return dk, dv


def _bf16_terms(x: Tensor, n: int) -> Tensor:
    """``x`` as the kernels carry it into a product: one bf16 rounding
    (``n == 1``) or hi + lo bf16 terms (``n == 2``), back in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi if n == 1 else hi + (x - hi).to(torch.bfloat16).float()


def _flash_bwd_mma_reference(q, k, v, do, lse, delta, lens, sm_scale,
                             causal, p_terms: int = 2, ds_terms: int = 2
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain model of the bf16 backward's numerics (``bwd_dq_wgmma`` and
    ``bwd_dkv_wgmma``): f32 scores q·kᵀ and dO·vᵀ from the bf16 operands;
    ``p = exp2(s·scale·log2 e − lse·log2 e)``, zero where masked; ``ds =
    p·(dp − delta)·scale``; p and ds carried into their products as
    ``p_terms`` / ``ds_terms`` bf16 terms (2: hi + lo, the kernels'; 1:
    one rounding) against bf16 K, Q and dO, summed in f32 tile by tile in
    the kernels' order: dQ over 64-key tiles, dK and dV over 64-row query
    tiles. ``(dq, dk, dv)`` rounded to q's dtype."""
    s_q, s_kv = q.shape[2], k.shape[2]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    vis = _visible(s_q, s_kv, lens, causal)
    log2e = 1.0 / math.log(2.0)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.exp2(s * (sm_scale * log2e)
                   - (lse.float() * log2e)[..., None])
    p = torch.where(vis, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.float()[..., None]) * sm_scale
    p, ds = _bf16_terms(p, p_terms), _bf16_terms(ds, ds_terms)
    dq = torch.zeros_like(qf)
    for k0 in range(0, s_kv, _TILE):
        dq = dq + ds[..., k0:k0 + _TILE] @ kf[:, :, k0:k0 + _TILE]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, s_q, _TILE):
        rows = slice(q0, q0 + _TILE)
        dv = dv + p[:, :, rows].transpose(-1, -2) @ dof[:, :, rows]
        dk = dk + ds[:, :, rows].transpose(-1, -2) @ qf[:, :, rows]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(do: Tensor, out: Tensor) -> Tensor:
    """``rowsum(dO · O)`` in f32, (b, h, s_q)."""
    return (do.float() * out.float()).sum(-1)


def _flash_bwd_reference(q, k, v, out, lse, do, lens, sm_scale, causal
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain backward from the forward's residuals: (dq, dk, dv)."""
    delta = _delta(do, out)
    dq = _flash_bwd_dq_reference(q, k, v, do, lse, delta, lens, sm_scale,
                                 causal)
    dk, dv = _flash_bwd_dkv_reference(q, k, v, do, lse, delta, lens,
                                      sm_scale, causal)
    return dq, dk, dv


# ---------------------------------------------------------------- kernels

class FlashPlan(NamedTuple):
    """How B3 and B4 run for one head dim and dtype: the body (``"wgmma"``:
    bf16 on the tensor cores; ``"fma"``: f32 on the CUDA cores), the head
    dim it computes with (padded with zero columns), the bytes per
    device-to-shared copy, the K/V ring's stages, threads per block, and
    dynamic shared memory per block in bytes. Both bodies take 64 query
    rows (B4: per head) and keys in tiles of 64."""
    body: str
    head_dim: int
    copy_bytes: int
    stages: int
    threads: int
    smem_bytes: int


def _flash_plan(d: int, dtype: torch.dtype) -> FlashPlan:
    """The forward's plan, as ``rt_flash_fwd_plan`` reports it from the
    compiled kernels (the card's tests hold the two equal). bf16: one
    warpgroup on wgmma, Q and the K/V tiles in 128-byte swizzled layouts,
    the head dim padded with zero columns to whole 64-column blocks,
    16-byte ``cp.async`` copies where a row is whole 16-byte chunks, else
    8-byte (d = 12), 3 K/V stages up to d = 64 and 2 above. f32: the
    first design's f32 tiles (q and k padded by 4 floats, v, and the p
    tile)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not compiled; the kernels take "
                         f"{HEAD_DIMS}")
    if dtype == torch.bfloat16:
        dp = -(-d // 64) * 64
        stages = 3 if d <= 64 else 2
        # a Q tile and the K/V ring, + 1024 bytes to align the swizzle
        return FlashPlan("wgmma", dp, 16 if (2 * d) % 16 == 0 else 8,
                         stages, 128, (1 + 2 * stages) * _TILE * dp * 2 + 1024)
    if dtype == torch.float32:
        return FlashPlan("fma", d, 4, 1, 256,
                         (2 * _TILE * (d + 4) + _TILE * d
                          + _TILE * (_TILE + 1)) * 4)
    raise TypeError(f"the kernels take float32 or bfloat16, got {dtype}")


class FlashBwdPlan(NamedTuple):
    """How B5 (``dq``) and B6 (``dkv``) run for one head dim and dtype,
    each as a :class:`FlashPlan` (an FMA body copies one element at a
    time, so its copy width is the element size)."""
    dq: FlashPlan
    dkv: FlashPlan


def _fma_bwd_plans(d: int, elem: int) -> FlashBwdPlan:
    """The first design's f32 tiles: B5 q, dO, k, v (padded by 4 floats),
    the ds tile, lse and delta; B6 k and v unpadded, q and dO padded, the
    pᵀ and dsᵀ tiles, lse and delta."""
    pt, rows = _TILE * (_TILE + 1), 2 * _TILE
    dq = (4 * _TILE * (d + 4) + pt + rows) * 4
    dkv = (2 * _TILE * d + 2 * _TILE * (d + 4) + 2 * pt + rows) * 4
    return FlashBwdPlan(FlashPlan("fma", d, elem, 1, 256, dq),
                        FlashPlan("fma", d, elem, 1, 256, dkv))


def _flash_bwd_plan(d: int, dtype: torch.dtype) -> FlashBwdPlan:
    """The backward's plans, as ``rt_flash_bwd_plan`` reports them from the
    compiled kernels (the card's tests hold the two equal). bf16: one
    warpgroup on wgmma with the forward's padded tiles and copies, 3 ring
    stages up to d = 64 and 2 above; B5 holds Q and dO with a ring of K/V
    stages, B6 holds K and V with a ring of Q/dO stages and their lse and
    delta rows (f32), each + 1024 bytes to align the swizzle. B6 above
    d = 128, and f32 everywhere, run the FMA bodies."""
    fwd = _flash_plan(d, dtype)
    if dtype == torch.float32:
        return _fma_bwd_plans(d, 4)
    tiles = (2 + 2 * fwd.stages) * _TILE * fwd.head_dim * 2 + 1024
    dq = fwd._replace(smem_bytes=tiles)
    if fwd.head_dim > 128:
        return FlashBwdPlan(dq, _fma_bwd_plans(d, 2).dkv)
    return FlashBwdPlan(dq, fwd._replace(
        smem_bytes=tiles + fwd.stages * 2 * _TILE * 4))


def _compiled_plan(d: int, dtype: torch.dtype) -> FlashPlan:
    """The plan the built library runs, from ``rt_flash_fwd_plan``."""
    out = (ctypes.c_int * 6)()
    _raise_on(_library().rt_flash_fwd_plan(_DTYPE_CODES[dtype], d, out),
              "rt_flash_fwd_plan")
    return FlashPlan(("fma", "wgmma")[out[0]], *out[1:])


def _compiled_bwd_plan(d: int, dtype: torch.dtype) -> FlashBwdPlan:
    """The backward's plans the built library runs, from
    ``rt_flash_bwd_plan``."""
    out = (ctypes.c_int * 12)()
    _raise_on(_library().rt_flash_bwd_plan(_DTYPE_CODES[dtype], d, out),
              "rt_flash_bwd_plan")
    return FlashBwdPlan(*(FlashPlan(("fma", "wgmma")[out[i]],
                                    *out[i + 1:i + 6]) for i in (0, 6)))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for plan in (lib.rt_flash_fwd_plan, lib.rt_flash_bwd_plan):
        plan.argtypes = [i32, i32, ptr]
        plan.restype = i32
    tail = [i32] * 5 + [f32, ptr]  # b, h, s_q, s_kv, causal, scale, stream
    lib.rt_flash_fwd.argtypes = [i32, i32] + [ptr] * 6 + tail
    lib.rt_flash_fwd.restype = i32
    lib.rt_flash_fwd_mh.argtypes = ([i32, i32] + [ptr] * 6 + tail[:-1]
                                    + [i32, ptr])  # block_h before stream
    lib.rt_flash_fwd_mh.restype = i32
    lib.rt_flash_bwd_dq.argtypes = [i32, i32] + [ptr] * 8 + tail
    lib.rt_flash_bwd_dq.restype = i32
    lib.rt_flash_bwd_dkv.argtypes = [i32, i32] + [ptr] * 9 + tail
    lib.rt_flash_bwd_dkv.restype = i32
    return lib


def _check_operands(q: Tensor, k: Tensor, v: Tensor, lens: Tensor,
                    **extra: Tensor) -> None:
    """Validate what the kernels take (they check nothing themselves)."""
    dev = q.device
    for name, t in {"q": q, "k": k, "v": v, "kv_lens": lens,
                    **extra}.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{t.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} is not compiled; the "
                         f"kernels take {HEAD_DIMS}")
    if lens.dtype != torch.int32:
        raise TypeError("kv_lens must be int32")


def _aligned(*ts: Tensor) -> Tuple[Tensor, ...]:
    """Contiguous operands for the bf16 bodies, which copy rows in 16-byte
    (8 for d = 12) pieces: a view that starts off that alignment gets a
    fresh copy."""
    return tuple(t.contiguous() if t.data_ptr() % 16 == 0
                 else t.contiguous().clone() for t in ts)


def _geometry(q: Tensor, k: Tensor, causal: bool, sm_scale: float):
    b, h, s_q, _ = q.shape
    return (b, h, s_q, k.shape[2], int(bool(causal)), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch_fwd(what: str, q: Tensor, k: Tensor, v: Tensor,
                kv_lens: Tensor, sm_scale: float, causal: bool,
                with_lse: bool, *block_h: int
                ) -> Tuple[Tensor, Optional[Tensor]]:
    """Check the operands, allocate ``(out, lse)`` and launch B3
    (``rt_flash_fwd``) or, given ``block_h``, B4 (``rt_flash_fwd_mh``,
    which takes it before the stream)."""
    lib = _library()
    q, k, v = _aligned(q, k, v)
    kv_lens = kv_lens.contiguous()  # held while the kernel may read it
    _check_operands(q, k, v, kv_lens)
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    *geom, stream = _geometry(q, k, causal, sm_scale)
    entry = lib.rt_flash_fwd_mh if block_h else lib.rt_flash_fwd
    with torch.cuda.device(q.device):
        err = entry(_DTYPE_CODES[q.dtype], q.shape[-1], q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
                    out.data_ptr(), lse.data_ptr() if with_lse else None,
                    *geom, *block_h, stream)
    _raise_on(err, what)
    return out, lse


def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, kv_lens: Tensor,
                        sm_scale: float, causal: bool,
                        with_lse: bool = True
                        ) -> Tuple[Tensor, Optional[Tensor]]:
    """B3: ``(out, lse)`` for (b, h, s, d) q/k/v and (b,) int32
    ``kv_lens`` (already clipped to [0, s_kv]). ``lse`` is (b, h, s_q)
    f32, or None without ``with_lse`` (the evaluation forward, which
    skips the residual write as JAX's serving path does)."""
    if not _runs_kernel(q):
        out, lse = _flash_fwd_reference(q, k, v, kv_lens, sm_scale, causal)
        return out, (lse if with_lse else None)
    out, lse = _launch_fwd("flash_attention_fwd", q, k, v, kv_lens,
                           sm_scale, causal, with_lse)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_fwd_mh(q: Tensor, k: Tensor, v: Tensor,
                           kv_lens: Tensor, sm_scale: float, causal: bool,
                           block_h: int, with_lse: bool = True
                           ) -> Tuple[Tensor, Optional[Tensor]]:
    """B4: :func:`flash_attention_fwd`'s function with ``block_h``
    consecutive heads of one example per block (``block_h`` divides the
    head count); the plain version is B3's."""
    h = q.shape[1]
    if block_h < 1 or h % block_h:
        raise ValueError(f"block_h={block_h} must be >= 1 and divide heads "
                         f"({h})")
    if not _runs_kernel(q):
        out, lse = _flash_fwd_reference(q, k, v, kv_lens, sm_scale, causal)
        return out, (lse if with_lse else None)
    out, lse = _launch_fwd("flash_attention_fwd_mh", q, k, v, kv_lens,
                           sm_scale, causal, with_lse, int(block_h))
    flash_attention_fwd_mh.launches += 1
    return out, lse


flash_attention_fwd_mh.launches = 0


def _bwd_operands(q, k, v, do, lse, delta, kv_lens):
    q, k, v, do = _aligned(q, k, v, do)
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    _check_operands(q, k, v, kv_lens, do=do, lse=lse, delta=delta)
    if do.dtype != q.dtype:
        raise TypeError(f"dO must be {q.dtype}, got {do.dtype}")
    return q, k, v, do, lse, delta, kv_lens.contiguous()


def flash_attention_bwd_dq(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                           lse: Tensor, delta: Tensor, kv_lens: Tensor,
                           sm_scale: float, causal: bool) -> Tensor:
    """B5: dQ from the forward's ``lse`` and ``delta = rowsum(dO·O)``
    (both (b, h, s_q) f32)."""
    if not _runs_kernel(q):
        return _flash_bwd_dq_reference(q, k, v, do, lse, delta, kv_lens,
                                       sm_scale, causal)
    lib = _library()
    q, k, v, do, lse, delta, kv_lens = _bwd_operands(q, k, v, do, lse,
                                                     delta, kv_lens)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.rt_flash_bwd_dq(
            _DTYPE_CODES[q.dtype], q.shape[-1], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            kv_lens.data_ptr(), dq.data_ptr(),
            *_geometry(q, k, causal, sm_scale))
    _raise_on(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                            lse: Tensor, delta: Tensor, kv_lens: Tensor,
                            sm_scale: float, causal: bool
                            ) -> Tuple[Tensor, Tensor]:
    """B6: (dK, dV). A key tile wholly past ``kv_len`` writes zeros."""
    if not _runs_kernel(q):
        return _flash_bwd_dkv_reference(q, k, v, do, lse, delta, kv_lens,
                                        sm_scale, causal)
    lib = _library()
    q, k, v, do, lse, delta, kv_lens = _bwd_operands(q, k, v, do, lse,
                                                     delta, kv_lens)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.rt_flash_bwd_dkv(
            _DTYPE_CODES[q.dtype], q.shape[-1], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            kv_lens.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_geometry(q, k, causal, sm_scale))
    _raise_on(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


# ---------------------------------------------------------------- public

def _forward(q, k, v, lens, sm_scale, causal, block_h, with_lse):
    """B3, or B4 for ``block_h > 1``."""
    if block_h > 1:
        return flash_attention_fwd_mh(q, k, v, lens, sm_scale, causal,
                                      block_h, with_lse)
    return flash_attention_fwd(q, k, v, lens, sm_scale, causal, with_lse)


class _FlashAttention(torch.autograd.Function):
    """B3 (or B4) forward, B5 + B6 backward; ``kv_lens`` is not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, lens, sm_scale, causal, block_h):
        out, lse = _forward(q, k, v, lens, sm_scale, causal, block_h, True)
        ctx.save_for_backward(q, k, v, out, lse, lens)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, lens = ctx.saved_tensors
        delta = _delta(do, out)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, lens,
                                    ctx.sm_scale, ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, lens,
                                         ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                    sm_scale: Optional[float] = None, causal: bool = False,
                    kv_lens=None, block_h: Optional[int] = None) -> Tensor:
    """Fused attention over (batch, heads, seq, head_dim) tensors, f32 or
    bf16; returns q's dtype.

    ``kv_lens`` (optional int [batch]) masks each example's keys past its
    valid length. Differentiable in q, k and v; without a gradient to
    take (``torch.no_grad`` or no input requiring one) the forward skips
    the LSE write. ``block_h > 1`` runs the head-tiled forward (B4) with
    that many heads of one example per block; it must divide the head
    count. ``block_h=None`` takes ``ATTN_BLOCK_H``, falling back to 1
    where that does not divide the heads."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q (b, h, s_q, d) and k/v (b, h, s_kv, d) "
                         f"disagree: {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if block_h is None:
        block_h = _env_block_h(q.shape[1])
    if block_h < 1:
        raise ValueError(f"block_h={block_h} must be >= 1")
    if block_h > 1 and q.shape[1] % block_h:
        raise ValueError(
            f"block_h={block_h} must divide heads ({q.shape[1]}): a head "
            "tile spanning two examples would mix their kv_lens")
    scale = sm_scale if sm_scale is not None else \
        1.0 / math.sqrt(q.shape[-1])
    lens = _prep_lens(kv_lens, q.shape[0], k.shape[2], q.device)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, lens, scale, causal, block_h)
    return _forward(q, k, v, lens, scale, causal, block_h, False)[0]
