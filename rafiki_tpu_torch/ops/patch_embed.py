"""ViT patch embedding: a layout op and one fused ``x @ w + b``.

Ports ``rafiki_tpu/ops/patch_embed.py``:

- :func:`extract_patches` ← ``extract_patches``: (B, H, W, C) →
  (B, H/P · W/P, P·P·C), the same patch and channel order.
- :func:`matmul_bias` ← ``matmul_bias``, whose Pallas kernel
  ``_matmul_bias_kernel`` (B7) becomes ``csrc/patch_embed.cu``
  ``matmul_bias_mma_kernel`` (bf16, ``wgmma`` tensor cores) or
  ``matmul_bias_fma_kernel`` (f32): f32 products and sums, the result
  rounded once to x's dtype. :func:`_matmul_plan` picks the body and its
  copy width from the shapes; :func:`_matmul_bias_reference` is the plain
  version, the JAX wrapper's XLA fallback.
- :func:`patch_embed` ← the ``jax.custom_vjp`` ``patch_embed``: a
  ``torch.autograd.Function`` whose forward runs :func:`matmul_bias` and
  whose backward is ``_pe_bwd`` in plain torch (f32 ``dw``, ``db`` and
  patch gradient, then the inverse patch layout), as JAX computes it
  outside Pallas.

The wrapper takes the plain version for tensors on the CPU and launches
the kernel (built by ``ops/_build.py`` at first use) for any other device,
or raises; it counts launches in ``matmul_bias.launches``. JAX's padding
of every dimension to block multiples was TPU tiling: the kernel masks
the ragged edges itself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from rafiki_tpu_torch.ops import _build
from rafiki_tpu_torch.ops.common import KERNEL_DTYPES as _DTYPE_CODES
from rafiki_tpu_torch.ops.common import check_launch as _raise_on
from rafiki_tpu_torch.ops.common import runs_kernel as _runs_kernel

Tensor = torch.Tensor


def extract_patches(images: Tensor, patch_size: int) -> Tensor:
    """(B, H, W, C) → (B, H/P · W/P, P·P·C) by reshapes and one
    permute."""
    b, h, w, c = images.shape
    p = int(patch_size)
    if h % p or w % p:
        raise ValueError(f"image {tuple(images.shape)} is not a multiple "
                         f"of patch {p}")
    x = images.reshape(b, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, hp, wp, P, P, C)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def _matmul_bias_reference(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Plain B7: ``x @ w + b`` in f32, cast back to x's dtype."""
    return (x.float() @ w.float() + b.float()).to(x.dtype)


class MatmulPlan(NamedTuple):
    """How ``rt_matmul_bias`` runs one call: its body (``"wgmma"``: bf16 on
    the tensor cores; ``"fma"``: f32 on the CUDA cores), the width in bytes
    of its device-to-shared copies, the block's output tile (rows,
    columns, k depth per stage) and the grid's block count."""
    body: str
    copy_bytes: int
    tile: tuple
    blocks: int


#: output tile (rows, columns, k depth) of each body
_TILES = {"wgmma": (128, 192, 64), "fma": (64, 64, 32)}


def _matmul_plan(m: int, n: int, k: int, dtype: torch.dtype,
                 aligned: bool = True) -> MatmulPlan:
    """B7's plan from shapes: f32 takes the FMA body (TF32 would break the
    f32 tolerance); bf16 takes the tensor-core body, fed by 16-byte
    ``cp.async`` copies when every row is 16-byte aligned (k and n
    multiples of 8, and ``aligned``: x, w and out start on 16 bytes), else
    by element copies into the same ring."""
    if dtype == torch.float32:
        body, copy = "fma", 4
    elif dtype == torch.bfloat16:
        body = "wgmma"
        copy = 16 if aligned and k % 8 == 0 and n % 8 == 0 else 2
    else:
        raise TypeError(f"matmul_bias takes float32 or bfloat16, got {dtype}")
    tm, tn, tk = _TILES[body]
    return MatmulPlan(body, copy, (tm, tn, tk), -(-m // tm) * -(-n // tn))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("patch_embed")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rt_matmul_bias.argtypes = [i32] + [ptr] * 4 + [i32] * 4 + [ptr]
    lib.rt_matmul_bias.restype = i32
    return lib


def _check_operands(x: Tensor, w: Tensor, b: Tensor) -> None:
    """Validate what the kernel takes (it checks nothing itself)."""
    dev = x.device
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{t.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype \
            or b.dtype != x.dtype:
        raise TypeError(f"x/w/b must share float32 or bfloat16, got "
                        f"{x.dtype}/{w.dtype}/{b.dtype}")
    if x.shape[0] == 0:
        raise ValueError("x has no rows")


def matmul_bias(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """B7: ``x @ w + b`` for x (m, k), w (k, n) and b (n,), f32 math,
    in x's dtype."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"x (m, k), w (k, n), b (n,) disagree: "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if not _runs_kernel(x):
        return _matmul_bias_reference(x, w, b)
    lib = _library()
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    _check_operands(x, w, b)
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    plan = _matmul_plan(m, n, k, x.dtype, all(
        t.data_ptr() % 16 == 0 for t in (x, w, out)))
    with torch.cuda.device(x.device):
        err = lib.rt_matmul_bias(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), m, n, k, plan.copy_bytes,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "matmul_bias")
    matmul_bias.launches += 1
    return out


matmul_bias.launches = 0


class _PatchEmbed(torch.autograd.Function):
    """Forward through :func:`matmul_bias`; backward ``_pe_bwd``."""

    @staticmethod
    def forward(ctx, images, w, b, patch_size):
        patches = extract_patches(images, patch_size)
        bsz, n, k = patches.shape
        out = matmul_bias(patches.reshape(bsz * n, k), w, b)
        ctx.save_for_backward(images, w)
        ctx.patch_size = patch_size
        ctx.b_dtype = b.dtype
        return out.reshape(bsz, n, -1)

    @staticmethod
    def backward(ctx, g):
        images, w = ctx.saved_tensors
        p = ctx.patch_size
        bsz, n, d = g.shape
        g2 = g.reshape(bsz * n, d).float()
        dimg = dw = db = None
        if ctx.needs_input_grad[1]:
            patches = extract_patches(images, p)
            p2 = patches.reshape(bsz * n, -1).float()
            dw = (p2.t() @ g2).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g2.sum(0).to(ctx.b_dtype)
        if ctx.needs_input_grad[0]:
            dp = (g2 @ w.float().t()).to(images.dtype)
            _, h, wd, c = images.shape
            dimg = dp.reshape(bsz, h // p, wd // p, p, p, c) \
                .permute(0, 1, 3, 2, 4, 5).reshape(bsz, h, wd, c)
        return dimg, dw, db, None


def patch_embed(images: Tensor, w: Tensor, b: Tensor,
                patch_size: int) -> Tensor:
    """ViT patch embedding: (B, H, W, C) → (B, N_patches, D) with ``w``
    (P·P·C, D) and ``b`` (D,); differentiable in all three."""
    return _PatchEmbed.apply(images, w, b, int(patch_size))
