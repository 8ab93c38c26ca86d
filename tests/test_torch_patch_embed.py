"""Port parity: ``rafiki_tpu_torch.ops.patch_embed`` against the JAX module.

On the CPU the port's ``matmul_bias`` runs its plain version (B7's); the
JAX side runs its Pallas kernel in the interpreter (``interpret=True``),
as ``tests/test_ops.py`` does. Inputs are drawn with numpy from a seed
and handed to both.

Tolerances: f32 at rtol 1e-5 with an absolute floor of 1e-5 (the two
sides sum the k products in another order; near-zero outputs and
gradient entries need the floor). bf16 outputs within one bf16 step
(2^-7 of the largest magnitude) plus 1e-3: each side rounds its f32 sum
to bf16 once, and a rounding that falls the other way differs by one
step.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu_torch.ops import patch_embed as tpe

# the module (rafiki_tpu.ops re-exports its patch_embed function)
jpe = importlib.import_module("rafiki_tpu.ops.patch_embed")

torch.set_num_threads(1)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-5, err_msg=what)


# (m, k, n): ragged against the JAX tiles (256, 512, 256) and the kernel's
# (64, 32, 64); ViT-like k = P·P·C
SHAPES = [(50, 48, 40), (130, 75, 33), (1, 768, 96), (200, 192, 128)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matmul_bias_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    b = rng.standard_normal((n,)).astype(np.float32)
    want = jpe.matmul_bias(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           interpret=True)
    got = tpe.matmul_bias(*(torch.from_numpy(a) for a in (x, w, b)))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, want)


def test_matmul_bias_bf16_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((70, 96), (96, 40), (40,))]
    jx, jw, jb = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    want = np.asarray(jpe.matmul_bias(jx, jw, jb, interpret=True),
                      np.float32)
    got = tpe.matmul_bias(*(torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(torch.bfloat16) for a in (jx, jw, jb)))
    assert got.dtype == torch.bfloat16
    tol = 1e-3 + 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= tol


@pytest.mark.parametrize("p,hw", [(4, (16, 12)), (16, (32, 32)),
                                  (7, (14, 28))])
def test_extract_patches_equal(p, hw):
    imgs = np.random.default_rng(p).standard_normal(
        (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jpe.extract_patches(jnp.asarray(imgs), p))
    got = tpe.extract_patches(torch.from_numpy(imgs), p).numpy()
    np.testing.assert_array_equal(got, want)


def test_extract_patches_rejects_a_ragged_image():
    with pytest.raises(ValueError, match="patch"):
        tpe.extract_patches(torch.zeros(1, 10, 8, 3), 4)


def test_patch_embed_forward_and_grads_match_jax():
    """The forward through B7's plain version and the backward
    (``_pe_bwd``): the image, kernel and bias gradients against
    ``jax.grad`` of the JAX ``patch_embed`` with its Pallas kernel in the
    interpreter."""
    rng = np.random.default_rng(7)
    p = 4
    imgs = rng.standard_normal((3, 12, 8, 3)).astype(np.float32)
    w = rng.standard_normal((p * p * 3, 20)).astype(np.float32) * 0.2
    b = rng.standard_normal((20,)).astype(np.float32)
    g = rng.standard_normal((3, 6, 20)).astype(np.float32)

    def jloss(imgs, w, b):
        return jnp.sum(jpe.patch_embed(imgs, w, b, p, True) * g)

    want_out = jpe.patch_embed(jnp.asarray(imgs), jnp.asarray(w),
                               jnp.asarray(b), p, True)
    want_grads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(imgs), jnp.asarray(w), jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (imgs, w, b)]
    out = tpe.patch_embed(*leaves, p)
    _close(out.detach(), want_out, "out")
    out.backward(torch.from_numpy(g))
    for name, t, want in zip(("images", "w", "b"), leaves, want_grads):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        _close(t.grad, want, f"d{name}")


def test_patch_embed_bf16_grads_keep_the_input_dtypes():
    """bf16 images, kernel and bias (the ViT's bf16 compute): the
    gradients come back in bf16, as JAX's ``astype(w.dtype)``."""
    leaves = [torch.randn(2, 8, 8, 3).to(torch.bfloat16).requires_grad_(),
              torch.randn(48, 16).to(torch.bfloat16).requires_grad_(),
              torch.randn(16).to(torch.bfloat16).requires_grad_()]
    out = tpe.patch_embed(*leaves, 4)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 16)
    out.float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)


def test_cpu_never_counts_launches_and_shapes_are_checked():
    before = tpe.matmul_bias.launches
    tpe.matmul_bias(torch.ones(3, 4), torch.ones(4, 5), torch.ones(5))
    assert tpe.matmul_bias.launches == before
    with pytest.raises(ValueError):
        tpe.matmul_bias(torch.ones(3, 4), torch.ones(5, 5), torch.ones(5))
    with pytest.raises(ValueError):
        tpe.matmul_bias(torch.ones(3, 4), torch.ones(4, 5), torch.ones(4))


# ---- B7's plan from shapes, and the wrapper handing it to the kernel

@pytest.mark.parametrize("m,n,k,dtype,aligned,want", [
    (64 * 196, 768, 768, torch.bfloat16, True, ("wgmma", 16, 392)),
    (128, 768, 768, torch.bfloat16, True, ("wgmma", 16, 4)),
    (129, 768, 768, torch.bfloat16, True, ("wgmma", 16, 8)),
    (130, 33, 75, torch.bfloat16, True, ("wgmma", 2, 2)),
    (127, 36, 768, torch.bfloat16, True, ("wgmma", 2, 1)),
    (127, 768, 76, torch.bfloat16, True, ("wgmma", 2, 4)),
    (128, 768, 768, torch.bfloat16, False, ("wgmma", 2, 4)),
    (64 * 196, 768, 768, torch.float32, True, ("fma", 4, 196 * 12)),
], ids=["vit", "m128", "m129", "k75-n33", "n36", "k76", "offset",
        "f32"])
def test_matmul_plan_from_shapes(m, n, k, dtype, aligned, want):
    """bf16 runs the tensor-core (wgmma) body, fed by 16-byte copies only
    when every row is 16-byte aligned (k and n multiples of 8, and the
    operands start on 16 bytes), else by element copies; f32 keeps the
    FMA body and its 64 x 64 tiles. The block count is the grid's."""
    plan = tpe._matmul_plan(m, n, k, dtype, aligned)
    assert (plan.body, plan.copy_bytes, plan.blocks) == want
    tm, tn, _ = plan.tile
    assert plan.blocks == -(-m // tm) * -(-n // tn)


def test_matmul_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tpe._matmul_plan(8, 8, 8, torch.float16)


class _RecordingLib:
    """Stands in for the built library: records each launch's arguments
    and reports success."""

    def __init__(self):
        self.calls = []
        self.rt_matmul_bias = self._launch

    def _launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("m,k,n,offset,copy", [
    (130, 768, 768, 0, 16), (130, 75, 33, 0, 2), (130, 768, 768, 1, 2)],
    ids=["aligned", "ragged", "offset-view"])
def test_wrapper_hands_the_plan_to_the_kernel(monkeypatch, m, k, n, offset,
                                              copy):
    """On the kernel path the wrapper launches once with the plan's copy
    width (a view that starts 2 bytes into its storage takes element
    copies) and counts the launch."""
    lib = _RecordingLib()
    monkeypatch.setattr(tpe, "_runs_kernel", lambda t: True)
    monkeypatch.setattr(tpe, "_library", lambda: lib)
    monkeypatch.setattr(tpe, "_check_operands", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    x = torch.zeros(m * k + offset, dtype=torch.bfloat16)[offset:] \
        .view(m, k)
    w = torch.zeros(k, n, dtype=torch.bfloat16)
    b = torch.zeros(n, dtype=torch.bfloat16)
    before = tpe.matmul_bias.launches
    out = tpe.matmul_bias(x, w, b)
    assert out.shape == (m, n) and tpe.matmul_bias.launches == before + 1
    (args,) = lib.calls
    assert args[0] == 1 and args[5:9] == (m, n, k, copy)


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
