"""PyTorch/CUDA port of ``rafiki_tpu`` for NVIDIA Hopper (H100).

The JAX package ``rafiki_tpu`` is the reference; this package mirrors its
file layout module by module (``rafiki_tpu_torch/ops/paged_attention.py``
ports ``rafiki_tpu/ops/paged_attention.py`` and so on), and every Pallas
kernel on a ported path becomes a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use.

Rules the port keeps:

- it imports ``torch`` and ``numpy``, never ``jax``/``flax``/``optax`` and
  nothing from ``rafiki_tpu`` — what it needs of a JAX-free reference
  module it keeps as its own copy;
- entry points run on the CUDA card unless the caller passes
  ``device="cpu"`` (:func:`rafiki_tpu_torch.utils.device.resolve_device`);
- a kernel wrapper runs its plain PyTorch version only for tensors that
  lie on the CPU; a CUDA tensor launches the kernel or raises.

Slices ported so far: paged Llama serving (the decoder's decode branch,
the continuous-batching ``DecodeEngine`` over a paged KV pool, kernels
B1/B2); LoRA training of the Llama template (the flash-attention forward
and backward, B3/B5/B6); and the ViT and BERT classifiers, serving and
training (the head-tiled forward B4 and the patch projection B7).
"""

__version__ = "0.1.0"
